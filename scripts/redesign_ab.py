#!/usr/bin/env python3
"""A kernel redesigned for Hopper against its earlier design, on one card
in one process: slot_gather_kernel (csrc/dispatch.cu), the masked
re-trace's slot selection, this tree's source as the redesign.

The earlier design is another checkout's source (--root, for example an
earlier commit unpacked under the git-ignored out/), built with this
tree's nvcc flags into build/imbatracer_torch/ and launched through this
tree's wrappers, whose C interface both share.  Each kernel is timed as
chip_smoke.graph_ms (10 launches captured in one CUDA graph, after a
warm-up), earlier, redesigned, redesigned, earlier, on chip_smoke.py's
selection cells (the dispatch tests' SELECT_CASES over a 2^18-lane band
at the flat and two-level slot shares) and on the slots the graph-ready
re-trace gathers from a bounce's rays (chip_smoke.recorded_slots): the
middle 2^18-lane band of a still-life PT frame at 1920x1080 after bounce
1 (flat) and the instanced scene at 1920x1080 after bounce 1 (two-level).
The two designs' slots must be equal to each other and to the plain
version bit for bit.

Each `[ab]` line names the card and its power limit, with the lanes in
need, the bound of the bytes the function moves (chip_smoke.py's count)
and each build's registers, local bytes and resident blocks.  Run from
the repository root:

    python3 scripts/redesign_ab.py --root out/earlier
"""

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
from functools import partial

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from imbatracer_torch import libbuild  # noqa: E402
from imbatracer_torch.device import card_line, get_device  # noqa: E402
from imbatracer_torch.ops import dispatch as dp  # noqa: E402

# The redesigned kernels: (module, kernel, resources() argument).
KERNELS = ((dp, "slot_gather_kernel", "slot_gather"),)


class _Built:
    """A NativeLib stand-in whose library is already built."""

    def __init__(self, path):
        self.path = path

    def build(self):
        return self.path


def earlier_builds(root, mods):
    """{module: (ctypes library, ptxas lines)} of the earlier sources."""
    out, procs = {}, []
    os.makedirs(libbuild.BUILD_DIR, exist_ok=True)
    inc = os.path.join(os.path.abspath(root), "imbatracer_torch", "csrc")
    for mod in mods:
        so = os.path.join(libbuild.BUILD_DIR, f"lib{mod.LIB.name}_earlier.so")
        cmd = [libbuild._nvcc(), *libbuild.NVCC_FLAGS, "-I", inc, "-o", so,
               os.path.join(inc, mod.LIB.source)]
        procs.append((mod, so, subprocess.Popen(
            cmd, stderr=subprocess.PIPE, text=True)))
    for mod, so, p in procs:
        err = p.communicate()[1]
        if p.returncode != 0:
            raise RuntimeError(f"building the earlier {mod.LIB.source} "
                               f"failed:\n{err}")
        out[mod] = (load(mod, so), err)
    return out


def load(mod, path):
    """The library at `path`, its argument types set by mod._library()."""
    keep, mod.LIB, mod._lib = mod.LIB, _Built(path), None
    try:
        return mod._library()
    finally:
        mod.LIB, mod._lib = keep, None


def ptxas(log, kernel):
    """A build log's stack, spill and register lines of `kernel`."""
    lines = log.splitlines()
    for k, ln in enumerate(lines):
        if "Compiling entry function" in ln and kernel in ln:
            return "; ".join(x.split(":", 1)[-1].strip()
                             for x in lines[k + 1:k + 4]
                             if "stack frame" in x or "registers" in x)
    return "built before this process (its log: the build's)"


def turns(mod, libs, fn):
    """graph_ms of fn() with each library in turn: earlier, redesigned,
    redesigned, earlier; ([earlier], [redesigned])."""
    got = {"earlier": [], "redesigned": []}
    for which in ("earlier", "redesigned", "redesigned", "earlier"):
        mod._lib = libs[which]
        got[which].append(cs.graph_ms(fn))
    mod._lib = libs["redesigned"]
    return got["earlier"], got["redesigned"]


def fmt(ms):
    return " / ".join(f"{x:.4f}" for x in ms)


def selection_case(libs, label, need, slots, hit, tcur, card):
    """One `[ab]` line: the selection of `slots` slots from `need` by
    each design in turns, both held bit for bit against each other and
    the plain version first."""
    fn = partial(dp.slot_gather_cuda, need, slots, hit, tcur)
    got = {}
    for which in ("earlier", "redesigned"):
        dp._lib = libs[which]
        got[which] = fn()
    torch.cuda.synchronize()
    plain = dp.slot_gather_plain(need, slots, hit, tcur)
    bad = [cs.slot_mismatches(got[w], plain) for w in got]
    if any(bad):
        raise AssertionError(f"[ab] slot_gather {label}: {bad} elements of "
                             f"the earlier and the redesigned slots differ "
                             f"from the plain version's")
    earlier, new = turns(dp, libs, fn)
    nvalid, count = int(plain.valid.sum()), int(plain.count)
    tw = 0 if tcur is None else 4
    n = need.shape[0]
    nbytes = (n + slots * (8 + 2 + 16 + tw) + 8
              + (nvalid + int(nvalid < slots)) * (16 + tw))
    bound_ms, by = cs.shade_bound(nbytes, 0)
    cs.log(f"[ab] slot_gather_kernel, {label}: {n} lanes, {count} in need, "
           f"{slots} slots: earlier {fmt(earlier)} ms, redesigned "
           f"{fmt(new)} ms, bound {bound_ms:.5f} ms by {by} ({nbytes} "
           f"bytes); slots bit-equal [{card}]")


def bounce_case(libs, label, scene, meta, size, bounce, card):
    c, _, alpha_fn = cs.shade_carry(scene, meta, *size, 8, bounce,
                                    scene.device)
    need, slots, hit, tcur = cs.recorded_slots(scene, c, alpha_fn)
    selection_case(libs, label, need, slots, hit, tcur, card)


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", required=True,
                   help="checkout holding the earlier design")
    args = p.parse_args()
    from imbatracer_torch.scene.build import build_scene
    from imbatracer_torch.scene.generate import CARD, write_instanced_scene
    from imbatracer_torch.scene.procedural import make_still_life_like

    dev = get_device("cuda")
    card = card_line(dev)
    mods = [mod for mod, _, _ in KERNELS]
    new = {mod: mod._library() for mod in mods}
    built = earlier_builds(args.root, mods)
    libs = {mod: {"earlier": built[mod][0], "redesigned": new[mod]}
            for mod in mods}
    for mod, kernel, which in KERNELS:
        log = libbuild.BUILD_INFO.get(mod.LIB.name, {}).get("log", "")
        cs.log(f"[ab] {kernel} ptxas: earlier {ptxas(built[mod][1], kernel)}"
               f"; redesigned {ptxas(log, kernel)} [{card}]")
        for lib in ("earlier", "redesigned"):
            mod._lib = libs[mod][lib]
            cs.log_resources(f"{lib} {kernel}", mod.resources(which), card)
        mod._lib = libs[mod]["redesigned"]

    for two_level in (False, True):
        for seed, case in enumerate(cs.dispatch_cases().SELECT_CASES):
            selection_case(
                libs[dp], f"{case}, {'two-level' if two_level else 'flat'}"
                f" share", *cs.selection_inputs(case, two_level, seed, dev),
                card)
    still = make_still_life_like(device=dev)
    bounce_case(libs[dp], "still_life 1920x1080 bounce 1, the khit "
                "re-trace's", *still, (1920, 1080), 1, card)
    del still
    tmp = tempfile.mkdtemp(prefix="imba_ab_")
    inst = build_scene(write_instanced_scene(tmp, **CARD), quiet=True,
                       device=dev)
    bounce_case(libs[dp], "instanced 1920x1080 bounce 1, the two-level "
                "re-trace's", *inst, (1920, 1080), 1, card)
    shutil.rmtree(tmp, ignore_errors=True)
    cs.log("[ab] done")


if __name__ == "__main__":
    main()
