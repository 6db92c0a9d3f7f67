#!/usr/bin/env python3
"""A kernel redesigned for Hopper against its earlier design, on one card
in one process: dispatch_keys_kernel (csrc/dispatch.cu), this tree's
source as the redesign.

The earlier design is another checkout's source (--root, for example the
parent commit unpacked under the git-ignored out/), built with this
tree's nvcc flags into build/imbatracer_torch/ and launched through this
tree's wrappers, whose C interface both share.  Each kernel is timed as
chip_smoke.graph_ms (10 launches captured in one CUDA graph, after a
warm-up), earlier, redesigned, redesigned, earlier, on the rays a PT
frame sorts: the middle 2^18-lane band of a still-life PT frame at
1920x1080 at bounces 0, 1 and chip_smoke.LATE_BOUNCE (chip_smoke's
shade_carry), the cornell at 1024^2 after 1 and the instanced scene at
1920x1080 after 1, each in the forms a dispatch takes: every lane with
its active flags; the graph-ready re-trace's slots at both shares
(traverse.retrace_slots: the first lanes of the active ones,
torch.nonzero_static, their flags by slot); and the eager re-trace's
slot map of every active lane with its flags by lane.  The two designs'
keys must be equal bit for bit on every slot.

Each `[ab]` line names the card and its power limit, with the active
share, the bound of the bytes the function moves (chip_smoke.py's count,
and a slot's 8-byte lane) and each build's registers, local bytes and
resident blocks.  Run from the repository root:

    python3 scripts/redesign_ab.py --root out/parent
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
from imbatracer_torch.render import traverse as tt  # noqa: E402

# The redesigned kernels: (module, kernel, resources() argument).
KERNELS = ((dp, "dispatch_keys_kernel", "dispatch_keys"),)


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


def keys_forms(act):
    """{form: (lanes, flags, by_lane)} of the dispatches a bounce's rays
    meet: every lane, the graph-ready re-trace's slots at both shares,
    and the eager re-trace's slot map of every active lane."""
    n = act.shape[0]
    out = {"every lane": (None, act, False)}
    for two_level in (True, False):
        slots = tt.retrace_slots(n, two_level)
        idx = torch.nonzero_static(act, size=slots, fill_value=0)[:, 0]
        valid = torch.arange(slots, device=act.device) < act.sum()
        out[f"{slots} slots"] = (idx, valid, False)
    out["eager slot map"] = (act.nonzero()[:, 0], None, True)
    return out


def keys_case(libs, label, scene, meta, size, max_len, bounces, card):
    dev = scene.device
    c, _, _ = cs.shade_carry(scene, meta, *size, max_len, bounces, dev)
    bvh = scene.bvh
    org, d, act = c["org"], c["d"], c["active"]
    for form, (lanes, flags, by_lane) in keys_forms(act).items():
        fn = partial(dp.keys_cuda, org, d, flags, bvh.bounds, bvh.center,
                     lanes, by_lane)
        got = {}
        for which in ("earlier", "redesigned"):
            dp._lib = libs[which]
            got[which] = fn()
        bad = cs.bit_mismatches(got["earlier"], got["redesigned"])
        if bad:
            raise AssertionError(f"[ab] dispatch_keys {label}, {form}: "
                                 f"{bad} keys differ")
        earlier, new = turns(dp, libs, fn)
        m = org.shape[0] if lanes is None else lanes.shape[0]
        nbytes = m * (24 + 4 + (flags is not None) + 8 * (lanes is not None))
        bound_ms, by = cs.shade_bound(nbytes, 0)
        live = float((got["redesigned"] < 2 ** 30).double().mean())
        cs.log(f"[ab] dispatch_keys_kernel, {label}, {form}: {m} slots, "
               f"{live:.4f} active: earlier {fmt(earlier)} ms, redesigned "
               f"{fmt(new)} ms, bound {bound_ms:.5f} ms by {by} ({nbytes} "
               f"bytes); keys bit-equal [{card}]")


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", required=True,
                   help="checkout holding the earlier design")
    args = p.parse_args()
    from imbatracer_torch.scene.build import build_scene
    from imbatracer_torch.scene.generate import CARD, write_instanced_scene
    from imbatracer_torch.scene.procedural import (make_cornell_scene,
                                                   make_still_life_like)

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

    still = make_still_life_like(device=dev)
    for bounce in (0, 1, cs.LATE_BOUNCE):
        keys_case(libs[dp], f"still_life 1920x1080 bounce {bounce}", *still,
                  (1920, 1080), 8, bounce, card)
    del still
    keys_case(libs[dp], "cornell 1024x1024 bounce 1",
              *make_cornell_scene(device=dev), (1024, 1024), 10, 1, card)
    tmp = tempfile.mkdtemp(prefix="imba_ab_")
    inst = build_scene(write_instanced_scene(tmp, **CARD), quiet=True,
                       device=dev)
    keys_case(libs[dp], "instanced 1920x1080 bounce 1", *inst, (1920, 1080),
              8, 1, card)
    shutil.rmtree(tmp, ignore_errors=True)
    cs.log("[ab] done")


if __name__ == "__main__":
    main()
