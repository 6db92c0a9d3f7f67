#!/usr/bin/env python3
"""Two kernels redesigned for Hopper against their earlier designs, on one
card in one process, this tree's sources as the redesigns: the masked
re-trace's finish (slot_finish_kernel, csrc/dispatch.cu, which merges the
slots' hits in its own launch) against the earlier finish followed by the
earlier slot_merge_kernel; and the PT bounce's NEE add
(pt_shade_finish_kernel, csrc/pt_shade.cu: a grid over the SMs, 16-byte
words, one count atomic a block, no copy of the count) against the
earlier kernel behind its wrapper's copy of the count.

The earlier designs are another checkout's sources (--root, for example
the parent commit unpacked under the git-ignored out/), built with this
tree's nvcc flags into build/imbatracer_torch/ and called through their
own C interfaces: the earlier finish and merge by this tree's
slot_finish_cuda through a stand-in library that hands the merge's
arguments on to the earlier merge kernel, the earlier NEE add by a copy
of its wrapper (the count cloned, then added to on the card).  A third
build, of the earlier NEE add with its count taken out (the warps'
same-address atomicAdd dropped from the source before the build), is a
measurement only: what the atomics cost.  An earlier tree with this
tree's C interfaces (a design set aside, say) is launched through this
tree's wrappers instead, with no variant.  Each design is timed as
chip_smoke.graph_ms (10 calls captured in one CUDA graph, after a
warm-up), earlier, redesigned, redesigned, earlier, the variant twice
after them, with the count's copy alone beside them.

Cells: the NEE add on phase 4b's bands (the still life at 1920x1080 at
bounces 0, 3 and 6, the cornell at 1024^2 after bounce 1, the instanced
scene at 1920x1080 after bounce 1) and on seeded full and ragged bands;
the finish on the slots that the graph-ready re-trace gathers from the
still life's and the instanced scene's bounce-1 rays and on phase 4e's
seeded need masks at both slot shares, with phase 4e's seeded finish
inputs (chip_smoke.finish_case).  Every design's outputs must equal the
plain version's bit for bit (the variant's radiance only).

Each `[ab]` line names the card and its power limit, with the bound of
the bytes the function moves (chip_smoke.py's count) and each build's
registers, local bytes and resident blocks.  Run from the repository
root:

    python3 scripts/redesign_ab.py --root out/earlier
"""

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
import tempfile
from functools import partial

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from imbatracer_torch import libbuild  # noqa: E402
from imbatracer_torch.device import card_line, get_device  # noqa: E402
from imbatracer_torch.ops import dispatch as dp  # noqa: E402
from imbatracer_torch.ops import shade as sh  # noqa: E402
from imbatracer_torch.ops import stream_traverse as st  # noqa: E402
from imbatracer_torch.render import traverse as tt  # noqa: E402

vp, i32 = ctypes.c_void_p, ctypes.c_int
# The earlier entry points' argument types, where this tree's differ.
EARLIER_ARGS = {"imba_slot_finish": [vp, ctypes.c_int64, vp, i32] + [vp] * 7,
                "imba_slot_merge": [vp, vp, i32, vp, vp, vp],
                "imba_pt_shade_finish": [vp] * 6 + [i32, vp]}
# The earlier NEE add's count, taken out of the variant's source.
COUNT_LINE = "  count_warp(cast, count);\n"
# imba_dispatch_resources' index of a kernel: (earlier, redesigned).
DISPATCH_INDEX = {"slot_merge_kernel": (5, None),
                  "slot_finish_kernel": (6, dp.KERNELS.index("slot_finish"))}


class _Built:
    """A NativeLib stand-in whose library is already built."""

    def __init__(self, path):
        self.path = path

    def build(self):
        return self.path


class EarlierDispatch:
    """The earlier dispatch library behind this tree's interface: the
    finish, which takes the merge's arguments, is the earlier finish, then
    the earlier merge, on the same stream."""

    def __init__(self, lib):
        self.lib = lib

    def imba_slot_finish(self, active, num_r, need, slots, count, dropped,
                         rounds, overflow, counts, ints, valid, idx, sub,
                         hit, stream):
        err = self.lib.imba_slot_finish(active, num_r, need, slots, count,
                                        dropped, rounds, overflow, counts,
                                        ints, stream)
        if err == 0:
            err = self.lib.imba_slot_merge(idx, valid, slots, sub, hit,
                                           stream)
        return err

    def __getattr__(self, name):
        return getattr(self.lib, name)


def build(src, so, inc):
    """A Popen of nvcc building `src` (including from `inc`) into `so`."""
    cmd = [libbuild._nvcc(), *libbuild.NVCC_FLAGS, "-I", inc, "-o", so, src]
    return subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True)


def load(mod, path, same):
    """The library at `path`, bound by mod._library() and then, unless
    `same`, with the earlier argument types of EARLIER_ARGS."""
    keep, mod.LIB, mod._lib = mod.LIB, _Built(path), None
    try:
        lib = mod._library()
    finally:
        mod.LIB, mod._lib = keep, None
    for name, args in ({} if same else EARLIER_ARGS).items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = ctypes.c_int, args
    return lib


def earlier_builds(root):
    """({"dispatch", "shade"[, "shade_no_count"]: (library, ptxas log)} of
    the earlier sources, built in parallel; whether they have this tree's
    C interfaces, and then no variant)."""
    os.makedirs(libbuild.BUILD_DIR, exist_ok=True)
    inc = os.path.join(os.path.abspath(root), "imbatracer_torch", "csrc")
    with open(os.path.join(inc, dp.LIB.source)) as fh:
        same = "imba_slot_merge" not in fh.read()
    with open(os.path.join(inc, sh.LIB.source)) as fh:
        text = fh.read()
    jobs = {"dispatch": (dp, os.path.join(inc, dp.LIB.source)),
            "shade": (sh, os.path.join(inc, sh.LIB.source))}
    if not same:
        if text.count(COUNT_LINE) != 1:
            raise RuntimeError("the earlier NEE add's count is not one "
                               f"{COUNT_LINE.strip()!r} line")
        variant = os.path.join(libbuild.BUILD_DIR, "pt_shade_no_count.cu")
        with open(variant, "w") as fh:
            fh.write(text.replace(COUNT_LINE, ""))
        jobs["shade_no_count"] = (sh, variant)
    procs = {}
    for key, (mod, src) in jobs.items():
        so = os.path.join(libbuild.BUILD_DIR, f"lib{key}_earlier.so")
        procs[key] = (mod, so, build(src, so, inc))
    out = {}
    for key, (mod, so, p) in procs.items():
        err = p.communicate()[1]
        if p.returncode != 0:
            raise RuntimeError(f"building the earlier {key} failed:\n{err}")
        out[key] = (load(mod, so, same), err)
    return out, same


def ptxas(log, kernel):
    """A build log's stack, spill and register lines of `kernel`."""
    lines = log.splitlines()
    for k, ln in enumerate(lines):
        if "Compiling entry function" in ln and kernel in ln:
            return "; ".join(x.split(":", 1)[-1].strip()
                             for x in lines[k + 1:k + 4]
                             if "stack frame" in x or "registers" in x)
    return "built before this process (its log: the build's)"


def fmt(ms):
    return " / ".join(f"{x:.4f}" for x in ms)


def earlier_finish(lib, radiance, contrib, ok, occ, n_rays):
    """The earlier NEE add's wrapper: the count cloned, then the kernel
    adds the shadow rays to the clone."""
    out, count = torch.empty_like(radiance), n_rays.clone()
    err = lib.imba_pt_shade_finish(
        radiance.data_ptr(), contrib.data_ptr(), ok.data_ptr(),
        occ.data_ptr(), out.data_ptr(), count.data_ptr(),
        radiance.shape[0], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"the earlier NEE add failed: CUDA error {err}")
    return out, count


def with_lib(mod, lib, fn, *args):
    """fn(*args) with `lib` as mod's library."""
    keep, mod._lib = mod._lib, lib
    try:
        return fn(*args)
    finally:
        mod._lib = keep


def nee_case(libs, label, args, card):
    """One `[ab]` line of the NEE add on `args` (radiance, contrib,
    shadow_ok, occluded, n_rays): each design held against the plain
    version bit for bit, then timed in turns."""
    if "shade_no_count" in libs:
        fns = {"earlier": partial(earlier_finish, libs["shade"], *args),
               "no_count": partial(earlier_finish, libs["shade_no_count"],
                                   *args)}
    else:
        fns = {"earlier": partial(with_lib, sh, libs["shade"],
                                  sh.pt_shade_finish_cuda, *args)}
    fns["redesigned"] = partial(sh.pt_shade_finish_cuda, *args)
    plain = sh.pt_shade_finish_plain(*args)
    bad = {}
    for which, fn in fns.items():
        got = fn()
        torch.cuda.synchronize()
        bad[which] = cs.bit_mismatches(got[0], plain[0]) + (
            which != "no_count" and int(got[1]) != int(plain[1]))
    if any(bad.values()):
        raise AssertionError(f"[ab] pt_shade_finish {label}: elements not "
                             f"bit-equal to the plain version {bad}")
    ms = {which: [] for which in fns}
    for which in ("earlier", "redesigned", "redesigned", "earlier",
                  "no_count", "no_count"):
        if which in fns:
            ms[which].append(cs.graph_ms(fns[which]))
    copy_ms = cs.graph_ms(partial(torch.clone, args[4]))
    lanes = args[0].shape[0]
    bound_ms, by = cs.shade_bound(lanes * cs.FINISH_LANE_BYTES, 0)
    variant = (f"the earlier with its count taken out "
               f"{fmt(ms['no_count'])} ms, " if "no_count" in ms else "")
    cs.log(f"[ab] pt_shade_finish_kernel, {label}: {lanes} lanes, "
           f"{int(args[2].sum())} shadow rays: earlier "
           f"{fmt(ms['earlier'])} ms, redesigned {fmt(ms['redesigned'])} "
           f"ms; {variant}the count's copy alone {copy_ms:.4f} ms; bound "
           f"{bound_ms:.5f} ms by {by}; bit-equal [{card}]")


def shade_args(scene, meta, size, max_len, bounce, dev):
    """Phase 4b's NEE-add inputs on a band of `scene` after `bounce`
    bounces (chip_smoke.hold_shade's)."""
    from imbatracer_torch.render.traverse import any_hit

    c, hit, alpha_fn = cs.shade_carry(scene, meta, *size, max_len, bounce,
                                      dev)
    nxt, shadow, con = sh.pt_shade_plain(scene, c, hit,
                                         has_bump=meta.has_bump,
                                         max_len=max_len)
    occ = any_hit(scene.bvh, shadow.pos, shadow.dir, shadow.tmin,
                  shadow.tmax, alpha_fn=alpha_fn, active=shadow.ok,
                  sort=True)
    return (nxt["radiance"], con, shadow.ok, occ, nxt["n_rays"])


def seeded_args(lanes, base, dev):
    """Seeded NEE-add inputs over `lanes` lanes, from an aligned base or
    one an element past it, with a carried count near 2^40."""
    rs = np.random.RandomState(lanes % 97)
    args = [torch.from_numpy(a).to(dev) for a in (
        rs.randn(lanes, 3).astype(np.float32),
        rs.rand(lanes, 3).astype(np.float32), rs.rand(lanes) < 0.5,
        rs.rand(lanes) < 0.5)]
    if base == "unaligned":
        args = [cs.unaligned(x) for x in args]
    return (*args, torch.tensor((1 << 40) - 1000, dtype=torch.int64,
                                device=dev))


def finish_case(libs, label, act, need, slots, hit, tcur, seed, card):
    """One `[ab]` line of the finish with its merge on the slots gathered
    from `need`: both designs held against the plain versions bit for bit
    (chip_smoke.finish_mismatches), then timed in turns (the parent's
    earlier design: the finish, then the merge)."""
    dp._lib = libs["redesigned"]
    k = dp.slot_gather_cuda(need, slots, hit, tcur)
    left, rounds, counts0, where, deltas = cs.finish_case(k, act, seed)
    bad = {}
    for which in ("earlier", "redesigned"):
        dp._lib = libs[which]
        bad[which] = cs.finish_mismatches(act, left, rounds, counts0, where,
                                          deltas, hit)
    torch.cuda.synchronize()
    if any(bad.values()):
        raise AssertionError(f"[ab] slot_finish {label}: elements not "
                             f"bit-equal to the plain versions {bad}")
    ck = counts0.clone()
    own = tt.Hit(*(x.clone() for x in hit))
    fn = partial(dp.slot_finish_cuda, ck[0], act, left, rounds,
                 (ck,) + where, deltas, hit=own)
    ms = {"earlier": [], "redesigned": []}
    for which in ("earlier", "redesigned", "redesigned", "earlier"):
        dp._lib = libs[which]
        ms[which].append(cs.graph_ms(fn))
    dp._lib = libs["redesigned"]
    n, nvalid = need.shape[0], int(k.valid.sum())
    nbytes = (n + 2 * slots + 12 + 24 + 8 * len(deltas)
              + nvalid * (8 + 16 + 16))
    bound_ms, by = cs.shade_bound(nbytes, 0)
    cs.log(f"[ab] slot_finish_kernel with the merge, {label}: {n} lanes, "
           f"{slots} slots, {nvalid} valid: earlier "
           f"{fmt(ms['earlier'])} ms, redesigned (one launch) "
           f"{fmt(ms['redesigned'])} ms; bound {bound_ms:.5f} ms by {by} "
           f"({nbytes} bytes); bit-equal [{card}]")


def bounce_finish(libs, label, scene, meta, size, card):
    c, _, alpha_fn = cs.shade_carry(scene, meta, *size, 8, 1, scene.device)
    need, slots, hit, tcur = cs.recorded_slots(scene, c, alpha_fn)
    finish_case(libs, label, c["active"], need, slots, hit, tcur, 1, card)


def log_builds(built, same, card):
    """ptxas and `[res]` lines of each earlier and redesigned kernel."""
    new_log = {m: libbuild.BUILD_INFO.get(m.LIB.name, {}).get("log", "")
               for m in (dp, sh)}
    for kernel, key, mod in (("slot_finish_kernel", "dispatch", dp),
                             ("slot_merge_kernel", "dispatch", dp),
                             ("pt_shade_finish_kernel", "shade", sh),
                             ("pt_shade_finish_kernel", "shade_no_count",
                              sh)):
        if key not in built or (same and kernel == "slot_merge_kernel"):
            continue
        lib, log = built[key]
        cs.log(f"[ab] {kernel} ptxas: earlier ({key}) {ptxas(log, kernel)};"
               f" redesigned {ptxas(new_log[mod], kernel)} [{card}]")
        if mod is dp:
            old, new = DISPATCH_INDEX[kernel]
            if same:
                old = new
            res = {"earlier": st._resources(lib.imba_dispatch_resources,
                                            old)}
            if new is not None:
                res["redesigned"] = dp.resources("slot_finish")
        else:
            res = {"earlier": st._resources(lib.imba_pt_shade_resources, 1),
                   "redesigned": sh.resources(True)}
        for which, r in res.items():
            cs.log_resources(f"{which} ({key}) {kernel}", r, card)


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", required=True,
                   help="checkout holding the earlier designs")
    args = p.parse_args()
    from imbatracer_torch.scene.build import build_scene
    from imbatracer_torch.scene.generate import CARD, write_instanced_scene
    from imbatracer_torch.scene.procedural import (make_cornell_scene,
                                                   make_still_life_like)

    dev = get_device("cuda")
    card = card_line(dev)
    new = {"dispatch": dp._library(), "shade": sh._library()}
    built, same = earlier_builds(args.root)
    log_builds(built, same, card)
    shade_libs = {k: lib for k, (lib, _) in built.items() if k != "dispatch"}
    earlier = built["dispatch"][0]
    slot_libs = {"earlier": earlier if same else EarlierDispatch(earlier),
                 "redesigned": new["dispatch"]}

    still = make_still_life_like(device=dev)
    for bounce in (0, 3, cs.LATE_BOUNCE):
        nee_case(shade_libs, f"still_life 1920x1080 bounce {bounce}",
                 shade_args(*still, (1920, 1080), 8, bounce, dev), card)
    nee_case(shade_libs, "cornell 1024x1024 bounce 1",
             shade_args(*make_cornell_scene(device=dev), (1024, 1024), 10, 1,
                        dev), card)
    for lanes, base in ((262144, "aligned"), (266277, "aligned"),
                        (266277, "unaligned"), (129, "aligned")):
        nee_case(shade_libs, f"seeded, {lanes} lanes from an {base} base",
                 seeded_args(lanes, base, dev), card)
    bounce_finish(slot_libs, "still_life 1920x1080 bounce 1, the khit "
                  "re-trace's", *still, (1920, 1080), card)
    for density, two_level, seed in ((0.0, False, 2), (0.01, False, 3),
                                     (0.2, True, 4), (0.3, True, 5)):
        slots = tt.retrace_slots(cs.NUM_RAYS, two_level)
        act, need, hit, tcur = cs.random_slots_case(
            cs.NUM_RAYS, density, slots, seed, dev, not two_level)
        finish_case(slot_libs, f"seeded need {density} of the lanes, "
                    f"{'two-level' if two_level else 'flat'} share", act,
                    need, slots, hit, tcur, seed, card)
    del still
    tmp = tempfile.mkdtemp(prefix="imba_ab_")
    inst = build_scene(write_instanced_scene(tmp, **CARD), quiet=True,
                       device=dev)
    nee_case(shade_libs, "instanced 1920x1080 bounce 1",
             shade_args(*inst, (1920, 1080), 8, 1, dev), card)
    bounce_finish(slot_libs, "instanced 1920x1080 bounce 1, the two-level "
                  "re-trace's", *inst, (1920, 1080), card)
    shutil.rmtree(tmp, ignore_errors=True)
    cs.log("[ab] done")


if __name__ == "__main__":
    main()
