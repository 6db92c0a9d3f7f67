#!/usr/bin/env python3
"""Two kernels redesigned for Hopper against their earlier designs, on one
card in one process, this tree's sources as the redesigns: the light
band's collect append (collect_append_kernel, csrc/light_tail.cu: one
launch, its offsets from a single-pass scan, each row's key pair written
beside it) against the earlier wrapper (the library's prefix sum, a copy
a thread a 16-byte word of every staged row, a one-thread tail); and the
selection's sort keys (select_keys_kernel, csrc/select.cu) from the
collect cache's key columns against the earlier kernel, which read them
from the packed rows.  Beside them, the re-trace's slot gather
(slot_gather_kernel, csrc/dispatch.cu, whose tile look-back now comes
from csrc/lookback.cuh) against the earlier one, through the same C
interface.

The earlier designs are another checkout's sources (--root, for example
the parent commit unpacked under the git-ignored out/), built with this
tree's nvcc flags into build/imbatracer_torch/ and called through their
own C interfaces (the append behind its wrapper's torch.cumsum); a tree
with this tree's interfaces is launched through this tree's wrappers.
Each design is timed as chip_smoke.graph_ms (10 calls captured in one
CUDA graph, after a warm-up), earlier, redesigned, redesigned, earlier.

Cells: the append on phase 4e's still-life band (8 x 262,144 staged rows
of the middle light band of a 1920x1080 vcm frame with 2^20 light paths)
into an empty cache of the frame's capacity, and on seeded bands of the
same size with 0, 31 and 100% of the rows valid; the keys on phase 4f's
collect cache (the admission keys of the collected rows, the canonical
keys of the kept rows through the first sort's order; 32-bit, the
frame's width, and 64-bit), the redesign from the key columns and from
the rows; the slot gather on phase 4e's seeded need masks at both slot
shares and on the still life's bounce-1 re-trace.  Every design's
outputs must equal the plain version's bit for bit.

Each `[ab]` line names the card and its power limit, with the bound of
the bytes the function moves (chip_smoke.py's count) and each build's
registers, spills and resident blocks.  Run from the repository root
(`--only append` and so on: those cells alone):

    python3 scripts/redesign_ab.py --root out/earlier [--only CELLS]
"""

import argparse
import ctypes
import os
import subprocess
import sys
from functools import partial

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from imbatracer_torch import libbuild  # noqa: E402
from imbatracer_torch.device import card_line, get_device  # noqa: E402
from imbatracer_torch.ops import dispatch as dp  # noqa: E402
from imbatracer_torch.ops import light_tail as lt  # noqa: E402
from imbatracer_torch.ops import select as sel  # noqa: E402
from imbatracer_torch.ops import stream_traverse as st  # noqa: E402
from imbatracer_torch.render import traverse as tt  # noqa: E402
from imbatracer_torch.render.light_cache import CollectCache  # noqa: E402

vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# The earlier entry points' argument types, where this tree's differ.
EARLIER_ARGS = {"imba_collect_append": [vp] * 5 + [i32, i64, vp, vp],
                "imba_select_keys": [vp, vp, i64, i32, i32, i32, vp, vp]}
# The earlier append's one-thread tail, which names its interface.
EARLIER_TAIL = "collect_tail_kernel"
CELLS = ("append", "keys", "gather")


class _Built:
    """A NativeLib stand-in whose library is already built."""

    def __init__(self, path):
        self.path = path

    def build(self):
        return self.path


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
    """({"light_tail", "select", "dispatch": (library, ptxas log)} of the
    earlier sources, built in parallel; whether they have this tree's C
    interfaces)."""
    os.makedirs(libbuild.BUILD_DIR, exist_ok=True)
    inc = os.path.join(os.path.abspath(root), "imbatracer_torch", "csrc")
    with open(os.path.join(inc, lt.LIB.source)) as fh:
        same = EARLIER_TAIL not in fh.read()
    procs = {}
    for mod in (lt, sel, dp):
        so = os.path.join(libbuild.BUILD_DIR, f"lib{mod.LIB.name}_earlier.so")
        procs[mod.LIB.name] = (mod, so, build(
            os.path.join(inc, mod.LIB.source), so, inc))
    out = {}
    for key, (mod, so, p) in procs.items():
        err = p.communicate()[1]
        if p.returncode != 0:
            raise RuntimeError(f"building the earlier {key} failed:\n{err}")
        out[key] = (load(mod, so, same or mod is dp), err)
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


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _ok(err, what):
    if err != 0:
        raise RuntimeError(f"the earlier {what} failed: CUDA error {err}")


def earlier_append(lib, c, valid, rows):
    """The earlier append's wrapper: the library's inclusive prefix of
    the flags, then the copy and its one-thread tail."""
    incl = torch.cumsum(valid, 0, dtype=torch.int32)
    _ok(lib.imba_collect_append(
        rows.data_ptr(), valid.data_ptr(), incl.data_ptr(),
        c.count.data_ptr(), c.lost.data_ptr(), c.rec.shape[0] - 1,
        rows.shape[0], c.rec.data_ptr(), _stream()), "append")


def earlier_keys(lib, rec, n, order, mode, bits):
    """The earlier keys' wrapper: the kernel over the packed rows."""
    keys = torch.empty((n,), dtype=torch.int64 if bits is None
                       else torch.int32, device=rec.device)
    _ok(lib.imba_select_keys(
        rec.data_ptr(), None if order is None else order.data_ptr(), n, mode,
        int(bits is None), bits or 0, keys.data_ptr(), _stream()), "keys")
    return keys


def with_lib(mod, lib, fn, *args):
    """fn(*args) with `lib` as mod's library."""
    keep, mod._lib = mod._lib, lib
    try:
        return fn(*args)
    finally:
        mod._lib = keep


def append_case(libs, same, label, valid, rows, cap, card):
    """One `[ab]` line of the append of `rows` into a seeded empty cache of
    `cap` rows: each design held against the plain version bit for bit
    (rec[:cap], count and lost; the redesign's key columns too), then
    timed in turns, the count's reset taken off."""
    dev = rows.device
    gen = torch.Generator(device=dev).manual_seed(cap)
    rec0 = torch.randn((cap + 1, 24), generator=gen, device=dev)
    keys0 = torch.zeros((cap + 1, 2), dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    state = lambda: CollectCache(rec0.clone(), zero.clone(), zero.clone(),
                                 keys0.clone())
    new = lambda c: lt.collect_append_cuda(c.rec, c.count, c.lost, valid,
                                           rows, c.keys)
    old = (partial(with_lib, lt, libs["earlier"], new) if same
           else lambda c: earlier_append(libs["earlier"], c, valid, rows))
    p = state()
    lt.collect_append_plain(p.rec, p.count, p.lost, valid, rows, p.keys)
    bad = {}
    for which, fn in (("earlier", old), ("redesigned", new)):
        c = state()
        fn(c)
        torch.cuda.synchronize()
        bad[which] = (cs.bit_mismatches(c.rec[:cap], p.rec[:cap])
                      + cs.bit_mismatches(c.count, p.count)
                      + cs.bit_mismatches(c.lost, p.lost))
        if which == "redesigned" or same:
            bad[which] += cs.bit_mismatches(c.keys[:cap], p.keys[:cap])
    if any(bad.values()):
        raise AssertionError(f"[ab] collect_append {label}: elements not "
                             f"bit-equal to the plain version {bad}")
    c = state()
    reset = partial(c.count.zero_)
    reset_ms = cs.graph_ms(reset)
    ms = {"earlier": [], "redesigned": []}
    for which in ("earlier", "redesigned", "redesigned", "earlier"):
        fn = old if which == "earlier" else new
        ms[which].append(cs.graph_ms(lambda: (reset(), fn(c))) - reset_ms)
    n, fit = rows.shape[0], int(p.count)
    nbytes = n + 8 + fit * (96 * 2 + 8) + 8
    bound_ms, by = cs.shade_bound(nbytes, 0)
    cs.log(f"[ab] collect_append_kernel, {label}: {n} staged rows, {fit} "
           f"valid: earlier (library prefix, copy, tail) "
           f"{fmt(ms['earlier'])} ms, redesigned (one launch, key columns) "
           f"{fmt(ms['redesigned'])} ms; bound {bound_ms:.4f} ms by {by} "
           f"({nbytes} bytes); bit-equal [{card}]")


def keys_case(libs, same, label, rec, keys, n, order, mode, bits, card):
    """One `[ab]` line of the sort keys of n rows (through `order`): the
    earlier kernel from the rows, the redesign from the key columns and
    from the rows, each held against the plain version bit for bit, then
    timed in turns."""
    new = partial(sel.select_keys_cuda, keys, n, order, mode, bits)
    rows24 = partial(sel.select_keys_cuda, rec, n, order, mode, bits)
    old = (partial(with_lib, sel, libs["earlier"], sel.select_keys_cuda, rec,
                   n, order, mode, bits) if same
           else partial(earlier_keys, libs["earlier"], rec, n, order, mode,
                        bits))
    want = sel.select_keys_plain(rec, n, order, mode, bits)
    bad = {which: cs.bit_mismatches(fn(), want) for which, fn in
           (("earlier", old), ("columns", new), ("rows", rows24))}
    torch.cuda.synchronize()
    if any(bad.values()):
        raise AssertionError(f"[ab] select_keys {label}: elements not "
                             f"bit-equal to the plain version {bad}")
    ms = {"earlier": [], "columns": [], "rows": []}
    for which in ("earlier", "columns", "columns", "earlier", "rows"):
        fn = {"earlier": old, "columns": new, "rows": rows24}[which]
        ms[which].append(cs.graph_ms(fn))
    nk = 8 if bits is None else 4
    nbytes = n * (8 + nk) + (0 if order is None else 8 * n)
    bound_ms, by = cs.shade_bound(nbytes, 0)
    cs.log(f"[ab] select_keys_kernel, {label}: {n} rows, "
           f"{'64' if bits is None else 32}-bit keys: earlier (from the "
           f"rows) {fmt(ms['earlier'])} ms, redesigned from the key columns "
           f"{fmt(ms['columns'])} ms, from the rows {fmt(ms['rows'])} ms; "
           f"bound {bound_ms:.4f} ms by {by} ({nbytes} bytes); bit-equal "
           f"[{card}]")


def gather_case(libs, label, need, slots, hit, tcur, card):
    """One `[ab]` line of the slot gather: both designs (one C interface)
    held against the plain version bit for bit, then timed in turns."""
    want = dp.slot_gather_plain(need, slots, hit, tcur)
    fns = {which: partial(with_lib, dp, lib, dp.slot_gather_cuda, need,
                          slots, hit, tcur) for which, lib in libs.items()}
    bad = {which: cs.slot_mismatches(fn(), want) for which, fn in
           fns.items()}
    torch.cuda.synchronize()
    if any(bad.values()):
        raise AssertionError(f"[ab] slot_gather {label}: elements not "
                             f"bit-equal to the plain version {bad}")
    ms = {"earlier": [], "redesigned": []}
    for which in ("earlier", "redesigned", "redesigned", "earlier"):
        ms[which].append(cs.graph_ms(fns[which]))
    cs.log(f"[ab] slot_gather_kernel, {label}: {need.shape[0]} lanes, "
           f"{int(want.count)} in need, {slots} slots: earlier "
           f"{fmt(ms['earlier'])} ms, redesigned (the shared look-back) "
           f"{fmt(ms['redesigned'])} ms; bit-equal [{card}]")


def log_builds(built, same, card):
    """ptxas and `[res]` lines of each earlier and redesigned kernel."""
    new_log = {m.LIB.name: libbuild.BUILD_INFO.get(m.LIB.name, {}).get(
        "log", "") for m in (lt, sel, dp)}
    for kernel, key in (("collect_append_kernel", "light_tail"),
                        (EARLIER_TAIL, "light_tail"),
                        ("select_keys_kernel", "select"),
                        ("slot_gather_kernel", "dispatch")):
        if same and kernel == EARLIER_TAIL:
            continue
        cs.log(f"[ab] {kernel} ptxas: earlier {ptxas(built[key][1], kernel)};"
               f" redesigned {ptxas(new_log[key], kernel)} [{card}]")
    res = {"collect_append_kernel": (
        st._resources(built["light_tail"][0].imba_light_tail_resources, 0),
        lt.resources("collect_append")),
           "select_keys_kernel<false>": (
        st._resources(built["select"][0].imba_select_resources, 0),
        sel.resources("keys32")),
           "slot_gather_kernel": (
        st._resources(built["dispatch"][0].imba_dispatch_resources,
                      dp.KERNELS.index("slot_gather")),
        dp.resources("slot_gather"))}
    for kernel, (old, new) in res.items():
        cs.log_resources(f"earlier {kernel}", old, card)
        cs.log_resources(f"redesigned {kernel}", new, card)


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", required=True,
                   help="checkout holding the earlier designs")
    p.add_argument("--only", nargs="+", default=CELLS, choices=CELLS,
                   help="the kernels whose cells run")
    args = p.parse_args()
    from imbatracer_torch.scene.procedural import make_still_life_like

    dev = get_device("cuda")
    card = card_line(dev)
    new = {m.LIB.name: m._library() for m in (lt, sel, dp)}
    built, same = earlier_builds(args.root)
    log_builds(built, same, card)
    libs = {k: {"earlier": built[k][0], "redesigned": new[k]} for k in new}

    scene, meta = make_still_life_like(device=dev)
    cam, fi, lpc, cap = cs.vcm_frame_inputs(scene, meta, 1920, 1080, 8, dev)
    if "append" in args.only:
        append_cells(libs, same, scene, meta, cam, fi, lpc, card)
    if "keys" in args.only:
        keys_cells(libs, same, scene, meta, cam, fi, lpc, cap, card)
    if "gather" in args.only:
        gather_cells(libs, scene, meta, card)
    cs.log("[ab] done")


def append_cells(libs, same, scene, meta, cam, fi, lpc, card):
    dev = scene.device
    valid, rows, _, _ = cs.light_band_tail(scene, meta, cam, fi, lpc, 8)
    append_case(libs["light_tail"], same, "still_life 1920x1080 band of "
                f"{cs.NUM_RAYS} of {lpc} light paths, empty cache",
                valid, rows, lpc * 8, card)
    n = rows.shape[0]
    for share in (0.0, 0.31, 1.0):
        rs = np.random.RandomState(int(share * 100))
        v = torch.from_numpy(rs.rand(n) < share).to(dev)
        append_case(libs["light_tail"], same, f"seeded, {share:.0%} of the "
                    f"rows valid", v, rows, lpc * 8, card)
    del valid, rows, v


def keys_cells(libs, same, scene, meta, cam, fi, lpc, cap, card):
    from imbatracer_torch.render.integrators import vcm

    collect, count = cs.vcm_collect(scene, meta, cam, fi, lpc, 8)
    c = collect.cache()
    bounds = vcm.key_bounds(lpc, 8)
    b1 = sel.key_bits(bounds["lengths"], bounds["paths"])
    b2 = sel.key_bits(bounds["paths"], bounds["lengths"])
    label = f"still_life 1920x1080, {count} collected rows"
    for bits in (b1, None):
        keys_case(libs["select"], same, f"{label}, admission keys", c.rec,
                  c.keys, count, None, sel.SHALLOW, bits, card)
    k1 = sel.select_keys_cuda(c.keys, count, None, sel.SHALLOW, b1)
    order1 = torch.sort(k1, stable=True)[1][:cap]
    kept = min(count, cap)
    for bits in (b2, None):
        keys_case(libs["select"], same, f"{label}, canonical keys of the "
                  f"{kept} kept rows", c.rec, c.keys, kept, order1,
                  sel.CANONICAL, bits, card)
    del collect, c, k1, order1
    torch.cuda.empty_cache()


def gather_cells(libs, scene, meta, card):
    dev = scene.device
    for density, two_level, seed in ((0.0, False, 2), (0.01, False, 3),
                                     (0.2, True, 4), (0.3, True, 5)):
        slots = tt.retrace_slots(cs.NUM_RAYS, two_level)
        _, need, hit, tcur = cs.random_slots_case(
            cs.NUM_RAYS, density, slots, seed, dev, not two_level)
        gather_case(libs["dispatch"], f"seeded need {density} of the lanes, "
                    f"{'two-level' if two_level else 'flat'} share", need,
                    slots, hit, tcur, card)
    carry, _, alpha_fn = cs.shade_carry(scene, meta, 1920, 1080, 8, 1, dev)
    need, slots, hit, tcur = cs.recorded_slots(scene, carry, alpha_fn)
    gather_case(libs["dispatch"], "still_life 1920x1080 bounce 1, the khit "
                "re-trace's", need, slots, hit, tcur, card)


if __name__ == "__main__":
    main()
