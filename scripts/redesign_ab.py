#!/usr/bin/env python3
"""Hand-written kernels redesigned for Hopper against their earlier designs,
on one card in one process, this tree's sources as the redesigns: the
VCM light band's start (vcm_light_start_kernel, csrc/vcm_shade.cu) and
the photon grid's keys (grid_keys_kernel, csrc/grid_build.cu, from the
position column that the selection's gather now writes,
select_gather_kernel in csrc/select.cu) against the earlier kernels;
the light band's collect append (collect_append_kernel,
csrc/light_tail.cu) against the earlier wrapper where the earlier tree
has one (the library's prefix sum, a copy, a one-thread tail); the
selection's sort keys (select_keys_kernel) from the key columns against
the earlier kernel; the re-trace's slot gather (slot_gather_kernel,
csrc/dispatch.cu) through the same C interface; and the two bounces
whose NEE searches the environment's CDFs (pt_shade_kernel,
csrc/pt_shade.cu, and vcm_camera_shade_kernel, csrc/vcm_shade.cu, both
through csrc/shading.cuh's env_sample_dir) against an earlier tree's,
for a change of that search; and the merge's query preparation
(merge_sort_key_kernel, merge_inverse_kernel, merge_query_rows_kernel in
csrc/merge_kernel.cu) against the earlier tree's sort keys and sorted
rows.

The earlier designs are another checkout's sources (--root, for example
the parent commit unpacked under the git-ignored out/), built with this
tree's nvcc flags into build/imbatracer_torch/ and called through their
own C interfaces (the append behind its wrapper's torch.cumsum; the
earlier gather without the position column, the earlier keys from the
packed rows); a library with this tree's interface is launched through
this tree's wrappers.  Each design is timed as chip_smoke.graph_ms (10
calls captured in one CUDA graph, after a warm-up), earlier,
redesigned, redesigned, earlier.

Cells: `light_start` the light band's start on the four bands of a
1920x1080 still-life vcm frame with 2^20 light paths (the first of its
area light alone, two straddling two lights, the last of its
environment alone; path start and end as pointers, as the graphed band
passes them), phase 4c's padded middle band, a band of half the lanes,
and the delta-light cornell's middle band (point, spot and directional
lights); each design's columns held against the plain version at phase
4b's gates and against each other bit for bit.  `grid` the selection's
gather and the grid's keys on phase 4f's collect cache (the frame's
selection to its working capacity), each design's rows, box, keys and
scalars (and the redesign's position column) bit-equal to the plain
versions, timed as a pair and alone; beside them a third design built
from scripts/ab_grid_last_block.cu, the scalars computed once by the
gather's last block and read by the keys, held and timed the same way.
`append` the append on phase 4e's still-life band (8 x 262,144 staged
rows of the middle light band) into an empty cache of the frame's
capacity, and on seeded bands of the same
size with 0, 31 and 100% of the rows valid; `keys` the sort keys on
phase 4f's collect cache (the admission keys of the collected rows, the
canonical keys of the kept rows through the first sort's order; 32-bit,
the frame's width, and 64-bit), the redesign from the key columns and
from the rows; `gather` the slot gather on phase 4e's seeded need masks
at both slot shares and on the still life's bounce-1 re-trace; `nee`
pt_shade_kernel on the middle band of PT bounce 1 of the still life and
of the instanced scene, and vcm_camera_shade_kernel on phase 4c's
still-life camera bounces 0 and 3, each line with the share of the lanes
whose NEE picks the environment; `prep` the merge's query preparation on
the camera bounce-1 queries of the middle band of a 1920x1080 vcm frame
with 2^20 light paths of the still life and of the instanced scene, and
on seeded queries spread over the still life's grid: the earlier design
(its sort keys, the library's sort, its rows in sorted order), this
tree's (keys, sort, inverse, rows in query order) and the sorted-order
staged rows of scripts/ab_prep_designs.cu, each step and the whole
timed (and each design's kernels traced after an L2 flush), and this
tree's keys and inverse at other widths (KEY_WIDTHS, INVERSE_WIDTHS),
traced with their inputs L2-warm and after a flush, beside a library
read of the same inputs and an empty kernel of the port's grid.  Every
design's outputs must equal the plain version's bit for bit (the light
start's: phase 4b's gates, and the two designs' bit for bit; the NEE
cells': the two designs' bit for bit, phase 4b's and 4c's gates holding
the plain versions).

Each `[ab]` line names the card and its power limit, with the bound of
the bytes the function moves (chip_smoke.py's count) and each build's
registers, spills and resident blocks.  Run from the repository root
(`--only light_start grid` and so on: those cells alone):

    python3 scripts/redesign_ab.py --root out/earlier [--only CELLS]
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
from imbatracer_torch.ops import light_tail as lt  # noqa: E402
from imbatracer_torch.ops import merge as mg  # noqa: E402
from imbatracer_torch.ops import select as sel  # noqa: E402
from imbatracer_torch.ops import shade as sh  # noqa: E402
from imbatracer_torch.ops import stream_traverse as st  # noqa: E402
from imbatracer_torch.ops import vcm_shade as vs  # noqa: E402
from imbatracer_torch.render import traverse as tt  # noqa: E402
from imbatracer_torch.render.light_cache import CollectCache  # noqa: E402

vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# The earlier entry points' argument types, where this tree's differ.
EARLIER_ARGS = {"imba_collect_append": [vp] * 5 + [i32, i64, vp, vp],
                "imba_select_keys": [vp, vp, i64, i32, i32, i32, vp, vp]}
# The earlier gather's, without the position column.
EARLIER_GATHER_ARGS = [vp, vp, vp, i64, i64, vp, vp, vp]
# The earlier append's one-thread tail, which names its interface.
EARLIER_TAIL = "collect_tail_kernel"
# This tree's gather, which names its interface.
POS_GATHER = "void* pos, void* stream"
CELLS = ("light_start", "grid", "append", "keys", "gather", "nee", "prep")
# The earlier libraries of LIBS each cell runs (prep builds its own).
CELL_LIBS = {"light_start": ("vcm_shade",), "grid": ("select", "grid_build"),
             "append": ("light_tail",), "keys": ("select",),
             "gather": ("dispatch",), "nee": ("pt_shade", "vcm_shade"),
             "prep": ()}
# Each earlier library: (module, its NativeLib's attribute, its cached
# library's attribute, its binding function's name).
LIBS = {"light_tail": (lt, "LIB", "_lib", "_library"),
        "select": (sel, "LIB", "_lib", "_library"),
        "dispatch": (dp, "LIB", "_lib", "_library"),
        "vcm_shade": (vs, "LIB", "_lib", "_library"),
        "pt_shade": (sh, "LIB", "_lib", "_library"),
        "grid_build": (mg, "GRID_LIB", "_grid_lib", "_grid_library")}


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


def load(key, path, args):
    """The library at `path`, bound by its module's binding function and
    then with the argument types `args` ({entry point: types}) where it
    has those entry points."""
    mod, lib_attr, cache_attr, bind = LIBS[key]
    keep = getattr(mod, lib_attr), getattr(mod, cache_attr)
    setattr(mod, lib_attr, _Built(path))
    setattr(mod, cache_attr, None)
    try:
        lib = getattr(mod, bind)()
    finally:
        setattr(mod, lib_attr, keep[0])
        setattr(mod, cache_attr, keep[1])
    for name, types in args.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = ctypes.c_int, types
    return lib


def this_library(key):
    """This tree's library of LIBS[key], built and bound."""
    mod, _, _, bind = LIBS[key]
    return getattr(mod, bind)()


def earlier_builds(root, keys):
    """({LIBS key: (library, ptxas log)} of the earlier sources of `keys`,
    built in parallel; whether the append and keys have this tree's C
    interfaces; whether the gather has).  A library that fails to build
    is left out (its log printed)."""
    os.makedirs(libbuild.BUILD_DIR, exist_ok=True)
    inc = os.path.join(os.path.abspath(root), "imbatracer_torch", "csrc")
    src = {}
    for key, (mod, lib_attr, _, _) in LIBS.items():
        with open(os.path.join(inc, getattr(mod, lib_attr).source)) as fh:
            src[key] = fh.read()
    same = EARLIER_TAIL not in src["light_tail"]
    same_gather = POS_GATHER in src["select"]
    procs = {}
    for key in keys:
        mod, lib_attr, _, _ = LIBS[key]
        name = getattr(mod, lib_attr).name
        so = os.path.join(libbuild.BUILD_DIR, f"lib{name}_earlier.so")
        procs[key] = (so, build(os.path.join(inc, getattr(
            mod, lib_attr).source), so, inc))
    out = {}
    for key, (so, p) in procs.items():
        err = p.communicate()[1]
        if p.returncode != 0:
            cs.log(f"[ab] building the earlier {key} failed:\n{err}")
            continue
        args = {} if same or key == "dispatch" else dict(EARLIER_ARGS)
        if key == "select" and not same_gather:
            args["imba_select_gather"] = EARLIER_GATHER_ARGS
        out[key] = (load(key, so, args), err)
    return out, same, same_gather


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


def with_lib(key, lib, fn, *args, **kw):
    """fn(*args, **kw) with `lib` as the library of LIBS[key]."""
    mod, _, cache_attr, _ = LIBS[key]
    keep = getattr(mod, cache_attr)
    setattr(mod, cache_attr, lib)
    try:
        return fn(*args, **kw)
    finally:
        setattr(mod, cache_attr, keep)


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
    old = (partial(with_lib, "light_tail", libs["earlier"], new) if same
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
    old = (partial(with_lib, "select", libs["earlier"], sel.select_keys_cuda,
                   rec, n, order, mode, bits) if same
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
    fns = {which: partial(with_lib, "dispatch", lib, dp.slot_gather_cuda,
                          need, slots, hit, tcur)
           for which, lib in libs.items()}
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
    new_log = {key: libbuild.BUILD_INFO.get(getattr(m, a).name, {}).get(
        "log", "") for key, (m, a, _, _) in LIBS.items()}
    for kernel, key in (("vcm_light_start_kernel", "vcm_shade"),
                        ("select_gather_kernel", "select"),
                        ("grid_keys_kernel", "grid_build"),
                        ("collect_append_kernel", "light_tail"),
                        (EARLIER_TAIL, "light_tail"),
                        ("select_keys_kernel", "select"),
                        ("slot_gather_kernel", "dispatch"),
                        ("pt_shade_kernel", "pt_shade"),
                        ("vcm_camera_shade_kernel", "vcm_shade")):
        if (same and kernel == EARLIER_TAIL) or key not in built:
            continue
        cs.log(f"[ab] {kernel} ptxas: earlier {ptxas(built[key][1], kernel)};"
               f" redesigned {ptxas(new_log[key], kernel)} [{card}]")
    res = {"vcm_light_start_kernel": ("vcm_shade", "imba_vcm_resources",
                                      vs.RESOURCE_KERNELS.index(
                                          "light_start"),
                                      lambda: vs.resources("light_start")),
           "select_gather_kernel": ("select", "imba_select_resources", 2,
                                    lambda: sel.resources("gather")),
           "grid_keys_kernel": ("grid_build", "imba_grid_resources", 0,
                                lambda: mg.grid_resources("keys")),
           "collect_append_kernel": ("light_tail",
                                     "imba_light_tail_resources", 0,
                                     lambda: lt.resources("collect_append")),
           "select_keys_kernel<false>": ("select", "imba_select_resources", 0,
                                         lambda: sel.resources("keys32")),
           "slot_gather_kernel": ("dispatch", "imba_dispatch_resources",
                                  dp.KERNELS.index("slot_gather"),
                                  lambda: dp.resources("slot_gather")),
           "pt_shade_kernel": ("pt_shade", "imba_pt_shade_resources", 0,
                               sh.resources),
           "vcm_camera_shade_kernel": ("vcm_shade", "imba_vcm_resources",
                                       vs.RESOURCE_KERNELS.index(
                                           "camera_shade"),
                                       lambda: vs.resources("camera_shade"))}
    for kernel, (key, entry, which, new) in res.items():
        if key not in built:
            continue
        cs.log_resources(f"earlier {kernel}", st._resources(
            getattr(built[key][0], entry), which), card)
        cs.log_resources(f"redesigned {kernel}", new(), card)


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
    cs.build_libraries()
    new = {key: this_library(key) for key in LIBS}
    built, same, same_gather = earlier_builds(args.root, sorted(
        {key for cell in args.only for key in CELL_LIBS[cell]}))
    log_builds(built, same, card)
    libs = {k: {"earlier": built[k][0], "redesigned": new[k]}
            for k in new if k in built}

    scene, meta = make_still_life_like(device=dev)
    cam, fi, lpc, cap = cs.vcm_frame_inputs(scene, meta, 1920, 1080, 8, dev)
    for cell, key in (("light_start", "vcm_shade"), ("grid", "select"),
                      ("grid", "grid_build"), ("append", "light_tail"),
                      ("keys", "select"), ("gather", "dispatch"),
                      ("nee", "pt_shade"), ("nee", "vcm_shade")):
        if cell in args.only and key not in libs:
            cs.log(f"[ab] {cell}: no earlier {key} library; not run")
            args.only = [c for c in args.only if c != cell]
    if "light_start" in args.only:
        start_cells(libs["vcm_shade"], scene, meta, fi, lpc, dev, card)
    if "grid" in args.only:
        grid_cells(libs, same_gather, scene, meta, cam, fi, lpc, cap, card)
    if "append" in args.only:
        append_cells(libs, same, scene, meta, cam, fi, lpc, card)
    if "keys" in args.only:
        keys_cells(libs, same, scene, meta, cam, fi, lpc, cap, card)
    if "gather" in args.only:
        gather_cells(libs, scene, meta, card)
    if "nee" in args.only:
        nee_cells(libs, scene, meta, cam, fi, lpc, cap, dev, card)
    if "prep" in args.only:
        prep_cells(args.root, scene, meta, dev, card)
    cs.log("[ab] done")


# The instanced frame's light paths (its renderer's default: one band).
INST_LPC = 1 << 17


def instanced_scene(dev):
    """The instanced scene (scene/generate.CARD) on `dev`: (scene, meta)."""
    from imbatracer_torch.scene.build import build_scene
    from imbatracer_torch.scene.generate import CARD, write_instanced_scene

    tmp = tempfile.mkdtemp(prefix="imba_ab_")
    try:
        return build_scene(write_instanced_scene(tmp, **CARD), quiet=True,
                           device=dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def start_call(scene, fi, lanes, lpc, start, end):
    """vcm_light_start_kernel's launch as light_start_cuda makes it (the
    path start and end as pointers)."""
    dev = scene.lights.rec.device
    out = vs._empty_carry(vs.LIGHT_CARRY, lanes, dev)
    ptrs = {"o_" + k: v for k, v in out.items()}
    ptrs.update(frame=vs._scalar(fi.frame, torch.int64, dev, "frame"),
                mis_eta_vc=vs._scalar(fi.mis_eta_vc, torch.float32, dev,
                                      "mis_eta_vc"),
                path_start=start, path_end=end)
    vs._launch("light_start", scene, lanes, ptrs, dict(lpc=lpc), {}, dev)
    return out


def start_case(libs, label, scene, fi, lpc, first, lanes, valid, card):
    """An `[ab]` line of the light band's start on `lanes` paths from
    `first` (those from first + valid on padding): this tree's kernel
    held against the plain version at phase 4b's gates and the earlier
    kernel bit-equal to it, then the two timed in turns."""
    dev = scene.lights.rec.device
    start = torch.tensor(first, dtype=torch.int32, device=dev)
    end = start + valid
    want = vs.light_start_plain(scene, fi.frame, fi.mis_eta_vc, lanes=lanes,
                                light_path_count=lpc, path_start=start,
                                path_end=end)
    num = scene.lights.kind.shape[0]
    idx = torch.clamp((want["path_id"] * num) // lpc, max=num - 1)
    kinds = sorted(set(scene.lights.kind[idx].tolist()))
    alive = float(want["active"].double().mean())
    new = partial(start_call, scene, fi, lanes, lpc, start, end)
    got = new()
    cs.hold_vcm_columns(f"light start, {label}, this tree",
                        {k: (got[k], want[k]) for k in want}, alive, {},
                        "err")
    nbytes = cs.tensor_bytes(want) + cs.distinct_rows(idx, 24)
    bound_ms, by = cs.shade_bound(nbytes,
                                  lanes * cs.VCM_LANE_OPS["light_start"])
    old = partial(with_lib, "vcm_shade", libs["earlier"], start_call, scene,
                  fi, lanes, lpc, start, end)
    o = old()
    torch.cuda.synchronize()
    bad = {k: cs.bit_mismatches(o[k], got[k]) for k in got}
    if any(bad.values()):
        raise AssertionError(f"[ab] light start {label}: the earlier kernel "
                             f"is not bit-equal to this tree's: {bad}")
    ms = {"earlier": [], "this": []}
    for which in ("earlier", "this", "this", "earlier"):
        ms[which].append(cs.graph_ms(old if which == "earlier" else new))
    cs.log(f"[ab] vcm_light_start_kernel, {label}: {lanes} lanes, "
           f"{alive:.4f} active, light kinds {kinds}: earlier "
           f"{fmt(ms['earlier'])} ms, this tree {fmt(ms['this'])} ms; bound "
           f"{bound_ms:.4f} ms by {by} ({nbytes} bytes); bit-equal [{card}]")


def start_cells(libs, scene, meta, fi, lpc, dev, card):
    n = cs.NUM_RAYS
    for b in range(lpc // n):
        start_case(libs, f"still_life 1920x1080, band {b} of {lpc // n}",
                   scene, fi, lpc, b * n, n, n, card)
    mid = (lpc - n) // 2
    start_case(libs, "still_life 1920x1080, phase 4c's padded middle band",
               scene, fi, lpc, mid, n, n - 1000, card)
    start_case(libs, "still_life 1920x1080, half a band", scene, fi, lpc,
               mid, n // 2, n // 2, card)
    delta = cs.delta_light_cornell(dev)
    _, fi_c, lpc_c, _ = cs.vcm_frame_inputs(*delta, 1024, 1024, 8, dev)
    start_case(libs, "cornell with point, spot and dir lights 1024x1024, "
               "middle band", delta[0], fi_c, lpc_c, (lpc_c - n) // 2, n, n,
               card)
    inst, inst_meta = instanced_scene(dev)
    _, fi_i, _, _ = cs.vcm_frame_inputs(inst, inst_meta, 1920, 1080, 8, dev)
    start_case(libs, f"instanced 1920x1080, its one band of {INST_LPC} "
               f"light paths", inst, fi_i, INST_LPC, 0, INST_LPC, INST_LPC,
               card)


def earlier_gather(lib, rec, order1, order2, rows):
    """The earlier gather: its rows and box, no position column."""
    out = torch.empty((rows, 24), dtype=torch.float32, device=rec.device)
    box = torch.empty((6,), dtype=torch.int32, device=rec.device)
    _ok(lib.imba_select_gather(
        rec.data_ptr(), None if order1 is None else order1.data_ptr(),
        order2.data_ptr(), order2.shape[0], rows, out.data_ptr(),
        box.data_ptr(), _stream()), "gather")
    return out, box


def earlier_grid_keys(lib, rows_rec, count, box, radius):
    """The earlier grid keys, from the packed rows: key and the (5,)
    scalars."""
    rows = rows_rec.shape[0]
    key = torch.empty((rows,), dtype=torch.int32, device=rows_rec.device)
    scal = torch.empty((5,), dtype=torch.float32, device=rows_rec.device)
    _ok(lib.imba_grid_keys(rows_rec.data_ptr(), count.data_ptr(),
                           box.data_ptr(), radius.data_ptr(), rows,
                           key.data_ptr(), scal.data_ptr(), _stream()),
        "grid keys")
    return key, scal


# The last-block design's entry points and argument types.
LAST_BLOCK_SRC = os.path.join(HERE, "scripts", "ab_grid_last_block.cu")
LAST_BLOCK_ARGS = {"imba_ab_gather_last_block": [vp] * 3 + [i64] * 2
                   + [vp] * 8,
                   "imba_ab_keys_from_scalars": [vp, vp, vp, i64, vp, vp]}


def last_block_library():
    """The last-block design (scripts/ab_grid_last_block.cu), built with
    this tree's flags and bound; None (its log printed) if it fails."""
    so = os.path.join(libbuild.BUILD_DIR, "libab_grid_last_block.so")
    proc = build(LAST_BLOCK_SRC, so, libbuild.CSRC)
    err = proc.communicate()[1]
    if proc.returncode != 0:
        cs.log(f"[ab] building {LAST_BLOCK_SRC} failed:\n{err}")
        return None
    lib = ctypes.CDLL(so)
    for name, types in LAST_BLOCK_ARGS.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_int, types
    return lib


def last_block_gather(lib, rec, order1, order2, rows, count, radius, ticket):
    """The last-block gather: (rows, box, position column, scalars)."""
    dev = rec.device
    out = torch.empty((rows, 24), dtype=torch.float32, device=dev)
    box = torch.empty((6,), dtype=torch.int32, device=dev)
    pos = torch.empty((rows, 4), dtype=torch.float32, device=dev)
    scal = torch.empty((5,), dtype=torch.float32, device=dev)
    _ok(lib.imba_ab_gather_last_block(
        rec.data_ptr(), None if order1 is None else order1.data_ptr(),
        order2.data_ptr(), order2.shape[0], rows, out.data_ptr(),
        box.data_ptr(), pos.data_ptr(), count.data_ptr(), radius.data_ptr(),
        scal.data_ptr(), ticket.data_ptr(), _stream()), "last-block gather")
    return out, box, pos, scal


def last_block_keys(lib, g, count):
    """The last-block keys from its gather's column and scalars."""
    pos, scal = g[2], g[3]
    key = torch.empty((pos.shape[0],), dtype=torch.int32, device=pos.device)
    _ok(lib.imba_ab_keys_from_scalars(pos.data_ptr(), count.data_ptr(),
                                      scal.data_ptr(), pos.shape[0],
                                      key.data_ptr(), _stream()),
        "last-block keys")
    return key


def grid_cells(libs, same_gather, scene, meta, cam, fi, lpc, cap, card):
    """`[ab]` lines of the selection's gather and the grid's keys on the
    still life's collect cache, the frame's selection to its working
    capacity: each design's outputs bit-equal to the plain versions', then
    the pair and each kernel timed in turns."""
    from imbatracer_torch.render.integrators import vcm

    collect, count = cs.vcm_collect(scene, meta, cam, fi, lpc, 8)
    c = collect.cache()
    bounds = vcm.key_bounds(lpc, 8)
    b1 = sel.key_bits(bounds["lengths"], bounds["paths"])
    b2 = sel.key_bits(bounds["paths"], bounds["lengths"])
    k1 = sel.select_keys_cuda(c.keys, count, None, sel.SHALLOW, b1)
    order1 = torch.sort(k1, stable=True)[1][:cap]
    kept = min(count, cap)
    k2 = sel.select_keys_cuda(c.keys, kept, order1, sel.CANONICAL, b2)
    order2 = torch.sort(k2, stable=True)[1]
    rec, rows = c.rec, cap
    radius = torch.as_tensor(fi.pm_radius, dtype=torch.float32,
                             device=rec.device).reshape(())
    n = torch.tensor(kept, dtype=torch.int32, device=rec.device)
    elib, glib = libs["select"]["earlier"], libs["grid_build"]["earlier"]
    if same_gather:
        old_gather = partial(with_lib, "select", elib, sel.select_gather_cuda,
                             rec, order1, order2, rows)
        old_keys = lambda g: with_lib("grid_build", glib, mg.grid_keys_cuda,
                                      g[2], n, g[1], radius)
    else:
        old_gather = partial(earlier_gather, elib, rec, order1, order2, rows)
        old_keys = lambda g: earlier_grid_keys(glib, g[0], n, g[1], radius)
    new_gather = partial(sel.select_gather_cuda, rec, order1, order2, rows)
    new_keys = lambda g: mg.grid_keys_cuda(g[2], n, g[1], radius)
    ref, _, ref_pos = sel.select_gather_plain(rec, order1, order2, rows)
    valid = torch.arange(rows, device=rec.device) < n
    pkey, pbmin, pinv = mg.grid_keys_plain(ref[:, 0:3], valid, radius)
    want_box = sel.box_plain(ref, kept)
    want_scal = torch.cat([pbmin, pinv.reshape(1),
                           (radius * radius).reshape(1)])
    g_old, g_new = old_gather(), new_gather()
    k_old, k_new = old_keys(g_old), new_keys(g_new)
    lb = last_block_library()
    if lb is not None:
        ticket = torch.zeros((1,), dtype=torch.int32, device=rec.device)
        lb_gather = partial(last_block_gather, lb, rec, order1, order2, rows,
                            n, radius, ticket)
        lb_keys = lambda g: last_block_keys(lb, g, n)
        g_lb = lb_gather()
        k_lb = lb_keys(g_lb)
    torch.cuda.synchronize()
    bad = {"earlier rows": cs.bit_mismatches(g_old[0], ref),
           "redesigned rows": cs.bit_mismatches(g_new[0], ref),
           "redesigned position column": cs.bit_mismatches(g_new[2],
                                                           ref_pos),
           "earlier box": int(not torch.equal(sel.box_floats(g_old[1]),
                                              want_box)),
           "redesigned box": int(not torch.equal(sel.box_floats(g_new[1]),
                                                 want_box)),
           "earlier keys": cs.bit_mismatches(k_old[0], pkey),
           "redesigned keys": cs.bit_mismatches(k_new[0], pkey),
           "earlier scalars": cs.bit_mismatches(k_old[1], want_scal),
           "redesigned scalars": cs.bit_mismatches(
               torch.cat([k_new[1], k_new[2].reshape(1),
                          k_new[3].reshape(1)]), want_scal)}
    if lb is not None:
        bad.update({
            "last-block rows": cs.bit_mismatches(g_lb[0], ref),
            "last-block position column": cs.bit_mismatches(g_lb[2],
                                                            ref_pos),
            "last-block box": int(not torch.equal(sel.box_floats(g_lb[1]),
                                                  want_box)),
            "last-block keys": cs.bit_mismatches(k_lb, pkey),
            "last-block scalars": cs.bit_mismatches(g_lb[3], want_scal),
            "last-block ticket": int(ticket.item() != 0)})
    if any(bad.values()):
        raise AssertionError(f"[ab] gather and grid keys: elements not "
                             f"bit-equal to the plain versions {bad}")
    fns = {"pair": (lambda: old_keys(old_gather()),
                    lambda: new_keys(new_gather())),
           "gather": (old_gather, new_gather),
           "keys": (partial(old_keys, g_old), partial(new_keys, g_new))}
    lb_fns = None if lb is None else {
        "pair": lambda: lb_keys(lb_gather()), "gather": lb_gather,
        "keys": partial(lb_keys, g_lb)}
    i64 = 8
    gather_bytes = kept * (2 * i64 + 96) + rows * 96 + 24
    nbytes = {"pair": (gather_bytes + kept * 12 + rows * 4 + 44,
                       gather_bytes + rows * 16 + kept * 16 + rows * 4 + 44),
              "gather": (gather_bytes, gather_bytes + rows * 16),
              "keys": (kept * 12 + rows * 4 + 44, kept * 16 + rows * 4 + 44)}
    for what, (old, new) in fns.items():
        run = {"earlier": old, "redesigned": new}
        turns = ("earlier", "redesigned", "redesigned", "earlier")
        if lb_fns is not None:
            run["last block"] = lb_fns[what]
            turns = ("earlier", "redesigned", "last block", "last block",
                     "redesigned", "earlier")
        ms = {which: [] for which in run}
        for which in turns:
            ms[which].append(cs.graph_ms(run[which]))
        bounds_ms = [cs.shade_bound(b, 0)[0] for b in nbytes[what]]
        third = ("" if lb_fns is None else f", the scalars by the gather's "
                 f"last block {fmt(ms['last block'])} ms")
        cs.log(f"[ab] select_gather_kernel + grid_keys_kernel, {what}, "
               f"still_life 1920x1080, {kept} kept rows of {rows}: earlier "
               f"(keys from the rows) {fmt(ms['earlier'])} ms, redesigned "
               f"(keys from the position column, the scalars by thread 0 "
               f"of each keys block) {fmt(ms['redesigned'])} ms{third}; "
               f"bound {bounds_ms[0]:.4f} / {bounds_ms[1]:.4f} ms by bytes "
               f"({nbytes[what][0]} / {nbytes[what][1]} bytes); bit-equal "
               f"[{card}]")
    del collect, c, k1, order1, order2, ref, g_old, g_new
    torch.cuda.empty_cache()


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


def tensors(x):
    """The tensors of a kernel's outputs (dicts and tuples, nested)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in tensors(v)]
    return []


def env_share(scene, c):
    """The share of the lanes whose NEE picks the environment (the pick
    of pt_shade's and the camera bounce's light draw)."""
    from imbatracer_torch.core import rng
    from imbatracer_torch.render.lights import LIGHT_ENV

    num = scene.lights.kind.shape[0]
    _, (ul,) = rng.next_floats(c["state"], 1)
    pick = torch.clamp((ul * num).to(torch.int32), max=num - 1).long()
    return float((scene.lights.kind[pick] == LIGHT_ENV).double().mean())


def nee_case(kernel, key, libs, label, fn, c, scene, card):
    """An `[ab]` line of `fn` (a shade wrapper's call on its inputs) with
    the earlier and this tree's library of LIBS[key]: their outputs held
    bit-equal, then timed in turns."""
    old = partial(with_lib, key, libs[key]["earlier"], fn)
    got, ref = tensors(fn()), tensors(old())
    torch.cuda.synchronize()
    bad = sum(cs.bit_mismatches(a, b) for a, b in zip(got, ref))
    if bad or len(got) != len(ref):
        raise AssertionError(f"[ab] {kernel} {label}: {bad} elements of the "
                             f"earlier kernel differ from this tree's")
    ms = {"earlier": [], "this": []}
    for which in ("earlier", "this", "this", "earlier"):
        ms[which].append(cs.graph_ms(old if which == "earlier" else fn))
    alive = float(c["active"].double().mean())
    cs.log(f"[ab] {kernel}, {label}: {c['active'].shape[0]} lanes, "
           f"{alive:.4f} active, NEE on the environment "
           f"{env_share(scene, c):.4f}: earlier {fmt(ms['earlier'])} ms, "
           f"this tree {fmt(ms['this'])} ms; bit-equal [{card}]")


def nee_cells(libs, scene, meta, cam, fi, lpc, cap, dev, card):
    inst = instanced_scene(dev)
    for name, (scn, mt) in (("still_life", (scene, meta)),
                            ("instanced", inst)):
        c, hit, _ = cs.shade_carry(scn, mt, 1920, 1080, 8, 1, dev)
        fn = partial(sh.pt_shade_cuda, scn, c, hit, has_bump=mt.has_bump,
                     max_len=8)
        nee_case("pt_shade_kernel", "pt_shade", libs, f"{name} 1920x1080, "
                 f"PT bounce 1", fn, c, scn, card)
    del inst, c, hit, fn
    wfi = cs.vcm_working_cache(scene, meta, cam, fi, lpc, cap, 8)
    for bounce in (0, 3):
        c, hit, kw = cs.camera_carry(scene, meta, cam, wfi, lpc, 8, bounce, 1)
        fn = partial(vs.camera_shade_cuda, scene, c, hit, bounce, **kw)
        nee_case("vcm_camera_shade_kernel", "vcm_shade", libs,
                 f"still_life 1920x1080, camera bounce {bounce}", fn, c,
                 scene, card)


# The merge's query preparation: the earlier design's entry points (its
# rows take the sort's permutation), the sorted-order design and this
# tree's keys and inverse at other widths (scripts/ab_prep_designs.cu).
EARLIER_PREP_ARGS = {"imba_merge_sort_keys": [vp] * 4 + [i32, vp, vp],
                     "imba_merge_query_rows": [vp] * 14 + [i32, vp, vp]}
DESIGNS_SRC = os.path.join(HERE, "scripts", "ab_prep_designs.cu")
DESIGNS_ARGS = {"imba_ab_rows_sorted": [vp] * 14 + [i32, vp, vp],
                "imba_ab_sort_keys": [i32, i32] + [vp] * 4 + [i32, vp, vp],
                "imba_ab_inverse": [i32, i32, vp, i32, vp, vp],
                "imba_ab_empty": [i32, i32, vp]}
# (entries a thread, threads a block) of the keys' and the inverse's
# variants (ab_prep_designs.cu KEY_WIDTHS, INVERSE_WIDTHS); the port's
# kernels' first (csrc/merge_kernel.cu: one entry a thread, kQB and kInvB
# threads a block).
KEY_WIDTHS = ((1, 128), (1, 256), (1, 512), (1, 1024), (2, 128), (2, 256),
              (4, 64), (4, 128), (8, 64))
INVERSE_WIDTHS = ((1, 256), (1, 128), (1, 512), (1, 1024), (2, 256),
                  (4, 256))
PREP_SEED = 26
# An L2 flush before each traced call: a fill of more than the 50 MB L2.
FLUSH_BYTES = 256 << 20


def bound_lib(src, inc, so, types):
    """`src` built with this tree's flags (including from `inc`) into
    `so` and bound with `types` ({entry point: argument types}): (the
    library, its ptxas log), or (None, the log) if it fails to build."""
    proc = build(src, so, inc)
    err = proc.communicate()[1]
    if proc.returncode != 0:
        cs.log(f"[ab] building {src} failed:\n{err}")
        return None, err
    lib = ctypes.CDLL(so)
    for name, args in types.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_int, args
    return lib, err


def earlier_sort_keys(lib, pin):
    """The earlier design's sort keys."""
    q = pin["qpos"]
    key = torch.empty((q.shape[0],), dtype=torch.int32, device=q.device)
    _ok(lib.imba_merge_sort_keys(
        q.data_ptr(), pin["active"].data_ptr(), pin["bbox_min"].data_ptr(),
        pin["inv_cell"].data_ptr(), q.shape[0], key.data_ptr(), _stream()),
        "sort keys")
    return key


def earlier_prep(lib, pin):
    """The earlier preparation: its sort keys, the library's stable sort,
    its rows in sorted order through the permutation: (qrec, perm,
    keys)."""
    key = earlier_sort_keys(lib, pin)
    perm = torch.sort(key, stable=True)[1]
    return earlier_rows(lib, pin, perm), perm, key


def earlier_rows(lib, pin, perm, entry="imba_merge_query_rows"):
    """Rows in sorted order through `perm` by the earlier design's rows
    kernel (or the sorted-order design's, `entry`)."""
    q = pin["qpos"]
    qrec = torch.empty((q.shape[0], mg.QREC_W), dtype=torch.float32,
                       device=q.device)
    _ok(getattr(lib, entry)(
        perm.data_ptr(), *(pin[k].data_ptr() for k in mg.PREP_COLUMNS),
        pin["bbox_min"].data_ptr(), pin["inv_cell"].data_ptr(), q.shape[0],
        qrec.data_ptr(), _stream()), entry)
    return qrec


def width_keys(lib, width, pin):
    """This tree's sort keys at `width` (a KEY_WIDTHS entry)."""
    q = pin["qpos"]
    key = torch.empty((q.shape[0],), dtype=torch.int32, device=q.device)
    _ok(lib.imba_ab_sort_keys(
        *width, q.data_ptr(), pin["active"].data_ptr(),
        pin["bbox_min"].data_ptr(), pin["inv_cell"].data_ptr(), q.shape[0],
        key.data_ptr(), _stream()), f"sort keys at {width}")
    return key


def width_inverse(lib, width, perm):
    """This tree's inverse at `width` (an INVERSE_WIDTHS entry)."""
    inv = torch.empty(perm.shape, dtype=torch.int32, device=perm.device)
    _ok(lib.imba_ab_inverse(*width, perm.data_ptr(), perm.shape[0],
                            inv.data_ptr(), _stream()),
        f"inverse at {width}")
    return inv


def cold_traced_us(fn, name=None, reps=10, flush=True):
    """Mean device time (us) of the kernels whose name holds `name` (all
    of a call's kernels but the flush, for None) over `reps` calls of fn,
    each after an L2 flush (a fill of FLUSH_BYTES; none unless `flush`),
    captured in one CUDA graph and traced (torch.profiler) over one
    replay: a launch as a frame meets it, its inputs in DRAM."""
    from torch.profiler import ProfilerActivity, profile

    buf = torch.empty((FLUSH_BYTES // 4,), dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            if flush:
                buf.fill_(1)
            fn()
    g.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        g.replay()
        torch.cuda.synchronize()
    ns = [e.duration_ns() for e in prof.profiler.kineto_results.events()
          if e.device_type() == torch.autograd.DeviceType.CUDA
          and (name in e.name() if name else "FillFunctor" not in e.name())]
    return sum(ns) / (max(len(ns), 1) if name else reps) / 1e3


def width_cells(slib, label, pin, perm, want_key, want_inv, card):
    """`[ab]` lines of the sort keys and the inverse at each width of
    KEY_WIDTHS and INVERSE_WIDTHS: bit-equal to the plain versions, then
    timed in turns, widths down the list and back: traced with the
    inputs L2-warm and after an L2 flush (cold_traced_us), beside a
    library read of the same inputs and an empty kernel of each port
    kernel's grid."""
    runs = {("keys", w): partial(width_keys, slib, w, pin)
            for w in KEY_WIDTHS}
    runs.update({("inverse", w): partial(width_inverse, slib, w, perm)
                 for w in INVERSE_WIDTHS})
    got = {k: fn() for k, fn in runs.items()}
    torch.cuda.synchronize()
    bad = {f"{k[0]} {k[1]}": cs.bit_mismatches(
        v, want_key if k[0] == "keys" else want_inv) for k, v in got.items()}
    if any(bad.values()):
        raise AssertionError(f"[ab] merge preparation widths {label}: "
                             f"elements not bit-equal {bad}")
    kernel = {"keys": "keys_wide_kernel", "inverse": "inverse_wide_kernel"}
    warm = {k: [] for k in runs}
    cold = {k: [] for k in runs}
    for k in [*runs, *reversed(list(runs))]:
        warm[k].append(cold_traced_us(runs[k], kernel[k[0]], flush=False))
        cold[k].append(cold_traced_us(runs[k], kernel[k[0]]))
    # One read pass over the same inputs by the library, cold: a sum over
    # the positions (3 MB in, 1 MB out) and the inverse's yardstick.
    iota = torch.arange(perm.shape[0], dtype=torch.int32, device=perm.device)
    inv_lib = torch.empty_like(iota)
    floor = {"keys": ("torch.sum of the positions' rows", [cold_traced_us(
        partial(torch.sum, pin["qpos"], 1)) for _ in range(2)]),
             "inverse": ("index_copy_ of the inverse", [cold_traced_us(
                 partial(inv_lib.index_copy_, 0, perm, iota))
                 for _ in range(2)])}
    # The floor of the port's grids: an empty kernel of the same shape.
    n = perm.shape[0]
    for what, block in (("keys", 128), ("inverse", 256)):
        blocks = -(-n // block)
        empty = lambda: _ok(slib.imba_ab_empty(blocks, block, _stream()),
                            "empty kernel")
        floor[what] += ([cold_traced_us(empty, "empty_kernel", flush=False)
                         for _ in range(2)], blocks, block)
    us = lambda v: " / ".join(f"{x:.2f}" for x in v)
    for what in ("keys", "inverse"):
        parts = "; ".join(
            f"{w[0]} a thread x {w[1]}: {us(warm[kind, w])} us warm, "
            f"{us(cold[kind, w])} us cold"
            for kind, w in runs if kind == what)
        lib_name, lib_us, empty_us, blocks, block = floor[what]
        cs.log(f"[ab] merge preparation, {label}: {what} (entries a thread "
               f"x threads a block; the port's first): {parts}; bit-equal; "
               f"the library's {lib_name} "
               + " / ".join(f"{x:.2f}" for x in lib_us) + " us cold; an "
               f"empty kernel of {blocks} x {block} threads "
               + " / ".join(f"{x:.2f}" for x in empty_us) + f" us [{card}]")


def recorded_queries(scene, meta, dev):
    """(grid, prepare_queries' arguments) of the camera bounce-1 merge of
    the middle band of a 1920x1080 vcm frame with 2^20 light paths, the
    working cache and grid as the frame builds them."""
    cam, fi, lpc, cap = cs.vcm_frame_inputs(scene, meta, 1920, 1080, 8, dev)
    wfi = cs.vcm_working_cache(scene, meta, cam, fi, lpc, cap, 8)
    c, hit, kw = cs.camera_carry(scene, meta, cam, wfi, lpc, 8, 1, 1)
    q = vs.camera_shade_cuda(scene, c, hit, 1, **kw)[2]
    return wfi.grid, (q.pos, q.normal, q.gn, q.w_out, q.params, q.d_vcm,
                      q.d_vm, q.active)


def seeded_queries(grid, num_q, dev):
    """prepare_queries' arguments of `num_q` seeded queries spread over
    the grid's 256^3 cells (PREP_SEED), 85% active."""
    rs = np.random.RandomState(PREP_SEED)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def unit(n):
        v = rs.randn(n, 3)
        return t(v / np.linalg.norm(v, axis=1, keepdims=True))

    extent = 256.0 / float(grid.inv_cell)
    n = unit(num_q)
    params = dict(kind=torch.as_tensor(rs.choice((0, 3, 4, 5), num_q),
                                       dtype=torch.int32, device=dev),
                  kd=t(rs.rand(num_q, 3)), ks=t(rs.rand(num_q, 3)),
                  ns=t(1.0 + rs.rand(num_q) * 30.0))
    return (grid.bbox_min + t(rs.rand(num_q, 3)) * extent, n,
            torch.nn.functional.normalize(n + 0.1 * unit(num_q), dim=1),
            unit(num_q), params, t(rs.rand(num_q) * 2), t(rs.rand(num_q) * 2),
            torch.as_tensor(rs.rand(num_q) > 0.15, device=dev))


def prep_case(elib, slib, label, grid, args, card):
    """An `[ab]` line of the merge's query preparation on `args`: the
    earlier design, this tree's (sort keys, sort, inverse, rows in query
    order) and the sorted-order design (this tree's keys and sort, the
    staged rows) held against prepare_queries bit for bit, then each step
    and the whole timed in turns (graph_ms)."""
    want, want_perm = mg.prepare_queries(grid, *args)
    want_key = mg.sort_keys_plain(grid, args[0], args[7])
    pin = mg.prep_inputs(grid, *args)
    e_rec, e_perm, e_key = earlier_prep(elib, pin)
    key = mg.sort_keys_cuda(pin)
    perm = torch.sort(key, stable=True)[1]
    inv = mg.inverse_cuda(perm)
    rows = mg.query_rows_cuda(pin, inv)
    got = {"earlier": (e_rec, e_perm, e_key),
           "redesigned": (rows, perm, key)}
    if slib is not None:
        got["sorted"] = (earlier_rows(slib, pin, perm, "imba_ab_rows_sorted"),
                         perm, key)
    torch.cuda.synchronize()
    bad = {which: cs.bit_mismatches(r, want)
           + cs.bit_mismatches(p, want_perm) + cs.bit_mismatches(k, want_key)
           for which, (r, p, k) in got.items()}
    want_inv = mg.inverse_plain(perm)
    bad["inverse"] = cs.bit_mismatches(inv, want_inv)
    if any(bad.values()):
        raise AssertionError(f"[ab] merge preparation {label}: elements not "
                             f"bit-equal to the plain versions {bad}")
    sort = partial(torch.sort, key, stable=True)
    fns = {"earlier": {
        "keys": partial(earlier_sort_keys, elib, pin),
        "rows": partial(earlier_rows, elib, pin, perm),
        "whole": partial(earlier_prep, elib, pin)},
        "redesigned": {
        "keys": partial(mg.sort_keys_cuda, pin), "sort": sort,
        "inverse": partial(mg.inverse_cuda, perm),
        "rows": partial(mg.query_rows_cuda, pin, inv),
        "whole": partial(mg.prepare_cuda, grid, *args)}}
    if slib is not None:
        fns["sorted"] = {
            "rows": partial(earlier_rows, slib, pin, perm,
                            "imba_ab_rows_sorted"),
            "whole": lambda: earlier_rows(
                slib, pin, torch.sort(mg.sort_keys_cuda(pin),
                                      stable=True)[1], "imba_ab_rows_sorted")}
    turns = ("earlier", "redesigned", "sorted", "sorted", "redesigned",
             "earlier")
    ms = {}
    for which in turns:
        for step, fn in fns.get(which, {}).items():
            ms.setdefault((which, step), []).append(cs.graph_ms(fn))
    num_q = want.shape[0]
    # The earlier keys moved the same 17 B a query; its rows read an
    # 8-byte permutation entry where this tree's read a 4-byte inverse one.
    bounds = {step: cs.shade_bound(num_q * nbytes, 0)[0] for step, nbytes in
              (("keys", cs.PREP_BYTES["keys"]),
               ("inverse", cs.PREP_BYTES["inverse"]),
               ("rows", cs.PREP_BYTES["rows"]),
               ("whole", cs.PREP_BYTES["prep"]))}
    live = float(args[7].double().mean())
    for which in fns:
        parts = ", ".join(f"{step} {fmt(ms[which, step])}"
                          for step in ("keys", "sort", "inverse", "rows",
                                       "whole") if (which, step) in ms)
        cs.log(f"[ab] merge preparation, {label}: {num_q} queries, {live:.4f}"
               f" active; {which}: {parts} ms; bounds keys "
               f"{bounds['keys']:.4f}, inverse {bounds['inverse']:.4f}, rows "
               f"{bounds['rows']:.4f}, whole {bounds['whole']:.4f} ms by "
               f"bytes; bit-equal [{card}]")
    names = {"keys": "merge_sort_key_kernel", "inverse":
             "merge_inverse_kernel", "rows": "merge_query_rows_kernel"}
    cold = {}
    for which in ("earlier", "redesigned", "sorted", "redesigned",
                  "earlier"):
        for step, fn in fns.get(which, {}).items():
            if step in names:
                name = "rows_sorted_kernel" if which == "sorted" else \
                    names[step]
                cold.setdefault((which, step), []).append(
                    cold_traced_us(fn, name))
    for which in fns:
        parts = ", ".join(
            f"{step} " + " / ".join(f"{x:.2f}" for x in cold[which, step])
            for step in names if (which, step) in cold)
        cs.log(f"[ab] merge preparation, {label}: {which}, traced after an "
               f"L2 flush: {parts} us a launch [{card}]")
    if slib is not None:
        width_cells(slib, label, pin, perm, want_key, want_inv, card)


def prep_cells(root, scene, meta, dev, card):
    """`[ab]` lines of the merge's query preparation: the earlier tree's
    (its merge_kernel.cu), this tree's and the sorted-order design, and
    this tree's keys and inverse at other widths, on the still life's and
    the instanced scene's recorded camera bounce-1 queries and on seeded
    queries over the still life's grid."""
    inc = os.path.join(os.path.abspath(root), "imbatracer_torch", "csrc")
    os.makedirs(libbuild.BUILD_DIR, exist_ok=True)
    elib, elog = bound_lib(os.path.join(inc, mg.LIB.source), inc, os.path.join(
        libbuild.BUILD_DIR, "libmerge_kernel_earlier.so"), EARLIER_PREP_ARGS)
    slib, slog = bound_lib(DESIGNS_SRC, libbuild.CSRC, os.path.join(
        libbuild.BUILD_DIR, "libab_prep_designs.so"), DESIGNS_ARGS)
    if elib is None:
        cs.log("[ab] prep: the earlier merge library did not build; not run")
        return
    grid, args = recorded_queries(scene, meta, dev)
    # This tree's kernels are in the designs' build too (the same flags)
    # when this process did not build the port's library itself.
    this = libbuild.BUILD_INFO.get(mg.LIB.name, {}).get("log", "") or slog
    for which, log, kernels in (
            ("earlier", elog, ("merge_sort_key_kernel",
                               "merge_query_rows_kernel")),
            ("this tree's", this, ("merge_sort_key_kernel",
                                   "merge_inverse_kernel",
                                   "merge_query_rows_kernel")),
            ("designs'", slog, ("rows_sorted_kernel", "keys_wide_kernel",
                                "inverse_wide_kernel"))):
        for kernel in kernels:
            if kernel in log:
                cs.log(f"[ab] {which} {kernel}: {ptxas(log, kernel)}")
    prep_case(elib, slib, "still_life 1920x1080 camera bounce 1, middle band",
              grid, args, card)
    prep_case(elib, slib, f"seeded over the still life's grid "
              f"(seed {PREP_SEED})", grid,
              seeded_queries(grid, args[0].shape[0], dev), card)
    del args
    inst, inst_meta = instanced_scene(dev)
    grid, args = recorded_queries(inst, inst_meta, dev)
    prep_case(elib, slib, "instanced 1920x1080 camera bounce 1, middle band",
              grid, args, card)


if __name__ == "__main__":
    main()
