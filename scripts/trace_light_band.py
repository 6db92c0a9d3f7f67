#!/usr/bin/env python3
"""Where a vcm frame's light-band tail and middle spend device time on a
CUDA card.

Traces (torch.profiler) of the still life at 1920x1080 with 2^20 light
paths, max_len 8, each region marked on the device by a spin kernel
where it opens and where it closes (its kernels are the device events
between the marks, the port's ctypes launches included):

* one eager light band of 262,144 paths (render/integrators/vcm.py
  `_light_pass`), regions around its collect append
  (`CollectCache.append`) and its camera splat (`vcm.splat`): each
  region's device time and kernels, by name;
* the selection of that band's collect cache (`select_shallowest`),
  which a frame runs once, outside the graphs, in a region of its own;
* one graphed vcm frame through make_frame_fn and the renderer, after a
  warm-up frame: wall and device busy time, the kernels with the most
  device time, by name, and the light tail's kernels and any index or
  cat kernels; inside it, the frame's middle as a region, from the end
  of `CollectCache.check` (the light pass's overflow read) to the end of
  `vcm.working_cache` (the camera pass's static inputs): the selection,
  the canonical order and the photon grid, eager once a frame, with
  their device time, kernels by name and launches, and the middle's
  peak memory above what the frame held when it began; then one graphed
  PT frame of the same scene (wall, busy, kernels), and one of the
  cornell box at the headline's 1024x1024 and max_len 10; every graphed
  frame also logs the device time and launches of the kernels in NAMED,
  ranks every hand-written kernel by launches x (us a launch - bound at
  the traced threads): each launch's threads (its grid and block, from
  the frame's chrome trace) times a thread's share of the bound, plus
  the bytes a launch moves whatever its threads (THREAD_BYTES,
  THREAD_US, LAUNCH_BYTES; the re-trace's valid slots a dispatch
  counted on the card in one more frame of fresh captures, after every
  trace is taken), beside the traced time of an empty kernel replayed
  in a graph; and counts the
  launches from each masked dispatch's first-round resolve to its WHILE
  node, from a pass's resolve to the node's next test, and from the
  node to the merged hit (`[loop]` lines);
* the instanced scene (scene/generate.CARD, 1920x1080, default light
  paths): one graphed vcm frame (busy, the middle, the scalar-add
  kernels `CUDAFunctorOnSelf_add` by launch shape from its chrome
  trace) and one graphed PT frame, then the adds that a fresh scene's
  captures record into its graphs, by call site, those inside a WHILE
  node's body (run once a round of the re-trace) marked, and the adds
  left a round: those recorded into the bodies over the bodies captured.

`--root DIR` imports the port from DIR (another checkout, for example a
parent commit unpacked under the git-ignored `out/`), so two trees can be
traced in one call on one card.  Run from the repository root:

    python3 scripts/trace_light_band.py [--root DIR] [--top N]
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time


def _args():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout whose port is traced")
    p.add_argument("--top", type=int, default=12,
                   help="kernels listed a trace")
    return p.parse_args()


ARGS = _args()
sys.path.insert(0, os.path.abspath(ARGS.root))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from imbatracer_torch.frontend.engine import (estimate_pixel_size,  # noqa
                                              make_frame_fn)
from imbatracer_torch.frontend.renderer import (ProgressiveRenderer,  # noqa
                                                RenderSettings,
                                                camera_for_scene)
from imbatracer_torch.render import light_cache, traverse  # noqa: E402
from imbatracer_torch.render.integrators import pt, vcm  # noqa: E402
from imbatracer_torch.scene.procedural import (make_cornell_scene,  # noqa
                                               make_still_life_like)

W, H, LPC, MAX_LEN, BAND = 1920, 1080, 1 << 20, 8, 1 << 18
CORNELL, CORNELL_LEN = 1024, 10       # the headline's frame (bench.py)
ACTS = [ProfilerActivity.CPU, ProfilerActivity.CUDA]


# Regions: a spin kernel (torch.cuda._sleep) launched where a region
# opens and where it closes marks it on the device, so that its kernels
# are the device events between the two marks, those that the port's
# ctypes wrappers launch included (the profiler ties no host op to
# them).  REGIONS names the regions in the order they opened.
MARK = "spin_kernel"
REGIONS = []
CUDA = torch.autograd.DeviceType.CUDA


def mark():
    torch.cuda._sleep(1)


def ranged(name, fn):
    def wrapped(*a, **k):
        REGIONS.append(name)
        mark()
        out = fn(*a, **k)
        mark()
        return out
    return wrapped


def device_events(prof):
    """(name, start ns, ns) of the trace's device events in time order."""
    return sorted(((e.name(), e.start_ns(), e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == CUDA), key=lambda e: e[1])


def regions(prof):
    """[(name, {kernel: [us, n]})] of the regions opened in this trace, in
    order: the device events between each pair of marks."""
    out, cur, opened = [], None, 0
    for name, _, ns in device_events(prof):
        if MARK in name:
            if cur is None:
                cur = []
            else:
                out.append((REGIONS[opened], by_name(cur)))
                opened, cur = opened + 1, None
        elif cur is not None:
            cur.append((name, ns / 1e3))
    del REGIONS[:]
    return out


def by_name(rows):
    """{name: [us, launches]} of (name, us) pairs."""
    tot = {}
    for name, us in rows:
        t = tot.setdefault(name, [0.0, 0])
        t[0] += us
        t[1] += 1
    return tot


def show(tag, tot, top):
    us = sum(v[0] for v in tot.values())
    n = sum(v[1] for v in tot.values())
    print(f"[lighttrace] {tag}: {us / 1e3:.3f} ms device over {n} kernels",
          flush=True)
    for name, (t, k) in sorted(tot.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"[lighttrace]   {t / 1e3:9.3f} ms {k:6d}x  {name[:160]}",
              flush=True)


def main():
    dev = torch.device("cuda")
    card = os.popen("nvidia-smi --query-gpu=name,power.limit "
                    "--format=csv,noheader").read().strip()
    print(f"[lighttrace] root {os.path.abspath(ARGS.root)}; {card}; torch "
          f"{torch.__version__}", flush=True)
    FLOOR["us"] = floor_us()
    scene, meta = make_still_life_like(device=dev)
    settings = RenderSettings(width=W, height=H, spp=1,
                              max_path_len=MAX_LEN, algorithm="vcm")
    cam = camera_for_scene(meta, settings, dev)
    base = estimate_pixel_size(scene, cam, meta) * settings.radius_factor
    (frame, base_radius, lpc, _, pm_radius, eta_vc,
     eta_vm) = vcm.frame_constants(cam, 1, base, algo="vcm",
                                   num_pixels=W * H, light_path_count=LPC,
                                   max_len=MAX_LEN)
    splat, append = vcm.splat, light_cache.CollectCache.append
    vcm.splat = ranged("tail.splat", splat)
    light_cache.CollectCache.append = ranged("tail.append", append)

    def band(collect):
        return vcm._light_pass(
            scene, cam, frame, eta_vc, eta_vm, collect, algo="vcm",
            num_pixels=W * H, light_path_count=lpc, max_len=MAX_LEN,
            alpha_fn=pt.alpha_fn_for(scene), has_bump=meta.has_bump,
            path_start=(lpc - BAND) // 2, band_paths=BAND)

    collect = light_cache.empty_collect(lpc * MAX_LEN, dev)
    band(collect)                                 # builds the kernels
    collect = light_cache.empty_collect(lpc * MAX_LEN, dev)
    torch.cuda.synchronize()
    del REGIONS[:]
    with profile(activities=ACTS) as prof:
        band(collect)
        torch.cuda.synchronize()
    vcm.splat, light_cache.CollectCache.append = splat, append
    for name, tot in regions(prof):
        show(f"eager light band, range {name}", tot, ARGS.top)
    select = ranged("tail.select", lambda c, cap: (
        light_cache.select_shallowest(c.cache(), cap)))
    with profile(activities=ACTS) as prof:
        select(collect, 2 * lpc)
        torch.cuda.synchronize()
    for _, tot in regions(prof):
        show("the collect cache's selection (eager, once a frame)", tot,
             ARGS.top)
    del collect

    settings.light_path_count = LPC
    middle_ranged()
    tot = graphed_frame(scene, meta, settings, "vcm")
    for part in ("collect_append_kernel", "collect_tail_kernel",
                 "splat_kernel", "index", "CatArrayBatchedCopy"):
        us = sum(v[0] for k, v in tot.items() if part in k)
        n = sum(v[1] for k, v in tot.items() if part in k)
        print(f"[lighttrace]   kernels named *{part}*: {us / 1e3:.3f} ms, "
              f"{n} launches", flush=True)
    settings = RenderSettings(width=W, height=H, spp=1,
                              max_path_len=MAX_LEN, algorithm="pt")
    graphed_frame(scene, meta, settings, "pt")
    del scene
    scene, meta = make_cornell_scene(device=dev)
    graphed_frame(scene, meta, RenderSettings(
        width=CORNELL, height=CORNELL, spp=1, max_path_len=CORNELL_LEN,
        algorithm="pt"), "cornell pt")
    del scene
    instanced(dev)
    ranked()


MIDDLE = {}


def middle_ranged():
    """Open a "frame.middle" region at the end of CollectCache.check and
    close it at the end of vcm.working_cache, noting the memory the
    frame held when it opened and resetting the peak there."""
    check, working = light_cache.CollectCache.check, vcm.working_cache

    def opened(self, *a, **k):
        out = check(self, *a, **k)
        REGIONS.append("frame.middle")
        mark()
        MIDDLE["held"] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        return out

    def closed(*a, **k):
        out = working(*a, **k)
        mark()
        MIDDLE["peak"] = torch.cuda.max_memory_allocated() - MIDDLE["held"]
        return out

    light_cache.CollectCache.check = opened
    vcm.working_cache = closed


# Kernels whose device time and launches every graphed frame logs: every
# hand-written kernel of the port but the traversals.
NAMED = ("pt_shade_kernel", "pt_shade_finish_kernel",
         "vcm_light_start_kernel", "vcm_light_shade_kernel",
         "vcm_camera_shade_kernel", "vcm_finish_kernel<false>",
         "vcm_finish_kernel<true>", "dispatch_keys_kernel",
         "dispatch_rows_kernel", "khit_resolve_kernel",
         "stream_resolve_kernel", "slot_gather_kernel", "slot_finish_kernel", "collect_append_kernel", "collect_tail_kernel",
         "splat_kernel", "select_keys_kernel", "select_gather_kernel",
         "grid_keys_kernel", "grid_tiles_kernel", "set_conditional")

# Every hand-written kernel of PERF.md section 6 is ranked by the time it
# loses against its bound, a launch's bound being the bytes its threads
# must move over 3.35 TB/s (a traversal's: its float instructions over
# 33.5e12/s), counted as threads x a thread's share (THREAD_BYTES,
# THREAD_US) plus what does not grow with the threads (LAUNCH_BYTES).
# A lane-a-thread kernel's share is chip_smoke.py's byte count of it on a
# 262,144-lane band (section 6's bound column) over the band's lanes --
# pt_shade its carry and hit in and its outputs out (SHADE_LANE_IN +
# SHADE_LANE_OUT, the shade-record and light rows left out), the light
# start its carry out, the finishes their contrib, pixel or radiance and
# flags, the resolves their row in and hit out, the keys a ray's origin
# and flag in and its key out.  The kernels that are not a lane a thread
# take chip_smoke.py's bytes of one launch on the still-life band over
# that launch's threads: the collect append a 16-byte word of staged rows
# a thread (at the band's 31.4% valid rows), the splat a row (its pixel,
# and a contribution where it has one; the film a launch), the
# selection's keys a row (the admission keys'; the canonical keys move
# 20), its gather and the grid's tiles a word or a photon slot, the
# grid's keys a photon.  The PT bounce's NEE add (pt_shade_finish_kernel,
# four lanes a thread in one tree, one in another) moves 38 B a lane of
# its band -- radiance, contrib and two flags in, radiance out -- over
# the frame's mean band (its pixels over its bands).  The slot
# kernels and the WHILE nodes' flag kernel move what the function needs
# a launch, whatever the kernel: the need flags of the band and the
# slots' state out (26 B a slot, 30 with tcur); every active flag and
# every slot's two flags, and a valid slot's lane index, its hit and its
# lane's hit (8 + 16 + 16 B: the merge, folded into the finish); and at
# most the slots' flags.
THREAD_BYTES = {"pt_shade_kernel": 86 + 115,
                "vcm_light_start_kernel": 66,
                "vcm_finish_kernel<false>": 34,
                "vcm_finish_kernel<true>": 52, "khit_resolve_kernel": 148,
                "stream_resolve_kernel": 56, "dispatch_keys_kernel": 29,
                "dispatch_rows_kernel": 18.1e6 / 262144,
                "vcm_light_shade_kernel": 74.7e6 / 262144,
                "vcm_camera_shade_kernel": 115e6 / 262144,
                "collect_append_kernel": 136.9e6 / (8 * 262144 * 6),
                "collect_tail_kernel": 12,
                "splat_kernel": (33.6e6 - 1920 * 1080 * 12) / (8 * 262144),
                "select_keys_kernel": 12,
                "select_gather_kernel": 429.2e6 / (2097152 * 6),
                "grid_keys_kernel": 32.8e6 / 2034225,
                "grid_tiles_kernel": 268.4e6 / 2034225}
# The traversals' operations bound of section 6 on a 262,144-ray band, a
# ray a thread: khit on the still life (S = 140), the instanced stream
# kernel's closest and any hit (S = 1,404), the flat one's (S = 68), the
# merge's gather and its query rows on the still-life band.
THREAD_US = {"khit_kernel": 35.9 / 262144,
             "stream_traverse_kernel<false, true": 58.5 / 262144,
             "stream_traverse_kernel<true, true": 54.0 / 262144,
             "stream_traverse_kernel<false, false": 19.1 / 262144,
             "stream_traverse_kernel<true, false": 12.5 / 262144,
             "merge_kernel<": 12.3 / 262144,
             "merge_query_rows_kernel": 20.1 / 262144}
LAUNCH_BYTES = {
    "pt_shade_finish_kernel": lambda f: 38 * f["pixels"] / -(-f["pixels"]
                                                             // BAND),
    "splat_kernel": lambda f: f["pixels"] * 12,
    "slot_gather_kernel": lambda f: f["lanes"] + f["slots"] * f["slot_b"],
    "slot_finish_kernel": lambda f: (f["lanes"] + 2 * f["slots"]
                                     + 40 * f["valid"]),
    "set_conditional": lambda f: f["slots"] + 8}
HBM_BYTES_PER_S = 3.35e12
# The floor of a launch in a graph: an empty kernel (torch.cuda._sleep(0),
# which returns at once) launched FLOOR_LAUNCHES times in one graph and
# traced over a replay, once a call (floor_us).
FLOOR_LAUNCHES = 200


def floor_us():
    """The traced us a launch of an empty kernel replayed in a graph."""
    torch.cuda._sleep(0)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(FLOOR_LAUNCHES):
            torch.cuda._sleep(0)
    g.replay()
    torch.cuda.synchronize()
    with profile(activities=ACTS) as prof:
        g.replay()
        torch.cuda.synchronize()
    ns = [n for name, _, n in device_events(prof) if MARK in name]
    return sum(ns) / 1e3 / max(len(ns), 1)


def chrome_threads(path):
    """{kernel name: [threads launched, launches]} of a chrome trace's
    kernels (grid x block)."""
    with open(path) as fh:
        evts = json.load(fh)["traceEvents"]
    tot = {}
    for e in evts:
        if e.get("cat") != "kernel":
            continue
        a = e.get("args", {})
        grid, block = a.get("grid", [0]), a.get("block", [0])
        n = 1
        for x in list(grid) + list(block):
            n *= int(x)
        t = tot.setdefault(e.get("name", ""), [0, 0])
        t[0] += n
        t[1] += 1
    return tot


def rank(tag, tot, threads, frame):
    """`[rank]` lines: every kernel of THREAD_BYTES, THREAD_US and
    LAUNCH_BYTES that the frame launched, by launches x (us a launch -
    bound at the traced threads), the most lost first; then the floor,
    FLOOR["us"].  `frame`: the band's lanes and slots, a slot's bytes, the
    valid slots a dispatch and the pixels."""
    rows = []
    for part in dict.fromkeys([*THREAD_BYTES, *THREAD_US, *LAUNCH_BYTES]):
        names = [k for k in tot if part in k]
        if not names:
            continue
        us = sum(tot[k][0] for k in names)
        n = sum(tot[k][1] for k in names)
        lanes = sum(v[0] for k, v in threads.items() if part in k)
        bound_us = (lanes * (THREAD_BYTES.get(part, 0.0) / HBM_BYTES_PER_S
                             * 1e6 + THREAD_US.get(part, 0.0))
                    + n * 1e6 * LAUNCH_BYTES.get(part, lambda f: 0)(frame)
                    / HBM_BYTES_PER_S)
        rows.append((us - bound_us, part, us, n, lanes, bound_us))
    for lost, part, us, n, lanes, bound_us in sorted(rows, reverse=True):
        print(f"[rank] graphed {tag} frame: {part}: {n} launches, "
              f"{us / n:.2f} us a launch against a bound of "
              f"{bound_us / n:.3f} us at {lanes / n:.0f} threads a launch "
              f"({us / max(bound_us, 1e-9):.1f}x), "
              f"{lost / 1e3:.3f} ms a frame above it", flush=True)
    print(f"[rank] graphed {tag} frame: the floor, an empty kernel "
          f"replayed in a graph: {FLOOR['us']:.2f} us a launch over "
          f"{FLOOR_LAUNCHES} launches", flush=True)


FLOOR = {"us": 0.0}


RESOLVES = ("khit_resolve_kernel", "stream_resolve_kernel")
WHILE_FLAG = "set_conditional"


# The kernels that write a dispatch's merged hit after its WHILE node: the
# finish, which merges the slots' hits, or in an earlier tree the finish
# and then a merge kernel of its own.
FINISH, MERGE = "slot_finish_kernel", "slot_merge_kernel"
LOOP_KINDS = {"entry": "loop entries, {n:.2f} launches each from the "
                       "resolve to the WHILE node (with the slots)",
              "pass": "loop pass ends, {n:.2f} launches each from the "
                      "resolve to the WHILE node (the loop test)",
              "exit": "loop exits, {n:.2f} launches each from the WHILE "
                      "node to the merged hit"}


def loop_launches(tag, events):
    """`[loop]` lines: the device launches (kernels, memsets, copies) from
    each re-trace resolve to the next WHILE flag kernel, which ends a
    dispatch's loop entry where the slot gather ran between them, else a
    pass of the body; and from a loop's last WHILE flag kernel to the
    launch that writes its merged hit (FINISH, or MERGE right after it):
    their count and device time, on average, and the names of one
    entry's, one pass's and one exit's launches."""
    events = [(name, ns) for name, _, ns in events if MARK not in name]
    since, after, found = None, None, {k: [] for k in LOOP_KINDS}
    for i, (name, ns) in enumerate(events):
        if after is not None:
            after.append((name, ns))
            nxt = events[i + 1][0] if i + 1 < len(events) else ""
            if MERGE in name or (FINISH in name and MERGE not in nxt):
                found["exit"].append(after)
                after = None
        if any(r in name for r in RESOLVES):
            since = []
        elif since is not None:
            since.append((name, ns))
            if WHILE_FLAG in name:
                kind = ("entry" if any("slot_gather" in k for k, _ in since)
                        else "pass")
                found[kind].append(since)
                since = None
        if WHILE_FLAG in name:
            after = []
    for kind, runs in found.items():
        if not runs:
            continue
        n = sum(len(r) for r in runs) / len(runs)
        us = sum(ns for r in runs for _, ns in r) / 1e3 / len(runs)
        names = ", ".join(
            k.replace("(anonymous namespace)::", "").replace("void ", "")
            .split("(")[0].split("<")[0][-40:] for k, _ in runs[0])
        print(f"[loop] graphed {tag} frame: {len(runs)} "
              f"{LOOP_KINDS[kind].format(n=n)}, {us:.2f} us device; one: "
              f"{names}", flush=True)


def valid_slots(scene, meta, settings):
    """The re-trace's valid slots a masked dispatch of one frame: the
    scene's graphs captured afresh with dispatch.slot_finish counting its
    slots' valid flags and its calls on the card, a frame to capture, the
    counts of one more frame read, and the captures dropped again (the
    next frame_fn captures without the counting)."""
    from imbatracer_torch.ops import dispatch as dp
    from imbatracer_torch.render import graphs

    acc = torch.zeros(2, dtype=torch.int64, device=scene.device)
    finish = dp.slot_finish

    def counted(overflow, act, slots, *a, **k):
        acc[0] += slots.valid.sum()
        acc[1] += 1
        return finish(overflow, act, slots, *a, **k)

    graphs._SCENES.pop(id(scene), None)
    dp.slot_finish = counted
    try:
        frame_fn, _ = make_frame_fn(scene, meta, settings)
        renderer = ProgressiveRenderer(frame_fn, settings, scene.device)
        renderer.step()
        before = acc.tolist()
        renderer.step()
        after = acc.tolist()
    finally:
        dp.slot_finish = finish
        graphs._SCENES.pop(id(scene), None)
    n = after[1] - before[1]
    return (after[0] - before[0]) / n if n else 0.0


# The graphed frames traced, ranked once every trace is taken (ranked()):
# (tag, {kernel: [us, n]}, chrome_threads, scene, meta, settings, the
# band's shapes).
RANKED = []


def ranked():
    """`[rank]` lines of every graphed frame traced, each with the valid
    slots a masked dispatch of its scene and settings (valid_slots), after
    the traces: the counting frames capture afresh."""
    for tag, tot, threads, scene, meta, settings, frame in RANKED:
        valid = valid_slots(scene, meta, settings)
        print(f"[lighttrace] graphed {tag} frame: {valid:.1f} valid slots "
              f"a masked dispatch (a frame of fresh captures)", flush=True)
        rank(tag, tot, threads, dict(frame, valid=valid))
    del RANKED[:]


def graphed_frame(scene, meta, settings, tag, chrome=None):
    """Trace one graphed frame after a warm-up frame (the captures); log
    its wall and device busy time, top kernels, the NAMED kernels and its
    middle's range, and keep what ranked() ranks; {name: [us, n]}.  The
    trace goes to `chrome`, or to a temporary file."""
    frame_fn, _ = make_frame_fn(scene, meta, settings)
    renderer = ProgressiveRenderer(frame_fn, settings, scene.device)
    renderer.step()
    torch.cuda.synchronize()
    del REGIONS[:]
    with profile(activities=ACTS) as prof:
        t0 = time.time()
        renderer.step()
        torch.cuda.synchronize()
        wall = 1e3 * (time.time() - t0)
    tot = by_name((name, ns / 1e3) for name, _, ns in device_events(prof)
                  if MARK not in name)
    streams = {e.device_resource_id()
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == CUDA}
    print(f"[lighttrace] graphed {tag} frame: wall {wall:.1f} ms, device "
          f"events on {len(streams)} streams", flush=True)
    show(f"graphed {tag} frame", tot, ARGS.top)
    for part in NAMED:
        us = sum(v[0] for k, v in tot.items() if part in k)
        n = sum(v[1] for k, v in tot.items() if part in k)
        print(f"[lighttrace]   graphed {tag} frame, kernels named *{part}*: "
              f"{us / 1e3:.3f} ms, {n} launches", flush=True)
    keep = chrome is not None
    if chrome is None:
        fd, chrome = tempfile.mkstemp(suffix=".json", prefix="imba_trace_")
        os.close(fd)
    prof.export_chrome_trace(chrome)
    two_level = scene.bvh.two_level
    RANKED.append((tag, tot, chrome_threads(chrome), scene, meta, settings,
                   dict(lanes=BAND,
                        slots=traverse.retrace_slots(BAND, two_level),
                        slot_b=26 if two_level else 30,
                        pixels=settings.width * settings.height)))
    loop_launches(tag, device_events(prof))
    if not keep:
        os.remove(chrome)
    for _, middle in regions(prof):
        show(f"graphed {tag} frame: the middle (selection, canonical "
             f"order, photon grid, static inputs)", middle, ARGS.top)
        print(f"[lighttrace]   the middle's peak memory above the frame's "
              f"{MIDDLE['held'] / 2**20:.1f} MiB: "
              f"{MIDDLE['peak'] / 2**20:.1f} MiB", flush=True)
    return tot


ADD = "CUDAFunctorOnSelf_add"


def adds_by_shape(path):
    """{(grid, block): [us, n]} of the scalar-add kernels of a chrome
    trace."""
    with open(path) as fh:
        evts = json.load(fh)["traceEvents"]
    tot = {}
    for e in evts:
        if e.get("cat") == "kernel" and ADD in e.get("name", ""):
            a = e.get("args", {})
            t = tot.setdefault((str(a.get("grid")), str(a.get("block"))),
                               [0.0, 0])
            t[0] += e.get("dur", 0.0)
            t[1] += 1
    return tot


def captured_adds(run):
    """Run `run()` with torch.Tensor.add_ and __iadd__ wrapped: ({the
    port's innermost call site: adds made while a CUDA graph captured}
    (each is launched once a replay of its graph, once a round inside a
    WHILE body, those marked "[body]"), the WHILE bodies captured)."""
    import traceback

    from imbatracer_torch.render import graphs

    sites, bodies = {}, [0]
    originals = {k: getattr(torch.Tensor, k) for k in ("add_", "__iadd__")}
    loop = graphs.CudaGraph.while_loop

    def wrap(name, fn):
        def wrapped(self, *a, **k):
            if torch.cuda.is_current_stream_capturing():
                stack = traceback.extract_stack()[:-1]
                here = [f for f in stack if "imbatracer_torch" in f.filename]
                body = any(f.name == "while_loop"
                           and f.filename.endswith("graphs.py")
                           for f in stack)
                key = (("[body] " if body else "")
                       + f"{name} of {tuple(self.shape)} at " + " < ".join(
                           f"{f.filename.split('imbatracer_torch/')[-1]}:"
                           f"{f.lineno} {f.name}"
                           for f in reversed(here[-2:])))
                sites[key] = sites.get(key, 0) + 1
            return fn(self, *a, **k)
        return wrapped

    def counted_loop(self, *a, **k):
        bodies[0] += 1
        return loop(self, *a, **k)

    for k, fn in originals.items():
        setattr(torch.Tensor, k, wrap(k, fn))
    graphs.CudaGraph.while_loop = counted_loop
    try:
        run()
    finally:
        for k, fn in originals.items():
            setattr(torch.Tensor, k, fn)
        graphs.CudaGraph.while_loop = loop
    return {k: [0.0, n] for k, n in sites.items()}, bodies[0]


def show_adds(tag, tot, top=12):
    n = sum(v[1] for v in tot.values())
    us = sum(v[0] for v in tot.values())
    print(f"[addtrace] {tag}: {n} adds, {us / 1e3:.3f} ms", flush=True)
    for k, (t, c) in sorted(tot.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"[addtrace]   {c:6d}x {t / 1e3:8.3f} ms  {k}", flush=True)


def instanced(dev):
    """The instanced vcm frame: graphed (busy, middle, the scalar adds by
    launch shape), and the adds a fresh scene's captures record into its
    graphs, by call site."""
    from imbatracer_torch.render import graphs
    from imbatracer_torch.scene.build import build_scene
    from imbatracer_torch.scene.generate import CARD, write_instanced_scene

    tmp = tempfile.mkdtemp(prefix="imba_instanced_")
    path = write_instanced_scene(tmp, **CARD)
    scene, meta = build_scene(path, quiet=True, device=dev)
    settings = RenderSettings(width=W, height=H, spp=1,
                              max_path_len=MAX_LEN, algorithm="vcm")
    chrome = os.path.join(tmp, "trace_instanced_vcm.json")
    graphed_frame(scene, meta, settings, "instanced vcm", chrome=chrome)
    show_adds("graphed instanced vcm frame, by (grid, block)",
              {f"grid {g} block {b}": v
               for (g, b), v in adds_by_shape(chrome).items()})
    graphed_frame(scene, meta, RenderSettings(
        width=W, height=H, spp=1, max_path_len=MAX_LEN, algorithm="pt"),
        "instanced pt")
    # A fresh scene's captures, their adds by call site.
    scene, meta = build_scene(path, quiet=True, device=dev)
    frame_fn, _ = make_frame_fn(scene, meta, settings)
    sites, bodies = captured_adds(
        lambda: (frame_fn(0), torch.cuda.synchronize()))
    show_adds("the instanced vcm frame's captures (adds recorded into a "
              "graph, by call site)", sites, top=20)
    in_bodies = sum(n for k, (_, n) in sites.items()
                    if k.startswith("[body]"))
    print(f"[addtrace] WHILE bodies captured: {bodies}; adds recorded in "
          f"them: {in_bodies}, {in_bodies / max(bodies, 1):.2f} a round",
          flush=True)
    print(f"[addtrace] graph stats {graphs.GRAPH_STATS}", flush=True)
    shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
