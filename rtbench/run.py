"""Run one cell of the benchmark once.

    python3 -m rtbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout holding BENCHMARK.json, rtbench/ and the
program (`imbatracer_torch/`), on a machine with the cards the cell asks
for.

Set-up (the process's start to the first timed frame, `setup_s`): the
program's CUDA libraries are built into the checkout's
`build/imbatracer_torch/` at the first run and found there after it;
the scene is made from the configuration and built by the program; the
frame function comes from `frontend.engine.make_frame_fn`, as the CLI
makes it; warm-up frames capture the graphs and touch every shape the
window uses.  The window then drives the user's loop,
`frontend.renderer.ProgressiveRenderer.step()` with a
`torch.cuda.synchronize` after each frame as `ProgressiveRenderer.run`
does, for `--seconds`.  Frame numbers start at an offset drawn from
`--seed`, so every seed renders other samples of the same work.

After the window: the peak of device memory is read, with `--trace 1`
a few more frames are profiled for the per-layer metrics, the program's
state is freed, and the plain reference renders sampled pixel rows of
sampled window frames for `correct` (rtbench/check.py).  The last line
of standard output is the result as one JSON object; the compared
numbers and their limits are also the last lines of standard error.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

from . import check, profile, spec, window  # noqa: E402

# Top-level module names that no process of the benchmark may hold.
FORBIDDEN = ("jax", "jaxlib", "flax", "imbatracer_tpu")
# Window frames are numbered from an offset below FRAME_SPAN; warm-up
# frames from WARM_OFFSET above it: all inside the 32-bit frame number.
FRAME_SPAN = (1 << 31) - (1 << 21)
WARM_OFFSET = 1 << 20
HOST_THREADS = 2


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def run_environment(root: str):
    """The program's BVH cache inside the checkout, at a fixed path (its
    CUDA libraries go to the checkout's `build/imbatracer_torch/` by
    themselves), and few host threads: the frame is paced by one
    launching thread, which other threads' spinning would slow by
    turns."""
    os.environ["IMBATRACER_CACHE_DIR"] = os.path.join(root, "build",
                                                      "rtbench", "accel")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = str(HOST_THREADS)


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else "?"
    except (OSError, subprocess.SubprocessError):
        return "?"


def build_libraries():
    from imbatracer_torch import libbuild
    from imbatracer_torch.accel import native
    from imbatracer_torch.ops import dispatch, khit, light_tail, merge
    from imbatracer_torch.ops import pairs, select, shade, stream_traverse
    from imbatracer_torch.ops import vcm_shade
    from imbatracer_torch.render import graphs

    libbuild.build_all((stream_traverse.LIB, khit.LIB, merge.LIB, pairs.LIB,
                        shade.LIB, vcm_shade.LIB, dispatch.LIB,
                        light_tail.LIB, select.LIB, merge.GRID_LIB,
                        graphs.COND_LIB, native.LIB))


def launch_counts() -> dict:
    """The program's launch counters of the traversal kernels."""
    from imbatracer_torch.ops import khit, stream_traverse

    st = stream_traverse.LAUNCHES
    return {"khit_kernel": khit.LAUNCHES["khit"],
            "stream_traverse_kernel": sum(
                st[k] for k in ("closest_hit", "any_hit",
                                "closest_hit_instanced", "any_hit_instanced"))}


def device_allocs(device) -> int:
    """The caching allocator's calls for new device memory so far."""
    import torch

    if torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.memory_stats(device).get("num_device_alloc", 0))


class Frames:
    """The frame function the renderer calls: the program's, at the
    seed's frame numbers, with the check's sampler looking on."""

    def __init__(self, fn, base: int):
        self.fn = fn
        self.base = base
        self.sampler = None
        self.renderer = None
        self.stats_fn = None     # with_stats frames of the traced segment
        self.rays = []

    def __call__(self, i):
        frame = self.base + i
        if self.stats_fn is not None:
            film, n_rays = self.stats_fn(frame)
            self.rays.append(n_rays)
        else:
            film = self.fn(frame)
        if self.sampler is not None:
            self.sampler.offer(i, frame, film, self.renderer.accum)
        return film


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device, sync=None) -> dict:
    """One run of `cell`; returns the result object.  `device` is where
    the program and the reference run; `sync` waits for it."""
    import torch

    from imbatracer_torch.frontend.engine import make_frame_fn
    from imbatracer_torch.frontend.renderer import (ProgressiveRenderer,
                                                    RenderSettings)
    from imbatracer_torch.render import graphs

    from .reference import camera as ref_camera
    from .reference import scene as ref_scene

    sync = sync or (lambda: None)
    tr = cell.traffic
    rs = tr["render"]
    settings = RenderSettings(**rs)
    kind = spec.scene_kind(cell.config["scene"])
    workdir = tempfile.mkdtemp(prefix="rtbench_")
    try:
        marks = [("start", time.time())]
        handle = kind.prepare(cell.config, workdir)
        marks.append(("inputs", time.time()))
        scene, meta = kind.program_scene(handle, device)
        marks.append(("scene build", time.time()))
        frame_fn, cam = make_frame_fn(scene, meta, settings)
        marks.append(("frame function", time.time()))
        frame0 = seed % FRAME_SPAN
        frames = Frames(frame_fn, frame0)
        renderer = ProgressiveRenderer(frames, settings, device)
        frames.renderer = renderer
        frames.base = frame0 + WARM_OFFSET
        for _ in range(int(tr["warmup_frames"])):
            renderer.step()
            sync()
        renderer.reset()
        marks.append(("warm-up frames", time.time()))
        frames.base = frame0
        frames.sampler = check.Sampler(int(tr["check"]["frames"]), seed)
        reruns0 = graphs.GRAPH_STATS["reruns"]
        allocs0 = device_allocs(device)
        sync()

        # ---- the timed window -------------------------------------------
        times = []
        t_open = time.perf_counter()
        setup_s = time.time() - T_START
        while True:
            t0 = time.perf_counter()
            renderer.step()
            sync()
            t1 = time.perf_counter()
            times.append(1e3 * (t1 - t0))
            frames.sampler.stepped(renderer.accum)
            if t1 - t_open >= seconds and len(times) >= 2:
                break
        window_s = t1 - t_open
        n = len(times)
        log("[setup] " + ", ".join(
            [f"process start to here {marks[0][1] - T_START:.2f} s"]
            + [f"{name} {t - marks[i][1]:.2f} s"
               for i, (name, t) in enumerate(marks[1:])]))
        reruns = graphs.GRAPH_STATS["reruns"] - reruns0
        allocs = device_allocs(device) - allocs0
        peak = (torch.cuda.max_memory_allocated(device)
                if torch.device(device).type == "cuda" else 0)
        sampler, frames.sampler = frames.sampler, None

        result_metrics = {}
        dev_info = {}
        breakdown = None
        if trace:
            result_metrics, dev_info, breakdown = traced_segment(
                cell, renderer, frames, scene, cam, meta, settings, handle,
                kind, n, reruns, sync)
        else:
            values = dict(frame_ms=window.frame_ms(window_s, n),
                          frame_ms_p90=window.frame_ms_p90(times),
                          setup_s=setup_s)
            for m in cell.end_to_end:
                result_metrics[m["name"]] = dict(value=values[m["name"]],
                                                 unit=m["unit"])
        log(f"[window] {cell.name} seed {seed}: {n} frames in "
            f"{window_s:.3f} s, frame_ms {window.frame_ms(window_s, n):.3f}, "
            f"p90 {window.frame_ms_p90(times):.3f} "
            f"({window.tail_count(times)} beyond), setup_s "
            f"{setup_s:.3f}, graph reruns {reruns}, device allocations "
            f"{allocs}, peak "
            f"{peak / 2**30:.3f} GiB")

        # ---- the check, with the program's state freed ------------------
        frames.fn = frames.stats_fn = None
        del renderer, frame_fn, scene, frames
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        raw = kind.reference_inputs(handle)
        t_ref = time.perf_counter()
        ref = ref_scene.build(raw, device)
        rcam = ref_camera.make_camera(raw.cam_pos, raw.cam_dir, raw.cam_up,
                                      settings.width, settings.height,
                                      settings.fov, device=device)
        rows = check.sample_rows(settings.height, int(tr["check"]["rows"]),
                                 seed)
        pid = check.pixel_ids(rows, settings.width, device)
        parts, gaps = [], []
        render = reference_renderer(rs, raw)
        for s in sampler.kept:
            gaps.append(check.accum_gap(s))
            ref_rows = render(ref, rcam, s.frame, pid)
            parts.append(check.compare(s.film[pid], ref_rows))
        sync()
        checks = check.judge(parts, gaps, cell.limits)
        ok = check.passed(checks)
        log(f"[check] {len(sampler.kept)} frames ({[s.index for s in sampler.kept]}"
            f" of {n}), rows {rows}, reference {time.perf_counter() - t_ref:.2f} s")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    result = {"correct": ok, "attempted": n,
              "failed": sum(1 for p, g in zip(parts, gaps)
                            if not check.passed(check.judge([p], [g],
                                                            cell.limits))),
              "metrics": result_metrics,
              "device": dict(platform="gpu" if torch.device(device).type
                             == "cuda" else torch.device(device).type,
                             kind=(torch.cuda.get_device_name(device)
                                   if torch.device(device).type == "cuda"
                                   else "cpu"),
                             count=cell.chips, memory_peak_bytes=int(peak),
                             **dev_info)}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def reference_renderer(render: dict, raw):
    """The reference's frame at chosen pixels, for the traffic's
    algorithm: render(ref_scene, camera, frame, pixel_id, lowp=False)."""
    if render["algorithm"] == "pt":
        from .reference import pt as ref_pt
        return ref_pt.renderer(render, raw)
    from .reference import vcm as ref_vcm
    return ref_vcm.renderer(render, raw)


def traced_segment(cell, renderer, frames, scene, cam, meta, settings,
                   handle, kind, window_frames, reruns, sync):
    """Profile `trace_frames` more frames: (per-layer metrics, device
    busy and window seconds, breakdown)."""
    if settings.algorithm == "pt":
        from imbatracer_torch.render.integrators.pt import render_pt_frame

        def stats_fn(frame):
            return render_pt_frame(
                scene, cam, frame, settings.width, settings.height,
                spp=settings.spp, max_len=settings.max_path_len,
                has_masks=meta.has_masks, has_bump=meta.has_bump,
                with_stats=True)
        frames.stats_fn = stats_fn
    nf = int(cell.traffic["trace_frames"])
    frames.rays = []
    dev, host, host_ns, counted = _profile(renderer, nf, sync)
    # The profiler has dropped and misnamed device events before: a trace
    # whose traversal launches disagree with the program's counters is
    # unsound, and its kernel times and idle share are not read.
    dtot, _ = profile.totals(dev, host)
    traced = {k: profile.count_matching(dtot, rf"\b{k}\b") for k in counted}
    sound = counted == traced
    frames.stats_fn = None
    # The profiler's clock and perf_counter differ: the window is the
    # traced events' own span, as long as the host clock's.
    starts = [s for s, _, _ in dev] + [s for s, _, _, _ in host]
    ends = [e for _, e, _ in dev] + [e for _, e, _, _ in host]
    w0 = min(starts) if starts else 0
    w1 = max(max(ends) if ends else 0, w0 + host_ns)
    busy = profile.busy_ns(dev, w0, w1)
    log(f"[trace] {nf} frames: window {(w1 - w0) / 1e6:.3f} ms, busy "
        f"{busy / 1e6:.3f} ms, launches traced / counted "
        + ", ".join(f"{k} {traced[k]}/{counted[k]}" for k in counted)
        + ("" if sound else ": the trace disagrees with the counters, so "
           "its kernel times are not read"))
    rays = (float(sum(int(r) for r in frames.rays)) if frames.rays
            else None)
    frames.rays = []
    ctx = dict(frames=nf, window_ns=w1 - w0, busy_ns=busy, dtot=dtot,
               sound=sound, launches=profile.launch_calls(host),
               window_frames=window_frames, graph_reruns=reruns, rays=rays,
               scene_bytes=kind.scene_bytes(handle),
               max_len=settings.max_path_len)
    metrics, claimed = {}, []
    for m in cell.per_layer:
        mod = spec.metric_reader(m["name"])
        claimed += list(getattr(mod, "KERNELS", ()))
        value = mod.read(ctx)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    all_ns = sum(ns for ns, _ in dtot.values())
    claimed_ns, _ = profile.group_ns(dtot, claimed)
    rest = sorted(((name, ns) for name, (ns, _) in dtot.items()
                   if not any(re.search(p, name)
                              for p in claimed)), key=lambda r: -r[1])
    log(f"[unclaimed] {(all_ns - claimed_ns) / 1e6 / nf:.3f} ms a frame of "
        f"{all_ns / 1e6 / nf:.3f} ms device time in no metric's kernel "
        f"table: " + "; ".join(f"{name[:60]} {ns / 1e6 / nf:.3f}"
                               for name, ns in rest[:8]))
    top = sorted(((name, ns) for name, (ns, _) in dtot.items()),
                 key=lambda r: -r[1])[:10]
    breakdown = dict(
        device_ops=[[name, ns / 1e9] for name, ns in top],
        idle_gaps=[[name, ns / 1e9]
                   for name, ns in profile.idle_gaps(dev, host, w0, w1)])
    return metrics, dict(busy_s=busy / 1e9, window_s=(w1 - w0) / 1e9), \
        breakdown


def _profile(renderer, nf: int, sync):
    """(device events, host events, host ns, launches counted) of `nf`
    frames of the renderer under torch.profiler."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    sync()
    c0 = launch_counts()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter_ns()
        for _ in range(nf):
            renderer.step()
        sync()
        t1 = time.perf_counter_ns()
    c1 = launch_counts()
    dev, host = profile.events_from_profiler(prof)
    return dev, host, t1 - t0, {k: c1[k] - c0[k] for k in c0}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    run_environment(spec.ROOT)
    cell = spec.load_cell(args.workload)

    import torch

    torch.set_num_threads(HOST_THREADS)

    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark measures the card")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} cards, "
            f"{torch.cuda.device_count()} visible")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    log(f"[card] {card_line()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    build_libraries()
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device, sync=lambda: torch.cuda.synchronize(device))
    bad = forbidden_modules()
    if bad:
        log(f"modules loaded that the benchmark may not hold: {bad}")
        return 3
    for name, c in result["checks"].items():
        log(f"{name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
