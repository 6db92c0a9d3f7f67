"""The program's own instruments beside the traced segment: the host spans
(imbatracer_torch/utils/trace.py) and the masked re-trace's loop log
(render/graphs.py), which the profiler's trace cannot see.

    python3 -m rtbench.stamped --workload <cell> --seed <n> \
        --seconds <s> [--span-frames <n>]

runs `rtbench.run` with `--trace 1` and, around its profiled frames,
turns the spans on, reads the loop log after them, puts the log on the
profiler's clock, then renders, with the profiler off, `--span-frames`
frames with spans off, as many with spans on, as many off again, and
one with CUDA's sync debugging on.  Besides the run's own lines it
prints, on standard error:

  [stamped] one JSON object: the four readings below, the calibration
            and its residuals, the %globaltimer's steps, the wall time of
            the frames with spans on and of those with spans off, and
            each span's host time a frame;
  [idle by span] the idle gaps of the stamped union (device events and
            calibrated loops), each named by the innermost program span
            open at its midpoint;
  [syncs]   the Python lines where a frame made the host wait.

The readings (the functions below take the traced segment's `ctx`, as
rtbench/metrics readers do, with the fields `context` adds):
  loop_ms.retrace          sum of exit - entry over the profiled frames'
                           loop records, a frame;
  device_idle_pct.stamped  1 - (device intervals U calibrated loop
                           intervals) / traced window, only where
                           `sound_loops` holds;
  host_enqueue_ms          a span-only frame's `frame` span less its
                           `wait:*` spans;
  host_syncs_per_frame     `wait:*` spans a span-only frame.
The benchmark's run.py does none of this: rtbench.run's traced segment
would call `context` and these readers to report them (PERF.md section
7).
"""

from __future__ import annotations

import bisect
import json
import re
import statistics
import sys
import time
import traceback
import warnings
from collections import defaultdict

from . import profile

ENTRY_KERNEL = r"\bset_conditional\b"
# The traversal launch counters of run.launch_counts, by the loop log's
# counter names (render/graphs.py COUNTER_NAMES).
WALKS = {"khit_kernel": (("khit", "khit"),),
         "stream_traverse_kernel": tuple(
             ("stream_traverse", k) for k in (
                 "closest_hit", "any_hit", "closest_hit_instanced",
                 "any_hit_instanced"))}


def calibrate(loops, launches):
    """(offset ns, residuals ns): the loop records `loops` (entry ns, exit
    ns, rounds, loop id on the card's %globaltimer) on the profiler's
    clock.  Each record's entry launch is the traced flag kernel
    (`launches`, (start, end)) that starts nearest its stamp moved by
    the first record's offset to the first launch (the profiler also
    traces a loop's first pass, whose flag kernel comes after the body);
    the offset is the median of start - stamp over the pairs; a residual
    is how far a calibrated stamp lies outside its launch's [start,
    end].  None where a launch would pair twice or there is none."""
    if not loops or not launches:
        return None
    stamps = sorted(r[0] for r in loops)
    launches = sorted(launches)
    starts = [s for s, _ in launches]
    off0 = starts[0] - stamps[0]
    picked = []
    for t in stamps:
        j = bisect.bisect_left(starts, t + off0)
        j = min((i for i in (j - 1, j) if 0 <= i < len(starts)),
                key=lambda i: abs(starts[i] - (t + off0)))
        picked.append(j)
    if len(set(picked)) != len(picked):
        return None
    pairs = [(t, launches[j]) for t, j in zip(stamps, picked)]
    offset = int(statistics.median(s - t for t, (s, _) in pairs))
    return offset, [max(0, s - (t + offset), (t + offset) - e)
                    for t, (s, e) in pairs]


def loop_intervals(loops, offset):
    """The loops' [entry, exit] on the profiler's clock, as device events,
    in time order."""
    return sorted((t0 + offset, t1 + offset, "loop")
                  for t0, t1, _, _ in loops)


def traced_outside(dev, ivs, kernels) -> dict:
    """{k: traced launches of kernel k that start outside every loop
    interval of `ivs` (sorted, disjoint)} for each name of `kernels`."""
    starts = [s for s, _, _ in ivs]
    out = {}
    for k in kernels:
        rx, n = re.compile(rf"\b{k}\b"), 0
        for s, _, name in dev:
            if rx.search(name):
                i = bisect.bisect_right(starts, s) - 1
                n += not (i >= 0 and ivs[i][0] <= s <= ivs[i][1])
        out[k] = n
    return out


def inside_launches(body) -> dict:
    """run.launch_counts' traversal counters, of the launches made inside
    WHILE bodies (`body`: graphs.body_counts)."""
    return {k: sum(body.get(key, 0) for key in keys)
            for k, keys in WALKS.items()}


def is_sound(loops, lost, calibrated, outside, counted, inside) -> bool:
    """Whether the loop log and the trace account for each other: no
    record lost, every record paired with its traced entry launch
    (`calibrated`), none ending before it began, and every traversal
    launch the counters count outside WHILE bodies traced outside the
    loops (`outside`: traced_outside)."""
    return (lost == 0 and calibrated
            and all(t1 >= t0 for t0, t1, _, _ in loops)
            and all(outside[k] == counted[k] - inside.get(k, 0)
                    for k in counted))


def host_frames(spans) -> list:
    """[(frame span ns, wait:* ns, wait:* spans)] of each `frame` span in
    `spans`, with the waits of that frame."""
    out = {}
    for name, _, frame, t0, t1 in spans:
        if name == "frame":
            out[frame] = [t1 - t0, 0, 0]
    for name, _, frame, t0, t1 in spans:
        if name.startswith("wait:") and frame in out:
            out[frame][1] += t1 - t0
            out[frame][2] += 1
    return [tuple(v) for _, v in sorted(out.items())]


def context(dev, window, loops, lost, body, spans, counted) -> dict:
    """The ctx fields the readings below read: `loop_ns` (the records'
    exit - entry summed), `loop_intervals` (calibrated, or None),
    `sound_loops`, `stamped_busy_ns` (the union of `dev` and the loop
    intervals over `window`, (w0, w1)), `spans` (the span-only frames'),
    `calibration` ((offset, residuals) or None)."""
    launches = [(s, e) for s, e, name in dev if re.search(ENTRY_KERNEL,
                                                          name)]
    cal = calibrate(loops, launches)
    ivs = loop_intervals(loops, cal[0]) if cal else None
    outside = traced_outside(dev, ivs or [], counted)
    w0, w1 = window
    return dict(
        loop_ns=sum(t1 - t0 for t0, t1, _, _ in loops),
        loop_intervals=ivs, calibration=cal, spans=spans,
        sound_loops=is_sound(loops, lost, cal is not None, outside,
                             counted, inside_launches(body)),
        stamped_busy_ns=(profile.busy_ns(dev + ivs, w0, w1) if ivs
                         else None),
        traced_outside=outside, entry_launches=len(launches))


def loop_ms_retrace(ctx):
    return ctx["loop_ns"] / 1e6 / ctx["frames"]


def device_idle_pct_stamped(ctx):
    if not ctx["sound_loops"]:
        return None
    return 100.0 * (1.0 - ctx["stamped_busy_ns"] / ctx["window_ns"])


def host_enqueue_ms(ctx):
    frames = host_frames(ctx["spans"])
    if not frames:
        return None
    return statistics.mean(ns - wait for ns, wait, _ in frames) / 1e6


def host_syncs_per_frame(ctx):
    frames = host_frames(ctx["spans"])
    if not frames:
        return None
    return statistics.mean(n for _, _, n in frames)


READINGS = {"loop_ms.retrace": loop_ms_retrace,
            "device_idle_pct.stamped": device_idle_pct_stamped,
            "host_enqueue_ms": host_enqueue_ms,
            "host_syncs_per_frame": host_syncs_per_frame}


def idle_by_span(dev, ivs, host, w0, w1):
    """The idle gaps of the union of `dev` and the loop intervals `ivs`,
    by the innermost program span (the profiler's `imba::` host events)
    open at each gap's midpoint."""
    spans = [ev for ev in host if ev[2].startswith("imba::")]
    return profile.idle_gaps(dev + (ivs or []), spans, w0, w1, top=12)


def span_ms(spans, frames: int) -> dict:
    """{span name: host ms a frame} summed over `spans`."""
    out = defaultdict(int)
    for name, _, _, t0, t1 in spans:
        out[name] += t1 - t0
    return {k: v / 1e6 / frames for k, v in sorted(out.items(),
                                                   key=lambda r: -r[1])}


def _syncs(renderer, sync) -> dict:
    """{where: count} of the host waits of one frame, from CUDA's sync
    debugging: the innermost line of the program on the stack (else the
    innermost outside torch), and the line that warned."""
    import torch

    out = defaultdict(int)

    def show(message, category, filename, lineno, file=None, line=None):
        stack = traceback.extract_stack()[:-1]
        ours = ([f for f in stack if "imbatracer_torch" in f.filename]
                or [f for f in stack if "/torch/" not in f.filename])
        at = f"{ours[-1].filename.split('/repo/')[-1]}:{ours[-1].lineno}"
        out[f"{at} ({filename.split('/')[-1]}:{lineno})"] += 1

    sync()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            renderer.step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sync()
    return dict(out)


def _stamped_profile(run, span_frames: int):
    """run._profile with the program's instruments around it.  The spans'
    record_function ranges also come back as device events (the
    profiler's GPU user annotations, `imba::` names); they are dropped
    before anything reads the device events."""
    original = run._profile

    def profiled(renderer, nf, sync):
        from imbatracer_torch.render import graphs
        from imbatracer_torch.utils import trace

        sync()
        trace.enable(True)
        dev, host, host_ns, counted = original(renderer, nf, sync)
        dev = [ev for ev in dev if not ev[2].startswith("imba::")]
        _, loops, lost = trace.drain()
        trace.enable(False)
        body = graphs.body_counts(loops)

        def timed():
            ns = []
            for _ in range(span_frames):
                t0 = time.perf_counter_ns()
                renderer.step()
                sync()
                ns.append(time.perf_counter_ns() - t0)
            return ns

        # Spans off, on, off: the frames on against those around them.
        plain = timed()
        trace.enable(True)
        wall = timed()
        spans, _, _ = trace.drain()
        trace.enable(False)
        plain += timed()
        syncs = _syncs(renderer, sync)
        steps = graphs.timer_steps("cuda")

        starts = [s for s, _, _ in dev] + [s for s, _, _, _ in host]
        ends = [e for _, e, _ in dev] + [e for _, e, _, _ in host]
        w0 = min(starts) if starts else 0
        w1 = max(max(ends) if ends else 0, w0 + host_ns)
        ctx = dict(frames=nf, window_ns=w1 - w0,
                   busy_ns=profile.busy_ns(dev, w0, w1))
        ctx.update(context(dev, (w0, w1), loops, lost, body, spans,
                           counted))
        cal = ctx["calibration"]
        hist = defaultdict(int)
        for _, _, r, _ in loops:
            hist[r] += 1
        out = {k: f(ctx) for k, f in READINGS.items()}
        out.update(
            frames=nf, span_frames=span_frames, records=len(loops),
            lost=lost, entry_launches=ctx["entry_launches"],
            sound_loops=ctx["sound_loops"], counted=counted,
            traced_outside=ctx["traced_outside"],
            inside=inside_launches(body), rounds=dict(sorted(hist.items())),
            window_ms=(w1 - w0) / 1e6, busy_ms=ctx["busy_ns"] / 1e6,
            stamped_busy_ms=(None if ctx["stamped_busy_ns"] is None
                             else ctx["stamped_busy_ns"] / 1e6),
            calibration_offset_ns=cal[0] if cal else None,
            residual_ns_max=max(cal[1]) if cal else None,
            residual_ns_median=statistics.median(cal[1]) if cal else None,
            timer_steps_ns=sorted(set(steps)),
            span_frame_ms=[ns / 1e6 for ns in wall],
            plain_frame_ms=[ns / 1e6 for ns in plain],
            host_ms_by_span=span_ms(spans, span_frames), syncs=syncs)
        run.log("[stamped] " + json.dumps(out))
        run.log("[idle by span] " + "; ".join(
            f"{name} {ns / 1e6 / nf:.3f}" for name, ns in idle_by_span(
                dev, ctx["loop_intervals"], host, w0, w1)))
        run.log("[syncs] " + "; ".join(f"{k} x{n}"
                                       for k, n in syncs.items()))
        return dev, host, host_ns, counted

    run._profile = profiled


def main(argv=None):
    import argparse

    from . import run

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--span-frames", type=int, default=4)
    args = p.parse_args(argv)
    _stamped_profile(run, args.span_frames)
    return run.main(["--workload", args.workload, "--seed", str(args.seed),
                     "--seconds", str(args.seconds), "--trace", "1"])


if __name__ == "__main__":
    sys.exit(main())
