"""Reduction of a torch.profiler trace to the numbers the per-layer
metrics read.

The trace's raw events are read once into plain tuples: device events
(start ns, end ns, name) and host events (start ns, end ns, name,
thread).  `totals` is a frozen copy of the program's
`chip_smoke.trace_totals` on those tuples: device time and count by
name, and host self time by name (an event's duration less that of the
events nested directly in it on its thread).  key_averages() is not
used: it builds an event tree in Python, which takes minutes for the
~2M events of one instanced 1080p frame.

Device busy time is the union of the device events' intervals, so two
streams' overlapping kernels count once; the idle gaps are the holes in
that union inside the traced window, each named by the innermost host
event open at its midpoint on the thread that launches the work.
"""

from __future__ import annotations

import re
from collections import defaultdict

# CUDA runtime and driver calls that put work on the device: kernel and
# graph launches, asynchronous copies and memsets.
LAUNCH_CALLS = re.compile(
    r"^(cudaLaunchKernel|cudaLaunchKernelExC|cuLaunchKernel|cuLaunchKernelEx"
    r"|cudaGraphLaunch|cudaMemcpyAsync|cudaMemsetAsync|cudaMemcpy2DAsync"
    r"|cuMemcpyAsync|cuMemsetD8Async|cuMemsetD32Async)(_v\d+)?$")


def events_from_profiler(prof):
    """(device events, host events) of a finished torch.profiler run."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == cuda:
            dev.append((s, s + d, e.name()))
        elif not e.is_async():
            host.append((s, s + d, e.name(), e.start_thread_id()))
    return dev, host


def totals(dev, host):
    """({name: [ns, count]} of the device events, the same of the host
    events by self time).  As in the program's trace_totals, a host event
    whose only child has its name counts once with that child."""
    dtot, htot, threads = {}, {}, defaultdict(list)

    def add(rows, name, ns, n=1):
        row = rows.setdefault(name, [0, 0])
        row[0] += ns
        row[1] += n

    def close(frame):                   # [end, name, self, children, last]
        _, name, ns, children, last = frame
        add(htot, name, ns, 0 if children == 1 and last == name else 1)

    for s, e, name in dev:
        add(dtot, name, e - s)
    for s, e, name, tid in host:
        threads[tid].append((s, -(e - s), name))
    for evs in threads.values():
        evs.sort()                      # parents before their children
        stack = []
        for start, neg_ns, name in evs:
            while stack and stack[-1][0] <= start:
                close(stack.pop())
            if stack:
                stack[-1][2] += neg_ns
                stack[-1][3] += 1
                stack[-1][4] = name
            stack.append([start - neg_ns, name, -neg_ns, 0, None])
        while stack:
            close(stack.pop())
    return dtot, htot


def busy_intervals(dev, t0=None, t1=None):
    """The union of the device events' intervals, clipped to [t0, t1]:
    a sorted list of disjoint (start, end)."""
    out = []
    for s, e, _ in sorted(dev):
        if t0 is not None:
            s = max(s, t0)
        if t1 is not None:
            e = min(e, t1)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def busy_ns(dev, t0=None, t1=None) -> int:
    return sum(e - s for s, e in busy_intervals(dev, t0, t1))


def launch_calls(host) -> int:
    """Host calls that put work on the device."""
    return sum(1 for _, _, name, _ in host if LAUNCH_CALLS.match(name))


def main_thread(host):
    counts = defaultdict(int)
    for ev in host:
        if LAUNCH_CALLS.match(ev[2]):
            counts[ev[3]] += 1
    if not counts:
        for ev in host:
            counts[ev[3]] += 1
    return max(counts, key=counts.get) if counts else None


def idle_gaps(dev, host, t0: int, t1: int, top: int = 10):
    """The device's idle time in [t0, t1] by what the host was doing:
    [[innermost host event at each gap's midpoint, ns summed]], longest
    first, at most `top`."""
    busy = busy_intervals(dev, t0, t1)
    gaps, cur = [], t0
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if t1 > cur:
        gaps.append((cur, t1))
    tid = main_thread(host)
    evs = sorted((s, -(e - s), name) for s, e, name, t in host if t == tid)
    sums = defaultdict(int)
    stack = []                          # open events, outermost first
    j = 0

    def resolve(gap):
        # Events on one thread nest: what is still open on the stack at
        # the midpoint, innermost last, covers it.
        mid = (gap[0] + gap[1]) // 2
        while stack and stack[-1][0] <= mid:
            stack.pop()
        sums[stack[-1][1] if stack else "(no host event)"] += gap[1] - gap[0]

    for s, neg, name in evs:
        while j < len(gaps) and (gaps[j][0] + gaps[j][1]) // 2 < s:
            resolve(gaps[j])
            j += 1
        while stack and stack[-1][0] <= s:
            stack.pop()
        stack.append((s - neg, name))
    for gap in gaps[j:]:
        resolve(gap)
    return sorted(([k, v] for k, v in sums.items()), key=lambda r: -r[1])[:top]


def group_ns(dtot, patterns) -> tuple:
    """(ns, launches) of the device events whose name matches any of the
    regular expressions `patterns`."""
    rx = [re.compile(p) for p in patterns]
    ns = n = 0
    for name, (t, c) in dtot.items():
        if any(r.search(name) for r in rx):
            ns += t
            n += c
    return ns, n


def count_matching(dtot, pattern) -> int:
    rx = re.compile(pattern)
    return sum(c for name, (_, c) in dtot.items() if rx.search(name))
