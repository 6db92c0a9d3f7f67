"""Host spans of a frame's phases, and the drain of the card's loop logs.

Off unless a caller turns it on (enable).  Off, span(name) costs one
global read and returns one shared no-op context.  On, it records
(name, parent, frame, t0_ns, t1_ns) on time.perf_counter_ns: `parent`
the name of the span open around it (None at the top), `frame` the
index the enclosing `frame` span carries (ProgressiveRenderer.step);
while the torch profiler runs, the span also opens
torch.profiler.record_function("imba::" + name), so that it sits on the
profiler's host timeline beside the device events.

Spans mark layer boundaries only, never a kernel launch (the modules'
LAUNCHES count those): `frame`; the PT and camera passes' `camera_rays`,
`band` and `compaction`; VCM's `light_pass`, `select`, `photon_grid`,
`camera_pass`; the graphs' `replay`, `capture` and `rerun`; the
traversal's `dispatch`, which runs on the eager route (a graph runs it
at its capture only); and `wait:<what>` around each copy on a graphed
frame's path that makes the host wait for the queue to drain: the reads
`wait:counts` (graphs.render_frame), `wait:collect`
(light_cache.CollectCache.check) and `wait:compact` (pt.compact_lanes),
and the copies of host numbers to the card `wait:seed` (core/rng.py, a
PT band's frame number) and `wait:constants` (vcm.frame_constants).

drain() returns the spans and the records of the scenes' loop logs
(render/graphs.py SceneGraphs.drain_loops), the only place the host
reads those logs; enable(True) empties both.
"""

from __future__ import annotations

import contextlib
import time

import torch

ENABLED = False
NOOP = contextlib.nullcontext()

_SPANS = []     # closed spans: (name, parent, frame, t0_ns, t1_ns)
_OPEN = []      # the open spans, innermost last


class _Span:
    __slots__ = ("name", "frame", "parent", "t0", "marker")

    def __init__(self, name: str, frame):
        self.name, self.frame = name, frame

    def __enter__(self):
        outer = _OPEN[-1] if _OPEN else None
        self.parent = outer.name if outer else None
        if self.frame is None and outer is not None:
            self.frame = outer.frame
        self.marker = None
        if torch.autograd._profiler_enabled():
            self.marker = torch.profiler.record_function("imba::" + self.name)
            self.marker.__enter__()
        _OPEN.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _OPEN.pop()
        if self.marker is not None:
            self.marker.__exit__(*exc)
        _SPANS.append((self.name, self.parent, self.frame, self.t0, t1))
        return False


def span(name: str, frame=None):
    """A context marking the phase `name` (of frame `frame`, else of the
    enclosing span's frame) while tracing is on; NOOP while it is off."""
    if not ENABLED:
        return NOOP
    return _Span(name, frame)


def enable(on: bool = True):
    """Turn spans on or off; turning them on empties the recorded spans
    and the live scenes' loop logs (one launch a scene)."""
    global ENABLED
    if on:
        from ..render import graphs     # graphs imports this module

        _SPANS.clear()
        for sg in graphs.scenes():
            sg.empty_loops()
    ENABLED = on


def drain() -> tuple:
    """(spans, loops, lost) recorded since tracing was turned on or last
    drained, both emptied: the closed spans in the order they closed;
    the live scenes' logged loops, (entry ns, exit ns, rounds, loop id)
    on the card's %globaltimer (graphs.body_counts tells what their
    bodies launched); the loops past the logs' capacity.  Reads the
    device: call it outside the frames it reports."""
    from ..render import graphs

    spans = list(_SPANS)
    _SPANS.clear()
    loops, lost = [], 0
    for sg in graphs.scenes():
        records, n = sg.drain_loops()
        loops += records
        lost += n
    return spans, loops, lost

