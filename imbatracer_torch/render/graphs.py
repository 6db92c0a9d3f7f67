"""CUDA graphs of the PT bounce and of the VCM family's bands: the card's
counterpart of the JAX package's compiled band programs
(imbatracer_tpu.render.integrators.pt `_pt_band`, `_pt_phase1`,
`_pt_phase2`; vcm `_vcm_light_band`, `_vcm_camera_band`,
`_vcm_camera_phase1`, `_vcm_camera_phase2`: one `jax.jit` program for
each static signature, its bounces a `fori_loop`).

A PhaseGraph captures one call of a step over static tensors, its
`state`: step(state, overflow=...) reads them and writes its results
into them in place.  Before the capture the step runs once eagerly on
a scratch copy of the state on a side stream (torch.cuda.graph's
recipe): it builds the kernel libraries and makes each kernel's first
launch, its cudaFuncSetAttribute included, outside the capture.  One
replay() runs the captured step again.  The VCM light band is one
(render/integrators/vcm.py).

A BounceGraph is a PhaseGraph over a static carry of `lanes` lanes,
laid out as the integrator's carry dict, whose step runs one or more
lockstep bounces, each column of its result copied back into the carry
inside the same graph.  The PT bounce is depth-per-lane, so one graph
of one bounce serves phase 1, phase 2 and the banded frame alike,
replayed once a bounce; a VCM camera phase holds its bounces [a, b), so
the bounce index stays a Python constant in the capture, as JAX's
phases are compiled for their bounce range.  Short bands are padded
with dead lanes (load()).

The graphs of a scene live in its SceneGraphs (for_scene): keyed by the
caller (for PT: lanes, max_len, has_masks, has_bump, route), sharing
one memory pool, the streams and pools of conditional bodies, and one
device counter vector (`counts`: the overflow counter of
render/traverse.py's graph-ready re-trace, then a slot for every launch
counter), and dropped with the scene, so a graph never outlives the
tensors it reads.  Their static inputs that change from frame to frame
(a VCM frame's constants, camera, cache and photon grid) live there
too, in StaticInputs sets that the frame copies its values into before
the replays.  They replay one after another on the current stream.

while_loop(cond, body) is jax.lax.while_loop over state that `body`
updates in place, the masked re-trace's rounds past its first.  Inside
a capture it is a WHILE conditional node (csrc/graph_cond.cu: a
one-thread kernel sets the node's handle from the 0-d bool tensor
cond() returns, before the node and again at the end of each pass of
the body), so a replay runs the body exactly as often as the data asks,
with no host read; the body is captured on a stream of its own, its
temporaries allocated from a body pool of the scene (one a nesting
depth).  Outside a capture it loops on the host, reading cond() each
time.

The launch counters of the kernel wrappers and MASK_STATS tick in
Python, so a capture counts one step and a replay none.  A capture's
counts are therefore taken as the graph's deltas and taken back off the
counters, and every replay adds the deltas.  The counts ticked inside a
conditional body are not in the deltas: the body adds them to their
slots of `counts` on the card each time it runs, and render_frame adds
the device counts to the counters at the end of the frame, in the one
host read that also reads the overflow counter.  So the counters count
the launches a frame really makes, graphed or not.  GRAPH_STATS counts
captures, the seconds they took (warm-up included), replays and the
frames rendered again on the eager route because the overflow counter
was above 0.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import time
import weakref

import torch

from ..libbuild import NativeLib
from ..ops import khit as khit_mod
from ..ops import merge as merge_mod
from ..ops import stream_traverse as st
from ..utils.log import logger
from . import traverse as tt

GRAPH_STATS = {"captures": 0, "capture_s": 0.0, "replays": 0, "reruns": 0}


def reset_stats():
    for k in GRAPH_STATS:
        GRAPH_STATS[k] = 0


def _counters():
    """The launch counters a replay adds its deltas to."""
    return (st.LAUNCHES, khit_mod.LAUNCHES, merge_mod.LAUNCHES,
            tt.MASK_STATS)


def _snapshot():
    return [dict(c) for c in _counters()]


def _restore(before):
    for c, b in zip(_counters(), before):
        c.update(b)


def _slots():
    """(counter index, key) of every slot of a SceneGraphs' `counts` past
    slot 0, the overflow counter."""
    return [(i, k) for i, c in enumerate(_counters()) for k in c]


def _slot(counter: dict, key: str) -> int:
    i = next(i for i, c in enumerate(_counters()) if c is counter)
    return 1 + _slots().index((i, key))


def _is_max(key: str) -> bool:
    """MASK_STATS' "max_*" entries are maxima, every other count a sum."""
    return key.startswith("max_")


def add_device_counts(values):
    """Add a frame's device counts (`counts` read as a list, slot 0 the
    overflow counter) to the launch counters."""
    counters = _counters()
    for (i, k), v in zip(_slots(), values[1:]):
        c = counters[i]
        c[k] = max(c[k], v) if _is_max(k) else c[k] + v


# --------------------------------------------------------------------------
# Conditional nodes
# --------------------------------------------------------------------------

COND_LIB = NativeLib("graph_cond", "graph_cond.cu")

_cond_lib = None


def _cond_library():
    global _cond_lib
    if _cond_lib is None:
        lib = ctypes.CDLL(COND_LIB.build())
        lib.imba_cond_begin.restype = ctypes.c_int
        lib.imba_cond_begin.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_ulonglong)]
        lib.imba_cond_end.restype = ctypes.c_int
        lib.imba_cond_end.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong,
                                      ctypes.c_void_p]
        lib.imba_stream_create.restype = ctypes.c_int
        lib.imba_stream_create.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
        _cond_lib = lib
    return _cond_lib


def _body(bodies: list, device, depth: int):
    """(stream, memory pool) that the conditional bodies at nesting depth
    `depth` of a SceneGraphs (its `bodies`, made as needed) are captured
    on and allocate from: a body's capture on a stream of its own, which
    allocates from a pool its enclosing capture does not record to."""
    while len(bodies) <= depth:
        bodies.append((_body_stream(device, len(bodies)),
                       torch.cuda.graph_pool_handle()))
    return bodies[depth]


# The streams conditional bodies are captured on, one a (device, nesting
# depth), made once a process: PyTorch's streams come from a small pool
# that it hands out in turn, so one of them may be the stream a capture
# runs on.
_BODY_STREAMS = {}


def _body_stream(device, depth: int):
    key = (device.index, depth)
    if key not in _BODY_STREAMS:
        handle = ctypes.c_void_p()
        err = _cond_library().imba_stream_create(ctypes.byref(handle))
        if err != 0:
            raise RuntimeError(f"creating a stream for conditional bodies "
                               f"failed: CUDA error {err}")
        _BODY_STREAMS[key] = torch.cuda.ExternalStream(handle.value,
                                                       device=device)
    return _BODY_STREAMS[key]


# The graph whose step is running, captured or replayed by a stand-in,
# with its scene's device counts: (graph, counts).
_ACTIVE = []


@contextlib.contextmanager
def _active(graph, counts):
    _ACTIVE.append((graph, counts))
    try:
        yield
    finally:
        _ACTIVE.pop()


def _host_flag(flag) -> bool:
    """One host read of a loop's 0-d bool flag (outside a capture)."""
    return bool(flag)


def while_loop(cond, body):
    """jax.lax.while_loop over state that body() updates in place: body
    runs while cond(), a 0-d bool tensor, is true.  Inside a capture the
    loop is the graph's (a WHILE node on the card), and the counts body
    ticks go to the device counts each time it runs; elsewhere it loops
    on the host."""
    if not _ACTIVE:
        while _host_flag(cond()):
            body()
        return
    graph, counts = _ACTIVE[-1]

    def counted():
        before = _snapshot()
        body()
        for slot, (i, k) in enumerate(_slots(), 1):
            n = _counters()[i][k] - before[i][k]
            if n and not _is_max(k):
                counts[slot].add_(n)
        _restore(before)

    graph.while_loop(cond, counted)


def count(counter: dict, key: str, n):
    """Add the 0-d device tensor `n` to the device count of counter[key]
    inside a capture; nothing elsewhere (the eager route counts on the
    host)."""
    if _ACTIVE:
        counts = _ACTIVE[-1][1]
        c = counts[_slot(counter, key)]
        n = n.to(counts.dtype)
        c.copy_(torch.maximum(c, n) if _is_max(key) else c + n)


class CudaGraph:
    """A torch.cuda.CUDAGraph captured in the memory pool of `sg`, a
    SceneGraphs; its while loops are WHILE conditional nodes whose bodies
    are captured on a body stream of sg into a body pool of sg, one of
    each a nesting depth.  It holds sg's pool and body list, not sg: a
    cycle between a scene's graphs would leave their destruction to
    the cyclic collector, which may run in the middle of another
    capture."""

    def __init__(self, sg):
        self.graph = torch.cuda.CUDAGraph()
        self.pool, self.bodies, self.device = sg.pool, sg.bodies, sg.device
        self.depth = 0
        # One entry a captured conditional body: the body pool it
        # allocated from, held as long as this graph, as a capture holds
        # its graph's pool.
        self.held = []
        weakref.finalize(self, _release_pools, self.device.index, self.held)

    def capture(self, fn, state):
        """Capture fn().  `state`, the tensors fn writes, is what a
        stand-in that runs fn must restore; a capture runs nothing.  The
        cyclic collector is held off meanwhile: the objects it frees may
        own card resources whose release a capture forbids."""
        collect = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, pool=self.pool):
                fn()
        finally:
            if collect:
                gc.enable()

    def while_loop(self, cond, body):
        lib = _cond_library()
        stream, pool = _body(self.bodies, self.device, self.depth)
        flag = cond()
        handle = ctypes.c_ulonglong()
        err = lib.imba_cond_begin(
            torch.cuda.current_stream(flag.device).cuda_stream,
            stream.cuda_stream, flag.data_ptr(), ctypes.byref(handle))
        if err != 0:
            raise RuntimeError(f"adding a WHILE conditional node to the "
                               f"captured graph failed: CUDA error {err}")
        dev = flag.device.index
        self.depth += 1
        try:
            with torch.cuda.stream(stream):
                # The body's allocations come from `pool`, as a capture's
                # come from its graph's pool.
                torch._C._cuda_beginAllocateCurrentStreamToPool(dev, pool)
                self.held.append(pool)
                try:
                    body()
                    flag = cond()
                except BaseException:
                    lib.imba_cond_end(stream.cuda_stream, handle.value, None)
                    raise
                finally:
                    torch._C._cuda_endAllocateToPool(dev, pool)
                err = lib.imba_cond_end(stream.cuda_stream, handle.value,
                                        flag.data_ptr())
        finally:
            self.depth -= 1
        if err != 0:
            raise RuntimeError(f"closing a WHILE node's body failed: CUDA "
                               f"error {err}")

    def replay(self):
        self.graph.replay()


# The graph type BounceGraph captures with (tests put a stand-in here).
make_graph = CudaGraph


@contextlib.contextmanager
def _side_stream(device):
    """Run the body on a side stream of a CUDA device, ordered after the
    current stream's work and before its later work; a no-op elsewhere."""
    if device.type != "cuda":
        yield
        return
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        yield
    cur.wait_stream(side)


class PhaseGraph:
    """One captured call of `step(state, overflow=...)`, which reads and
    writes the static tensors of `state` (a dict) in place; `sg` is the
    scene's SceneGraphs."""

    def __init__(self, step, state: dict, sg):
        t0 = time.perf_counter()
        overflow = sg.overflow
        # The tensors the graph writes live as long as the graph.
        self.state, self.counts = state, sg.counts
        scratch = {k: v.clone() for k, v in state.items()}
        with _side_stream(overflow.device):
            step(scratch, overflow=torch.zeros_like(overflow))
        del scratch
        self.graph = make_graph(sg)
        before = _snapshot()
        with _active(self.graph, self.counts):
            self.graph.capture(lambda: step(state, overflow=overflow),
                               list(state.values()) + [self.counts])
        after = _snapshot()
        self.deltas = [{k: a[k] - b[k] for k in a}
                       for a, b in zip(after, before)]
        _restore(before)
        GRAPH_STATS["captures"] += 1
        GRAPH_STATS["capture_s"] += time.perf_counter() - t0

    def replay(self, times: int = 1):
        """Run the captured step `times` times, adding the capture's
        launch counts for each."""
        for _ in range(times):
            with _active(self.graph, self.counts):
                self.graph.replay()
            for c, d in zip(_counters(), self.deltas):
                for k, n in d.items():
                    c[k] += n
            GRAPH_STATS["replays"] += 1


class BounceGraph(PhaseGraph):
    """Captured bounces over a static carry of `lanes` lanes.

    `step(carry, overflow=...) -> carry` runs them; `template`, a carry
    of at most `lanes` lanes, fills the static carry for the warm-up and
    the capture."""

    def __init__(self, step, template: dict, lanes: int, sg):
        self.lanes = lanes
        self.carry = {k: (torch.empty_like(v) if v.dim() == 0 else
                          v.new_empty((lanes,) + tuple(v.shape[1:])))
                      for k, v in template.items()}
        self.load(template)

        def bounce(carry, overflow):
            out = step(carry, overflow=overflow)
            for k, v in carry.items():
                v.copy_(out[k])

        super().__init__(bounce, self.carry, sg)

    def load(self, src: dict):
        """Copy a carry of n <= lanes lanes into the static carry's first
        n lanes; the others become dead lanes (inactive), and the traced
        ray count 0."""
        n = src["active"].shape[0]
        if n > self.lanes:
            raise ValueError(f"a carry of {n} lanes does not fit a graph "
                             f"of {self.lanes}")
        for k, v in self.carry.items():
            if k == "n_rays":
                v.zero_()
            else:
                v[:n].copy_(src[k])
        self.carry["active"][n:] = False


class StaticInputs(dict):
    """Named static tensors that captured graphs read: load() copies a
    frame's values into them, each made at its first load."""

    def load(self, **values):
        for k, v in values.items():
            if k not in self:
                self[k] = torch.empty_like(v)
            if self[k] is not v:
                self[k].copy_(v)


class SceneGraphs:
    """The captured graphs of one scene, with their memory pool, the
    streams and memory pools their conditional bodies are captured on
    and allocate from, their device counts (an int32 vector: the overflow
    counter of their masked re-traces, `overflow`, then one slot for
    each launch counter) and their static inputs."""

    def __init__(self, device):
        device = torch.device(device)
        cuda = device.type == "cuda"
        if cuda and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.pool = torch.cuda.graph_pool_handle() if cuda else None
        self.bodies = []
        self.counts = torch.zeros(1 + len(_slots()), dtype=torch.int32,
                                  device=device)
        self.overflow = self.counts[0]
        self.graphs = {}
        self.statics = {}

    def bounce(self, key, step, template: dict, lanes: int) -> BounceGraph:
        """The graph of `key`, captured from `step` and `template` when
        the scene has none yet."""
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = BounceGraph(step, template, lanes, self)
        return g

    def phase(self, key, step, state: dict) -> PhaseGraph:
        """The graph of `key`, captured from `step` over `state` when the
        scene has none yet."""
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = PhaseGraph(step, state, self)
        return g

    def inputs(self, key) -> StaticInputs:
        """The static inputs of `key`, empty at first use."""
        return self.statics.setdefault(key, StaticInputs())


def render_frame(scene, graph: bool, render, what: str, total=None):
    """render(sg) -> a frame, through the scene's graphs (`sg`, its
    SceneGraphs) when `graph`, else eagerly (`sg` None).  A graphed
    frame zeroes the device counts first and reads them once at its end
    (`total(counts) -> list`, by default their own values; slot 0 the
    overflow counter) and adds them to the launch counters; with the
    overflow counter above 0, the frame is rendered again eagerly,
    counted in GRAPH_STATS["reruns"] and logged with its lanes past the
    re-trace's slots and past its rounds' cap.  A failed capture
    raises."""
    if graph:
        sg = for_scene(scene)
        sg.counts.zero_()
        out = render(sg)
        values = sg.counts.tolist() if total is None else total(sg.counts)
        add_device_counts(values)
        if values[0] == 0:
            return out
        GRAPH_STATS["reruns"] += 1
        at = lambda k: values[_slot(tt.MASK_STATS, k)]
        logger.info("%s: %d lanes of the masked re-trace left unresolved "
                    "under graphs (%d past the gathered slots, %d at the "
                    "cap of the rounds on this rank); rendered again on the "
                    "eager route", what, values[0], at("dropped"),
                    at("capped"))
    return render(None)


def _release_pools(device, held):
    """Give back a dropped graph's holds on the body pools."""
    for pool in held:
        torch._C._cuda_releasePool(device, pool)


_SCENES = {}


def for_scene(scene) -> SceneGraphs:
    """The SceneGraphs of `scene`, made at first use and dropped when the
    scene is collected."""
    key = id(scene)
    sg = _SCENES.get(key)
    if sg is None:
        sg = _SCENES[key] = SceneGraphs(scene.device)
        weakref.finalize(scene, _SCENES.pop, key, None)
    return sg
