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
one memory pool and one overflow counter (render/traverse.py's
graph-ready re-trace), and dropped with the scene, so a graph never
outlives the tensors it reads.  Their static inputs that change from
frame to frame (a VCM frame's constants, camera, cache and photon grid)
live there too, in StaticInputs sets that the frame copies its values
into before the replays.  They replay one after another on the current
stream.

The launch counters of the kernel wrappers and MASK_STATS tick in
Python, so a capture counts one step and a replay none.  A capture's
counts are therefore taken as the graph's deltas and taken back off the
counters, and every replay adds the deltas: the counters count the
launches a frame makes, graphed or not.  GRAPH_STATS counts captures,
replays and the frames rendered again on the eager route because the
overflow counter was above 0.
"""

from __future__ import annotations

import contextlib
import weakref

import torch

from ..ops import khit as khit_mod
from ..ops import merge as merge_mod
from ..ops import stream_traverse as st
from ..utils.log import logger
from . import traverse as tt

GRAPH_STATS = {"captures": 0, "replays": 0, "reruns": 0}


def reset_stats():
    for k in GRAPH_STATS:
        GRAPH_STATS[k] = 0


def _counters():
    """The launch counters a replay adds its deltas to."""
    return (st.LAUNCHES, khit_mod.LAUNCHES, merge_mod.LAUNCHES,
            tt.MASK_STATS)


def _snapshot():
    return [dict(c) for c in _counters()]


class CudaGraph:
    """A torch.cuda.CUDAGraph captured in the memory pool `pool`."""

    def __init__(self, device, pool):
        self.graph = torch.cuda.CUDAGraph()
        self.pool = pool

    def capture(self, fn, state):
        """Capture fn().  `state`, the tensors fn writes, is what a
        stand-in that runs fn must restore; a capture runs nothing."""
        with torch.cuda.graph(self.graph, pool=self.pool):
            fn()

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
    writes the static tensors of `state` (a dict) in place."""

    def __init__(self, step, state: dict, overflow, pool):
        device = overflow.device
        # The tensors the graph writes live as long as the graph.
        self.state, self.overflow = state, overflow
        scratch = {k: v.clone() for k, v in state.items()}
        with _side_stream(device):
            step(scratch, overflow=torch.zeros_like(overflow))
        del scratch
        self.graph = make_graph(device, pool)
        before = _snapshot()
        self.graph.capture(lambda: step(state, overflow=overflow),
                           list(state.values()) + [overflow])
        after = _snapshot()
        self.deltas = [{k: a[k] - b[k] for k in a}
                       for a, b in zip(after, before)]
        for c, b in zip(_counters(), before):
            c.update(b)
        GRAPH_STATS["captures"] += 1

    def replay(self, times: int = 1):
        """Run the captured step `times` times, adding the capture's
        launch counts for each."""
        for _ in range(times):
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

    def __init__(self, step, template: dict, lanes: int, overflow, pool):
        self.lanes = lanes
        self.carry = {k: (torch.empty_like(v) if v.dim() == 0 else
                          v.new_empty((lanes,) + tuple(v.shape[1:])))
                      for k, v in template.items()}
        self.load(template)

        def bounce(carry, overflow):
            out = step(carry, overflow=overflow)
            for k, v in carry.items():
                v.copy_(out[k])

        super().__init__(bounce, self.carry, overflow, pool)

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
    overflow counter of their masked re-traces (a 0-d int32 tensor) and
    their static inputs."""

    def __init__(self, device):
        device = torch.device(device)
        self.pool = (torch.cuda.graph_pool_handle()
                     if device.type == "cuda" else None)
        self.overflow = torch.zeros((), dtype=torch.int32, device=device)
        self.graphs = {}
        self.statics = {}

    def bounce(self, key, step, template: dict, lanes: int) -> BounceGraph:
        """The graph of `key`, captured from `step` and `template` when
        the scene has none yet."""
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = BounceGraph(step, template, lanes,
                                               self.overflow, self.pool)
        return g

    def phase(self, key, step, state: dict) -> PhaseGraph:
        """The graph of `key`, captured from `step` over `state` when the
        scene has none yet."""
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = PhaseGraph(step, state, self.overflow,
                                              self.pool)
        return g

    def inputs(self, key) -> StaticInputs:
        """The static inputs of `key`, empty at first use."""
        return self.statics.setdefault(key, StaticInputs())


def render_frame(scene, graph: bool, render, what: str, total=None):
    """render(sg) -> a frame, through the scene's graphs (`sg`, its
    SceneGraphs) when `graph`, else eagerly (`sg` None).  A graphed
    frame zeroes the overflow counter first and reads it once at its
    end (`total(counter) -> int`, by default its own value); above 0,
    the frame is rendered again eagerly, counted in
    GRAPH_STATS["reruns"] and logged.  A failed capture raises."""
    if graph:
        sg = for_scene(scene)
        sg.overflow.zero_()
        out = render(sg)
        lost = int(sg.overflow) if total is None else total(sg.overflow)
        if lost == 0:
            return out
        GRAPH_STATS["reruns"] += 1
        logger.info("%s: %d lanes of the masked re-trace left unresolved "
                    "under graphs; rendered again on the eager route", what,
                    lost)
    return render(None)


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
