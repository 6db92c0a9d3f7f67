"""CUDA graphs of the PT bounce: the card's counterpart of the JAX
package's compiled band programs (imbatracer_tpu.render.integrators.pt
`_pt_band`, `_pt_phase1`, `_pt_phase2`: one `jax.jit` program for each
static signature, its bounces a `fori_loop`).

A BounceGraph owns a static carry of `lanes` lanes, laid out as
pt._init_carry's dict, and one captured bounce: the step function on
the static carry, each column of its result copied back into the carry
inside the same graph.  One replay() advances the carry one bounce in
place.  Before the capture one eager bounce runs on a scratch copy of
the carry on a side stream (torch.cuda.graph's recipe): it builds the
kernel libraries and makes each kernel's first launch, its
cudaFuncSetAttribute included, outside the capture.  The bounce is
depth-per-lane, so one graph serves phase 1, phase 2 and the banded
frame alike; short bands are padded with dead lanes (load()).

The graphs of a scene live in its SceneGraphs (for_scene): keyed by
(lanes, max_len, has_masks, has_bump, route), sharing one memory pool
and one overflow counter (render/traverse.py's graph-ready re-trace),
and dropped with the scene, so a graph never outlives the tensors it
reads.  They replay one after another on the current stream.

The launch counters of the kernel wrappers and MASK_STATS tick in
Python, so a capture counts one bounce and a replay none.  A capture's
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
from ..ops import stream_traverse as st
from . import traverse as tt

GRAPH_STATS = {"captures": 0, "replays": 0, "reruns": 0}


def reset_stats():
    for k in GRAPH_STATS:
        GRAPH_STATS[k] = 0


def _counters():
    """The launch counters a replay adds its deltas to."""
    return (st.LAUNCHES, khit_mod.LAUNCHES, tt.MASK_STATS)


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


class BounceGraph:
    """One captured bounce over a static carry of `lanes` lanes.

    `step(carry, overflow=...) -> carry` is the bounce; `template`, a carry
    of at most `lanes` lanes, fills the static carry for the warm-up and
    the capture."""

    def __init__(self, step, template: dict, lanes: int, overflow, pool):
        self.lanes = lanes
        self.carry = {k: (torch.empty_like(v) if v.dim() == 0 else
                          v.new_empty((lanes,) + tuple(v.shape[1:])))
                      for k, v in template.items()}
        self.load(template)
        device = overflow.device
        scratch = {k: v.clone() for k, v in self.carry.items()}
        with _side_stream(device):
            step(scratch, overflow=torch.zeros_like(overflow))
        del scratch

        def bounce():
            out = step(self.carry, overflow=overflow)
            for k, v in self.carry.items():
                v.copy_(out[k])

        self.graph = make_graph(device, pool)
        before = _snapshot()
        self.graph.capture(bounce, list(self.carry.values()) + [overflow])
        after = _snapshot()
        self.deltas = [{k: a[k] - b[k] for k in a}
                       for a, b in zip(after, before)]
        for c, b in zip(_counters(), before):
            c.update(b)
        GRAPH_STATS["captures"] += 1

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

    def replay(self, times: int = 1):
        """Advance the static carry `times` bounces, adding the capture's
        launch counts for each."""
        for _ in range(times):
            self.graph.replay()
            for c, d in zip(_counters(), self.deltas):
                for k, n in d.items():
                    c[k] += n
            GRAPH_STATS["replays"] += 1


class SceneGraphs:
    """The captured bounces of one scene, with their memory pool and the
    overflow counter of their masked re-traces (a 0-d int32 tensor)."""

    def __init__(self, device):
        device = torch.device(device)
        self.pool = (torch.cuda.graph_pool_handle()
                     if device.type == "cuda" else None)
        self.overflow = torch.zeros((), dtype=torch.int32, device=device)
        self.graphs = {}

    def bounce(self, key, step, template: dict, lanes: int) -> BounceGraph:
        """The graph of `key`, captured from `step` and `template` when
        the scene has none yet."""
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = BounceGraph(step, template, lanes,
                                               self.overflow, self.pool)
        return g


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
