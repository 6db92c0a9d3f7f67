"""The CPU's stand-ins for the CUDA-graph route (render/graphs.py), shared
by tests/test_torch_graphs.py and tests/test_torch_vcm_graphs.py.

* StandInGraph and the `standin` fixture: the graph object on the CPU,
  where graphs do not exist; it runs the captured step at each replay,
  so the route's bookkeeping (static state, padding of short bands,
  keys, launch deltas, the device counts, the overflow counter and the
  eager rerun) runs as it does on the card.  Its while loops run their
  body once at the capture, as a capture runs the body's Python once,
  and at a replay while their flag is true, as a WHILE node does.
* no_sync: a context that raises HostRead on any host read of a tensor
  and on any tensor made from host data, as a failed capture would; the
  kernel wrappers' plain versions, which stand for one launch each on
  the card, and the host read of a while loop's flag, which a WHILE
  node makes on the card, run with it lifted.
"""

import contextlib

import pytest
import torch

from imbatracer_torch.ops import khit as kh
from imbatracer_torch.ops import merge as merge_mod
from imbatracer_torch.ops import stream_traverse as st
from imbatracer_torch.render import graphs
from imbatracer_torch.render.integrators import pt as tpt


class StandInGraph:
    """The graph object on the CPU: capture() runs the bounce once, as a
    capture runs its Python, and puts back the tensors it wrote, as a
    capture launches nothing; replay() runs it again with the launch
    counters held, as a replay ticks none of them.  while_loop() runs
    the body once at the capture and, at a replay, while the flag is
    true."""

    def __init__(self, sg):
        self.fn = None

    def while_loop(self, cond, body):
        if self.fn is None:
            cond()
            body()
            cond()
            return
        while graphs._host_flag(cond()):
            body()

    def capture(self, fn, state):
        saved = [t.clone() for t in state]
        fn()
        for t, s in zip(state, saved):
            t.copy_(s)
        self.fn = fn

    def replay(self):
        before = graphs._snapshot()
        self.fn()
        for c, b in zip(graphs._counters(), before):
            c.update(b)


@pytest.fixture
def standin(monkeypatch):
    monkeypatch.setattr(graphs, "make_graph", StandInGraph)
    monkeypatch.setattr(tpt, "use_graphs", lambda dev, bvh: not bvh.pairs)
    graphs.reset_stats()


class HostRead(AssertionError):
    pass


_GUARD = {"on": False}


@contextlib.contextmanager
def _lifted():
    was = _GUARD["on"]
    _GUARD["on"] = False
    try:
        yield
    finally:
        _GUARD["on"] = was


def _bool_index(idx):
    items = idx if isinstance(idx, tuple) else (idx,)
    return any(torch.is_tensor(i) and i.dtype == torch.bool and i.dim() > 0
               for i in items)


@contextlib.contextmanager
def no_sync(monkeypatch):
    """Raise HostRead on any host read of a tensor and on any tensor made
    from host data while the body runs; the kernel wrappers' plain
    versions (st.traverse, kh.khit, merge_plain, whose pair_chunks reads
    its pair count), which stand for one launch each on the card, and
    graphs._host_flag, a while loop's flag, read by a WHILE node on the
    card, run unguarded."""
    T = torch.Tensor

    def refuse(name, orig):
        def f(*a, **k):
            if _GUARD["on"]:
                raise HostRead(name)
            return orig(*a, **k)
        return f

    for name in ("__bool__", "__int__", "__float__", "item", "tolist",
                 "numpy", "nonzero"):
        monkeypatch.setattr(T, name, refuse(name, getattr(T, name)))
    for name in ("tensor", "as_tensor"):
        orig = getattr(torch, name)

        def make(data, *a, _orig=orig, _name=name, **k):
            if _GUARD["on"] and not torch.is_tensor(data):
                raise HostRead(f"torch.{_name} of host data")
            return _orig(data, *a, **k)
        monkeypatch.setattr(torch, name, make)
    for name in ("__getitem__", "__setitem__"):
        orig = getattr(T, name)

        def index(self, idx, *a, _orig=orig, _name=name):
            if _GUARD["on"] and _bool_index(idx):
                raise HostRead(f"boolean-mask {_name}")
            return _orig(self, idx, *a)
        monkeypatch.setattr(T, name, index)
    for mod, name in ((st, "traverse"), (kh, "khit"),
                      (merge_mod, "merge_plain"), (graphs, "_host_flag")):
        orig = getattr(mod, name)

        def kernel(*a, _orig=orig, **k):
            with _lifted():
                return _orig(*a, **k)
        monkeypatch.setattr(mod, name, kernel)
    _GUARD["on"] = True
    try:
        yield
    finally:
        _GUARD["on"] = False
