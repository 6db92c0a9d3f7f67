"""The port's tracing (utils/trace.py) and the re-trace's loop log
(render/graphs.py, csrc/graph_cond.cu).

On the CPU: spans off record nothing and cost the shared no-op context;
spans on record their nesting, parents and frame index, and drain()
empties them; the host while loop is the one it was (no loop id, no
log); a graphed frame (the stand-in graph of tests/torch_graph_guard.py)
reads its device counts inside a `wait:` span, its collect cache's count
too in a VCM frame; the loop log's decoding, its count of records past
the capacity and body_counts' arithmetic on records written by hand.
Marked `cuda` (they skip without a card): a captured LoopTest loop made
to run 1 to `cap` rounds logs one record a replay, its exit stamp not
before its entry's and its rounds the loop's own round counter, and a
full log counts the records it could not keep; the card's %globaltimer
steps.  tests/test_torch_kernel_cuda.py holds the masked re-trace's own
loop on the card.
"""

import pytest
import torch

from imbatracer_torch.frontend.renderer import (ProgressiveRenderer,
                                                RenderSettings,
                                                camera_for_scene)
from imbatracer_torch.ops import stream_traverse as st
from imbatracer_torch.render import graphs
from imbatracer_torch.render import traverse as tt
from imbatracer_torch.render.integrators.pt import render_pt_frame
from imbatracer_torch.render.integrators.vcm import render_vcm_frame
from imbatracer_torch.scene.procedural import make_masked_scene
from imbatracer_torch.utils import trace
from torch_graph_guard import standin  # noqa: F401
from torch_threads import cap_torch_threads

cap_torch_threads()

SIZE = 16


@pytest.fixture
def tracing():
    trace.enable(True)
    try:
        yield
    finally:
        trace.enable(False)
        trace.drain()


@pytest.fixture(scope="module")
def masked():
    return make_masked_scene(device="cpu")


def _pt_frames(scene, meta, n, **kw):
    s = RenderSettings(width=SIZE, height=SIZE, max_path_len=3)
    cam = camera_for_scene(meta, s, "cpu")
    r = ProgressiveRenderer(
        lambda i: render_pt_frame(scene, cam, i, SIZE, SIZE, max_len=3,
                                  has_masks=meta.has_masks, **kw), s, "cpu")
    for _ in range(n):
        r.step()
    return r


def test_spans_off_record_nothing(masked):
    scene, meta = masked
    assert not trace.ENABLED
    assert trace.span("frame", frame=0) is trace.NOOP
    assert trace.span("wait:counts") is trace.NOOP
    _pt_frames(scene, meta, 1)
    spans, loops, lost = trace.drain()
    assert spans == [] and loops == [] and lost == 0


def test_spans_nest_with_parents_and_frames(tracing):
    with trace.span("frame", frame=7):
        with trace.span("band"):
            with trace.span("wait:x"):
                pass
        with trace.span("replay"):
            pass
    with trace.span("capture"):
        pass
    spans, _, _ = trace.drain()
    assert [s[:3] for s in spans] == [("wait:x", "band", 7),
                                      ("band", "frame", 7),
                                      ("replay", "frame", 7),
                                      ("frame", None, 7),
                                      ("capture", None, None)]
    at = {s[0]: s[3:] for s in spans}
    for inner, outer in (("wait:x", "band"), ("band", "frame"),
                         ("replay", "frame")):
        assert at[outer][0] <= at[inner][0] <= at[inner][1] <= at[outer][1]
    assert at["band"][1] <= at["replay"][0]
    assert trace.drain() == ([], [], 0)


def test_host_while_loop_is_unchanged(tracing):
    """Outside a capture while_loop loops on the host: the LoopTest gets
    no loop id, nothing joins LOOP_DELTAS, and no span is recorded."""
    need = torch.tensor([True, False, True])
    rounds = torch.zeros((), dtype=torch.int32)
    test = graphs.LoopTest(need, need.sum(dtype=torch.int32), rounds, 5)
    n_loops = len(graphs.LOOP_DELTAS)
    runs = []

    def body():
        runs.append(1)
        need[int(need.nonzero()[0])] = False

    assert graphs.while_loop(test, body) == ()
    assert len(runs) == 2 and int(rounds) == 3
    assert test.loop is None and len(graphs.LOOP_DELTAS) == n_loops
    assert trace.drain() == ([], [], 0)


def test_graphed_frame_reads_its_counts_in_a_wait_span(masked, standin,
                                                       tracing):
    """A graphed PT frame's one read of its device counts is a
    `wait:counts` span of its `frame`; its bands replay the captured
    bounce inside `band` spans, each band's camera rays a span of their
    own, where the frame number's copy to the device waits; the first
    frame captures, the second replays only; a compacted frame reads its
    live count in `wait:compact` inside `compaction`.  The masked
    scene's re-trace loops took loop ids."""
    scene, meta = masked
    n_loops = len(graphs.LOOP_DELTAS)
    _pt_frames(scene, meta, 2)
    spans, _, _ = trace.drain()
    assert len(graphs.LOOP_DELTAS) > n_loops
    by = lambda name, f: [s for s in spans if s[0] == name and s[2] == f]
    for f in (0, 1):
        assert [s[1] for s in by("wait:counts", f)] == ["frame"]
        assert [s[1] for s in by("wait:seed", f)] == ["camera_rays"]
        assert by("band", f) and by("replay", f) and by("camera_rays", f)
        assert {s[1] for s in by("replay", f)} == {"band"}
        assert {s[1] for s in by("camera_rays", f)} == {"band"}
        assert not by("rerun", f)
    assert by("capture", 0) and not by("capture", 1)
    assert [s[2] for s in spans if s[0] == "frame"] == [0, 1]
    _pt_frames(scene, meta, 1, compact=True)
    spans, _, _ = trace.drain()
    assert [s[1] for s in spans if s[0] == "wait:compact"] == ["compaction"]
    assert sorted(s[0] for s in spans if s[0].startswith("wait:")) == [
        "wait:compact", "wait:counts", "wait:seed"]


def test_graphed_vcm_frame_spans(masked, standin, tracing):
    """A graphed VCM frame: its constants' copy to the device first,
    its phases' spans in order, the collect cache's read in
    `wait:collect` inside `select`, the counts' read at the end."""
    scene, meta = masked
    s = RenderSettings(width=SIZE, height=SIZE, max_path_len=3)
    cam = camera_for_scene(meta, s, "cpu")
    render_vcm_frame(scene, cam, 1, 0.05, width=SIZE, height=SIZE, max_len=3,
                     light_path_count=64, has_masks=True, graph=True)
    spans, _, _ = trace.drain()
    top = [name for name, parent, *_ in spans if parent is None]
    assert top == ["wait:constants", "light_pass", "select", "photon_grid",
                   "camera_pass", "wait:counts"]
    waits = [(name, parent) for name, parent, *_ in spans
             if name.startswith("wait:")]
    assert waits == [("wait:constants", None), ("wait:collect", "select"),
                     ("wait:counts", None)]


def test_loop_log_decoding_and_lost_records(monkeypatch):
    """drain_loops decodes (entry, exit, rounds | loop << 32) records,
    counts those past the capacity as lost and empties the log."""
    monkeypatch.setattr(graphs, "LOOP_LOG_RECORDS", 2)
    sg = graphs.SceneGraphs("cpu")
    assert sg.loops.numel() == 1 + 2 * graphs.LOOP_WORDS
    sg.loops[0] = 3
    sg.loops[1:] = torch.tensor([10, 25, (5 << 32) | 2,
                                 30, 31, (6 << 32) | 1])
    assert sg.drain_loops() == ([(10, 25, 2, 5), (30, 31, 1, 6)], 1)
    assert int(sg.loops[0]) == 0
    assert sg.drain_loops() == ([], 0)


def test_body_counts_are_each_runs_counts_times_its_runs(monkeypatch):
    closest = graphs._slot(st.LAUNCHES, "closest_hit_instanced")
    rounds = graphs._slot(tt.MASK_STATS, "rounds")
    monkeypatch.setattr(graphs, "LOOP_DELTAS",
                        [[(closest, 1), (rounds, 1)], [(closest, 2)]])
    records = [(0, 9, 4, 0), (10, 11, 1, 0), (12, 20, 3, 1)]
    assert graphs.body_counts(records) == {
        ("stream_traverse", "closest_hit_instanced"): 3 + 0 + 4,
        ("mask_stats", "rounds"): 3}
    assert graphs.body_counts([]) == {}
    assert len(graphs.COUNTER_NAMES) == len(graphs._counters())


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the WHILE node and its stamps "
                    "have no CPU or interpret mode")
    return torch.device("cuda", torch.cuda.current_device())


def _loop_graph(dev, cap):
    """A captured LoopTest loop over `pattern`'s flags: each pass shifts
    the need flags one lane down and counts a round in MASK_STATS, so a
    flag at lane k asks for k + 1 passes (at most cap - 1 run)."""
    n = 4096 + 37
    state = {"pattern": torch.zeros(n, dtype=torch.bool, device=dev),
             "need": torch.zeros(n, dtype=torch.bool, device=dev),
             "rounds": torch.zeros((), dtype=torch.int32, device=dev)}

    def step(s_, overflow):
        s_["need"].copy_(s_["pattern"])
        test = graphs.LoopTest(s_["need"],
                               s_["pattern"].sum(dtype=torch.int32),
                               s_["rounds"], cap)

        def body():
            tt.MASK_STATS["rounds"] += 1
            shifted = torch.zeros_like(s_["need"])
            shifted[:-1] = s_["need"][1:]
            s_["need"].copy_(shifted)

        graphs.while_loop(test, body)

    sg = graphs.SceneGraphs(dev)
    return sg, sg.phase("loop_log", step, state), state


@pytest.mark.cuda
def test_cuda_loop_log_holds_each_loops_rounds(cuda_device):
    cap = 6
    sg, g, state = _loop_graph(cuda_device, cap)
    sg.drain_loops()
    for flags, rounds in (((), 1), ((0,), 2), ((3, 100), cap), ((2,), 4),
                          ((4095,), cap)):
        state["pattern"].zero_()
        state["pattern"][list(flags)] = True
        g.replay()
        torch.cuda.synchronize()
        records, lost = sg.drain_loops()
        assert lost == 0 and len(records) == 1, flags
        t0, t1, got, loop = records[0]
        assert got == int(state["rounds"]) == rounds, flags
        assert 0 < t0 <= t1, flags
        assert graphs.LOOP_DELTAS[loop] == [
            (graphs._slot(tt.MASK_STATS, "rounds"), 1)]
        assert graphs.body_counts(records) == {
            ("mask_stats", "rounds"): rounds - 1}


@pytest.mark.cuda
def test_cuda_full_loop_log_counts_what_it_drops(cuda_device, monkeypatch):
    monkeypatch.setattr(graphs, "LOOP_LOG_RECORDS", 2)
    sg, g, state = _loop_graph(cuda_device, 4)
    sg.drain_loops()
    state["pattern"][1] = True
    for _ in range(5):
        g.replay()
    records, lost = sg.drain_loops()
    assert len(records) == 2 and lost == 3
    assert [r[2] for r in records] == [3, 3]
    assert records[0][1] <= records[1][0]


@pytest.mark.cuda
def test_cuda_globaltimer_steps(cuda_device):
    steps = graphs.timer_steps(cuda_device, 32)
    assert len(steps) == 32 and all(0 < s < 100_000 for s in steps)
