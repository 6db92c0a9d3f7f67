"""The port's CUDA-graph route (render/graphs.py) and the graph-ready
masked re-trace (render/traverse.py) on the CPU, where graphs do not
exist: a stand-in for the graph object runs the captured bounce at each
replay, so the route's bookkeeping (static carry, padding of short
bands, keys, launch deltas, the overflow counter and the eager rerun)
runs as it does on the card.

* The sync-free re-trace on the stacked masked layers of
  tests/test_torch_masks.py (1, 6, 10, 12 and 16 layers: 16 needs 17
  rounds of the two-level re-trace, more than the 12 fixed rounds it
  once ran), over a flat BVH (khit) and a two-level one: hits and
  occlusion flags equal to the eager route's bit for bit, and to JAX's
  masked traversal as test_masked_traversal_matches_jax holds them (t
  within 1e-5 relative, ids and flags equal), with the overflow counter
  0 at the route's cap on the rounds; with the cap cut to 2 khit rounds
  or 12 dispatches the counter is 0 when every lane needs at most that
  many and above 0 beyond them.  A lane past the gathered slots counts
  too.  Under a stand-in capture the device counts hold the rounds the
  eager loop ran, and a loop whose flag is false leaves the slot state
  as it was.
* A no-sync guard: one `_pt_bounce` of a few hundred lanes on each
  route (flat unmasked, flat masked, two-level masked; the masked ones
  with an env map, bump maps and every material kind) under a context
  that raises on any host read (Tensor.__bool__, __int__, __float__,
  item, tolist, numpy, nonzero, a boolean-mask index) and on
  torch.tensor / torch.as_tensor of host data.  The kernel wrappers'
  plain versions, which stand for one launch each, run with the guard
  lifted.  It passes for the graph-ready bounce and trips on the eager
  khit loop's nonzero.
* Film parity: PT frames through the graph route (the stand-in graph)
  equal to the eager route's bit for bit, traced rays equal, banded and
  compacted, with short last bands padded (the cornell, the masked
  scene, a two-level masked scene), and to JAX's render_pt_frame within
  tests/test_torch_pt.py's tolerances; a frame whose re-trace overflows
  is rendered again eagerly, bit for bit, and counted.
* Bookkeeping: one capture a key, replays a band-bounce, launch counts
  of a graphed frame equal to the eager frame's (on the masked scene,
  plus one first round for each empty dispatch, with the rounds past
  the first from the device counts), load() padding and its size check,
  and graph=True refused where graphs cannot run.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imbatracer_tpu.render import traverse as jtr
from imbatracer_tpu.render.camera import make_camera as jcamera
from imbatracer_tpu.render.integrators.pt import render_pt_frame as jrender
from imbatracer_tpu.scene import procedural as jproc
from imbatracer_torch.accel.device import DeviceBvh
from imbatracer_torch.accel.instancing import build_two_level
from imbatracer_torch.convert import scene_from_numpy, scene_to_numpy
from imbatracer_torch.frontend.renderer import (RenderSettings,
                                                camera_for_scene)
from imbatracer_torch.ops import dispatch as dp
from imbatracer_torch.ops import khit as kh
from imbatracer_torch.ops import stream_traverse as st
from imbatracer_torch.render import graphs
from imbatracer_torch.render import traverse as tt
from imbatracer_torch.render.camera import make_camera as tcamera
from imbatracer_torch.render.integrators import pt as tpt
from imbatracer_torch.render.intersect import BIG
from imbatracer_torch.scene.build import build_scene
from imbatracer_torch.scene.generate import write_instanced_scene
from imbatracer_torch.scene.procedural import make_still_life_like
from test_torch_masks import _layers
from torch_graph_guard import HostRead, no_sync, standin  # noqa: F401
from torch_threads import cap_torch_threads

cap_torch_threads()


# --------------------------------------------------------------------------
# Scenes
# --------------------------------------------------------------------------

def _two_level_layers(layers):
    """_layers' triangles under one identity instance of a two-level BVH
    (flat ids equal mesh ids, so _layers' alpha functions apply)."""
    f, half = (2, 1) if layers == 1 else (4, 2)
    tris = [((-f, 0, f), (f, 0, f), (f, 0, -f)),
            ((-f, 0, f), (f, 0, -f), (-f, 0, -f))]
    for k in range(layers):
        y = 1.0 + k
        tris += [((-half, y, half), (half, y, half), (half, y, -half)),
                 ((-half, y, half), (half, y, -half), (-half, y, -half))]
    v = [np.asarray([t[i] for t in tris], np.float32) for i in range(3)]
    tl = build_two_level([tuple(v)], [dict(mesh_idx=0, matrix=np.eye(4),
                                           face_base=0)])
    return DeviceBvh.from_two_level(tl.sbox, tl.tiles, tl.tile_idx,
                                    tl.inst_of, tl.itab, device="cpu")


@pytest.fixture(scope="module")
def procedural():
    out = {}
    for name, build in (("cornell", jproc.make_cornell_scene),
                        ("masked", jproc.make_masked_scene)):
        js, meta = build()
        out[name] = (js, scene_from_numpy(scene_to_numpy(js), "cpu"), meta)
    return out


@pytest.fixture(scope="module")
def two_level_masked(tmp_path_factory):
    path = write_instanced_scene(str(tmp_path_factory.mktemp("graphs")),
                                 counts=dict(ground=1, sphere=3, blob=1,
                                             crystal=1, card=6, panel=1))
    scene, meta = build_scene(path, quiet=True, device="cpu")
    assert scene.bvh.two_level and meta.has_masks
    return scene, meta


# --------------------------------------------------------------------------
# The sync-free re-trace
# --------------------------------------------------------------------------

def _stack_rays(layers, n=64):
    top = layers + 2.0
    span = 0.9 if layers == 1 else 1.5
    x = np.linspace(-span, span, n, dtype=np.float32)
    org = np.stack([x, np.full(n, top, np.float32),
                    np.zeros(n, np.float32)], axis=1)
    d = np.tile(np.asarray([[0.0, -1.0, 0.0]], np.float32), (n, 1))
    return x, top, org, d


# The caps that a capped case cuts the rounds to: the rounds the
# graph-ready re-trace once ran in every dispatch.
SMALL_CAPS = {False: ("KHIT_MAX_ROUNDS", 2),
              True: ("RETRACE_MAX_ROUNDS", 12)}


def _rounds_needed(layers, two_level):
    """Rounds the see-through rays need: khit takes K layers a round, the
    two-level re-trace one."""
    return layers + 1 if two_level else layers // kh.K + 1


@pytest.mark.parametrize("capped", [False, True])
@pytest.mark.parametrize("two_level", [False, True])
@pytest.mark.parametrize("layers", [1, 6, 10, 12, 16])
def test_graph_ready_retrace_matches_eager_and_jax(layers, two_level, capped,
                                                   monkeypatch):
    jbvh, flat, jalpha, talpha = _layers(layers)
    bvh = _two_level_layers(layers) if two_level else flat
    x, top, org, d = _stack_rays(layers)
    o, dd = torch.from_numpy(org), torch.from_numpy(d)
    need = _rounds_needed(layers, two_level)
    if capped:
        monkeypatch.setattr(tt, *SMALL_CAPS[two_level])
    rounds = tt.retrace_plan(two_level)[0]
    monkeypatch.setitem(tt.MASK_STATS, "max_rounds", 0)
    eager = tt.closest_hit(bvh, o, dd, 0.0, BIG, alpha_fn=talpha, sort=True)
    assert tt.MASK_STATS["max_rounds"] == need
    ovf = torch.zeros((), dtype=torch.int32)
    got = tt.closest_hit(bvh, o, dd, 0.0, BIG, alpha_fn=talpha, sort=True,
                         overflow=ovf)
    tmax = torch.full((x.shape[0],), top - 0.5)   # short of the floor
    occ_ovf = torch.zeros((), dtype=torch.int32)
    occ = tt.any_hit(bvh, o, dd, 0.0, tmax, alpha_fn=talpha, sort=True,
                     overflow=occ_ovf)
    occ_eager = tt.any_hit(bvh, o, dd, 0.0, tmax, alpha_fn=talpha, sort=True)
    clear = x < 0.0
    if need <= rounds:
        assert int(ovf) == 0 and int(occ_ovf) == 0
        for a, b in zip(got, eager):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_array_equal(occ.numpy(), occ_eager.numpy())
        jh = jtr.closest_hit(jbvh, jnp.asarray(org), jnp.asarray(d), 0.0,
                             BIG, alpha_fn=jalpha)
        np.testing.assert_array_equal(got.prim_id.numpy(),
                                      np.asarray(jh.prim_id))
        np.testing.assert_allclose(got.t.numpy(), np.asarray(jh.t),
                                   rtol=1e-5)
        jo = jtr.any_hit(jbvh, jnp.asarray(org), jnp.asarray(d), 0.0,
                         jnp.asarray(tmax.numpy()), alpha_fn=jalpha)
        np.testing.assert_array_equal(occ.numpy(), np.asarray(jo))
    else:
        # Every see-through ray is left unresolved; the others agree.
        assert capped
        assert int(ovf) == int(clear.sum()) > 0
        assert int(occ_ovf) == int(clear.sum())
        for a, b in zip(got, eager):
            np.testing.assert_array_equal(a.numpy()[~clear],
                                          b.numpy()[~clear])
    np.testing.assert_allclose(eager.t.numpy(),
                               np.where(clear, top, top - layers), rtol=1e-5)
    np.testing.assert_array_equal(occ_eager.numpy(), ~clear)


def _captured_dispatch(bvh, o, dd, talpha, tmin=0.0):
    """A masked closest hit over `bvh` captured by the stand-in graph
    (its hit written into a static state) and its SceneGraphs."""
    sg = graphs.SceneGraphs("cpu")
    n = o.shape[0]
    state = {"t": torch.zeros(n), "id": torch.zeros(n, dtype=torch.int32)}

    def step(st_, overflow):
        hit = tt.closest_hit(bvh, o, dd, tmin, BIG, alpha_fn=talpha,
                             sort=True, overflow=overflow)
        st_["t"].copy_(hit.t)
        st_["id"].copy_(hit.prim_id)

    return sg.phase("k", step, state), sg, state


@pytest.mark.parametrize("two_level", [False, True])
@pytest.mark.parametrize("layers", [6, 16])
def test_device_counts_hold_the_eager_rounds(layers, two_level, standin,
                                             monkeypatch):
    """A replay runs the rounds the eager loop runs: its device counts
    and the replay's deltas add up to the eager dispatch's rounds, most
    rounds and lanes past the first, and its hits equal the eager ones
    bit for bit."""
    _, flat, _, talpha = _layers(layers)
    bvh = _two_level_layers(layers) if two_level else flat
    _, _, org, d = _stack_rays(layers)
    o, dd = torch.from_numpy(org), torch.from_numpy(d)
    for k in tt.MASK_STATS:
        monkeypatch.setitem(tt.MASK_STATS, k, 0)
    eager = tt.closest_hit(bvh, o, dd, 0.0, BIG, alpha_fn=talpha, sort=True)
    want = dict(tt.MASK_STATS)
    assert want["max_rounds"] == _rounds_needed(layers, two_level)
    g, sg, state = _captured_dispatch(bvh, o, dd, talpha)
    for k in tt.MASK_STATS:
        tt.MASK_STATS[k] = 0
    sg.counts.zero_()
    g.replay()
    values = sg.counts.tolist()
    assert values[0] == 0
    at = lambda k: values[graphs._slot(tt.MASK_STATS, k)]
    assert at("rounds") == want["rounds"] - 1     # the first is a delta
    assert tt.MASK_STATS["rounds"] == 1
    graphs.add_device_counts(values)
    assert tt.MASK_STATS == want
    np.testing.assert_array_equal(state["t"].numpy(), eager.t.numpy())
    np.testing.assert_array_equal(state["id"].numpy(),
                                  eager.prim_id.numpy())


@pytest.mark.parametrize("two_level", [False, True])
@pytest.mark.parametrize("layers", [1, 6, 16])
def test_folded_counts_equal_the_host_loops(layers, two_level, standin,
                                            monkeypatch):
    """The re-trace's WHILE body adds no count: its loop hands the counts
    a run ticks to slot_finish, which adds them times the runs.  A
    replay's launch counters and MASK_STATS, its deltas and device counts
    added, equal those of the same route run on the host (its loop a
    Python loop, every count ticked each round), the FINISH_KEYS that
    only the device counts hold aside; the loop's body ran past the
    first round wherever the layers ask it to."""
    _, flat, _, talpha = _layers(layers)
    bvh = _two_level_layers(layers) if two_level else flat
    _, _, org, d = _stack_rays(layers)
    o, dd = torch.from_numpy(org), torch.from_numpy(d)
    g, sg, state = _captured_dispatch(bvh, o, dd, talpha)
    adds = []
    orig = torch.Tensor.add_

    def add_(self, *a, **k):
        at = self.data_ptr() - sg.counts.data_ptr()
        adds.append("count" if self._base is sg.counts and at > 0 else
                    "overflow" if self._base is sg.counts else
                    tuple(self.shape))
        return orig(self, *a, **k)

    def counters():
        return [dict(c) for c in graphs._counters()]

    def zero():
        for c in graphs._counters():
            for k in c:
                c[k] = 0

    zero()
    overflow = torch.zeros((), dtype=torch.int32)
    host = tt.closest_hit(bvh, o, dd, 0.0, BIG, alpha_fn=talpha, sort=True,
                          overflow=overflow)
    want = counters()
    zero()
    sg.counts.zero_()
    monkeypatch.setattr(torch.Tensor, "add_", add_)
    g.replay()
    monkeypatch.setattr(torch.Tensor, "add_", orig)
    values = sg.counts.tolist()
    graphs.add_device_counts(values)
    got = counters()
    for c in (want, got):
        for k in dp.FINISH_KEYS:
            c[-1].pop(k)
    assert got == want
    assert values[0] == int(overflow) == 0
    runs = _rounds_needed(layers, two_level) - 1
    assert tt.MASK_STATS["rounds"] == runs + 1
    # One round counter add a run of the body, no count add.
    assert adds.count(()) == runs and "count" not in adds
    np.testing.assert_array_equal(state["t"].numpy(), host.t.numpy())


def _loop_graph(nested: bool):
    """A stand-in graph whose step runs graphs.while_loop over a static
    state: each pass doubles `x`, counts one round and takes one off
    `left`; nested, each pass runs an inner loop that adds 1 to `y`
    `inner` times."""
    sg = graphs.SceneGraphs("cpu")
    state = {"x": torch.arange(8.0), "y": torch.zeros(8),
             "left": torch.zeros((), dtype=torch.int32),
             "inner": torch.zeros((), dtype=torch.int32),
             "k": torch.zeros((), dtype=torch.int32)}

    def step(s_, overflow):
        def inner():
            s_["y"].add_(1.0)
            s_["k"].add_(1)

        def body():
            tt.MASK_STATS["rounds"] += 1
            s_["x"].mul_(2.0)
            s_["left"].sub_(1)
            if nested:
                s_["k"].zero_()
                graphs.while_loop(lambda: s_["k"] < s_["inner"], inner)

        graphs.while_loop(lambda: s_["left"] > 0, body)

    return sg.phase("loop", step, state), sg, state


@pytest.mark.parametrize("nested", [False, True])
def test_while_loop_runs_while_its_flag_is_set(nested, standin):
    """A replay runs the body as often as the flag asks and counts each
    pass on the device; with the flag false at the start the state stays
    bit for bit as it was."""
    g, sg, state = _loop_graph(nested)
    slot = graphs._slot(tt.MASK_STATS, "rounds")
    for left, inner in ((0, 2), (3, 2), (0, 0), (1, 3)):
        before = {k: v.clone() for k, v in state.items()}
        state["left"].fill_(left)
        state["inner"].fill_(inner)
        sg.counts.zero_()
        g.replay()
        assert int(sg.counts[slot]) == left
        np.testing.assert_array_equal(state["x"].numpy(),
                                      before["x"].numpy() * 2.0 ** left)
        np.testing.assert_array_equal(
            state["y"].numpy(),
            before["y"].numpy() + (left * inner if nested else 0))
        if left == 0:
            for k in ("x", "y", "k"):
                assert torch.equal(state[k], before[k]), k


@pytest.mark.parametrize("cap", [2, 7, tt.KHIT_MAX_ROUNDS])
@pytest.mark.parametrize("lanes", [0, 1, 5])
def test_plain_loop_test_matches_the_host_condition(lanes, cap):
    """graphs.LoopTest's plain version against the condition the
    re-trace's host loop tested before it, cond() & (rounds < cap) with
    cond the slots' need.any() and the round added by the body: at the
    entry (rounds 1, the lanes in need counted by the slot gather), and
    at the end of a pass that leaves rounds at cap - 1 and at cap; the
    round counter as the host loop leaves it."""
    slots = 64
    need = torch.zeros(slots, dtype=torch.bool)
    need[torch.randperm(slots, generator=torch.Generator().manual_seed(
        lanes))[:lanes]] = True
    count = need.sum(dtype=torch.int32)
    rounds = torch.full((), 99, dtype=torch.int32)
    test = graphs.LoopTest(need, count, rounds, cap)
    assert bool(test()) == (bool(need.any()) and 1 < cap)    # the entry
    assert int(rounds) == 1
    for at in (cap - 1, cap):
        old = torch.tensor(at - 1, dtype=torch.int32)
        old.add_(1)                           # the old body's round add
        want = need.any() & (old < cap)
        rounds.fill_(at - 1)
        got = test()                          # the end of a pass
        assert got.dtype == torch.bool and got.dim() == 0
        assert bool(got) == bool(want) == (lanes > 0 and at < cap)
        assert int(rounds) == int(old) == at
    # The same flags through the plain functions the test calls.
    rounds.fill_(cap - 2)
    assert bool(graphs.loop_test_plain(need, rounds, cap)) == (lanes > 0)
    assert bool(graphs.loop_entry_plain(count, rounds, cap)) == (lanes > 0)
    assert int(rounds) == 1


def test_loop_test_loops_as_the_host_condition():
    """A host loop over a LoopTest runs the body as often as the loop it
    replaced (while cond() & (rounds < cap): body, rounds += 1), with the
    slots' flags cleared a pass at a time or never, under and at the cap;
    its round counter ends where the old one did."""
    for flags, cap in ((3, 10), (3, 2), (12, 5), (0, 4), (12, 1)):
        runs = []
        for form in ("old", "new"):
            need = torch.zeros(16, dtype=torch.bool)
            need[:flags] = True
            n = [0]

            def body():
                n[0] += 1
                need[n[0] - 1] = False        # one slot resolved a pass

            if form == "old":
                rounds = torch.ones((), dtype=torch.int32)

                def counted():
                    body()
                    rounds.add_(1)

                graphs.while_loop(lambda: need.any() & (rounds < cap),
                                  counted)
            else:
                rounds = torch.empty((), dtype=torch.int32)
                graphs.while_loop(graphs.LoopTest(
                    need, need.sum(dtype=torch.int32), rounds, cap), body)
            runs.append((n[0], int(rounds)))
        assert runs[0] == runs[1], (flags, cap, runs)


@pytest.mark.parametrize("two_level", [False, True])
def test_resolved_dispatch_runs_no_round_past_its_first(two_level,
                                                        standin):
    """A dispatch whose first round resolves every lane: the replay's
    hits equal the eager ones, and its device counts hold no round past
    the first and one round as the most a dispatch ran."""
    layers = 1 if two_level else 2
    _, flat, _, talpha = _layers(layers)
    bvh = _two_level_layers(layers) if two_level else flat
    _, _, org, d = _stack_rays(layers)
    org[:, 0] = 0.5                       # every ray hits an opaque texel
    o, dd = torch.from_numpy(org), torch.from_numpy(d)
    eager = tt.closest_hit(bvh, o, dd, 0.0, BIG, alpha_fn=talpha, sort=True)
    g, sg, state = _captured_dispatch(bvh, o, dd, talpha)
    sg.counts.zero_()
    g.replay()
    values = sg.counts.tolist()
    assert values[0] == 0
    assert values[graphs._slot(tt.MASK_STATS, "rounds")] == 0
    assert values[graphs._slot(tt.MASK_STATS, "max_rounds")] == 1
    np.testing.assert_array_equal(state["t"].numpy(), eager.t.numpy())
    np.testing.assert_array_equal(state["id"].numpy(),
                                  eager.prim_id.numpy())


@pytest.mark.parametrize("two_level", [False, True])
def test_lanes_past_the_slots_overflow(two_level, monkeypatch):
    """With one slot block for 512 lanes and every lane re-tracing, the
    lanes past the slots count as unresolved."""
    layers = 1 if two_level else 6
    _, flat, _, talpha = _layers(layers)
    bvh = _two_level_layers(layers) if two_level else flat
    n = 512
    _, _, org, d = _stack_rays(layers, n)
    org[:, 0] = -0.5                      # every ray sees through
    monkeypatch.setattr(tt, "RETRACE_SLOT_DIV" if two_level
                        else "KHIT_SLOT_DIV", n)
    assert tt.retrace_slots(n, two_level) == st.BLK
    ovf = torch.zeros((), dtype=torch.int32)
    got = tt.closest_hit(bvh, torch.from_numpy(org), torch.from_numpy(d),
                         0.0, BIG, alpha_fn=talpha, overflow=ovf, sort=True)
    assert int(ovf) == n - st.BLK
    # The slots' rays reach the floor (ids 0 and 1); the others keep
    # their first round's result.
    assert int(((got.prim_id >= 0) & (got.prim_id < 2)).sum()) == st.BLK


@pytest.mark.parametrize("fill", [0.0, 0.01, 0.5, 1.0])
def test_gather_and_merge_slots(fill):
    rs = np.random.RandomState(int(100 * fill))
    need = torch.from_numpy(rs.rand(1000) < fill)
    hit = tt.Hit(*(torch.from_numpy(rs.rand(1000).astype(np.float32))
                   for _ in range(4)))
    slots = tt.gather_slots(need, 64, hit)
    idx, valid, dropped = slots.idx, slots.valid, slots.dropped
    lanes = need.numpy().nonzero()[0]
    k = min(len(lanes), 64)
    np.testing.assert_array_equal(idx.numpy()[:k], lanes[:k])
    assert int(valid.sum()) == k and bool(valid[:k].all())
    assert int(dropped) == len(lanes) - k
    sub = tt.Hit(*(torch.from_numpy(rs.rand(64).astype(np.float32))
                   for _ in range(4)))
    got = dp.slot_merge(slots._replace(hit=sub), hit)
    for g, h, s in zip(got, hit, sub):
        want = h.numpy().copy()
        want[lanes[:k]] = s.numpy()[:k]
        np.testing.assert_array_equal(g.numpy(), want)


# --------------------------------------------------------------------------
# The no-sync guard
# --------------------------------------------------------------------------

def _carry(scene, meta, size=16):
    cam = tcamera(meta.cam_pos, meta.cam_dir, meta.cam_up, size, size, 60.0,
                  device="cpu")
    org, d, state, _ = tpt.camera_rays(cam, size, size, 1, 2)
    return tpt._init_carry(org, d, state)


def _bounce(scene, meta, c, overflow):
    return tpt._pt_bounce(
        scene, c, alpha_fn=tpt.alpha_fn_for(scene) if meta.has_masks
        else None, has_bump=meta.has_bump, max_len=4, overflow=overflow)


@pytest.mark.parametrize("route", ["flat", "flat_masked", "still_life",
                                   "two_level_masked"])
def test_graph_ready_bounce_reads_nothing(route, procedural,
                                          two_level_masked, monkeypatch):
    """Flat unmasked (the cornell: mirror and glass), flat masked (the
    masked scene; a small still life: the env map and every material
    kind) and two-level masked (env map, bump maps, every light kind)."""
    if route == "still_life":
        scene, meta = make_still_life_like(num_objects=40, num_cards=16,
                                           device="cpu")
    else:
        _, scene, meta = (procedural["cornell"] if route == "flat" else
                          procedural["masked"] if route == "flat_masked"
                          else (None,) + two_level_masked)
    c = _carry(scene, meta)
    c = _bounce(scene, meta, c, None)             # a mid-path carry
    want = _bounce(scene, meta, c, torch.zeros((), dtype=torch.int32))
    ovf = torch.zeros((), dtype=torch.int32)
    with no_sync(monkeypatch):
        got = _bounce(scene, meta, c, ovf)
    assert int(ovf) == 0 and int(c["active"].sum()) > 100
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), k)


def test_guard_trips_on_the_eager_khit_loop(procedural, monkeypatch):
    _, scene, meta = procedural["masked"]
    c = _carry(scene, meta)
    with pytest.raises(HostRead, match="nonzero"):
        with no_sync(monkeypatch):
            _bounce(scene, meta, c, None)


# --------------------------------------------------------------------------
# Film parity and bookkeeping
# --------------------------------------------------------------------------

def _frames(scene, meta, cam, size, spp=1, max_len=4, compact=None,
            frame=3):
    """[(film, traced rays)] of `frame` on the eager and the graph route;
    the graph route's frame must have replayed one bounce a band-bounce
    (a rerun adds none)."""
    out = []
    for graph in (False, True):
        replays, stats = graphs.GRAPH_STATS["replays"], {}
        film, n = tpt.render_pt_frame(
            scene, cam, frame, *size, spp=spp, max_len=max_len,
            has_masks=meta.has_masks, has_bump=meta.has_bump,
            with_stats=True, compact=compact, graph=graph, stats=stats)
        assert graphs.GRAPH_STATS["replays"] - replays == (
            stats["band_bounces"] if graph else 0)
        out.append((film.numpy(), int(n)))
    return out


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("name", ["cornell", "masked"])
def test_graph_films_equal_eager_and_jax(name, compact, procedural, standin,
                                         monkeypatch):
    js, ts, meta = procedural[name]
    W, SPP, MAX_LEN = 32, 2, 4
    # 320-pixel bands: three full bands and a short one of 64 pixels.
    monkeypatch.setattr(tpt, "BAND_RAYS", 320 * SPP)
    cam = (meta.cam_pos, meta.cam_dir, meta.cam_up, W, W, 60.0)
    tcam = tcamera(*cam, device="cpu")
    (ef, en), (gf, gn) = _frames(ts, meta, tcam, (W, W), spp=SPP,
                                 max_len=MAX_LEN, compact=compact)
    np.testing.assert_array_equal(gf, ef)
    assert gn == en
    assert graphs.GRAPH_STATS["captures"] <= 1    # one a key and scene
    assert graphs.GRAPH_STATS["reruns"] == 0
    jf, jn = jrender(js, jcamera(*cam), jnp.uint32(3), W, W, spp=SPP,
                     max_len=MAX_LEN, has_masks=meta.has_masks,
                     with_stats=True, max_steps=0)
    jf = np.asarray(jf)
    assert abs(gf.mean() - jf.mean()) / jf.mean() <= 1e-3
    rel = np.abs(gf - jf) / np.maximum(np.abs(jf), 1e-3)
    assert (rel.max(axis=-1) <= 1e-4).mean() >= 0.98
    assert abs(gn - int(jn)) <= 1e-2 * int(jn)


@pytest.mark.parametrize("rounds", [tt.RETRACE_MAX_ROUNDS, 1])
def test_two_level_graph_film_and_rerun(rounds, two_level_masked, standin,
                                        monkeypatch):
    """The two-level masked scene through the graph route: bit-equal to
    the eager frame; with the rounds capped at one a transparent hit
    overflows at the cap and the frame is rendered again eagerly, bit
    for bit."""
    scene, meta = two_level_masked
    monkeypatch.setattr(tt, "RETRACE_MAX_ROUNDS", rounds)
    for k in ("dropped", "capped"):
        monkeypatch.setitem(tt.MASK_STATS, k, 0)
    cam = camera_for_scene(meta, RenderSettings(width=32, height=24, spp=1,
                                                max_path_len=4), "cpu")
    # Frame 1 at spp 4: seven lanes cross a transparent texel.
    (ef, en), (gf, gn) = _frames(scene, meta, cam, (32, 24), spp=4,
                                 frame=1)
    np.testing.assert_array_equal(gf, ef)
    assert gn == en
    assert graphs.GRAPH_STATS["reruns"] == (1 if rounds == 1 else 0)
    assert tt.MASK_STATS["dropped"] == 0
    assert (tt.MASK_STATS["capped"] > 0) == (rounds == 1)


@pytest.mark.parametrize("name", ["cornell", "masked", "two_level"])
def test_replays_count_the_frames_launches(name, procedural,
                                           two_level_masked, standin,
                                           monkeypatch):
    """A graphed frame counts the launches the eager frame makes; one
    capture a key, one replay a band-bounce; another max_len is another
    key.  On the masked scenes the rounds are the eager frame's, plus one
    first round for each empty dispatch, the rounds past the first
    counted on the device (a capture runs the loop's body once, and
    counts none of it): khit rounds on the flat masked scene, stream
    dispatches on the two-level one, whose frame 1 at spp 4 re-traces."""
    if name == "two_level":
        ts, meta = two_level_masked
        cam = camera_for_scene(meta, RenderSettings(
            width=32, height=24, spp=4, max_path_len=4), "cpu")
        size, spp = (32, 24), 4
    else:
        _, ts, meta = procedural[name]
        cam = tcamera(meta.cam_pos, meta.cam_dir, meta.cam_up, 32, 32,
                      60.0, device="cpu")
        size, spp = (32, 32), 1
    monkeypatch.setattr(tpt, "BAND_RAYS", 320 * spp)

    def frame(graph, max_len=4):
        st.reset_launches()
        kh.reset_launches()
        for k in tt.MASK_STATS:
            monkeypatch.setitem(tt.MASK_STATS, k, 0)
        stats = {}
        tpt.render_pt_frame(ts, cam, 1, *size, spp=spp, max_len=max_len,
                            has_masks=meta.has_masks,
                            has_bump=meta.has_bump, graph=graph,
                            stats=stats)
        return (st.LAUNCHES["plain"] + kh.LAUNCHES["plain"],
                dict(tt.MASK_STATS), stats["band_bounces"])

    frame(True)                                   # captures, warms up
    assert graphs.GRAPH_STATS["captures"] == 1
    replays = graphs.GRAPH_STATS["replays"]
    eager, eager_mask, bb = frame(False)
    graphed, mask, bb2 = frame(True)
    assert graphs.GRAPH_STATS["replays"] - replays == bb == bb2
    assert graphs.GRAPH_STATS["captures"] == 1
    assert graphs.GRAPH_STATS["reruns"] == 0
    if name == "cornell":
        assert graphed == eager == 2 * bb and bb == 4 * 4
    else:
        empty = mask["empty"]
        assert graphed == eager + empty
        assert mask["rounds"] == eager_mask["rounds"] + empty
        for k in ("dispatches", "empty", "max_rounds", "max_lanes",
                  "dropped", "capped"):
            assert mask[k] == eager_mask[k], k
        assert eager_mask["max_rounds"] == (2 if name == "two_level"
                                            else 1)
    frame(True, max_len=3)
    assert graphs.GRAPH_STATS["captures"] == 2
    sg = graphs.for_scene(ts)
    assert {(320 * spp, 3), (320 * spp, 4)} <= {k[:2] for k in sg.graphs}


def test_load_pads_with_dead_lanes(procedural, standin):
    _, ts, meta = procedural["cornell"]
    c = _carry(ts, meta, 16)                      # 256 lanes
    sg = graphs.SceneGraphs("cpu")
    step = lambda carry, overflow: _bounce(ts, meta, carry, overflow)
    g = sg.bounce("k", step, c, 300)
    assert sg.bounce("k", None, None, 0) is g
    g.carry["n_rays"].fill_(7)
    g.load({k: v[:100] for k, v in c.items() if k != "n_rays"})
    assert bool(g.carry["active"][:100].all())
    assert not bool(g.carry["active"][100:].any())
    assert int(g.carry["n_rays"]) == 0
    np.testing.assert_array_equal(g.carry["org"][:100].numpy(),
                                  c["org"][:100].numpy())
    g.replay(2)
    assert int(g.carry["n_rays"]) > 0
    assert not bool(g.carry["active"][100:].any())
    with pytest.raises(ValueError, match="does not fit"):
        g.load({k: torch.cat([v, v]) for k, v in c.items()
                if k != "n_rays"})


def test_graph_true_is_refused_where_graphs_cannot_run(procedural):
    _, ts, meta = procedural["cornell"]
    cam = tcamera(meta.cam_pos, meta.cam_dir, meta.cam_up, 8, 8, 60.0,
                  device="cpu")
    assert not tpt.use_graphs("cpu", ts.bvh)
    with pytest.raises(ValueError, match="graph=True"):
        tpt.render_pt_frame(ts, cam, 0, 8, 8, graph=True)
    paired = dataclasses.replace(ts.bvh, pairs=True)
    assert not tpt.use_graphs("cuda", paired)
    assert tpt.use_graphs("cuda", ts.bvh)
