"""The VCM family's CUDA-graph route (render/integrators/vcm.py over
render/graphs.py) on the CPU, through the stand-in graph and the no-sync
guard of tests/torch_graph_guard.py.

* No-sync guard: one light band (vcm, bpt, ppm, lt) and one camera phase
  of two bounces (vcm, bpt, ppm, pt) on a flat unmasked, a flat masked
  and a two-level masked scene read nothing on the host, with the plain
  versions that stand for one launch each (st.traverse, kh.khit,
  merge_plain) lifted; their results equal the unguarded graph-ready
  run's bit for bit.  The guard trips on the eager masked light pass.
* Film parity: graphed frames equal the eager route's bit for bit on the
  CPU, banded and compacted, with short last light and camera bands,
  traced rays equal; and JAX's render_vcm_frame within
  tests/test_torch_vcm.py's tolerances.
* The sync-free append (CollectCache.append) gives the boolean-mask
  append's rows and count bit for bit, counts the rows past the
  capacity, and check() raises on them.
* A frame whose re-trace overflows is rendered again eagerly, bit for
  bit, and counted; a graphed frame's merge, khit and stream launch
  counts equal the eager frame's; a padded light band logs and splats
  nothing; the sharded graphed frame (ranks as threads) equals the
  unsharded one; graph=True is refused where graphs cannot run.
"""

import dataclasses

import numpy as np
import pytest
import torch

from imbatracer_torch.frontend.renderer import (RenderSettings,
                                                camera_for_scene)
from imbatracer_torch.ops import khit as kh
from imbatracer_torch.ops import merge as tmerge
from imbatracer_torch.ops import stream_traverse as st
from imbatracer_torch.parallel import shard
from imbatracer_torch.render import graphs
from imbatracer_torch.render import light_cache as tlc
from imbatracer_torch.render import traverse as tt
from imbatracer_torch.render.camera import make_camera as tcamera
from imbatracer_torch.render.integrators import pt as tpt
from imbatracer_torch.render.integrators import vcm as tvcm
from test_torch_graphs import procedural, two_level_masked  # noqa: F401
from test_torch_shard import run_ranks
from test_torch_vcm import _assert_films_agree, _jax_frame
from torch_graph_guard import HostRead, no_sync, standin  # noqa: F401
from torch_threads import cap_torch_threads

cap_torch_threads()

RADIUS, FRAME, MAX_LEN = 0.06, 2, 4


def _scene(route, procedural, two_level_masked):  # noqa: F811
    """(scene, meta) of a route: flat unmasked (the cornell), flat masked
    (the masked scene), two-level masked (the generated instanced
    scene)."""
    if route == "two_level_masked":
        return two_level_masked
    _, ts, meta = procedural["cornell" if route == "flat" else "masked"]
    return ts, meta


def _cam(scene, meta, w, h):
    if scene.bvh.two_level:
        return camera_for_scene(meta, RenderSettings(width=w, height=h),
                                "cpu")
    return tcamera(meta.cam_pos, meta.cam_dir, meta.cam_up, w, h, 60.0,
                   device="cpu")


def _kinds(scene):
    return tuple(sorted(set(scene.materials.kind.tolist())))


def _frame_kw(scene, meta, algo, w, h, lpc, **kw):
    return dict(algo=algo, width=w, height=h, max_len=MAX_LEN,
                light_path_count=lpc, has_masks=meta.has_masks,
                has_bump=meta.has_bump, mat_kinds=_kinds(scene), **kw)


# --------------------------------------------------------------------------
# The no-sync guard
# --------------------------------------------------------------------------

def _band_and_phase(scene, meta, algo, overflow, guard=None, size=16,
                    lpc=192):
    """One light band of 256 lanes (lpc paths, the rest padding) and the
    camera bounces [0, 2) of a 16x16 band, both graph-ready; the second
    under `guard` (a context) when given.  Returns the tensors they
    wrote."""
    cam = _cam(scene, meta, size, size)
    (frame, base_radius, lpc, cap, pm, evc, evm) = tvcm.frame_constants(
        cam, FRAME, RADIUS, algo=algo, num_pixels=size * size,
        light_path_count=lpc, max_len=MAX_LEN)
    alpha_fn = tpt.alpha_fn_for(scene) if meta.has_masks else None
    kinds = _kinds(scene)
    out = {}
    collect = tlc.empty_collect(lpc * MAX_LEN, "cpu")
    start = torch.zeros((), dtype=torch.int32)
    end = torch.full((), lpc, dtype=torch.int32)
    guard = guard or (lambda: torch.no_grad())
    if algo != "pt":
        with guard():
            out["light_film"] = tvcm._light_pass(
                scene, cam, frame, evc, evm,
                collect if algo != "lt" else None, algo=algo,
                num_pixels=size * size, light_path_count=lpc,
                max_len=MAX_LEN, alpha_fn=alpha_fn, has_bump=meta.has_bump,
                path_start=start, band_paths=256, path_end=end,
                overflow=overflow)
        out["rec"], out["count"] = collect.rec, collect.count
    if algo == "lt":
        return out
    fi = tvcm.FrameInputs(cam, frame, base_radius, pm, evc, evm)
    cache = grid = None
    if algo != "pt":
        cache = tlc.select_shallowest(collect.cache(), cap)
    if algo in ("vcm", "ppm"):
        grid = tvcm.photon_grid(cache, pm)
    fi = tvcm.working_cache(fi, cache, grid, None, ())
    c = dict(tvcm._camera_carry(cam, frame, width=size, height=size, spp=1,
                                light_path_count=lpc, start_pixel=0,
                                band_pixels=size * size),
             n_rays=torch.zeros((), dtype=torch.int64))
    with guard():
        for i in range(2):
            c = tvcm._camera_bounce(
                scene, c, i, cache_count=fi.cache_count,
                cache_rec=fi.cache_rec, grid=fi.grid, pm_radius=pm,
                base_radius=base_radius, mis_eta_vc=evc, mis_eta_vm=evm,
                algo=algo, max_len=MAX_LEN, light_path_count=lpc,
                num_connections=1, has_bump=meta.has_bump,
                alpha_fn=alpha_fn, techniques=tvcm.TECHNIQUES,
                mat_kinds=kinds, overflow=overflow)
    out.update({f"camera_{k}": v for k, v in c.items()})
    return out


@pytest.mark.parametrize("route", ["flat", "flat_masked",
                                   "two_level_masked"])
@pytest.mark.parametrize("algo", ["vcm", "bpt", "ppm", "lt", "pt"])
def test_light_band_and_camera_phase_read_nothing(algo, route, procedural,
                                                  two_level_masked,
                                                  monkeypatch):  # noqa: F811
    scene, meta = _scene(route, procedural, two_level_masked)
    ovf = torch.zeros((), dtype=torch.int32)
    want = _band_and_phase(scene, meta, algo, torch.zeros_like(ovf))
    got = _band_and_phase(scene, meta, algo, ovf,
                          guard=lambda: no_sync(monkeypatch))
    assert int(ovf) == 0
    if algo != "pt":
        assert float(want["light_film"].sum()) > 0.0 or algo == "ppm"
    if algo not in ("pt", "lt"):
        assert int(want["count"]) > 0
    if algo != "lt":
        assert int(want["camera_n_rays"]) > 0
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), k)


def test_guard_trips_on_the_eager_masked_light_pass(procedural,
                                                    monkeypatch):  # noqa: F811
    _, scene, meta = procedural["masked"]
    with pytest.raises(HostRead, match="nonzero"):
        _band_and_phase(scene, meta, "vcm", None,
                        guard=lambda: no_sync(monkeypatch))


# --------------------------------------------------------------------------
# The sync-free append and the padded band
# --------------------------------------------------------------------------

def _boolean_mask_append(rec, count, valid, rows):
    """The append the sync-free one replaced: rec[valid] after the count."""
    add = int(valid.sum())
    out = rec.clone()
    out[count:count + add] = rows[valid]
    return out, count + add


@pytest.mark.parametrize("fill", [0.0, 0.3, 1.0])
def test_sync_free_append_matches_the_boolean_mask_append(fill, monkeypatch):
    rs = np.random.RandomState(int(10 * fill) + 3)
    cap = 1000
    collect = tlc.empty_collect(cap, "cpu")
    ref, n = collect.rec[:-1].clone(), 0
    for _ in range(3):
        valid = torch.from_numpy(rs.rand(300) < fill)
        rows = torch.from_numpy(rs.randn(300, 24).astype(np.float32))
        with no_sync(monkeypatch):
            collect.append(valid, rows)
        ref, n = _boolean_mask_append(ref, n, valid, rows)
    assert int(collect.count) == n and int(collect.lost) == 0
    np.testing.assert_array_equal(collect.rec[:-1].numpy().view(np.uint32),
                                  ref.numpy().view(np.uint32))
    collect.check()


def test_sync_free_append_counts_and_raises_on_overflow(monkeypatch):
    rs = np.random.RandomState(5)
    collect = tlc.empty_collect(100, "cpu")
    rows = torch.from_numpy(rs.randn(80, 24).astype(np.float32))
    valid = torch.ones(80, dtype=torch.bool)
    with no_sync(monkeypatch):
        collect.append(valid, rows)
        collect.append(valid, rows)
    assert int(collect.count) == 100 and int(collect.lost) == 60
    np.testing.assert_array_equal(collect.rec[:80].numpy(), rows.numpy())
    np.testing.assert_array_equal(collect.rec[80:100].numpy(),
                                  rows[:20].numpy())
    with pytest.raises(RuntimeError, match="overflow"):
        collect.check()
    # append_packed keeps its contract: a new cache, or a raise.
    cache = tlc.empty_cache(100, "cpu")
    cache = tlc.append_packed(cache, valid, rows)
    with pytest.raises(RuntimeError, match="overflow"):
        tlc.append_packed(cache, valid, rows)
    assert int(cache.count) == 80


def _band(scene, meta, cam, collect, start, lanes, end, lpc):
    (frame, _, lpc, _, _, evc, evm) = tvcm.frame_constants(
        cam, FRAME, RADIUS, algo="vcm", num_pixels=cam.width * cam.height,
        light_path_count=lpc, max_len=MAX_LEN)
    return tvcm._light_pass(
        scene, cam, frame, evc, evm, collect, algo="vcm",
        num_pixels=cam.width * cam.height, light_path_count=lpc,
        max_len=MAX_LEN, alpha_fn=None, has_bump=False, path_start=start,
        band_paths=lanes, path_end=end, overflow=torch.zeros(
            (), dtype=torch.int32))


def test_padded_light_band_logs_and_splats_nothing(procedural):  # noqa: F811
    """Paths 256..299 of 300 in a band of 128 lanes: the padded lanes'
    path ids reach 383, past the last light's share (their light index
    is clamped), and the band logs and splats exactly what the unpadded
    band of 44 lanes does.  A band of padding only does nothing."""
    _, ts, meta = procedural["cornell"]
    cam = _cam(ts, meta, 32, 32)
    lpc, n = 300, 44
    assert (383 * ts.lights.kind.shape[0]) // lpc >= ts.lights.kind.shape[0]
    a, b = (tlc.empty_collect(lpc * MAX_LEN, "cpu") for _ in range(2))
    fa = _band(ts, meta, cam, a, 256, n, None, lpc)
    fb = _band(ts, meta, cam, b, torch.tensor(256, dtype=torch.int32), 128,
               torch.tensor(256 + n, dtype=torch.int32), lpc)
    assert int(a.count) == int(b.count) > 0 and float(fa.sum()) > 0.0
    np.testing.assert_array_equal(fb.numpy(), fa.numpy())
    np.testing.assert_array_equal(b.rec[:-1].numpy(), a.rec[:-1].numpy())
    c = tlc.empty_collect(lpc * MAX_LEN, "cpu")
    fc = _band(ts, meta, cam, c, torch.tensor(256, dtype=torch.int32), 128,
               torch.tensor(256, dtype=torch.int32), lpc)
    assert int(c.count) == 0 and not bool(fc.any())


# --------------------------------------------------------------------------
# Frames
# --------------------------------------------------------------------------

def _frames(scene, meta, algo, w, h, lpc, frame=FRAME, **kw):
    """[(film, camera rays)] of one frame on the eager and the graph
    route, at spp 1 in light and camera bands of kw's sizes; the graph
    route's frame must have replayed one light graph a light band and one
    camera graph a camera band or phase-2 band (a rerun adds none)."""
    cam = _cam(scene, meta, w, h)
    out = []
    for graph in (False, True):
        replays, route = graphs.GRAPH_STATS["replays"], {}
        reruns = graphs.GRAPH_STATS["reruns"]
        film = tvcm.render_vcm_frame(
            scene, cam, frame, RADIUS, graph=graph, stats={"route": route},
            **_frame_kw(scene, meta, algo, w, h, lpc, **kw))
        want = 0 if algo == "pt" else -(-lpc // kw["light_band"])
        if algo != "lt":
            want += -(-w * h // kw["camera_band"]) + route.get(
                "phase2_bands", 0)
        if graph and graphs.GRAPH_STATS["reruns"] == reruns:
            assert graphs.GRAPH_STATS["replays"] - replays == want
        rays = route.get("camera_rays", torch.zeros(()))
        out.append((film.numpy(), int(rays)))
    return out


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("algo", ["vcm", "bpt", "ppm", "lt", "pt"])
def test_graph_films_equal_eager(algo, compact, procedural,
                                 standin):  # noqa: F811
    """32x32 at 300 light paths in bands of 128 (the last 44) and camera
    bands of 320 pixels (the last 64)."""
    _, ts, meta = procedural["cornell"]
    (ef, en), (gf, gn) = _frames(ts, meta, algo, 32, 32, 300,
                                 light_band=128, camera_band=320,
                                 compact=compact)
    assert ef.mean() > 0.0
    np.testing.assert_array_equal(gf, ef)
    assert gn == en
    assert graphs.GRAPH_STATS["reruns"] == 0


@pytest.mark.parametrize("route", ["flat_masked", "two_level_masked"])
def test_masked_graph_films_equal_eager(route, procedural, two_level_masked,
                                        standin):  # noqa: F811
    scene, meta = _scene(route, procedural, two_level_masked)
    for compact in (False, True):
        (ef, en), (gf, gn) = _frames(scene, meta, "vcm", 32, 24, 300,
                                     light_band=128, camera_band=320,
                                     compact=compact)
        np.testing.assert_array_equal(gf, ef)
        assert gn == en
    assert graphs.GRAPH_STATS["reruns"] == 0
    assert graphs.GRAPH_STATS["captures"] <= 4    # light, band; phase 1, 2


@pytest.mark.parametrize("name", ["cornell", "masked"])
def test_graph_frame_matches_jax(name, procedural, standin):  # noqa: F811
    """tests/test_torch_vcm.py's frame (24x24, 256 light paths), graphed
    in light bands of 96 and camera bands of 200 pixels, against JAX's
    render_vcm_frame at that file's tolerances."""
    js, ts, meta = procedural[name]
    cam = _cam(ts, meta, 24, 24)
    film = tvcm.render_vcm_frame(
        ts, cam, FRAME, RADIUS, graph=True, light_band=96, camera_band=200,
        **_frame_kw(ts, meta, "vcm", 24, 24, 256))
    assert graphs.GRAPH_STATS["replays"] > 0
    _assert_films_agree(film.numpy(), _jax_frame(js, ts, meta, "vcm"))


@pytest.mark.parametrize("rounds", [tt.RETRACE_ROUNDS, 1])
def test_overflowing_frame_is_rendered_again(rounds, two_level_masked,
                                             standin,
                                             monkeypatch):  # noqa: F811
    """The two-level masked scene with one re-trace round: a transparent
    hit overflows, and the frame is rendered again eagerly, bit for bit,
    and counted."""
    scene, meta = two_level_masked
    monkeypatch.setattr(tt, "RETRACE_ROUNDS", rounds)
    (ef, en), (gf, gn) = _frames(scene, meta, "vcm", 32, 24, 300,
                                 light_band=128, camera_band=320, frame=1)
    np.testing.assert_array_equal(gf, ef)
    assert gn == en
    assert graphs.GRAPH_STATS["reruns"] == (1 if rounds == 1 else 0)


def test_replays_count_the_frames_launches(procedural, standin):  # noqa: F811
    """A graphed frame counts the eager frame's merge, khit and stream
    launches (plain versions on the CPU).  On the cornell: a masked
    dispatch's graph-ready re-trace runs its fixed rounds, where the
    eager one stops when its lanes are resolved."""
    _, ts, meta = procedural["cornell"]
    cam = _cam(ts, meta, 32, 32)

    def frame(graph):
        for reset in (st.reset_launches, kh.reset_launches,
                      tmerge.reset_launches):
            reset()
        tvcm.render_vcm_frame(ts, cam, 3, RADIUS, graph=graph,
                              light_band=128, camera_band=320,
                              **_frame_kw(ts, meta, "vcm", 32, 32, 300))
        return (dict(st.LAUNCHES), dict(kh.LAUNCHES), dict(tmerge.LAUNCHES))

    frame(True)                                   # captures, warms up
    captures = graphs.GRAPH_STATS["captures"]
    eager, graphed = frame(False), frame(True)
    assert graphed == eager
    assert eager[0]["plain"] > 0 and eager[2]["plain"] > 0
    assert eager[2]["prep_plain"] > 0
    assert graphs.GRAPH_STATS["captures"] == captures


@pytest.mark.parametrize("algo", ["vcm", "bpt"])
def test_sharded_graph_frame_equals_one_process(algo, procedural,
                                                standin):  # noqa: F811
    """Two ranks as threads, each over its own scene object (a scene's
    graphs and static inputs are its rank's), graphed: the unsharded
    frame in light bands of the paths a rank traces a step."""
    _, ts, meta = procedural["cornell"]
    cam = _cam(ts, meta, 32, 32)
    kw = _frame_kw(ts, meta, algo, 32, 32, 512, camera_band=320,
                   light_band=128)
    ref = tvcm.render_vcm_frame(ts, cam, FRAME, RADIUS, graph=False, **kw)
    scenes = [dataclasses.replace(ts) for _ in range(2)]
    got = run_ranks(2, lambda c: shard.render_vcm_frame_sharded(
        scenes[c.rank], cam, FRAME, RADIUS, c, graph=True, **kw))
    assert graphs.GRAPH_STATS["replays"] > 0
    for film in got:
        np.testing.assert_array_equal(film.numpy(), ref.numpy())


def test_graph_true_is_refused_where_graphs_cannot_run(procedural,
                                                       standin):  # noqa: F811
    _, ts, meta = procedural["cornell"]
    cam = _cam(ts, meta, 8, 8)
    kw = _frame_kw(ts, meta, "vcm", 8, 8, 32)
    paired = dataclasses.replace(ts, bvh=dataclasses.replace(ts.bvh,
                                                             pairs=True))
    for scene, stats in ((paired, None), (ts, {"merge_queries": []})):
        with pytest.raises(ValueError, match="graph=True"):
            tvcm.render_vcm_frame(scene, cam, 0, RADIUS, graph=True,
                                  stats=stats, **kw)
    assert not tvcm.use_vcm_graphs("cuda", ts.bvh, True)
    assert not tvcm.use_vcm_graphs("cuda", paired.bvh, False)


def test_graph_true_is_refused_on_the_cpu(procedural):  # noqa: F811
    _, ts, meta = procedural["cornell"]
    cam = _cam(ts, meta, 8, 8)
    assert not tvcm.use_vcm_graphs("cpu", ts.bvh, False)
    with pytest.raises(ValueError, match="graph=True"):
        tvcm.render_vcm_frame(ts, cam, 0, RADIUS, graph=True,
                              **_frame_kw(ts, meta, "vcm", 8, 8, 32))
