"""The port's sharded frames (imbatracer_torch.parallel.shard) with ranks
as threads over gloo (ProcessGroupGloo on one HashStore), at 2 and 3
ranks, on the CPU.

* Against the port, bit for bit: render_pt_frame_sharded on the cornell
  at 32x32 (max_len 4, spp 1 and 2) equals render_pt_frame; for vcm,
  bpt, ppm, lt and vcm_pt, render_vcm_frame_sharded equals
  render_vcm_frame(..., light_band=bp), bp the paths a rank traces a
  step, with 512 light paths (513 at 3 ranks: the count must divide by
  the ranks, and the engine rounds 512 up to 513), in one step and in
  four; gather_cache equals select_shallowest over one collect cache of
  every rank's vertices, row for row, both from real light passes and
  from synthetic vertex sets that the capacity cuts.
* Compaction: with compact=True at 2 ranks and bands of 128 pixels
  (four a rank), the PT and vcm frames equal the one-process compacted
  frame and the one-process banded frame, bit for bit: each rank sorts
  its own lanes, and a lane's path does not depend on its neighbours.
* Tails: a 13x5 image at 2 and 3 ranks and a 13x2 image at 3 ranks (a
  rank with no rows) cover every pixel once; 255 light paths at 2 ranks
  raise ValueError.
* The collective census: PT 1 (+1 with_stats), VCM 1 a light step + 2
  for the cache + 1 for the camera film, the progressive loop +1 a
  frame; make_frame_fn's one-time digest gather and base-radius
  broadcast.
* Against JAX: imbatracer_tpu.parallel.shard's render_pt_frame_sharded
  and render_vcm_frame_sharded (bpt, lt) over make_mesh(jax.devices()
  [:2]) on conftest's virtual CPU devices, to tests/test_torch_vcm.py's
  tolerance: film mean within 1e-3 relative, >= 95% of pixels within
  1e-4 relative (of max(|value|, 1e-3)).  bpt and lt do not merge, so
  JAX's CPU merge route does not enter; vcm and ppm are held against JAX
  through the port's single-process frame (tests/test_torch_vcm.py).
"""

import datetime
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed import HashStore, PrefixStore, ProcessGroupGloo

from imbatracer_tpu.parallel import shard as jshard
from imbatracer_tpu.render.camera import make_camera as jcamera
from imbatracer_tpu.scene import procedural as jproc
from imbatracer_torch.convert import scene_from_numpy, scene_to_numpy
from imbatracer_torch.frontend.engine import make_frame_fn
from imbatracer_torch.frontend.renderer import (ProgressiveRenderer,
                                                RenderSettings)
from imbatracer_torch.parallel import shard
from imbatracer_torch.parallel.comm import Comm
from imbatracer_torch.render import light_cache as tlc
from imbatracer_torch.render.camera import make_camera as tcamera
from imbatracer_torch.render.integrators import pt as tpt
from imbatracer_torch.render.integrators import vcm as tvcm
from imbatracer_torch.render.integrators.pt import render_pt_frame
from torch_threads import cap_torch_threads

cap_torch_threads()

W, MAX_LEN, LPC, RADIUS, FRAME = 32, 4, 512, 0.06, 2


@pytest.fixture(scope="module")
def cornell():
    js, meta = jproc.make_cornell_scene()
    return js, scene_from_numpy(scene_to_numpy(js), "cpu"), meta


def run_ranks(world, fn):
    """fn(comm) on `world` threads, one rank each; their results in rank
    order.  A collective that waits 60 s raises."""
    store = HashStore()
    out, errors = [None] * world, []

    def rank(r):
        try:
            pg = ProcessGroupGloo(PrefixStore("shard", store), r, world,
                                  datetime.timedelta(seconds=60))
            out[r] = fn(Comm.from_group(pg, r, world, "cpu"))
        except Exception as e:         # re-raised below, in the test
            errors.append(e)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def _cam(meta, w=W, h=W):
    return tcamera(meta.cam_pos, meta.cam_dir, meta.cam_up, w, h, 60.0,
                   device="cpu")


def _kinds(scene):
    return tuple(sorted(set(scene.materials.kind.tolist())))


def _lpc(world):
    return -(-LPC // world) * world


def _assert_all_equal(films, ref):
    for f in films:
        assert f.shape == ref.shape
        assert torch.equal(f, ref)


def test_comm_collectives():
    """Row blocks of 3, 0 and 2 rows in rank order, the rank-order sum,
    broadcasts, and the counts of calls and bytes."""
    def rank(c):
        rows = torch.arange(6.0).reshape(3, 2)[:(3, 0, 2)[c.rank]] + c.rank
        got = c.all_gather_rows(rows, counts=(3, 0, 2))
        total = c.sum_in_rank_order(torch.tensor([0.1 * (c.rank + 1)]),
                                    init=torch.tensor([1e8]))
        b = c.broadcast(torch.tensor([float(c.rank + 7)]))
        flag = c.broadcast_flag(c.rank + 4, src=2)
        return got, total, b, flag, c.calls, c.bytes, c.kinds

    for got, total, b, flag, calls, nbytes, kinds in run_ranks(3, rank):
        assert torch.equal(got, torch.tensor(
            [[0.0, 1.0], [2.0, 3.0], [4.0, 5.0], [2.0, 3.0], [4.0, 5.0]]))
        assert torch.equal(total, ((torch.tensor([1e8]) + 0.1) + 0.2) + 0.3)
        assert float(b) == 7.0 and flag == 6
        assert calls == 4 and kinds == {"all_gather": 2, "broadcast": 2}
        assert nbytes == 3 * 3 * 2 * 4 + 3 * 4 + 4 + 8


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("spp", [1, 2])
def test_pt_frame_equals_one_process(cornell, world, spp):
    _, ts, meta = cornell
    cam = _cam(meta)
    ref = render_pt_frame(ts, cam, FRAME, W, W, spp=spp, max_len=MAX_LEN)
    _assert_all_equal(run_ranks(world, lambda c: shard.render_pt_frame_sharded(
        ts, cam, FRAME, W, W, c, spp=spp, max_len=MAX_LEN)), ref)


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("algo", ["vcm", "bpt", "ppm", "lt", "pt"])
def test_vcm_family_frame_equals_one_process(cornell, algo, world):
    _, ts, meta = cornell
    cam = _cam(meta)
    lpc = _lpc(world)
    kw = dict(algo=algo, width=W, height=W, max_len=MAX_LEN,
              light_path_count=lpc, mat_kinds=_kinds(ts))
    ref = tvcm.render_vcm_frame(ts, cam, FRAME, RADIUS,
                                light_band=lpc // world, **kw)
    assert float(ref.mean()) > 0.0
    _assert_all_equal(run_ranks(world, lambda c: shard.render_vcm_frame_sharded(
        ts, cam, FRAME, RADIUS, c, **kw)), ref)


@pytest.mark.parametrize("algo", ["vcm", "lt"])
def test_light_steps_equal_one_process_bands(cornell, algo):
    """Four light steps of 64 paths a rank at 2 ranks: the single
    process's light pass in 8 bands of 64, and the stats of one process."""
    _, ts, meta = cornell
    cam = _cam(meta)
    kw = dict(algo=algo, width=W, height=W, max_len=MAX_LEN,
              light_path_count=LPC, mat_kinds=_kinds(ts), light_band=64)
    ref_stats = {}
    ref = tvcm.render_vcm_frame(ts, cam, FRAME, RADIUS, stats=ref_stats, **kw)

    def rank(c):
        st = {}
        return shard.render_vcm_frame_sharded(ts, cam, FRAME, RADIUS, c,
                                              stats=st, **kw), st

    got = run_ranks(2, rank)
    _assert_all_equal([g[0] for g in got], ref)
    for _, st in got:
        assert st.keys() == ref_stats.keys()
        for k, v in ref_stats.items():
            assert int(st[k]) == int(v), k


@pytest.mark.parametrize("algo", ["pt", "vcm"])
def test_compacted_frames_equal_one_process(cornell, algo, monkeypatch):
    _, ts, meta = cornell
    cam = _cam(meta)
    monkeypatch.setattr(tpt, "BAND_RAYS", 128)
    monkeypatch.setattr(tpt, "COMPACT_DEPTH", 2)
    monkeypatch.setattr(tvcm, "VCM_COMPACT_DEPTH", 2)
    if algo == "pt":
        refs = [render_pt_frame(ts, cam, FRAME, W, W, max_len=MAX_LEN,
                                compact=compact) for compact in (True, False)]
        got = run_ranks(2, lambda c: shard.render_pt_frame_sharded(
            ts, cam, FRAME, W, W, c, max_len=MAX_LEN, compact=True))
    else:
        kw = dict(algo=algo, width=W, height=W, max_len=MAX_LEN,
                  light_path_count=LPC, mat_kinds=_kinds(ts), camera_band=128)
        refs = [tvcm.render_vcm_frame(ts, cam, FRAME, RADIUS,
                                      light_band=LPC // 2, compact=compact,
                                      **kw) for compact in (True, False)]
        got = run_ranks(2, lambda c: shard.render_vcm_frame_sharded(
            ts, cam, FRAME, RADIUS, c, compact=True, **kw))
    assert float(refs[0].mean()) > 0.0
    for ref in refs:
        _assert_all_equal(got, ref)


def _collect(ts, cam, algo, path_ranges, capacity, lpc):
    """A collect cache of the light passes over `path_ranges`."""
    pm, evc, evm = tvcm._mis_constants(torch.tensor(FRAME), torch.tensor(
        RADIUS), lpc, algo)
    collect = tlc.empty_collect(capacity, "cpu")
    for start, n in path_ranges:
        tvcm._light_pass(
            ts, cam, torch.tensor(FRAME), evc, evm, collect, algo=algo,
            num_pixels=W * W, light_path_count=lpc, max_len=MAX_LEN,
            alpha_fn=None, has_bump=False, path_start=start, band_paths=n)
    collect.check()
    return collect.cache()


@pytest.mark.parametrize("world", [2, 3])
def test_gathered_cache_equals_one_process(cornell, world):
    _, ts, meta = cornell
    cam = _cam(meta)
    lpc = _lpc(world)
    bp = lpc // world
    capacity = tvcm.auto_cache_capacity(lpc, MAX_LEN)
    whole = _collect(ts, cam, "vcm", [(0, lpc)], lpc * MAX_LEN, lpc)
    ref = tlc.select_shallowest(whole, capacity)
    assert 0 < int(ref.count) < int(whole.count)     # the capacity cuts
    got = run_ranks(world, lambda c: shard.gather_cache(c, _collect(
        ts, cam, "vcm", [(c.rank * bp, bp)], bp * MAX_LEN, lpc), capacity))
    for cache in got:
        assert int(cache.count) == int(ref.count)
        assert torch.equal(cache.packed(), ref.packed())


def _synthetic(rs, paths, first):
    """Packed vertices of paths first..first+paths-1, 0-3 a path."""
    rows = []
    for p in range(first, first + paths):
        for length in range(1, rs.randint(0, 4) + 1):
            f = torch.from_numpy(rs.rand(1, 24).astype(np.float32))
            i = lambda v: torch.tensor([v], dtype=torch.int32)
            rows.append(tlc.pack_batch(
                f[:, 0:3], f[:, 3:6], f[:, 6:9], f[:, 9:12], f[:, 12:14],
                i(rs.randint(0, 5)), f[:, 15:18], f[:, 18], f[:, 19],
                f[:, 20], i(length), i(p)))
    return torch.cat(rows) if rows else torch.zeros((0, 24))


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("capacity", [40, 400])
def test_gather_cache_on_synthetic_vertices(world, capacity):
    rs = np.random.RandomState(7 + world)
    per_rank = 30
    parts = [_synthetic(rs, per_rank, r * per_rank) for r in range(world)]
    # The single process appends its bands in path order.
    ref = tlc.select_shallowest(tlc.from_rows(torch.cat(parts), 4096),
                                capacity)
    got = run_ranks(world, lambda c: shard.gather_cache(
        c, tlc.from_rows(parts[c.rank], per_rank * 4), capacity))
    for cache in got:
        assert cache.capacity == ref.capacity
        assert int(cache.count) == int(ref.count)
        assert torch.equal(cache.packed(), ref.packed())


@pytest.mark.parametrize("world,w,h", [(2, 13, 5), (3, 13, 5), (3, 13, 2)])
def test_tails_cover_every_pixel_once(cornell, world, w, h):
    _, ts, meta = cornell
    cam = _cam(meta, w, h)
    rows = [shard.row_range(h, r, world) for r in range(world)]
    assert rows[0][0] == 0 and rows[-1][1] == h
    assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
    ref = render_pt_frame(ts, cam, FRAME, w, h, max_len=3)
    _assert_all_equal(run_ranks(world, lambda c: shard.render_pt_frame_sharded(
        ts, cam, FRAME, w, h, c, max_len=3)), ref)
    kw = dict(algo="bpt", width=w, height=h, max_len=3,
              light_path_count=-(-256 // world) * world,
              mat_kinds=_kinds(ts))
    vref = tvcm.render_vcm_frame(ts, cam, FRAME, RADIUS,
                                 light_band=kw["light_path_count"] // world,
                                 **kw)
    _assert_all_equal(run_ranks(world, lambda c: shard.render_vcm_frame_sharded(
        ts, cam, FRAME, RADIUS, c, **kw)), vref)


def test_indivisible_light_path_count_raises(cornell):
    _, ts, meta = cornell
    cam = _cam(meta, 13, 5)
    with pytest.raises(ValueError, match="divisible"):
        run_ranks(2, lambda c: shard.render_vcm_frame_sharded(
            ts, cam, FRAME, RADIUS, c, algo="bpt", width=13, height=5,
            max_len=3, light_path_count=255))


def test_row_bands_are_whole_rows():
    assert shard.row_bands(0, 1080, 1920, 1 << 18) == [
        (y * 1920, min(136, 1080 - y) * 1920) for y in range(0, 1080, 136)]
    assert shard.row_bands(3, 9, 10, 25) == [(30, 20), (50, 20), (70, 20)]
    assert shard.row_bands(0, 2, 100, 10) == [(0, 100), (100, 100)]


@pytest.mark.parametrize("algo,calls", [
    ("pt", 1), ("vcm", 1 + 2 + 1), ("bpt", 1 + 2 + 1), ("lt", 1),
    ("vcm_pt", 1)])
def test_collective_census(cornell, algo, calls):
    """Collectives a frame at 2 ranks (one light step by default; four
    with 64-path steps), and a frame of the progressive loop."""
    _, ts, meta = cornell
    settings = RenderSettings(width=W, height=W, max_path_len=MAX_LEN,
                              algorithm=algo, light_path_count=LPC,
                              max_samples=3)

    def rank(c):
        frame_fn, cam = make_frame_fn(ts, meta, settings, comm=c)
        got = {"setup": dict(c.kinds)}
        c.reset_counts()
        frame_fn(FRAME)
        got["frame"] = c.calls
        c.reset_counts()
        ProgressiveRenderer(frame_fn, settings, "cpu", comm=c).run(quiet=True)
        got["loop"] = c.calls
        c.reset_counts()
        if algo == "pt":
            shard.render_pt_frame_sharded(ts, cam, FRAME, W, W, c,
                                          max_len=MAX_LEN, with_stats=True)
        elif algo in ("vcm", "lt"):
            shard.render_vcm_frame_sharded(
                ts, cam, FRAME, RADIUS, c, algo=algo, width=W, height=W,
                max_len=MAX_LEN, light_path_count=LPC, light_band=64)
        got["variant"] = c.calls
        return got

    for got in run_ranks(2, rank):
        assert got["setup"] == ({"all_gather": 1, "broadcast": 1}
                                if algo == "vcm" else {"all_gather": 1})
        assert got["frame"] == calls
        assert got["loop"] == 3 * (calls + 1)
        assert got["variant"] == {"pt": 2, "vcm": 4 + 2 + 1, "lt": 4}.get(
            algo, 0)


def _assert_films_agree(tf, jf):
    assert tf.shape == jf.shape and np.isfinite(tf).all()
    assert jf.mean() > 0.0
    assert abs(tf.mean() - jf.mean()) / jf.mean() <= 1e-3
    rel = np.abs(tf - jf) / np.maximum(np.abs(jf), 1e-3)
    assert (rel.max(axis=-1) <= 1e-4).mean() >= 0.95


@pytest.mark.parametrize("algo", ["pt-dedicated", "bpt", "lt"])
def test_sharded_frames_match_jax(cornell, algo):
    js, ts, meta = cornell
    mesh = jshard.make_mesh(jax.devices()[:2])
    jcam = jcamera(meta.cam_pos, meta.cam_dir, meta.cam_up, W, W, 60.0)
    cam = _cam(meta)
    if algo == "pt-dedicated":
        jf = jshard.render_pt_frame_sharded(js, jcam, jnp.uint32(FRAME), W, W,
                                            mesh, max_len=MAX_LEN)
        got = run_ranks(2, lambda c: shard.render_pt_frame_sharded(
            ts, cam, FRAME, W, W, c, max_len=MAX_LEN))
    else:
        jf = jshard.render_vcm_frame_sharded(
            js, jcam, jnp.uint32(FRAME), jnp.float32(RADIUS), mesh, algo=algo,
            width=W, height=W, max_len=MAX_LEN, light_path_count=LPC,
            mat_kinds=_kinds(ts))
        got = run_ranks(2, lambda c: shard.render_vcm_frame_sharded(
            ts, cam, FRAME, RADIUS, c, algo=algo, width=W, height=W,
            max_len=MAX_LEN, light_path_count=LPC, mat_kinds=_kinds(ts)))
    for g in got:
        _assert_films_agree(g.numpy(), np.asarray(jf))
