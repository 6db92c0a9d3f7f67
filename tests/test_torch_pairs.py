"""The port's pair-queue traversal (ops/pairs.py: ray_candidates, the
queue, the kernel's plain version, resolve and the saturation fallback)
against the JAX package's `ray_candidates`, `closest_hit_pairs` and
`any_hit_pairs`, with its Pallas kernels in interpret mode, on scenes of
more than K_MAX = 8 super-chunks so the fallback runs: a flat
make_big_scene(900) (S = 16) and a two-level scene of 20 overlapping box
instances (S = 20).

Tolerances: ray_candidates' idx and count equal, mindrop and the entry t
bit-equal.  Hits: ids equal except at bit-equal t; t within 1e-5
relative on at least 98% of the rays and within 1e-3 on all, u/v within
1e-4 absolute.  XLA on the CPU contracts the interpret-mode kernel's
products and sums into FMAs, and t = (o.n - v0.n) / det cancels on
grazing rays far from the triangle (and under instancing on the
ray transform too), so ~1% of the rays differ from JAX beyond 1e-5 (the
CUDA kernels and the plain versions, which round alike, agree bit for
bit: tests/test_torch_kernel_cuda.py).  u/v differ beyond 1e-4 on at
most 1% of the hits (ties on shared edges, where JAX's epilogue may mix
two triangles' fields).  Occlusion flags equal."""

import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imbatracer_tpu.accel.instancing import build_two_level as jtwo
from imbatracer_tpu.ops import pallas_pairs as jpairs
from imbatracer_tpu.scene import procedural as jproc
from imbatracer_torch.accel.device import DeviceBvh
from imbatracer_torch.accel.instancing import build_two_level
from imbatracer_torch.convert import scene_from_numpy, scene_to_numpy
from imbatracer_torch.core import math3d
from imbatracer_torch.ops import pairs as pm
from imbatracer_torch.ops import stream_traverse as st
from imbatracer_torch.render import traverse as tt
from imbatracer_torch.render.intersect import BIG
from imbatracer_torch.scene.procedural import _add_box, make_cornell_scene
from torch_threads import cap_torch_threads

cap_torch_threads()

N = 1024


def _interp(fn):
    orig = pl.pallas_call

    def interp(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)

    pl.pallas_call = interp
    try:
        return fn()
    finally:
        pl.pallas_call = orig


@pytest.fixture(scope="module")
def flat_case():
    js, _ = jproc.make_big_scene(900)
    bvh = scene_from_numpy(scene_to_numpy(js), "cpu").bvh
    rs = np.random.RandomState(3)
    org = rs.uniform((-30, 1, -30), (30, 10, 30), (N, 3)).astype(np.float32)
    org -= bvh.center.numpy()
    return bvh, org


@pytest.fixture(scope="module")
def inst_case():
    tris = []
    _add_box(tris, center=(0, 0, 0), size=(1.0, 0.3, 1.0), angle_deg=15.0,
             mat=0)
    _add_box(tris, center=(0, 0.3, 0), size=(0.6, 0.3, 0.6), angle_deg=40.0,
             mat=0)
    mesh = tuple(np.asarray([t[k] for t in tris], np.float32)
                 for k in range(3))
    rs = np.random.RandomState(4)
    insts = [dict(mesh_idx=0, face_base=i * mesh[0].shape[0],
                  matrix=math3d.instance_matrix(
                      rs.uniform(-1.5, 1.5, 3), rs.uniform(0.5, 1.5, 3),
                      rs.uniform(0, 360, 3))) for i in range(20)]
    tl = build_two_level([mesh], insts)
    bvh = DeviceBvh.from_two_level(tl.sbox, tl.tiles, tl.tile_idx,
                                   tl.inst_of, tl.itab, device="cpu")
    org = rs.uniform(-3, 3, (N, 3)).astype(np.float32)
    return bvh, org, jtwo([mesh], insts)


def _rays(org, seed):
    rs = np.random.RandomState(seed)
    d = rs.randn(org.shape[0], 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    act = rs.rand(org.shape[0]) < 0.85
    tmax = rs.uniform(0.5, 6.0, org.shape[0]).astype(np.float32)
    return d, act, tmax


def test_ray_candidates_match_jax(flat_case):
    bvh, org = flat_case
    d, _, _ = _rays(org, 5)
    rays, _ = st.rays8(torch.from_numpy(org), torch.from_numpy(d), 1e-3, BIG,
                       None)
    idx, ent, count, mindrop = pm.ray_candidates(rays, bvh.sbox)
    jidx, jent, jcount, jmin = jpairs.ray_candidates(
        jnp.asarray(rays.numpy().T), jnp.asarray(bvh.sbox.numpy()))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(count.numpy(), np.asarray(jcount))
    np.testing.assert_array_equal(ent.numpy(), np.asarray(jent))
    np.testing.assert_array_equal(mindrop.numpy(), np.asarray(jmin))
    assert idx.shape[1] == pm.K_MAX and int((count > pm.K_MAX).sum()) > 0


def test_build_queue_sorts_pairs_by_superchunk(flat_case):
    bvh, org = flat_case
    d, act, _ = _rays(org, 6)
    rays, _ = st.rays8(torch.from_numpy(org), torch.from_numpy(d), 1e-3, BIG,
                       torch.from_numpy(act))
    idx, _, _, _ = pm.ray_candidates(rays, bvh.sbox)
    rows, sc, order = pm.build_queue(idx, rays, bvh.sbox.shape[0])
    valid = sc >= 0
    assert bool((sc[valid][1:] >= sc[valid][:-1]).all())
    assert bool(valid[:int(valid.sum())].all())       # sentinels last
    assert int(valid.sum()) == int((idx >= 0).sum())
    assert torch.equal(rows[:, :7], rays[order // idx.shape[1], :7])
    assert bool((rows[~valid, 7] == -1.0).all())


def _hold_hits(t, pid, u, v, jt, jid, ju, jv):
    tie = (pid != jid) & (t == jt)
    assert ((pid == jid) | tie).all()
    same = (pid == jid) & (pid >= 0)
    assert same.sum() > 100
    rel = np.abs(t[same] - jt[same]) / np.maximum(np.abs(jt[same]), 1e-6)
    assert (rel <= 1e-5).mean() >= 0.98 and rel.max() <= 1e-3
    # JAX's lane-column epilogue takes u, v and id each as the maximum
    # over the columns holding the best t, so on an exact tie between two
    # triangles (a shared edge) it may pair one's id with the other's
    # u / v; its FMA rounding can then also move t by an ulp.
    off = (np.abs(u - ju) > 1e-4) | (np.abs(v - jv) > 1e-4)
    assert (off & same).sum() <= 0.01 * same.sum()


@pytest.mark.parametrize("case", ["flat", "instanced"])
def test_pair_routes_match_jax(flat_case, inst_case, case):
    if case == "flat":
        (bvh, org), jinst = flat_case, None
    else:
        bvh, org, tl = inst_case
        jinst = (jnp.asarray(tl.tile_idx), jnp.asarray(tl.inst_of),
                 jnp.asarray(tl.itab))
    assert bvh.sbox.shape[0] > pm.K_MAX
    d, act, tmax = _rays(org, 7)
    sbox, tiles = jnp.asarray(bvh.sbox.numpy()), jnp.asarray(bvh.tiles.numpy())

    def run():
        h = jpairs.closest_hit_pairs(sbox, tiles, jnp.asarray(org),
                                     jnp.asarray(d), 1e-3, BIG,
                                     active=jnp.asarray(act), inst=jinst)
        occ = jpairs.any_hit_pairs(sbox, tiles, jnp.asarray(org),
                                   jnp.asarray(d), 1e-3, jnp.asarray(tmax),
                                   active=jnp.asarray(act), inst=jinst)
        return [np.asarray(x) for x in h], np.asarray(occ)

    (jt, jid, ju, jv), jocc = _interp(run)
    o, dd, a = (torch.from_numpy(x) for x in (org, d, act))
    before = dict(pm.FALLBACK)
    rows = pm.closest_hit_pairs(bvh.sbox, bvh.tiles, o, dd, 1e-3, BIG, a,
                                inst=bvh.inst)
    assert pm.FALLBACK["rays"] > before["rays"]           # the fallback ran
    pid = rows[:, 3].to(torch.int32).numpy()
    t = np.where(pid >= 0, rows[:, 0].numpy(), BIG)
    _hold_hits(t, pid, rows[:, 1].numpy(), rows[:, 2].numpy(), jt, jid, ju,
               jv)
    occ = pm.any_hit_pairs(bvh.sbox, bvh.tiles, o, dd, 1e-3,
                           torch.from_numpy(tmax), a, inst=bvh.inst)
    np.testing.assert_array_equal(occ[:, 0].numpy() > 0, jocc)
    assert 0 < jocc.sum() < N


@pytest.mark.parametrize("k_max", [2, 8])
def test_pair_route_is_exact(inst_case, k_max):
    """With any cap the route equals the stream kernel's plain version
    (the fallback makes a saturated ray exact)."""
    bvh, org, _ = inst_case
    d, act, tmax = _rays(org, 8)
    rays, _ = st.rays8(torch.from_numpy(org), torch.from_numpy(d), 1e-3, BIG,
                       torch.from_numpy(act))
    for occl in (False, True):
        if occl:
            rays[:, 7] = torch.where(rays[:, 7] >= 0,
                                     torch.from_numpy(np.resize(tmax, 1024)),
                                     -1.0)
        got = pm.pair_rows(rays, bvh.sbox, bvh.tiles, occl, bvh.inst, k_max)
        want = st.traverse_plain(rays, bvh.sbox, bvh.tiles, occl, bvh.inst)
        if occl:
            assert torch.equal(got[:, 0], want[:, 0])
        else:
            same = got[:, 3] == want[:, 3]
            assert bool((same | (got[:, 0] == want[:, 0])).all())
            assert torch.equal(got[same, :3], want[same, :3])


def test_pairs_switch_routes_sorted_dispatches(flat_case):
    """With the BVH's pairs switch on, sorted unmasked dispatches on
    scenes of at least PAIRS_MIN_SUPERCHUNKS super-chunks take the pair
    queue; unsorted ones and small scenes keep the stream kernel."""
    import dataclasses

    bvh, org = flat_case
    d, _, _ = _rays(org, 9)
    o, dd = torch.from_numpy(org) + bvh.center, torch.from_numpy(d)
    on = dataclasses.replace(bvh, pairs=True)
    p0 = pm.LAUNCHES["plain"]
    h_on = tt.closest_hit(on, o, dd, 1e-3, BIG, sort=True)
    assert pm.LAUNCHES["plain"] == p0 + 1
    h_off = tt.closest_hit(bvh, o, dd, 1e-3, BIG, sort=True)
    assert torch.equal(h_on.prim_id, h_off.prim_id)
    tt.closest_hit(on, o, dd, 1e-3, BIG, sort=False)
    tt.any_hit(on, o, dd, 1e-3, 2.0, sort=True)
    assert pm.LAUNCHES["plain"] == p0 + 2
    small, _ = make_cornell_scene(device="cpu")
    sb = dataclasses.replace(small.bvh, pairs=True)
    assert sb.sbox.shape[0] < tt.PAIRS_MIN_SUPERCHUNKS
    tt.closest_hit(sb, o[:64] * 0.01, dd[:64], 1e-3, BIG, sort=True)
    assert pm.LAUNCHES["plain"] == p0 + 2


@pytest.mark.parametrize("seg_len", [7, pm.SEG])
def test_segment_table_cuts_the_runs(flat_case, seg_len):
    """segment_table, the plain version of the card queue's table: rows
    ascend by super-chunk and tile build_queue's valid lanes [0, total)
    without a gap, each row's lanes share its super-chunk, and every
    segment is full but a run's last."""
    bvh, org = flat_case
    d, act, _ = _rays(org, 6)
    rays, _ = st.rays8(torch.from_numpy(org), torch.from_numpy(d), 1e-3, BIG,
                       torch.from_numpy(act))
    num_s = bvh.sbox.shape[0]
    idx, _, _, _ = pm.ray_candidates(rays, bvh.sbox)
    _, sc, _ = pm.build_queue(idx, rays, num_s)
    counts = torch.bincount(idx[idx >= 0].long(), minlength=num_s)
    tab = pm.segment_table(counts.to(torch.int32), seg_len)
    assert tab.dtype == torch.int32 and tab.shape[1] == 4
    tab = tab.long()
    sc_of, start, length = tab[:, 0], tab[:, 1], tab[:, 2]
    total = int(counts.sum())
    assert bool(((length >= 1) & (length <= seg_len)).all())
    assert torch.equal(start, torch.cumsum(length, 0) - length)
    assert int(length.sum()) == total
    assert torch.equal(torch.repeat_interleave(sc_of, length),
                       sc[:total].long())
    last = torch.ones_like(sc_of, dtype=torch.bool)
    last[:-1] = sc_of[1:] != sc_of[:-1]
    assert bool((length[~last] == seg_len).all())
    assert int((counts > seg_len).sum()) > 0
    assert bool((tab[:, 3] == 0).all())


@pytest.mark.parametrize("occl", [False, True])
def test_resolve_matches_the_route_logic(inst_case, occl):
    """resolve, the plain version of the resolve kernel, against the
    route's logic it took over: the queue's lanes put back in pair order,
    the argmin over a ray's k lanes (a lane past the ray's count is a miss
    at tmax -1), the miss row at tmax, and the saturation flag; k = 2, so
    that many rays saturate."""
    bvh, org, _ = inst_case
    d, act, tmax = _rays(org, 8)
    rays, _ = st.rays8(torch.from_numpy(org), torch.from_numpy(d), 1e-3,
                       torch.from_numpy(tmax) if occl else BIG,
                       torch.from_numpy(act))
    num_r = rays.shape[0]
    idx, _, count, mindrop = pm.ray_candidates(rays, bvh.sbox, 2)
    k = idx.shape[1]
    rows, sc, order = pm.build_queue(idx, rays, bvh.sbox.shape[0])
    lanes = torch.empty((num_r * k, 8))
    lanes[order] = pm.pairs_plain(rows, sc, bvh.tiles, occl, bvh.inst)
    out, sat = pm.resolve(rays, lanes, count, mindrop, k, occl)

    res, ray_tmax = lanes.view(num_r, k, 8), rays[:, 7]
    if occl:
        occ = (res[:, :, 0] > 0.0).any(dim=1)
        want = torch.zeros_like(rays)
        want[:, 0] = occ.to(torch.float32)
        want_sat = (count > k) & ~occ
    else:
        t = torch.where(res[:, :, 3] >= 0.0, res[:, :, 0], BIG)
        want = res[torch.arange(num_r), torch.argmin(t, dim=1)]
        found = want[:, 3] >= 0.0
        want[:, 0] = torch.where(found, want[:, 0], ray_tmax)
        want_sat = (count > k) & (~found | (want[:, 0] > mindrop))
    want_sat = want_sat & (ray_tmax >= 0.0)
    assert torch.equal(out, want)
    assert torch.equal(sat, want_sat)
    assert 0 < int(sat.sum()) < num_r
