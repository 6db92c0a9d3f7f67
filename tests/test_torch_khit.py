"""The port's K-nearest-hit traversal (imbatracer_torch.ops.khit, plain
PyTorch version on the CPU) against the JAX reference kernel
(imbatracer_tpu.ops.pallas_khit.khit_sorted) run in interpret mode, and
against a brute-force float64 intersector.

Tolerances: both packages round the feature-dot Moller-Trumbore test in
their own order, so t is held to 1e-5 relative against JAX (XLA may
contract products into FMAs where the port rounds each one) and 2e-4
relative against the float64 brute force (the test in float32); the sets
of present hits are equal; ids are equal except between hits of equal t
(a ray on a shared edge hits both triangles at one t, and the packages
order such ties differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imbatracer_tpu.ops import pallas_stream as ps
from imbatracer_tpu.ops.pallas_khit import khit_sorted as jkhit
from imbatracer_tpu.scene import procedural as jproc
from imbatracer_torch.accel.builder import build_bvh, triangle_bboxes
from imbatracer_torch.accel.flatten import thread_bvh
from imbatracer_torch.convert import scene_from_numpy, scene_to_numpy
from imbatracer_torch.ops import khit as kh
from imbatracer_torch.ops import stream_traverse as st

K = kh.K


def _interp(fn):
    """Run fn with pallas_call in interpret mode (the CPU reference)."""
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def interp(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)

    pl.pallas_call = interp
    try:
        return fn()
    finally:
        pl.pallas_call = orig


def _tiles(tris):
    v0 = np.asarray([t[0] for t in tris], np.float32)
    v1 = np.asarray([t[1] for t in tris], np.float32)
    v2 = np.asarray([t[2] for t in tris], np.float32)
    lo, hi = triangle_bboxes(v0, v1, v2)
    p = thread_bvh(build_bvh(lo, hi), v0, v1, v2)
    sbox, tiles, center = st.pack_stream_tiles(p.tri_v0, p.tri_e1, p.tri_e2,
                                               p.tri_id)
    return v0, v1, v2, sbox, tiles, center


def _brute_hits(v0, v1, v2, org, d, tmin, tmax):
    """All (ray, tri) intersection ts in float64, BIG where none."""
    e1 = v1 - v0
    e2 = v2 - v0
    n = np.cross(e1, e2)
    res = np.full((org.shape[0], v0.shape[0]), 1e30, np.float64)
    for r in range(org.shape[0]):
        o, dd = org[r].astype(np.float64), d[r].astype(np.float64)
        det = -(dd @ n.T)
        c = np.cross(o, dd)
        u_num = c @ e2.T + dd @ np.cross(v0, e2).T
        v_num = -(c @ e1.T) + dd @ np.cross(e1, v0).T
        t_num = o @ n.T - (v0 * n).sum(-1)
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = np.where(np.abs(det) < 1e-12, 0.0, 1.0 / det)
        t = t_num * inv
        u = u_num * inv
        v = v_num * inv
        ok = ((inv != 0) & (u >= 0) & (v >= 0) & (u + v <= 1)
              & (t > tmin) & (t < tmax))
        res[r] = np.where(ok, t, 1e30)
    return res


def _both(sbox, tiles, org, d, tmin, tmax, active=None):
    """(port, jax) khit_sorted results as NumPy (t, u, v, id)."""
    tt = lambda a: torch.as_tensor(np.asarray(a))
    port = kh.khit_sorted(tt(sbox), tt(tiles), tt(org), tt(d), tt(tmin),
                          tt(tmax), None if active is None else tt(active))

    def run():
        return jkhit(jnp.asarray(sbox), jnp.asarray(tiles), jnp.asarray(org),
                     jnp.asarray(d), jnp.asarray(tmin), jnp.asarray(tmax),
                     active=None if active is None else jnp.asarray(active))

    ref = _interp(run)
    return [x.numpy() for x in port], [np.asarray(x) for x in ref]


def _assert_khit_equal(port, ref):
    (pt, pu, pv, pid), (jt, ju, jv, jid) = port, ref
    assert ((pid >= 0) == (jid >= 0)).all()
    have = pid >= 0
    np.testing.assert_allclose(pt[have], jt[have], rtol=1e-5, atol=1e-6)
    assert (pt[~have] == st.BIG).all() and (jt[~have] == st.BIG).all()
    # Ids equal except between hits of equal t (shared-edge ties).
    tied = np.zeros_like(have)
    for k in range(K):
        for j in range(K):
            if j != k:
                tied[:, k] |= (pt[:, k] == pt[:, j]) & have[:, j]
    same = have & (pid == jid)
    assert (same | (have & tied) | ~have).all()
    np.testing.assert_allclose(pu[same], ju[same], rtol=0, atol=1e-4)
    np.testing.assert_allclose(pv[same], jv[same], rtol=0, atol=1e-4)
    assert (pu[~have] == 0).all() and (pv[~have] == 0).all()


@pytest.fixture(scope="module")
def stacked():
    """Eight stacked parallel quads plus 60 random clutter triangles:
    many rays cross more than K surfaces (tests/test_khit.py's fixture)."""
    rs = np.random.RandomState(11)
    tris = []
    for k in range(8):
        y = 0.5 + 0.5 * k
        tris += [((-2, y, 2), (2, y, 2), (2, y, -2)),
                 ((-2, y, 2), (2, y, -2), (-2, y, -2))]
    for _ in range(60):
        a = rs.uniform(-2, 2, 3)
        tris.append((a, a + rs.uniform(-0.5, 0.5, 3),
                     a + rs.uniform(-0.5, 0.5, 3)))
    v0, v1, v2, sbox, tiles, center = _tiles(tris)
    n = 64
    org = np.stack([rs.uniform(-1.8, 1.8, n), np.full(n, 8.0, np.float32),
                    rs.uniform(-1.8, 1.8, n)], axis=1).astype(np.float32)
    d = np.tile(np.asarray([[0.0, -1.0, 0.0]], np.float32), (n, 1))
    d[n // 2:] = rs.randn(n - n // 2, 3).astype(np.float32)
    d[n // 2:] /= np.linalg.norm(d[n // 2:], axis=1, keepdims=True)
    return v0, v1, v2, sbox, tiles, center, org, d


def test_khit_matches_jax_and_brute_force(stacked):
    v0, v1, v2, sbox, tiles, center, org, d = stacked
    n = org.shape[0]
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, 1e30, np.float32)
    port, ref = _both(sbox, tiles, org - center, d, tmin, tmax)
    _assert_khit_equal(port, ref)

    all_t = _brute_hits(v0, v1, v2, org, d, 0.0, 1e30)
    want = np.sort(all_t, axis=1)[:, :K]
    have = want < 1e30
    assert ((port[3] >= 0) == have).all()
    np.testing.assert_allclose(port[0][have], want[have], rtol=2e-4)
    assert (np.sum(all_t < 1e30, axis=1) > K).any()


def test_khit_respects_active_and_tmin():
    tris = [((-2, 1, 2), (2, 1, 2), (2, 1, -2)),
            ((-2, 1, 2), (2, 1, -2), (-2, 1, -2)),
            ((-2, 3, 2), (2, 3, 2), (2, 3, -2)),
            ((-2, 3, 2), (2, 3, -2), (-2, 3, -2))]
    _, _, _, sbox, tiles, center = _tiles(tris)
    # Off the quads' shared diagonal, where a ray hits both triangles.
    org = np.tile([[0.3, 8.0, 0.2]], (4, 1)).astype(np.float32) - center
    d = np.tile([[0.0, -1.0, 0.0]], (4, 1)).astype(np.float32)
    tmin = np.asarray([0.0, 6.0, 0.0, 0.0], np.float32)   # lane 1 skips y=3
    tmax = np.full(4, 1e30, np.float32)
    act = np.asarray([True, True, False, True])
    port, ref = _both(sbox, tiles, org, d, tmin, tmax, act)
    _assert_khit_equal(port, ref)
    t4, _, _, id4 = port
    np.testing.assert_allclose(t4[0, :2], [5.0, 7.0], rtol=1e-5)
    assert id4[0, 2] < 0
    np.testing.assert_allclose(t4[1, 0], 7.0, rtol=1e-5)
    assert id4[1, 1] < 0
    assert (id4[2] < 0).all() and (t4[2] == st.BIG).all()
    np.testing.assert_allclose(t4[3, :2], [5.0, 7.0], rtol=1e-5)


@pytest.mark.parametrize("bounded", [False, True])
def test_khit_multi_superchunk_matches_jax(bounded):
    """Random rays through make_big_scene(110) (two super-chunks), mixed
    tmin, ~80% active, unbounded or bounded tmax."""
    js, _ = jproc.make_big_scene(num_boxes=110, seed=9)
    ts = scene_from_numpy(scene_to_numpy(js), "cpu")
    sbox, tiles = ts.bvh.sbox.numpy(), ts.bvh.tiles.numpy()
    assert sbox.shape[0] > 1
    rs = np.random.RandomState(5)
    n = 512
    org = rs.uniform((-30, 1, -30), (30, 10, 30), (n, 3)).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = rs.uniform(0.0, 2.0, n).astype(np.float32)
    tmax = (rs.uniform(3.0, 40.0, n) if bounded
            else np.full(n, 1e30)).astype(np.float32)
    act = rs.rand(n) < 0.8
    port, ref = _both(sbox, tiles, org - ts.bvh.center.numpy(), d, tmin,
                      tmax, act)
    _assert_khit_equal(port, ref)
    assert (port[3][:, 0] >= 0).sum() > 100
    assert (port[3][:, 1] >= 0).sum() > 5


def test_khit_plain_rows_and_dispatch():
    """khit() on CPU tensors is the plain version: rows of (R, 8K), the
    first hit of each row equal to the single-hit plain traversal's."""
    js, _ = jproc.make_big_scene(num_boxes=110, seed=9)
    ts = scene_from_numpy(scene_to_numpy(js), "cpu")
    rs = np.random.RandomState(2)
    n = 256
    org = torch.from_numpy(rs.uniform(-20, 20, (n, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(
        torch.from_numpy(rs.randn(n, 3).astype(np.float32)), dim=1)
    rays, _ = st.rays8(org - ts.bvh.center, d, 1e-3, st.BIG, None)
    before = dict(kh.LAUNCHES)
    rows = kh.khit(rays, ts.bvh.sbox, ts.bvh.tiles)
    assert kh.LAUNCHES["plain"] == before["plain"] + 1
    assert kh.LAUNCHES["khit"] == before["khit"]
    assert rows.shape == (n, 8 * K)
    one = st.traverse_plain(rays, ts.bvh.sbox, ts.bvh.tiles, False)
    hit = one[:, 3] >= 0
    assert hit.sum() > 50
    assert torch.equal(rows[hit, 0], one[hit, 0])
    assert torch.equal((rows[:, 3] >= 0), hit)
    # Sorted by t, absent hits last.
    t = rows[:, 0::8]
    assert bool((t[:, 1:] >= t[:, :-1]).all())
    assert bool((rows[:, 4::8] == 0).all())
    with pytest.raises(ValueError):
        kh.khit(rays.to(torch.float64).to("meta"), ts.bvh.sbox,
                ts.bvh.tiles)
