"""The port's split-BVH builders (imbatracer_torch.accel.sbvh and
accel.native.build_sbvh_native) against the JAX package's, and the
port's traversal over the multiset of references they make.

* Both builders give exactly JAX's `BvhNodes` on the same triangles and
  reference budget (the port's are copies, and both are deterministic),
  and beat the binned build's SAH cost as JAX's test asks (< 0.92x), on
  tests/test_sbvh.py's class of long thin diagonal triangles.
* Leaf packing (accel/flatten.thread_bvh, stream tiles) takes the
  multiset: one tile row per reference, rows of one triangle identical.
* khit over a split build: no row repeats an id; the rows hold the K
  nearest distinct triangles of a float64 brute force (t within 2e-4
  relative, as tests/test_torch_khit.py holds it); they equal JAX's
  `khit_sorted` in interpret mode (ids up to bit-equal-t ties; u and v
  within 5e-4, see the test) and the
  binned build's rows (t, u, v bit for bit: both test the same triangles
  with the same arithmetic).
* Closest and any hit over the split build equal the binned build's, as
  tests/test_sbvh.py:47-68 holds them.
"""

import dataclasses

import numpy as np
import pytest
import torch

from imbatracer_tpu.accel import native as jnative
from imbatracer_tpu.accel.sbvh import build_sbvh as jbuild_sbvh
from imbatracer_torch.accel.builder import build_bvh, triangle_bboxes
from imbatracer_torch.accel.device import DeviceBvh
from imbatracer_torch.accel.flatten import CHUNK, SUPER, thread_bvh
from imbatracer_torch.accel.native import build_bvh_native, build_sbvh_native
from imbatracer_torch.accel.sbvh import build_sbvh, sah_cost
from imbatracer_torch.ops import khit as kh
from imbatracer_torch.ops import stream_traverse as st
from imbatracer_torch.render import traverse as tt
from imbatracer_torch.render.intersect import BIG
from test_torch_khit import _both, _brute_hits
from torch_jax_native import ensure_jax_native
from torch_threads import cap_torch_threads

cap_torch_threads()
ensure_jax_native()

K = kh.K


def _thin_tri_scene(n=1500, seed=0):
    """tests/test_sbvh.py's scene: long thin diagonal triangles."""
    rs = np.random.RandomState(seed)
    base = rs.rand(n, 3).astype(np.float32) * 10
    d1 = (np.tile(np.array([[3.0, 3.0, 3.0]], np.float32), (n, 1))
          + rs.randn(n, 3).astype(np.float32) * 0.05)
    d2 = rs.randn(n, 3).astype(np.float32) * 0.05
    return np.stack([base, base + d1, base + d2], axis=1)


def _references(nodes):
    """Reference count per triangle, over the leaves."""
    leaf = nodes.right == -1
    ids = np.concatenate([nodes.prim_ids[s:s + c] for s, c in
                          zip(nodes.start[leaf], nodes.count[leaf])])
    return np.bincount(ids)


@pytest.mark.parametrize("route", ["numpy", "native"])
def test_split_builders_match_jax(route):
    verts = _thin_tri_scene()
    lo, hi = triangle_bboxes(verts[:, 0], verts[:, 1], verts[:, 2])
    if route == "numpy":
        port = build_sbvh(lo, hi, verts, ref_budget=3.0)
        ref = jbuild_sbvh(lo, hi, verts, ref_budget=3.0)
    else:
        port = build_sbvh_native(verts, ref_budget=3.0)
        ref = jnative.build_sbvh_native(verts, ref_budget=3.0)
    assert ref is not None
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    refs = _references(port)
    assert refs.shape[0] == verts.shape[0] and (refs >= 1).all()
    assert refs.max() > 1
    assert port.prim_ids.shape[0] <= 3 * verts.shape[0] + 16
    assert sah_cost(port) < 0.92 * sah_cost(build_bvh(lo, hi))


@pytest.fixture(scope="module")
def builds():
    """The thin-triangle scene (600 triangles) packed from a split build
    (ref_budget 3.0) and from the binned build: {name: (verts, packed,
    (sbox, tiles, center))}."""
    verts = _thin_tri_scene(n=600, seed=3)
    v0, v1, v2 = verts[:, 0], verts[:, 1], verts[:, 2]
    out = {}
    for name, nodes in (("split", build_sbvh_native(verts, ref_budget=3.0)),
                        ("binned",
                         build_bvh_native(*triangle_bboxes(v0, v1, v2)))):
        p = thread_bvh(nodes, v0, v1, v2)
        out[name] = (verts, nodes, p, st.pack_stream_tiles(
            p.tri_v0, p.tri_e1, p.tri_e2, p.tri_id))
    return out


def test_leaf_packing_takes_references(builds):
    verts, nodes, p, (sbox, tiles, center) = builds["split"]
    ids = p.tri_id[p.tri_id >= 0]
    np.testing.assert_array_equal(np.sort(ids), np.sort(nodes.prim_ids))
    assert ids.shape[0] > (builds["binned"][2].tri_id >= 0).sum()
    have = p.tri_id >= 0
    np.testing.assert_array_equal(p.tri_v0[have], verts[ids, 0])
    np.testing.assert_array_equal(p.tri_e1[have], verts[ids, 1] -
                                  verts[ids, 0])
    assert sbox.shape[0] == -(-p.tri_id.shape[0] // (CHUNK * SUPER))
    assert sbox.shape[0] >= builds["binned"][3][0].shape[0]
    np.testing.assert_array_equal(center, builds["binned"][3][2])


def _rays(verts, n, seed):
    """Half the rays aimed at a point inside a random triangle (so they
    meet at least it), half in random directions; origins around the
    scene."""
    rs = np.random.RandomState(seed)
    org = (rs.rand(n, 3) * 14 - 2).astype(np.float32)
    tri = verts[rs.randint(0, verts.shape[0], n)]
    b = rs.dirichlet((1, 1, 1), n).astype(np.float32)
    aim = (b[:, :, None] * tri).sum(1) - org
    d = rs.randn(n, 3).astype(np.float32)
    d[: n // 2] = aim[: n // 2]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org, d


def _ties(t):
    """Slots whose t equals a neighbouring slot's bit for bit."""
    tie = np.zeros(t.shape, bool)
    for k in range(1, t.shape[1]):
        eq = (t[:, k] == t[:, k - 1]) & (t[:, k] < BIG)
        tie[:, k] |= eq
        tie[:, k - 1] |= eq
    return tie


def test_khit_over_split_build(builds):
    verts, _, _, (sbox, tiles, center) = builds["split"]
    n = 512
    org, d = _rays(verts, n, 7)
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, BIG, np.float32)
    port, ref = _both(sbox, tiles, org - center, d, tmin, tmax)
    t, _, _, ids = port

    # No row repeats an id.
    for k in range(K):
        for j in range(k):
            assert not ((ids[:, k] >= 0) & (ids[:, k] == ids[:, j])).any()

    # The K nearest distinct triangles of a float64 brute force.
    v0, v1, v2 = verts[:, 0], verts[:, 1], verts[:, 2]
    all_t = _brute_hits(v0, v1, v2, org, d, 0.0, BIG)
    want = np.sort(all_t, axis=1)[:, :K]
    have = want < BIG
    assert ((ids >= 0) == have).all()
    np.testing.assert_allclose(t[have], want[have], rtol=2e-4)
    rows = np.nonzero(have)[0]
    np.testing.assert_allclose(all_t[rows, ids[have]], t[have], rtol=2e-4)
    assert (have.sum(1) >= 2).sum() > 50

    # JAX's khit_sorted in interpret mode: hits, ids and t as
    # tests/test_torch_khit.py holds them; u and v within 5e-4, as the
    # barycentric numerators of these thin triangles (0.05 wide, 5 long)
    # cancel to a few ulps of a det close to 0, where XLA's contracted
    # products and the port's rounded ones part (2.3e-4 seen).
    jt, ju, jv, jid = ref
    tie = _ties(t)
    assert ((ids >= 0) == (jid >= 0)).all()
    np.testing.assert_allclose(t[have], jt[have], rtol=1e-5, atol=1e-6)
    same = have & (ids == jid)
    assert (same | (have & tie) | ~have).all()
    for a, b in ((port[1], ju), (port[2], jv)):
        np.testing.assert_allclose(a[same], b[same], rtol=0, atol=5e-4)

    # The binned build's rows: t, u, v bit for bit, ids up to ties.
    _, _, _, (bsbox, btiles, bcenter) = builds["binned"]
    tb = lambda a: torch.as_tensor(np.asarray(a))
    binned = [x.numpy() for x in kh.khit_sorted(
        tb(bsbox), tb(btiles), tb(org - bcenter), tb(d), tb(tmin),
        tb(tmax))]
    for a, b in zip(port[:3], binned[:3]):
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    assert ((ids == binned[3]) | tie).all()


def test_closest_and_any_hit_over_split_build(builds):
    verts = builds["split"][0]
    bvh = {name: DeviceBvh.from_packed(p.tri_v0, p.tri_e1, p.tri_e2,
                                       p.tri_id, device="cpu")
           for name, (_, _, p, _) in builds.items()}
    rs = np.random.RandomState(11)
    n = 2048
    org = torch.from_numpy(rs.rand(n, 3).astype(np.float32) * 14 - 2)
    d = torch.nn.functional.normalize(
        torch.from_numpy(rs.randn(n, 3).astype(np.float32)), dim=1)
    org[:256], d[:256] = (torch.from_numpy(x) for x in _rays(verts, 256, 5))
    ha = tt.closest_hit(bvh["binned"], org, d, 0.0, BIG)
    hb = tt.closest_hit(bvh["split"], org, d, 0.0, BIG)
    np.testing.assert_array_equal(ha.prim_id.numpy(), hb.prim_id.numpy())
    m = (ha.prim_id >= 0).numpy()
    assert m.sum() > 200
    np.testing.assert_allclose(ha.t.numpy()[m], hb.t.numpy()[m], rtol=1e-4)
    tmax = torch.where(ha.prim_id >= 0, ha.t * 1.01, 5.0)
    np.testing.assert_array_equal(
        tt.any_hit(bvh["binned"], org, d, 0.0, tmax).numpy(),
        tt.any_hit(bvh["split"], org, d, 0.0, tmax).numpy())


def test_build_scene_spatial_matches_jax(tmp_path, monkeypatch):
    """build_scene(spatial=True) on a small written flat scene (one
    instance of each mesh, packed close so the split build duplicates a
    reference): every array equal to the JAX package's build, through
    convert.scene_to_numpy."""
    from imbatracer_tpu.scene.build import build_scene as jbuild
    from imbatracer_torch.convert import scene_to_numpy
    from imbatracer_torch.scene.build import build_scene
    from imbatracer_torch.scene.generate import write_instanced_scene

    monkeypatch.setenv("IMBATRACER_CACHE_DIR", str(tmp_path / "accel"))
    path = write_instanced_scene(
        str(tmp_path / "scene"), spread=2.0,
        counts=dict(ground=1, sphere=1, blob=1, crystal=1, card=1, panel=1))
    js, _ = jbuild(path, quiet=True, spatial=True)
    ts, meta = build_scene(path, quiet=True, device="cpu", spatial=True)
    assert not ts.bvh.two_level
    assert int((ts.bvh.tri_id >= 0).sum()) > meta.num_tris
    ja, ta = scene_to_numpy(js), scene_to_numpy(ts)
    assert ja.keys() == ta.keys()
    for k, a in ja.items():
        b = ta[k]
        if a is None or isinstance(a, tuple):
            assert a == b, k
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(
            np.ascontiguousarray(a).reshape(-1).view(np.uint8),
            np.ascontiguousarray(b).reshape(-1).view(np.uint8), err_msg=k)
