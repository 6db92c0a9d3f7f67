"""Alpha-masked traversal of the port (imbatracer_torch.render.traverse
with an `alpha_fn`, the k-nearest-hit re-trace over the plain PyTorch
version on the CPU) against the JAX package's exact in-loop masked
traversal (mode "xla"), and the port's alpha test (`alpha_fn_for`,
`textures.sample_mask`) against the JAX package's.

Tolerances: t within 1e-5 relative (the packages round the hit test in
their own order); hit ids and occlusion flags equal; alpha-test results
equal bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imbatracer_tpu.accel.builder import build_bvh as jbuild_bvh
from imbatracer_tpu.accel.builder import triangle_bboxes as jbboxes
from imbatracer_tpu.accel.device import DeviceBvh as JBvh
from imbatracer_tpu.accel.flatten import thread_bvh as jthread
from imbatracer_tpu.render import traverse as jtr
from imbatracer_tpu.render.integrators.pt import alpha_fn_for as jalpha_for
from imbatracer_tpu.scene import procedural as jproc
from imbatracer_tpu.scene.textures import sample_mask as jsample_mask
from imbatracer_torch.accel.device import DeviceBvh
from imbatracer_torch.convert import scene_from_numpy, scene_to_numpy
from imbatracer_torch.render import traverse as tt
from imbatracer_torch.render.integrators.pt import alpha_fn_for
from imbatracer_torch.render.intersect import BIG
from imbatracer_torch.scene.textures import sample_mask
from torch_jax_native import ensure_jax_native
from torch_threads import cap_torch_threads

cap_torch_threads()
ensure_jax_native()


def _layers(layers):
    """Opaque floor at y=0 plus `layers` quads at y = 1..layers; layer
    quads are transparent where world x < 0 (tests/test_masks.py)."""
    f, half = (2, 1) if layers == 1 else (4, 2)
    tris = [((-f, 0, f), (f, 0, f), (f, 0, -f)),
            ((-f, 0, f), (f, 0, -f), (-f, 0, -f))]
    for k in range(layers):
        y = 1.0 + k
        tris += [((-half, y, half), (half, y, half), (half, y, -half)),
                 ((-half, y, half), (half, y, -half), (-half, y, -half))]
    v0 = np.asarray([t[0] for t in tris], np.float32)
    v1 = np.asarray([t[1] for t in tris], np.float32)
    v2 = np.asarray([t[2] for t in tris], np.float32)
    lo, hi = jbboxes(v0, v1, v2)
    jt = jthread(jbuild_bvh(lo, hi), v0, v1, v2, octants=True)
    port = DeviceBvh.from_packed(jt.tri_v0, jt.tri_e1, jt.tri_e2, jt.tri_id,
                                 device="cpu")
    jv = tuple(map(jnp.asarray, (v0, v1, v2)))
    tv = tuple(map(torch.from_numpy, (v0, v1, v2)))

    def jalpha(prim, u, v):
        p0, e1, e2 = jv[0][prim], jv[1][prim] - jv[0][prim], \
            jv[2][prim] - jv[0][prim]
        x = p0[:, 0] + u * e1[:, 0] + v * e2[:, 0]
        return jnp.where(prim >= 2, x >= 0.0, True)

    def talpha(prim, u, v):
        prim = prim.long()
        p0, e1, e2 = tv[0][prim], tv[1][prim] - tv[0][prim], \
            tv[2][prim] - tv[0][prim]
        x = p0[:, 0] + u * e1[:, 0] + v * e2[:, 0]
        return torch.where(prim >= 2, x >= 0.0, True)

    return JBvh.from_threaded(jt, mode="xla"), port, jalpha, talpha


@pytest.mark.parametrize("layers,top,tmax_occ", [(1, 2.0, 1.5),
                                                 (6, 8.0, 7.5)])
def test_masked_traversal_matches_jax(layers, top, tmax_occ):
    """One masked occluder over a floor, and a stack of six masked layers
    (more than K = 4): transparent rays reach the floor through every
    layer, opaque ones stop at the top layer; occlusion follows."""
    jbvh, bvh, jalpha, talpha = _layers(layers)
    n = 64
    span = 0.9 if layers == 1 else 1.5
    x = np.linspace(-span, span, n, dtype=np.float32)
    org = np.stack([x, np.full(n, top, np.float32),
                    np.zeros(n, np.float32)], axis=1)
    d = np.tile(np.asarray([[0.0, -1.0, 0.0]], np.float32), (n, 1))
    jh = jtr.closest_hit(jbvh, jnp.asarray(org), jnp.asarray(d), 0.0, BIG,
                         alpha_fn=jalpha)
    for sort in (False, True):
        th = tt.closest_hit(bvh, torch.from_numpy(org), torch.from_numpy(d),
                            0.0, BIG, alpha_fn=talpha, sort=sort)
        np.testing.assert_array_equal(th.prim_id.numpy(),
                                      np.asarray(jh.prim_id))
        np.testing.assert_allclose(th.t.numpy(), np.asarray(jh.t),
                                   rtol=1e-5)
    want_t = np.where(x < 0.0, top, top - layers)
    np.testing.assert_allclose(th.t.numpy(), want_t, rtol=1e-5)

    tmax = np.full(n, tmax_occ, np.float32)
    jo = jtr.any_hit(jbvh, jnp.asarray(org), jnp.asarray(d), 0.0,
                     jnp.asarray(tmax), alpha_fn=jalpha)
    to = tt.any_hit(bvh, torch.from_numpy(org), torch.from_numpy(d), 0.0,
                    torch.from_numpy(tmax), alpha_fn=talpha, sort=True)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(to.numpy(), x >= 0.0)


def test_masked_traversal_inactive_lanes_and_rounds():
    """Inactive lanes miss; the six-layer stack needs more than one khit
    round for the see-through rays."""
    _, bvh, _, talpha = _layers(6)
    org = torch.tensor([[-0.5, 8.0, 0.0], [0.5, 8.0, 0.0], [-0.5, 8.0, 0.0]])
    d = torch.tensor([[0.0, -1.0, 0.0]]).expand(3, 3)
    before = dict(tt.MASK_STATS)
    h = tt.closest_hit(bvh, org, d, 0.0, BIG, alpha_fn=talpha,
                       active=torch.tensor([True, True, False]))
    assert tt.MASK_STATS["dispatches"] == before["dispatches"] + 1
    assert tt.MASK_STATS["rounds"] >= before["rounds"] + 2
    np.testing.assert_allclose(h.t.numpy()[:2], [8.0, 2.0], rtol=1e-5)
    assert int(h.prim_id[2]) == -1 and bool(h.t[2] == BIG)


@pytest.fixture(scope="module")
def leaves():
    js, _ = jproc.make_leaf_scene(200)
    return js, scene_from_numpy(scene_to_numpy(js), "cpu")


def test_alpha_fn_for_matches_jax_bitwise(leaves):
    js, ts = leaves
    rs = np.random.RandomState(4)
    n = 8192
    num_f = int(js.attrs.rec.shape[0])
    prim = rs.randint(0, num_f, n).astype(np.int32)
    u = rs.uniform(0.0, 1.0, n).astype(np.float32)
    v = (rs.uniform(0.0, 1.0, n) * (1.0 - u)).astype(np.float32)
    want = np.asarray(jalpha_for(js)(jnp.asarray(prim), jnp.asarray(u),
                                     jnp.asarray(v)))
    got = alpha_fn_for(ts)(torch.from_numpy(prim), torch.from_numpy(u),
                           torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.2 < want.mean() < 0.95          # both opaque and clear texels


def test_sample_mask_matches_jax(leaves):
    js, ts = leaves
    rs = np.random.RandomState(9)
    n = 4096
    tex = rs.randint(-1, 1, n).astype(np.int32)
    u = rs.uniform(-2.0, 3.0, n).astype(np.float32)
    v = rs.uniform(-2.0, 3.0, n).astype(np.float32)
    want = np.asarray(jsample_mask(js.textures, jnp.asarray(tex),
                                   jnp.asarray(u), jnp.asarray(v)))
    got = sample_mask(ts.textures, torch.from_numpy(tex), torch.from_numpy(u),
                      torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, want)
    assert want[tex < 0].all() and not want[tex >= 0].all()
