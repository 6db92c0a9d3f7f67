"""Two-level instanced traversal in the port (the instanced branch of the
stream kernel's plain version, `stream_traverse.traverse_plain(inst=)`,
and the masked re-trace of render/traverse.py) against the JAX
package's instanced stream kernel in interpret mode and against the
port's own flattened scene.

Tolerances: against JAX, ids equal except where the two hits have
bit-equal t, t within 1e-5 relative, u/v within 1e-4 absolute (as
tests/test_torch_traverse.py: XLA on the CPU contracts the interpret-mode
kernel's products and sums into FMAs, so barycentrics, sums of
cancelling products, differ in their last bits); any-hit flags equal.  Against the
flattened scene (vertices transformed instead of rays, so t rounds
differently), t within 2e-4 relative and ids equal on >= 99.5% of the
rays, any-hit flags differing on at most 2 rays, as tests/
test_instancing.py holds the JAX package's two routes."""

import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imbatracer_tpu.accel.instancing import build_two_level as jtwo
from imbatracer_tpu.ops import pallas_stream as ps
from imbatracer_torch.accel.builder import build_bvh, triangle_bboxes
from imbatracer_torch.accel.device import DeviceBvh
from imbatracer_torch.accel.flatten import thread_bvh
from imbatracer_torch.accel.instancing import build_two_level
from imbatracer_torch.core import math3d
from imbatracer_torch.ops import khit as kh
from imbatracer_torch.ops import stream_traverse as st
from imbatracer_torch.render import traverse as tt
from imbatracer_torch.render.integrators.pt import alpha_fn_for
from imbatracer_torch.render.intersect import BIG
from imbatracer_torch.scene.build import build_scene
from imbatracer_torch.scene.generate import write_instanced_scene
from imbatracer_torch.scene.procedural import _add_box

N = 1024


def _box_mesh(n_seg=3):
    tris = []
    for i in range(n_seg):
        _add_box(tris, center=(0, 0.18 * i, 0),
                 size=(1.0 - 0.2 * i, 0.15, 1.0 - 0.2 * i),
                 angle_deg=15.0 * i, mat=0)
    return tuple(np.asarray([t[k] for t in tris], np.float32)
                 for k in range(3))


SPECS = [((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (0, 0, 0)),
         ((2.5, 0.3, -1.0), (0.7, 0.7, 0.7), (0, 40, 0)),
         ((-2.0, -0.2, 1.5), (1.6, 1.2, 1.6), (10, 0, 25)),
         ((0.5, 1.5, 2.0), (0.5, 0.5, 0.5), (0, 160, 80))]


@pytest.fixture(scope="module")
def boxes():
    """(mesh, instance list, the port's two-level BVH, its flattened BVH,
    rays (org, d))."""
    v0, v1, v2 = _box_mesh()
    mats = [math3d.instance_matrix(*s) for s in SPECS]
    insts = [dict(mesh_idx=0, matrix=m, face_base=i * v0.shape[0])
             for i, m in enumerate(mats)]
    tl = build_two_level([(v0, v1, v2)], insts)
    bvh2 = DeviceBvh.from_two_level(tl.sbox, tl.tiles, tl.tile_idx,
                                    tl.inst_of, tl.itab, device="cpu")
    w = [np.concatenate([math3d.transform_points(m, v).astype(np.float32)
                         for m in mats]) for v in (v0, v1, v2)]
    t = thread_bvh(build_bvh(*triangle_bboxes(*w)), *w)
    flat = DeviceBvh.from_packed(t.tri_v0, t.tri_e1, t.tri_e2, t.tri_id,
                                 device="cpu")
    rs = np.random.RandomState(11)
    org = rs.uniform(-4, 4, (N, 3)).astype(np.float32)
    # Aim most rays near an instance so that every instance is hit.
    aim = np.asarray([s[0] for s in SPECS])[rs.randint(0, len(SPECS), N)]
    d = (aim + rs.uniform(-0.8, 0.8, (N, 3)) - org).astype(np.float32)
    d[: N // 4] = rs.randn(N // 4, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (v0, v1, v2), insts, tl, bvh2, flat, org, d


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


def test_instanced_plain_matches_jax_kernel(boxes):
    mesh, insts, _, bvh2, _, org, d = boxes
    jl = jtwo([mesh], insts)
    inst = (jnp.asarray(jl.tile_idx), jnp.asarray(jl.inst_of),
            jnp.asarray(jl.itab))
    sbox, tiles = jnp.asarray(jl.sbox), jnp.asarray(jl.tiles)
    tmax = np.random.RandomState(2).uniform(0.5, 4.0, N).astype(np.float32)

    def run():
        h = ps.closest_hit_stream(sbox, tiles, jnp.asarray(org),
                                  jnp.asarray(d), 0.0, BIG, inst=inst)
        occ = ps.any_hit_stream(sbox, tiles, jnp.asarray(org), jnp.asarray(d),
                                0.0, jnp.asarray(tmax), inst=inst)
        return [np.asarray(x) for x in h], np.asarray(occ)

    (jt, jid, ju, jv), jocc = _interp(run)
    before = st.LAUNCHES["plain"]
    h = tt.closest_hit(bvh2, torch.from_numpy(org), torch.from_numpy(d), 0.0,
                       BIG)
    assert st.LAUNCHES["plain"] == before + 1
    pid = h.prim_id.numpy()
    assert (pid >= 0).sum() > 200 and pid.max() >= 3 * mesh[0].shape[0]
    tie = (pid != jid) & (h.t.numpy() == jt)
    assert ((pid == jid) | tie).all()
    same = (pid == jid) & (pid >= 0)
    np.testing.assert_allclose(h.t.numpy()[same], jt[same], rtol=1e-5,
                               atol=1e-6)
    for got, want in ((h.u, ju), (h.v, jv)):
        np.testing.assert_allclose(got.numpy()[same], want[same], rtol=0,
                                   atol=1e-4)
    occ = tt.any_hit(bvh2, torch.from_numpy(org), torch.from_numpy(d), 0.0,
                     torch.from_numpy(tmax)).numpy()
    np.testing.assert_array_equal(occ, jocc)
    assert 0 < occ.sum() < N


@pytest.mark.parametrize("sort", [False, True])
def test_instanced_matches_flattened(boxes, sort):
    *_, bvh2, flat, org, d = boxes
    o, dd = torch.from_numpy(org), torch.from_numpy(d)
    h2 = tt.closest_hit(bvh2, o, dd, 0.0, BIG, sort=sort)
    hx = tt.closest_hit(flat, o, dd, 0.0, BIG, sort=sort)
    np.testing.assert_allclose(h2.t.numpy(), hx.t.numpy(), rtol=2e-4,
                               atol=1e-5)
    assert float((h2.prim_id == hx.prim_id).float().mean()) > 0.995
    tmax = torch.full((N,), 2.5)
    occ2 = tt.any_hit(bvh2, o, dd, 0.0, tmax, sort=sort)
    occx = tt.any_hit(flat, o, dd, 0.0, tmax, sort=sort)
    assert int((occ2 != occx).sum()) <= 2


def test_inst_inputs_are_checked(boxes):
    *_, tl, bvh2, _, _, _ = boxes
    with pytest.raises(ValueError):
        DeviceBvh.from_two_level(tl.sbox, tl.tiles, tl.tile_idx + 99,
                                 tl.inst_of, tl.itab, device="cpu")
    with pytest.raises(ValueError):
        DeviceBvh.from_two_level(tl.sbox[:-1], tl.tiles, tl.tile_idx,
                                 tl.inst_of, tl.itab, device="cpu")
    # The CUDA wrapper raises before launching on CPU tensors.
    rays, _ = st.rays8(torch.zeros(4, 3), torch.ones(4, 3), 0.0, 1.0, None)
    with pytest.raises(ValueError):
        st.traverse_cuda(rays, bvh2.sbox, bvh2.tiles, False, inst=bvh2.inst)


def test_plain_route_beyond_the_list_cap_matches_jax():
    """A two-level scene of 131^2 = 17,161 card instances (one super-chunk
    each) lies above the 16,384 super-chunks a CUDA block's candidate list
    holds in shared memory (the kernels then take their global-list
    route); the plain route has no cap and returns the JAX stream route's
    rows on a few hundred rays, at the tolerances above."""
    import chip_smoke

    mesh, insts = chip_smoke.card_grid()
    tl = build_two_level([mesh], insts)
    assert tl.sbox.shape[0] == 131 * 131 > st.MAX_SUPER
    bvh = DeviceBvh.from_two_level(tl.sbox, tl.tiles, tl.tile_idx,
                                   tl.inst_of, tl.itab, device="cpu")
    jl = jtwo([mesh], insts)
    inst = (jnp.asarray(jl.tile_idx), jnp.asarray(jl.inst_of),
            jnp.asarray(jl.itab))
    rays = chip_smoke.card_grid_rays(256, 5)
    org, d = rays[:, 0:3].numpy(), rays[:, 4:7].numpy()
    tmax = np.where(rays[:, 7].numpy() >= 0.0, 1e30, -1.0)
    occ_tmax = np.random.RandomState(6).uniform(0.5, 3.0, 256)

    def run():
        h = ps.closest_hit_stream(jnp.asarray(jl.sbox), jnp.asarray(jl.tiles),
                                  jnp.asarray(org), jnp.asarray(d), 1e-3,
                                  BIG, active=jnp.asarray(tmax >= 0), inst=inst)
        occ = ps.any_hit_stream(jnp.asarray(jl.sbox), jnp.asarray(jl.tiles),
                                jnp.asarray(org), jnp.asarray(d), 1e-3,
                                jnp.asarray(occ_tmax, jnp.float32),
                                active=jnp.asarray(tmax >= 0), inst=inst)
        return [np.asarray(x) for x in h], np.asarray(occ)

    (jt, jid, _, _), jocc = _interp(run)
    o, dd = torch.from_numpy(org), torch.from_numpy(d)
    act = torch.from_numpy(tmax >= 0)
    h = tt.closest_hit(bvh, o, dd, 1e-3, BIG, active=act)
    pid = h.prim_id.numpy()
    assert (pid >= 0).sum() > 100 and pid.max() > 2 * st.MAX_SUPER
    live = tmax >= 0
    tie = (pid != jid) & (h.t.numpy() == jt)
    assert ((pid == jid) | tie)[live].all()
    same = (pid == jid) & (pid >= 0)
    np.testing.assert_allclose(h.t.numpy()[same], jt[same], rtol=1e-5,
                               atol=1e-6)
    occ = tt.any_hit(bvh, o, dd, 1e-3,
                     torch.as_tensor(occ_tmax, dtype=torch.float32),
                     active=act).numpy()
    np.testing.assert_array_equal(occ[live], jocc[live])
    assert 0 < occ[live].sum() < live.sum()


@pytest.fixture(scope="module")
def masked_scenes(tmp_path_factory):
    path = write_instanced_scene(str(tmp_path_factory.mktemp("masked")),
                                 counts=dict(ground=1, sphere=3, blob=1,
                                             crystal=1, card=6, panel=1))
    two, meta = build_scene(path, quiet=True, device="cpu")
    flat, _ = build_scene(path, quiet=True, device="cpu", force_flatten=True)
    assert two.bvh.two_level and meta.has_masks
    return two, flat


def _card_rays(n, seed):
    rs = np.random.RandomState(seed)
    org = torch.from_numpy(rs.uniform((-7, 0.1, -7), (7, 2.5, 7),
                                      (n, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(
        torch.from_numpy(rs.randn(n, 3).astype(np.float32)), dim=1)
    return org, d


def test_masked_two_level_never_reaches_khit(masked_scenes, monkeypatch):
    """A masked query on a two-level BVH goes through the one-layer re-
    trace over the stream kernel, never the khit kernel (whose tiles are
    per super-chunk), and returns the flattened (khit) scene's hits."""
    two, flat = masked_scenes
    org, d = _card_rays(1500, 4)
    act = torch.from_numpy(np.random.RandomState(5).rand(1500) < 0.9)
    tmax = torch.full((1500,), 4.0)
    hx = tt.closest_hit(flat.bvh, org, d, 1e-3, BIG, alpha_fn_for(flat),
                        active=act, sort=True)
    ox = tt.any_hit(flat.bvh, org, d, 1e-3, tmax, alpha_fn_for(flat),
                    active=act, sort=True)

    def no_khit(*a, **k):
        raise AssertionError("khit reached on a two-level BVH")

    for name in ("khit", "khit_plain", "khit_sorted"):
        monkeypatch.setattr(kh, name, no_khit)
    before = dict(tt.MASK_STATS)
    h2 = tt.closest_hit(two.bvh, org, d, 1e-3, BIG, alpha_fn_for(two),
                        active=act, sort=True)
    o2 = tt.any_hit(two.bvh, org, d, 1e-3, tmax, alpha_fn_for(two),
                    active=act, sort=True)
    # The re-trace took more than one round somewhere: rays crossed a
    # transparent card texel.
    assert tt.MASK_STATS["rounds"] - before["rounds"] > \
        tt.MASK_STATS["dispatches"] - before["dispatches"]
    np.testing.assert_allclose(h2.t.numpy(), hx.t.numpy(), rtol=2e-4,
                               atol=1e-5)
    assert float((h2.prim_id == hx.prim_id).float().mean()) > 0.995
    assert not bool((h2.prim_id[~act] >= 0).any())
    assert int((o2 != ox).sum()) <= 2 and 0 < int(o2.sum()) < 1500
