"""What the VCM family's light paths add to the shading layer, against the
JAX package on the same random inputs: photon emission
(lights.sample_emit, every light kind including the environment), the
adjoint BSDF (eval_bsdf(adjoint=True), pdf_bsdf, sample_bsdf(adjoint=
True)) and the camera projection of light-to-camera connections
(camera.world_to_raster / raster_to_id).

Tolerance: 1e-5 relative with a 1e-6 absolute floor (transcendentals
round differently in XLA and ATen by an ulp or so); masks and pixel ids
equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imbatracer_tpu.render import camera as jcam
from imbatracer_tpu.render import envmap as jenv
from imbatracer_tpu.render import lights as jlights
from imbatracer_tpu.render import materials as jmat
from imbatracer_torch.render import camera as tcam
from imbatracer_torch.render import envmap as tenv
from imbatracer_torch.render import lights as tlights
from imbatracer_torch.render import materials as tmat
from torch_threads import cap_torch_threads

cap_torch_threads()

N = 2048


def _close(t, j, name=""):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                               atol=1e-6, err_msg=name)


def _same(t, j, name=""):
    if t.dtype == torch.bool:
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    else:
        _close(t, j, name)


def _unit(rs, n):
    v = rs.randn(n, 3).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _light_rows(rs):
    rows = []
    for _ in range(2):
        p0, p1, p2 = (rs.uniform(-1, 1, 3).astype(np.float32)
                      + np.array([0, 2, 0], np.float32) for _ in range(3))
        nn = np.cross(p1 - p0, p2 - p0)
        area = 0.5 * np.linalg.norm(nn)
        rows.append(dict(kind=jlights.LIGHT_TRI, p0=p0, p1=p1, p2=p2,
                         normal=nn / (2 * area), intensity=(5.0, 4.0, 3.0),
                         area=area))
    rows.append(dict(kind=jlights.LIGHT_POINT, p0=(0.2, 1.7, -0.1),
                     intensity=(6.0, 5.0, 3.5)))
    rows.append(dict(kind=jlights.LIGHT_SPOT, p0=(0.0, 1.9, 0.0),
                     normal=(0.0, -1.0, 0.0), intensity=(6.0, 5.0, 3.5),
                     cos_angle=np.cos(np.deg2rad(40.0))))
    dn = np.asarray((0.2, -0.6, -1.0), np.float32)
    rows.append(dict(kind=jlights.LIGHT_DIR, normal=dn / np.linalg.norm(dn),
                     intensity=(1.5, 1.3, 1.0)))
    rows.append(dict(kind=jlights.LIGHT_ENV, intensity=(1.0, 1.0, 1.0)))
    return rows


@pytest.mark.parametrize("kinds", [(), (0, 1, 2, 3, 4)])
def test_sample_emit_every_light_kind(kinds):
    rs = np.random.RandomState(21)
    rows = _light_rows(rs)
    jt = jlights.build_light_table(rows)
    tt = tlights.build_light_table(rows, device="cpu")
    sky = rs.gamma(0.5, 2.0, (16, 32, 3)).astype(np.float32)
    je = jenv.build_envmap(sky, (1.0, 1.0, 1.0))
    te = tenv.build_envmap(sky, (1.0, 1.0, 1.0))
    idx = rs.randint(0, len(rows), N).astype(np.int32)
    us = [rs.rand(N).astype(np.float32) for _ in range(4)]
    center = np.array([0.0, 1.0, 0.0], np.float32)
    jb = jlights.BSphere(center=jnp.asarray(center), radius=jnp.float32(3.0),
                         inv_radius_sqr=jnp.float32(1.0 / 9.0))
    tb = tlights.BSphere(center=torch.from_numpy(center),
                         radius=torch.tensor(3.0),
                         inv_radius_sqr=torch.tensor(1.0 / 9.0))
    je_s = jlights.sample_emit(jt, jnp.asarray(idx),
                               *(jnp.asarray(u) for u in us), jb, je,
                               kinds=kinds)
    te_s = tlights.sample_emit(tt, torch.from_numpy(idx),
                               *(torch.from_numpy(u) for u in us), tb, te,
                               kinds=kinds)
    for name in je_s._fields:
        _same(getattr(te_s, name), getattr(je_s, name), name)
    # Every kind is drawn, and each emits somewhere.
    for k in range(len(rows)):
        sel = idx == k
        assert sel.any() and (te_s.pdf_emit_w.numpy()[sel] > 0).any()


def test_sample_emit_env_needs_the_map():
    rows = [dict(kind=jlights.LIGHT_ENV, intensity=(1, 1, 1))]
    tt = tlights.build_light_table(rows, device="cpu")
    tb = tlights.BSphere(center=torch.zeros(3), radius=torch.tensor(1.0),
                         inv_radius_sqr=torch.tensor(1.0))
    u = torch.rand(8)
    with pytest.raises(ValueError):
        tlights.sample_emit(tt, torch.zeros(8, dtype=torch.int32), u, u, u, u,
                            tb, None, kinds=(jlights.LIGHT_ENV,))


def _material_inputs(kind, seed):
    rs = np.random.RandomState(seed)
    n = _unit(rs, N)
    gn = n + 0.2 * _unit(rs, N)
    gn = (gn / np.linalg.norm(gn, axis=1, keepdims=True)).astype(np.float32)
    p = dict(
        kind=np.full(N, kind, np.int32) if kind >= 0
        else rs.randint(0, 6, N).astype(np.int32),
        kd=rs.uniform(0.0, 0.9, (N, 3)).astype(np.float32),
        ks=rs.uniform(0.0, 1.0, (N, 3)).astype(np.float32),
        tf=rs.uniform(0.0, 1.0, (N, 3)).astype(np.float32),
        ns=rs.uniform(1.0, 60.0, N).astype(np.float32),
        ior=rs.uniform(1.2, 1.8, N).astype(np.float32),
        emit=np.zeros((N, 3), np.float32),
        kd_tex=np.full(N, -1, np.int32), bump_tex=np.full(N, -1, np.int32),
        mask_tex=np.full(N, -1, np.int32),
    )
    arrays = [n, gn, _unit(rs, N), _unit(rs, N)]
    arrays += [rs.rand(N).astype(np.float32) for _ in range(3)]
    jp = jmat.MatParams({k: jnp.asarray(v) for k, v in p.items()})
    tp = tmat.MatParams({k: torch.from_numpy(v) for k, v in p.items()})
    return (jp, [jnp.asarray(a) for a in arrays], tp,
            [torch.from_numpy(a) for a in arrays])


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4, 5, -1])
def test_adjoint_bsdf(kind):
    """eval_bsdf(adjoint=True), pdf_bsdf both ways and the adjoint sample
    for each kind alone and all mixed (-1), on test_torch_shading's
    inputs (seed kind + 10).  (At the peak of a narrow glossy lobe, ns up
    to 60, f = ks D G F / .. carries pow's last-ulp difference times the
    exponent: other draws can reach 1.2e-5 relative there.)"""
    kinds = (kind,) if kind >= 0 else ()
    jp, (jn, jgn, jwo, jwi, *ju), tp, (tn, tgn, two, twi, *tu) = \
        _material_inputs(kind, seed=kind + 10)
    _close(tmat.eval_bsdf(tp, tn, tgn, two, twi, adjoint=True, kinds=kinds),
           jmat.eval_bsdf(jp, jn, jgn, jwo, jwi, adjoint=True, kinds=kinds),
           "eval")
    for a, b in ((two, twi), (twi, two)):
        ja, jb = (jwo, jwi) if a is two else (jwi, jwo)
        _close(tmat.pdf_bsdf(tp, tn, tgn, a, b, kinds=kinds),
               jmat.pdf_bsdf(jp, jn, jgn, ja, jb, kinds=kinds), "pdf")
    jr = jmat.sample_bsdf(jp, jn, jgn, jwo, *ju, adjoint=True, kinds=kinds)
    tr = tmat.sample_bsdf(tp, tn, tgn, two, *tu, adjoint=True, kinds=kinds)
    for name, a, b in zip(("wi", "f", "pdf", "spec", "valid"), tr, jr):
        _same(a, b, name)
    if kind == 2:
        # Adjoint glass transmission drops the (eta_i / eta_t)^2 factor.
        fr = tmat.sample_bsdf(tp, tn, tgn, two, *tu, kinds=kinds)[1]
        assert not torch.equal(fr, tr[1])


def test_world_to_raster_and_pixel_ids():
    rs = np.random.RandomState(3)
    cam = ((0.0, 1.0, 3.0), (0.05, -0.1, -1.0), (0.0, 1.0, 0.0), 48, 32,
           60.0)
    jc, tc = jcam.make_camera(*cam), tcam.make_camera(*cam, device="cpu")
    pts = (rs.uniform(-2, 2, (N, 3)) + np.array([0, 1, 0])).astype(np.float32)
    jx, jy, jd = jcam.world_to_raster(jc, jnp.asarray(pts))
    tx, ty, td = tcam.world_to_raster(tc, torch.from_numpy(pts))
    for name, a, b in (("x", tx, jx), ("y", ty, jy), ("depth", td, jd)):
        _close(a, b, name)
    jid = np.asarray(jcam.raster_to_id(jc, jx, jy))
    tid = tcam.raster_to_id(tc, tx, ty).numpy()
    np.testing.assert_array_equal(tid, jid)
    assert tid.dtype == np.int32 and (tid >= 0).any() and (tid < 0).any()
    # A pixel centre projects back onto its own id.
    org, d = tcam.generate_ray(tc, torch.tensor([10.5]), torch.tensor([7.5]))
    x, y, _ = tcam.world_to_raster(tc, org + 2.0 * d)
    assert int(tcam.raster_to_id(tc, x, y)) == 7 * 48 + 10
