"""BSDF sampling / evaluation, NEE light sampling and surface-interaction
assembly of the port against the JAX reference, on the same random
inputs.  Tolerance: 1e-5 relative (with a 1e-6 absolute floor for values
near zero); boolean masks equal.  Transcendentals (pow, sin, cos) differ
between XLA and ATen by a few ulps, far inside that bound."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imbatracer_tpu.render import lights as jlights
from imbatracer_tpu.render import materials as jmat
from imbatracer_tpu.render import surface as jsurf
from imbatracer_tpu.render.traverse import Hit as JHit
from imbatracer_tpu.scene import procedural as jproc
from imbatracer_torch.render import lights as tlights
from imbatracer_torch.render import materials as tmat
from imbatracer_torch.render import surface as tsurf
from imbatracer_torch.render.traverse import Hit as THit
from imbatracer_torch.scene import procedural as tproc
from torch_threads import cap_torch_threads

cap_torch_threads()

RTOL, ATOL = 1e-5, 1e-6
N = 2048


def _close(t, j, name=""):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                               atol=ATOL, err_msg=name)


def _unit(rs, n):
    v = rs.randn(n, 3).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _material_inputs(kind, seed):
    rs = np.random.RandomState(seed)
    n = _unit(rs, N)
    # Geometric normals near the shading normal (bump / interpolation).
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
    wo, wi = _unit(rs, N), _unit(rs, N)
    u = [rs.rand(N).astype(np.float32) for _ in range(3)]
    return p, n, gn, wo, wi, u


def _both(p, *arrays):
    jp = jmat.MatParams({k: jnp.asarray(v) for k, v in p.items()})
    tp = tmat.MatParams({k: torch.from_numpy(v) for k, v in p.items()})
    return (jp, [jnp.asarray(a) for a in arrays],
            tp, [torch.from_numpy(a) for a in arrays])


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4, 5, -1])
def test_sample_and_eval_bsdf(kind):
    """Every kind on its own (with its static `kinds` specialisation) and
    all kinds mixed (kind=-1, unspecialised)."""
    p, n, gn, wo, wi, u = _material_inputs(kind, seed=kind + 10)
    kinds = (kind,) if kind >= 0 else ()
    jp, ja, tp, ta = _both(p, n, gn, wo, wi, *u)
    jn, jgn, jwo, jwi, ju1, ju2, ju3 = ja
    tn, tgn, two, twi, tu1, tu2, tu3 = ta

    jr = jmat.sample_bsdf(jp, jn, jgn, jwo, ju1, ju2, ju3, kinds=kinds)
    tr = tmat.sample_bsdf(tp, tn, tgn, two, tu1, tu2, tu3, kinds=kinds)
    for name, a, b in zip(("wi", "f", "pdf", "spec", "valid"), tr, jr):
        if a.dtype == torch.bool:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)
        else:
            _close(a, b, name)

    je = jmat.eval_pdf_bsdf(jp, jn, jgn, jwo, jwi, kinds=kinds)
    te = tmat.eval_pdf_bsdf(tp, tn, tgn, two, twi, kinds=kinds)
    for name, a, b in zip(("f", "pdf_fwd", "pdf_rev"), te, je):
        _close(a, b, name)


def _light_rows():
    rs = np.random.RandomState(5)
    rows = []
    for _ in range(3):
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
    return rows


@pytest.mark.parametrize("kinds", [(), (0, 1, 2, 3)])
def test_sample_direct_all_light_kinds(kinds):
    rows = _light_rows()
    jt = jlights.build_light_table(rows)
    tt = tlights.build_light_table(rows, device="cpu")
    np.testing.assert_array_equal(tt.rec.numpy().view(np.uint32),
                                  np.asarray(jt.rec).view(np.uint32))
    rs = np.random.RandomState(6)
    idx = rs.randint(0, len(rows), N).astype(np.int32)
    pos = rs.uniform(-1, 1, (N, 3)).astype(np.float32)
    u1, u2 = (rs.rand(N).astype(np.float32) for _ in range(2))
    center = np.array([0.0, 1.0, 0.0], np.float32)
    jb = jlights.BSphere(center=jnp.asarray(center), radius=jnp.float32(2.0),
                         inv_radius_sqr=jnp.float32(0.25))
    tb = tlights.BSphere(center=torch.from_numpy(center),
                         radius=torch.tensor(2.0),
                         inv_radius_sqr=torch.tensor(0.25))
    jd = jlights.sample_direct(jt, jnp.asarray(idx), jnp.asarray(pos),
                               jnp.asarray(u1), jnp.asarray(u2), jb,
                               kinds=kinds)
    td = tlights.sample_direct(tt, torch.from_numpy(idx),
                               torch.from_numpy(pos), torch.from_numpy(u1),
                               torch.from_numpy(u2), tb, kinds=kinds)
    for name in jd._fields:
        a, b = getattr(td, name), getattr(jd, name)
        if a.dtype == torch.bool:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            _close(a, b, name)


def test_env_light_raises():
    """An ENV row builds the JAX package's table; sampling a table that
    names ENV lights without an environment map raises."""
    rows = [dict(kind=tlights.LIGHT_ENV, intensity=(1, 1, 1))]
    tt = tlights.build_light_table(rows, device="cpu")
    np.testing.assert_array_equal(
        tt.rec.numpy().view(np.uint32),
        np.asarray(jlights.build_light_table(rows).rec).view(np.uint32))
    ones = torch.ones(4)
    tb = tlights.BSphere(center=torch.zeros(3), radius=torch.tensor(1.0),
                         inv_radius_sqr=torch.tensor(1.0))
    with pytest.raises(ValueError):
        tlights.sample_direct(tt, torch.zeros(4, dtype=torch.int32),
                              torch.zeros(4, 3), ones * 0.5, ones * 0.5, tb,
                              None, kinds=(tlights.LIGHT_ENV,))


@pytest.mark.parametrize("builder,has_bump", [
    ("make_cornell_scene", False), ("make_bumped_scene", True)])
def test_make_interaction(builder, has_bump):
    """Shade-record fetch, attribute lerp, bump mapping (textured floor of
    make_bumped_scene) and the normal flip, on random hits."""
    js, _ = getattr(jproc, builder)()
    ts, _ = getattr(tproc, builder)(device="cpu")
    num_f = int(js.attrs.rec.shape[0])
    rs = np.random.RandomState(8)
    prim = rs.randint(-1, num_f, N).astype(np.int32)
    u = rs.uniform(0.0, 0.6, N).astype(np.float32)
    v = (rs.uniform(0.0, 1.0, N) * (1.0 - u)).astype(np.float32)
    t = rs.uniform(0.1, 4.0, N).astype(np.float32)
    org = rs.uniform(-1, 1, (N, 3)).astype(np.float32)
    d = _unit(rs, N)
    jh = JHit(t=jnp.asarray(t), prim_id=jnp.asarray(prim), u=jnp.asarray(u),
              v=jnp.asarray(v))
    th = THit(t=torch.from_numpy(t), prim_id=torch.from_numpy(prim),
              u=torch.from_numpy(u), v=torch.from_numpy(v))
    ji = jsurf.make_interaction(js, jh, jnp.asarray(org), jnp.asarray(d),
                                has_bump=has_bump)
    ti = tsurf.make_interaction(ts, th, torch.from_numpy(org),
                                torch.from_numpy(d), has_bump=has_bump)
    for name in ji._fields:
        a, b = getattr(ti, name), getattr(ji, name)
        if name == "params":
            for k in b:
                if a[k].dtype == torch.int32:
                    np.testing.assert_array_equal(a[k].numpy(),
                                                  np.asarray(b[k]))
                else:
                    _close(a[k], b[k], k)
        elif a.dtype == torch.int32:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            _close(a, b, name)
