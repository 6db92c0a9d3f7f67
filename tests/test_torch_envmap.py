"""The port's environment map (imbatracer_torch.render.envmap) and the
ENV branch of lights.sample_direct against the JAX package, on the
still-life proxy's HDR sky (a gradient with a sun disc ~200x brighter)
and on a random HDR image.

Tolerances: the host-built tables are equal bit for bit; radiance,
sampled directions and pdfs, given the same uniforms, within 1e-5
relative (+1e-6 absolute; atan2/acos/sin/cos round differently in the
two frameworks by an ulp or so).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imbatracer_tpu.render import envmap as jenv
from imbatracer_tpu.render import lights as jlights
from imbatracer_torch.render import envmap as tenv
from imbatracer_torch.render import lights as tlights

N = 4096


def _sky():
    eh, ew = 64, 128
    tt = (np.arange(eh, dtype=np.float32) + 0.5) / eh
    sky = np.zeros((eh, ew, 3), np.float32)
    zen = np.array([0.25, 0.45, 0.9], np.float32)
    hor = np.array([0.9, 0.8, 0.7], np.float32)
    sky[:] = zen[None, None] * (1 - tt)[:, None, None] + \
        hor[None, None] * tt[:, None, None]
    sy, sx = int(eh * 0.28), int(ew * 0.8)
    sky[sy - 1: sy + 2, sx - 1: sx + 2] = (180.0, 160.0, 120.0)
    return sky, (1.0, 1.0, 1.0)


def _random_hdr():
    rs = np.random.RandomState(12)
    return (rs.gamma(0.5, 2.0, (16, 40, 4)).astype(np.float32),
            (2.0, 1.5, 0.5))


@pytest.fixture(scope="module", params=["sky", "random"])
def envs(request):
    img, intensity = _sky() if request.param == "sky" else _random_hdr()
    return jenv.build_envmap(img, intensity), tenv.build_envmap(img,
                                                                intensity)


def _close(a, b, what):
    a = a.numpy() if hasattr(a, "numpy") else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6,
                               err_msg=what)


def _dirs(n, seed):
    rs = np.random.RandomState(seed)
    d = rs.randn(n, 3).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def test_build_envmap_tables_equal(envs):
    je, te = envs
    for key in tenv.ENV_KEYS:
        a, b = getattr(te, key).numpy(), np.asarray(getattr(je, key))
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, key
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32),
                                      err_msg=key)
    moved = te.to("cpu")
    assert torch.equal(moved.row_cdf, te.row_cdf)


def test_radiance_matches_jax(envs):
    je, te = envs
    d = _dirs(N, 3)
    j = jenv.radiance(je, jnp.asarray(d), jnp.float32(0.01))
    t = tenv.radiance(te, torch.from_numpy(d), torch.tensor(0.01))
    for name, a, b in zip(("li", "pdf_direct_w", "pdf_emit_w"), t, j):
        _close(a, b, name)
    assert float(t[1].min()) > 0.0


def test_sample_dir_matches_jax(envs):
    je, te = envs
    rs = np.random.RandomState(5)
    u1, u2 = (rs.rand(N).astype(np.float32) for _ in range(2))
    j = jenv.sample_dir(je, jnp.asarray(u1), jnp.asarray(u2))
    t = tenv.sample_dir(te, torch.from_numpy(u1), torch.from_numpy(u2))
    for name, a, b in zip(("dir", "li", "pdf_w"), t, j):
        _close(a, b, name)
    # Importance sampling: the sampled pdf agrees with the lookup pdf.
    _, pdf_back, _ = tenv.radiance(te, t[0], torch.tensor(1.0))
    frac = float(torch.isclose(pdf_back, t[2], rtol=1e-3).float().mean())
    assert frac > 0.97


def test_sample_direct_env_branch_matches_jax(envs):
    je, te = envs
    rows = [dict(kind=jlights.LIGHT_TRI, p0=(0, 2, 0), p1=(1, 2, 0),
                 p2=(0, 2, 1), normal=(0, -1, 0), intensity=(5, 4, 3),
                 area=0.5),
            dict(kind=jlights.LIGHT_ENV, intensity=(1, 1, 1))]
    jt = jlights.build_light_table(rows)
    tt = tlights.build_light_table(rows, device="cpu")
    np.testing.assert_array_equal(tt.rec.numpy().view(np.uint32),
                                  np.asarray(jt.rec).view(np.uint32))
    rs = np.random.RandomState(7)
    idx = rs.randint(0, 2, N).astype(np.int32)
    pos = rs.uniform(-1, 1, (N, 3)).astype(np.float32)
    u1, u2 = (rs.rand(N).astype(np.float32) for _ in range(2))
    center = np.array([0.0, 1.0, 0.0], np.float32)
    jb = jlights.BSphere(center=jnp.asarray(center), radius=jnp.float32(3.0),
                         inv_radius_sqr=jnp.float32(1.0 / 9.0))
    tb = tlights.BSphere(center=torch.from_numpy(center),
                         radius=torch.tensor(3.0),
                         inv_radius_sqr=torch.tensor(1.0 / 9.0))
    kinds = (jlights.LIGHT_TRI, jlights.LIGHT_ENV)
    jd = jlights.sample_direct(jt, jnp.asarray(idx), jnp.asarray(pos),
                               jnp.asarray(u1), jnp.asarray(u2), jb, je,
                               kinds=kinds)
    td = tlights.sample_direct(tt, torch.from_numpy(idx),
                               torch.from_numpy(pos), torch.from_numpy(u1),
                               torch.from_numpy(u2), tb, te, kinds=kinds)
    for name in jd._fields:
        a, b = getattr(td, name), getattr(jd, name)
        if a.dtype == torch.bool:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            _close(a, b, name)
    env_rows = idx == 1
    assert (td.distance.numpy()[env_rows] == np.float32(tlights.FAR)).all()
