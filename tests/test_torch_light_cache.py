"""The port's light-vertex cache (imbatracer_torch.render.light_cache)
against the JAX package's on the same batches: append / append_packed /
canonicalize / select_shallowest give the same caches bit for bit.  Then
the property of tests/test_cache_admission.py on the port's own light
pass: the selected cache does not depend on the light-band schedule, and
it is the JAX renderer's selection.  An append that does not fit raises
(the JAX cache drops the rows past its capacity)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imbatracer_tpu.render import light_cache as jlc
from imbatracer_tpu.render.integrators import vcm as jvcm
from imbatracer_torch.render import light_cache as tlc
from torch_threads import cap_torch_threads

cap_torch_threads()

FIELDS = ("pos", "w_out", "normal", "gn", "uv", "mat_id", "throughput",
          "d_vc", "d_vcm", "d_vm", "path_length", "path_id", "count")


def _assert_same(t, j):
    for name in FIELDS:
        a, b = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a.view(np.uint32) if a.ndim else a,
                                      b.view(np.uint32) if b.ndim else b,
                                      err_msg=name)


def _batch(rs, n, bounce):
    f = lambda *s: rs.randn(*s).astype(np.float32)
    return [f(n, 3), f(n, 3), f(n, 3), f(n, 3), f(n, 2),
            rs.randint(0, 9, n).astype(np.int32), f(n, 3), f(n), f(n), f(n),
            np.full(n, bounce + 2, np.int32),
            rs.permutation(4 * n)[:n].astype(np.int32)]


def _both_caches(capacity, batches, packed):
    j, t = jlc.empty_cache(capacity), tlc.empty_cache(capacity, "cpu")
    for valid, arrays in batches:
        if packed:
            j = jlc.append_packed(j, jnp.asarray(valid), jlc.pack_batch(
                *(jnp.asarray(a) for a in arrays)))
            t = tlc.append_packed(t, torch.from_numpy(valid), tlc.pack_batch(
                *(torch.from_numpy(a) for a in arrays)))
        else:
            j = jlc.append(j, jnp.asarray(valid),
                           *(jnp.asarray(a) for a in arrays))
            t = tlc.append(t, torch.from_numpy(valid),
                           *(torch.from_numpy(a) for a in arrays))
    return j, t


@pytest.mark.parametrize("packed", [False, True])
def test_append_canonicalize_select_bit_equal(packed):
    rs = np.random.RandomState(1)
    batches = [(rs.rand(200) < 0.6, _batch(rs, 200, b)) for b in range(4)]
    total = sum(int(v.sum()) for v, _ in batches)
    j, t = _both_caches(total + 37, batches, packed)
    _assert_same(t, j)
    assert int(t.count) == total
    np.testing.assert_array_equal(t.packed().numpy().view(np.uint32),
                                  np.asarray(j.packed()).view(np.uint32))
    _assert_same(tlc.canonicalize(t), jlc.canonicalize(j))
    for cap in (total // 3, total, total + 37, total + 100):
        _assert_same(tlc.select_shallowest(t, cap),
                     jlc.select_shallowest(j, cap))


def test_append_past_capacity_raises():
    rs = np.random.RandomState(2)
    cache = tlc.empty_cache(100, "cpu")
    valid = np.ones(64, bool)
    arrays = [torch.from_numpy(a) for a in _batch(rs, 64, 0)]
    cache = tlc.append(cache, torch.from_numpy(valid), *arrays)
    with pytest.raises(RuntimeError, match="overflow"):
        tlc.append(cache, torch.from_numpy(valid), *arrays)
    assert int(cache.count) == 64


def _port_collect(scene, cam, lpc, max_len, band):
    from imbatracer_torch.render.integrators import vcm as tvcm

    pm = torch.tensor(0.05)
    eta = tvcm.PI * pm * pm * lpc
    cache = tlc.empty_cache(lpc * max_len, "cpu")
    for start in range(0, lpc, band):
        _, cache = tvcm._light_pass(
            scene, cam, 0, 1.0 / eta, eta, cache, algo="vcm",
            num_pixels=cam.width * cam.height, light_path_count=lpc,
            max_len=max_len, alpha_fn=None, has_bump=False,
            path_start=start, band_paths=min(band, lpc - start))
    return cache


def test_selection_is_band_invariant_and_matches_jax():
    from imbatracer_tpu.render.camera import make_camera as jcam
    from imbatracer_tpu.scene.procedural import make_cornell_scene
    from imbatracer_torch.convert import scene_from_numpy, scene_to_numpy
    from imbatracer_torch.render.camera import make_camera as tcam

    js, meta = make_cornell_scene()
    ts = scene_from_numpy(scene_to_numpy(js), "cpu")
    args = (meta.cam_pos, meta.cam_dir, meta.cam_up, 16, 16, 60.0)
    lpc, max_len = 256, 6
    cap = jvcm.auto_cache_capacity(lpc, max_len)

    full_a = _port_collect(ts, tcam(*args, device="cpu"), lpc, max_len, 256)
    full_b = _port_collect(ts, tcam(*args, device="cpu"), lpc, max_len, 64)
    assert int(full_a.count) == int(full_b.count) > cap   # selection binds
    a = tlc.select_shallowest(full_a, cap)
    b = tlc.select_shallowest(full_b, cap)
    assert int(a.count) == cap
    for name in FIELDS:
        assert torch.equal(getattr(a, name), getattr(b, name)), name

    # The JAX renderer's single-band route: append-order truncation at
    # the working capacity, then canonicalize.
    pm = jnp.float32(0.05)
    eta = jvcm.PI * 0.05 * 0.05 * lpc
    _, jcache = jvcm._light_pass(
        js, jcam(*args), jnp.uint32(0), pm, pm, jvcm.mis_pow(1.0 / eta),
        jvcm.mis_pow(eta), algo="vcm", num_pixels=256, light_path_count=lpc,
        max_len=max_len, cache_capacity=cap, has_masks=False, has_bump=False,
        alpha_fn=None, path_start=jnp.int32(0), band_paths=lpc,
        cache_in=jvcm.empty_cache(cap), admit_cap=0)
    jcache = jlc.canonicalize(jcache)
    n = int(jcache.count)
    assert n == cap
    for name in ("path_id", "path_length", "mat_id"):
        np.testing.assert_array_equal(getattr(a, name).numpy()[:n],
                                      np.asarray(getattr(jcache, name))[:n])
    for name in ("pos", "throughput", "d_vcm", "d_vc", "d_vm"):
        np.testing.assert_allclose(getattr(a, name).numpy()[:n],
                                   np.asarray(getattr(jcache, name))[:n],
                                   rtol=1e-5, atol=1e-6, err_msg=name)
