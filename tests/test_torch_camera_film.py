"""Camera rays, film reduction, tone mapping and PNG output of the port
against the JAX reference.  Tolerances: ray origins and directions 1e-6
absolute (unit vectors, float32 rsqrt on both sides); RNG states and pixel
ids bitwise; the film reductions sum the same float32 values, 1e-6
relative; tone mapping 1e-6 absolute."""

import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imbatracer_tpu.render import film as jfilm
from imbatracer_tpu.render.camera import make_camera as jcamera
from imbatracer_tpu.render.integrators import pt as jpt
from imbatracer_torch.io.image import store_png
from imbatracer_torch.render import film as tfilm
from imbatracer_torch.render.camera import make_camera as tcamera
from imbatracer_torch.render.integrators import pt as tpt
from torch_threads import cap_torch_threads

cap_torch_threads()

CAM = ((0.0, 1.0, 3.6), (0.1, -0.05, -1.0), (0.0, 1.0, 0.0))


@pytest.mark.parametrize("width,height,spp,frame,start,count", [
    (64, 32, 2, 5, 0, 0),            # whole frame, tile-permuted
    (64, 64, 1, 2 ** 32 - 1, 1024, 2048),  # a row-aligned band
    (48, 20, 3, 9, 100, 100),        # a band that is not row-aligned
])
def test_camera_rays(width, height, spp, frame, start, count):
    jc = jcamera(*CAM, width, height, 55.0)
    tc = tcamera(*CAM, width, height, 55.0, device="cpu")
    jo, jd, js, jp = jpt.camera_rays(jc, width, height, spp,
                                     jnp.uint32(frame), start, count)
    to, td, ts, tp = tpt.camera_rays(tc, width, height, spp, frame, start,
                                     count)
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    np.testing.assert_array_equal(np.asarray(js).astype(np.int64), ts.numpy())
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)


@pytest.mark.parametrize("num_pixels,width,spp", [(2048, 64, 3),
                                                   (300, 48, 2)])
def test_unswizzle_and_splat(num_pixels, width, spp):
    rs = np.random.RandomState(num_pixels)
    rad = rs.rand(spp * num_pixels, 3).astype(np.float32)
    j = np.asarray(jpt.unswizzle_film(jnp.asarray(rad), spp, num_pixels,
                                      width))
    t = tpt.unswizzle_film(torch.from_numpy(rad), spp, num_pixels, width)
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-6)

    pid = rs.randint(-1, num_pixels, spp * num_pixels).astype(np.int32)
    j = np.asarray(jfilm.splat(jnp.asarray(rad), jnp.asarray(pid),
                               num_pixels))
    t = tfilm.splat(torch.from_numpy(rad), torch.from_numpy(pid), num_pixels)
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-5)


def test_tonemap_and_png(tmp_path):
    rs = np.random.RandomState(1)
    film = (rs.rand(96, 3).astype(np.float32) * 4.0 - 0.5)
    j = np.asarray(jfilm.tonemap(jnp.asarray(film), 0.25, 0.5))
    t = tfilm.tonemap(torch.from_numpy(film), 0.25, 0.5)
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-6)

    img = t.numpy().reshape(8, 12, 3)
    path = tmp_path / "out.png"
    store_png(str(path), img, weight=1.0, gamma=1.0)
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", data[16:24])
    assert (w, h) == (12, 8)
    idat = data.index(b"IDAT")
    (n,) = struct.unpack(">I", data[idat - 4:idat])
    rows = np.frombuffer(zlib.decompress(data[idat + 4:idat + 4 + n]),
                         np.uint8).reshape(8, 1 + 12 * 3)
    assert (rows[:, 0] == 0).all()
    want = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(rows[:, 1:].reshape(8, 12, 3), want)
