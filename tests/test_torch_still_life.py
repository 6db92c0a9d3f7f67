"""The masked and environment-lit PT frame of the port against the JAX
reference, the frontend on a masked scene, and the image metrics and PNG
decoder used to hold the still-life frame against its golden.

render_pt_frame runs on the same scene arrays, camera and frame number in
both packages (JAX through its exact in-loop masked traversal,
max_steps=0; the port through the k-nearest-hit re-trace over the plain
traversal), held as tests/test_torch_pt.py holds the cornell: mean
relative difference <= 1e-3, >= 98% of pixels within 1e-4 relative (of
max(|value|, 1e-3)), traced-ray counts within 1%.  Metrics and the
decoder are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imbatracer_tpu.render.camera import make_camera as jcamera
from imbatracer_tpu.render.integrators.pt import render_pt_frame as jrender
from imbatracer_tpu.scene import procedural as jproc
from imbatracer_tpu.utils import metrics as jmetrics
from imbatracer_torch.convert import scene_from_numpy, scene_to_numpy
from imbatracer_torch.frontend.engine import make_frame_fn
from imbatracer_torch.frontend.renderer import (ProgressiveRenderer,
                                                RenderSettings)
from imbatracer_torch.io.image import encode_png, load_png
from imbatracer_torch.render import traverse as tt
from imbatracer_torch.render.camera import make_camera as tcamera
from imbatracer_torch.render.integrators.pt import render_pt_frame as trender
from imbatracer_torch.scene.procedural import make_still_life_like
from imbatracer_torch.utils import metrics as tmetrics

W, SPP, MAX_LEN = 32, 2, 4
SMALL_STILL_LIFE = dict(num_objects=40, num_cards=16)


@pytest.mark.parametrize("name,kw", [
    ("make_masked_scene", {}),
    ("make_still_life_like", SMALL_STILL_LIFE)])
def test_masked_env_pt_frame_matches_jax(name, kw):
    js, meta = getattr(jproc, name)(**kw)
    ts = scene_from_numpy(scene_to_numpy(js), "cpu")
    assert meta.has_masks and ts.attrs.mask_rec is not None
    assert (ts.env is not None) == meta.has_env
    cam = (meta.cam_pos, meta.cam_dir, meta.cam_up, W, W, 60.0)
    jf, jn = jrender(js, jcamera(*cam), jnp.uint32(3), W, W, spp=SPP,
                     max_len=MAX_LEN, has_masks=True, with_stats=True,
                     max_steps=0)
    before = dict(tt.MASK_STATS)
    tf, tn = trender(ts, tcamera(*cam, device="cpu"), 3, W, W, spp=SPP,
                     max_len=MAX_LEN, has_masks=True, with_stats=True)
    # Every bounce's closest hit and shadow query went the masked route.
    assert tt.MASK_STATS["dispatches"] == before["dispatches"] + 2 * MAX_LEN
    jf, tf = np.asarray(jf), tf.numpy()
    assert tf.shape == (W * W, 3) and np.isfinite(tf).all()
    assert jf.mean() > 0.0
    assert abs(tf.mean() - jf.mean()) / jf.mean() <= 1e-3
    rel = np.abs(tf - jf) / np.maximum(np.abs(jf), 1e-3)
    assert (rel.max(axis=-1) <= 1e-4).mean() >= 0.98
    assert abs(int(tn) - int(jn)) <= 1e-2 * int(jn)


def test_frame_fn_on_masked_env_scene():
    """make_frame_fn carries has_masks and the env map through; the
    progressive accumulator is the sum of the frames."""
    scene, meta = make_still_life_like(device="cpu", **SMALL_STILL_LIFE)
    assert meta.has_masks and meta.has_env and scene.env is not None
    settings = RenderSettings(width=16, height=12, spp=1, max_path_len=3)
    frame_fn, _ = make_frame_fn(scene, meta, settings)
    renderer = ProgressiveRenderer(frame_fn, settings, "cpu")
    before = tt.MASK_STATS["dispatches"]
    renderer.step()
    renderer.step()
    assert tt.MASK_STATS["dispatches"] > before
    want = (frame_fn(0) + frame_fn(1)).numpy().reshape(12, 16, 3)
    np.testing.assert_array_equal(renderer.raw(), want)
    img = renderer.image()
    assert img.shape == (12, 16, 3) and 0.0 < img.mean() <= 1.0


def test_metrics_match_jax():
    rs = np.random.RandomState(3)
    a = rs.uniform(-0.1, 1.1, (24, 32, 3)).astype(np.float32)
    b = np.clip(a + rs.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    np.testing.assert_array_equal(tmetrics.quantize(a), jmetrics.quantize(a))
    assert tmetrics.rmse(a, b) == jmetrics.rmse(a, b)
    assert tmetrics.psnr(a, b) == jmetrics.psnr(a, b)
    assert tmetrics.psnr(a, a) == float("inf")


def test_load_png_matches_pil_on_golden():
    import os

    golden = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "goldens", "still_life_512_len4.png")
    got = tmetrics.load_reference_png(golden)
    np.testing.assert_array_equal(got, jmetrics.load_reference_png(golden))
    assert got.shape == (512, 512, 3) and got.dtype == np.float32


def _png_with_every_filter(img):
    """PNG bytes of `img` (H, W, 3|4 uint8) whose row y uses filter type
    y % 5, filtered with the PNG specification's forward formulas."""
    import struct
    import zlib

    h, w, ch = img.shape
    rows = img.reshape(h, w * ch).astype(np.int32)
    out = []
    for y in range(h):
        cur = rows[y]
        prev = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(ch, np.int32), cur[:-ch]])
        upleft = np.concatenate([np.zeros(ch, np.int32), prev[:-ch]])
        f = y % 5
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = (np.abs(p - left), np.abs(p - prev),
                          np.abs(p - upleft))
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        out.append(bytes([f]) + ((cur - pred) & 0xFF).astype(np.uint8)
                   .tobytes())

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, {3: 2, 4: 6}[ch], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ch", [3, 4])
def test_load_png_filters(tmp_path, ch):
    """Every PNG filter type (0-4) on RGB and RGBA rows decodes to the
    encoded pixels; the port's own encoder round-trips."""
    rs = np.random.RandomState(8)
    img = rs.randint(0, 256, (20, 17, ch)).astype(np.uint8)
    (tmp_path / "f.png").write_bytes(_png_with_every_filter(img))
    np.testing.assert_array_equal(load_png(str(tmp_path / "f.png")), img)
    (tmp_path / "g.png").write_bytes(encode_png(img[..., :3].copy()))
    np.testing.assert_array_equal(load_png(str(tmp_path / "g.png")),
                                  img[..., :3])
