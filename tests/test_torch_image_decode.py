"""The port's BMP and baseline-JPEG decoders (imbatracer_torch.io.image,
NumPy only) against PIL's decode of files that PIL writes here.

* BMP, 24- and 32-bit, bottom-up as PIL writes them and top-down as this
  test rewrites them: equal to PIL's RGBA bit for bit (a 32-bit BI_RGB
  file's fourth byte is not alpha, and both read alpha 1); a 32-bit
  BI_BITFIELDS file with an alpha mask too.
* JPEG at quality 90, 4:4:4, 4:2:2, 4:2:0, grey and 4:2:0 with restart
  markers: mean absolute difference at most 1 level of 255 (the largest
  seen on these images: 0.035 of a level; the largest single difference
  2 levels).  The bound: the port's float IDCT and PIL's (libjpeg's)
  integer IDCT round a sample apart by at most a level, and the port
  copies libjpeg's fancy chroma upsampling and fixed-point colour
  conversion, so chroma edges do not widen the gap.
* A progressive JPEG, an RLE BMP and a 16-bit BMP give None with a
  warning that names the variant (the caller's magenta placeholder).

The tests skip where PIL is absent (the port itself never imports it).
"""

import logging
import struct

import numpy as np
import pytest

from imbatracer_torch.io import image as im
from torch_threads import cap_torch_threads

cap_torch_threads()

Image = pytest.importorskip("PIL.Image")


def _test_image(h=37, w=53, seed=0):
    """Smooth colour ramps with noise: chroma varies at every scale."""
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 5.0), 128 + 100 * np.cos(y / 7.0),
                    (x * 3 + y * 2) % 256], -1)
    return np.clip(img + rs.randn(h, w, 3) * 10, 0, 255).astype(np.uint8)


def _pil(path):
    return np.asarray(Image.open(path).convert("RGBA"), np.float32) / 255.0


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
@pytest.mark.parametrize("order", ["bottom-up", "top-down"])
def test_bmp_equals_pil(mode, order, tmp_path):
    img = _test_image()
    if mode == "RGBA":
        alpha = np.random.RandomState(1).randint(0, 256, img.shape[:2])
        img = np.concatenate([img, alpha[..., None].astype(np.uint8)], -1)
    path = tmp_path / "t.bmp"
    Image.fromarray(img, mode).save(path)
    want = _pil(path)
    if order == "top-down":
        data = bytearray(path.read_bytes())
        offset, = struct.unpack("<I", data[10:14])
        w, h, _, bpp = struct.unpack("<iiHH", data[18:30])
        stride = (w * bpp // 8 + 3) & ~3
        rows = bytes(data[offset:offset + stride * h])
        flipped = b"".join(rows[i * stride:(i + 1) * stride]
                           for i in reversed(range(h)))
        data[offset:offset + stride * h] = flipped
        data[22:26] = struct.pack("<i", -h)
        path.write_bytes(bytes(data))
    got = im.load_image(str(path))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_bmp_bitfields_equals_pil(tmp_path):
    """A 32-bit BI_BITFIELDS file with a V4 header (BGRA masks), as image
    editors write one with alpha: read through its masks, alpha too."""
    h, w = 5, 7
    bgra = np.random.RandomState(3).randint(0, 256, (h, w, 4)).astype(
        np.uint8)
    masks = struct.pack("<IIII", 0x00FF0000, 0x0000FF00, 0x000000FF,
                        0xFF000000)
    info = struct.pack("<IiiHHIIiiII", 108, w, h, 1, 32, 3, w * h * 4, 0, 0,
                       0, 0) + masks + bytes(108 - 40 - 16)
    offset = 14 + len(info)
    path = tmp_path / "v4.bmp"
    path.write_bytes(b"BM" + struct.pack("<IHHI", offset + w * h * 4, 0, 0,
                                         offset) + info
                     + bgra[::-1].tobytes())
    want = _pil(path)
    assert not (want[..., 3] == 1.0).all()
    np.testing.assert_array_equal(im.load_image(str(path)), want)


@pytest.mark.parametrize("case", ["444", "422", "420", "grey", "restart"])
def test_jpeg_within_a_level_of_pil(case, tmp_path):
    img = _test_image()
    path = tmp_path / "t.jpg"
    kw = dict(quality=90)
    if case == "grey":
        pil = Image.fromarray(img[..., 0])
    else:
        pil = Image.fromarray(img)
        kw["subsampling"] = {"444": 0, "422": 1}.get(case, 2)
    if case == "restart":
        kw["restart_marker_blocks"] = 3
    pil.save(path, **kw)
    data = path.read_bytes()
    if case == "restart":
        assert b"\xff\xdd" in data and b"\xff\xd0" in data
    got, want = im.load_image(str(path)), _pil(path)
    assert got.shape == want.shape == img.shape[:2] + (4,)
    diff = np.abs(got - want) * 255.0
    assert diff.mean() <= 1.0, diff.mean()
    assert diff.max() <= 2.0 + 1e-3
    assert (got[..., 3] == 1.0).all()


def test_jpeg_decodes_a_larger_image_exactly_enough(tmp_path):
    """A 512x512 4:2:0 image of 8x8 flat tiles (blocks that compress to
    their DC, where both IDCTs are exact)."""
    rs = np.random.RandomState(2)
    img = np.kron((rs.rand(64, 64, 3) * 255).astype(np.uint8),
                  np.ones((8, 8, 1), np.uint8))
    path = tmp_path / "big.jpg"
    Image.fromarray(img).save(path, quality=90)
    diff = np.abs(im.load_image(str(path)) - _pil(path)) * 255.0
    assert diff.mean() <= 0.05


def _bmp_header(bpp, comp):
    w, h = 4, 2
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, bpp, comp, 0, 0, 0, 0, 0)
    return b"BM" + struct.pack("<IHHI", 14 + 40 + 64, 0, 0, 54) + info + \
        bytes(64)


@pytest.mark.parametrize("name,make,word", [
    ("progressive", "progressive", "progressive"),
    ("rle", (8, 1), "RLE8"),
    ("16bit", (16, 0), "16-bit")])
def test_unsupported_variants_give_the_placeholder(name, make, word,
                                                   tmp_path, caplog):
    if make == "progressive":
        path = tmp_path / "p.jpg"
        Image.fromarray(_test_image()).save(path, quality=90,
                                            progressive=True)
    else:
        path = tmp_path / f"{name}.bmp"
        path.write_bytes(_bmp_header(*make))
    with caplog.at_level(logging.WARNING, logger="imbatracer_torch"):
        assert im.load_image(str(path)) is None
    assert word in caplog.text
