"""Image input and output with the standard library only (zlib + struct)
and NumPy.

Tone mapping matches imbatracer_tpu.io.image.store_png
(`pow(v * weight, gamma)`, clamp, 8-bit quantisation).  `load_png`
decodes 8-bit RGB / RGBA PNGs (filter types 0-4, no interlace), `load_tga`
true-colour and grey Targa files (raw or RLE, either origin), `load_hdr`
Radiance RGBE files (flat and adaptive-RLE scanlines).  `load_image`
dispatches by extension and returns what the JAX package's loader
returns: float32 RGBA in [0, 1] (HDR unbounded), top-left origin, or None
when the file cannot be decoded (the caller substitutes
`magenta_placeholder`).  No PIL: the machine with the card does not have
it, so JPEG and BMP textures are not decoded (None).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from ..utils.log import logger


def _chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def encode_png(rgb8: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> PNG file bytes (8-bit RGB, filter 0 rows)."""
    h, w, c = rgb8.shape
    if c != 3 or rgb8.dtype != np.uint8:
        raise ValueError("encode_png expects an (H, W, 3) uint8 image")
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           rgb8.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def store_png(path: str, img: np.ndarray, weight: float = 1.0,
              gamma: float = 1.0 / 2.2) -> None:
    """Tone-map (`pow(v * weight, gamma)`) and write an 8-bit RGB PNG."""
    rgb = np.clip(np.power(np.maximum(img[..., :3] * weight, 0.0), gamma),
                  0.0, 1.0)
    out = (rgb * 255.0 + 0.5).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(encode_png(out))


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (None, Sub, Up, Average, Paeth) of a
    decompressed IDAT stream; returns (h, w * bpp) uint8 rows."""
    stride = w * bpp
    buf = np.frombuffer(raw, np.uint8)
    if buf.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {buf.size} bytes, expected "
                         f"{h * (stride + 1)}")
    rows = buf.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        elif ftype in (1, 3, 4):
            # Left-neighbour filters run byte by byte along the row.
            cur = np.zeros(stride, np.int32)
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = prev[i]
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (
                        b if pb <= pc else c)
                cur[i] = (line[i] + pred) & 0xFF
        else:
            raise ValueError(f"unknown PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def load_png(path: str) -> np.ndarray:
    """8-bit RGB or RGBA PNG file -> (H, W, 3 or 4) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    channels = {2: 3, 6: 4}.get(ctype)
    if depth != 8 or channels is None or interlace != 0:
        raise ValueError(f"{path}: only 8-bit RGB/RGBA non-interlaced PNGs "
                         f"are supported (depth {depth}, colour type "
                         f"{ctype}, interlace {interlace})")
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, w, channels)
    return rows.reshape(h, w, channels)


def load_tga(path: str) -> np.ndarray:
    """Targa file -> (H, W, 4) float32 RGBA in [0, 1], top-left origin.
    Image types 2 / 10 (true colour, 24 or 32 bits) and 3 / 11 (8-bit
    grey), raw or run-length encoded; the descriptor's origin bits are
    honoured.  Palette and 16-bit images raise ValueError."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 18:
        raise ValueError(f"{path}: not a TGA file")
    id_len, cmap_type, itype = data[0], data[1], data[2]
    w, h = struct.unpack("<HH", data[12:16])
    depth, flags = data[16], data[17]
    channels = {(2, 24): 3, (2, 32): 4, (3, 8): 1}.get((itype & 7, depth))
    if cmap_type != 0 or channels is None or w == 0 or h == 0:
        raise ValueError(f"{path}: unsupported TGA (type {itype}, depth "
                         f"{depth}, colour map {cmap_type})")
    buf = np.frombuffer(data, np.uint8, offset=18 + id_len)
    n = w * h
    if itype & 8:
        px = np.empty((n, channels), np.uint8)
        i = bp = 0
        while i < n:
            head = int(buf[bp])
            count = (head & 0x7F) + 1
            bp += 1
            if head & 0x80:
                px[i:i + count] = buf[bp:bp + channels]
                bp += channels
            else:
                px[i:i + count] = buf[bp:bp + count * channels].reshape(
                    count, channels)
                bp += count * channels
            i += count
    else:
        px = buf[:n * channels].reshape(n, channels)
    px = px.reshape(h, w, channels)
    if not flags & 0x20:          # bottom-left origin
        px = px[::-1]
    if flags & 0x10:              # right-to-left
        px = px[:, ::-1]
    rgba = np.full((h, w, 4), 255, np.uint8)
    if channels == 1:
        rgba[..., :3] = px
    else:
        rgba[..., :3] = px[..., 2::-1]                      # BGR(A) -> RGB
        if channels == 4:
            rgba[..., 3] = px[..., 3]
    return rgba.astype(np.float32) / 255.0


def load_hdr(path: str) -> np.ndarray:
    """Radiance .hdr (RGBE) decoder, flat and adaptive-RLE scanlines.
    Returns (H, W, 4) float32, alpha 1."""
    with open(path, "rb") as f:
        data = f.read()

    # Header: lines until the blank line, then the resolution line.
    pos = 0
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"not a Radiance HDR file: {path}")
    while True:
        eol = data.index(b"\n", pos)
        line = data[pos:eol]
        pos = eol + 1
        if line == b"":
            break
    eol = data.index(b"\n", pos)
    res = data[pos:eol].split()
    pos = eol + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"unsupported HDR orientation: {res}")
    height, width = int(res[1]), int(res[3])

    rgbe = np.zeros((height, width, 4), np.uint8)
    buf = np.frombuffer(data, np.uint8, offset=pos)
    bp = 0
    for y in range(height):
        if width < 8 or width > 0x7FFF or buf[bp] != 2 or buf[bp + 1] != 2:
            # Flat (non-RLE) scanline.
            rgbe[y] = buf[bp:bp + width * 4].reshape(width, 4)
            bp += width * 4
            continue
        if (int(buf[bp + 2]) << 8 | int(buf[bp + 3])) != width:
            raise ValueError("HDR scanline length mismatch")
        bp += 4
        for c in range(4):
            x = 0
            while x < width:
                count = int(buf[bp])
                bp += 1
                if count > 128:  # run
                    count -= 128
                    rgbe[y, x:x + count, c] = buf[bp]
                    bp += 1
                else:  # literal
                    rgbe[y, x:x + count, c] = buf[bp:bp + count]
                    bp += count
                x += count

    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 136)).astype(np.float32)
    out = np.empty((height, width, 4), np.float32)
    out[..., :3] = (rgbe[..., :3].astype(np.float32) + 0.5) * scale[..., None]
    out[..., 3] = 1.0
    return out


def _png_rgba(path: str) -> np.ndarray:
    img = load_png(path)
    if img.shape[-1] == 3:
        img = np.concatenate(
            [img, np.full(img.shape[:2] + (1,), 255, np.uint8)], axis=-1)
    return img.astype(np.float32) / 255.0


def load_image(path: str) -> np.ndarray | None:
    """Dispatch by extension; None when the file cannot be decoded or its
    format is not ported (JPEG, BMP)."""
    ext = os.path.splitext(path)[1].lower()
    try:
        if ext == ".png":
            return _png_rgba(path)
        if ext == ".tga":
            return load_tga(path)
        if ext in (".hdr", ".pic"):
            return load_hdr(path)
    except (OSError, ValueError, IndexError, struct.error, zlib.error) as exc:
        logger.warning("cannot decode %s: %s", path, exc)
        return None
    if ext in (".jpg", ".jpeg", ".bmp"):
        logger.warning("%s: %s images are not decoded by the port", path,
                       ext[1:].upper())
    return None


def magenta_placeholder(size: int = 4) -> np.ndarray:
    """Texture-load-failure placeholder: opaque magenta."""
    img = np.zeros((size, size, 4), np.float32)
    img[..., 0] = 1.0
    img[..., 2] = 1.0
    img[..., 3] = 1.0
    return img
