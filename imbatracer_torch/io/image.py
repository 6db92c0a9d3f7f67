"""PNG output and input with the standard library only (zlib + struct)
and NumPy.

Tone mapping matches imbatracer_tpu.io.image.store_png
(`pow(v * weight, gamma)`, clamp, 8-bit quantisation).  `load_png`
decodes 8-bit RGB / RGBA PNGs (filter types 0-4, no interlace), enough
for the repository's goldens.  No PIL: the machine with the card does
not have it.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


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
