"""Image input and output with the standard library only (zlib + struct)
and NumPy.

Tone mapping matches imbatracer_tpu.io.image.store_png
(`pow(v * weight, gamma)`, clamp, 8-bit quantisation).  `load_png`
decodes 8-bit RGB / RGBA PNGs (filter types 0-4, no interlace), `load_tga`
true-colour and grey Targa files (raw or RLE, either origin), `load_hdr`
Radiance RGBE files (flat and adaptive-RLE scanlines), `load_bmp`
uncompressed 24- and 32-bit BMPs (either row order), `load_jpeg`
baseline Huffman JPEGs (8-bit, grey or YCbCr, 4:4:4 / 4:2:2 / 4:2:0,
restart intervals).  `load_image` dispatches by extension and returns
what the JAX package's loader (through PIL) returns: float32 RGBA in
[0, 1] (HDR unbounded), top-left origin, or None when the file cannot be
decoded (the caller substitutes `magenta_placeholder`), with a warning
that names the variant: progressive, arithmetic-coded, lossless and
12-bit JPEGs, RLE, palette and 16-bit BMPs are not decoded.  No PIL: the
machine with the card does not have it.
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


def load_bmp(path: str) -> np.ndarray:
    """Uncompressed 24- or 32-bit BMP -> (H, W, 4) float32 RGBA in [0, 1],
    top-left origin; bottom-up and top-down files.  A 32-bit BI_RGB
    file's fourth byte is unused (alpha 1, as PIL reads it); BI_BITFIELDS
    files are read through their channel masks."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"BM" or len(data) < 30:
        raise ValueError(f"{path}: not a BMP file")
    (offset,) = struct.unpack("<I", data[10:14])
    (hsize,) = struct.unpack("<I", data[14:18])
    if hsize == 12:
        w, h, _, bpp = struct.unpack("<HHHH", data[18:26])
        comp = 0
    else:
        w, h, _, bpp, comp = struct.unpack("<iiHHI", data[18:34])
    names = {1: "RLE8", 2: "RLE4", 4: "JPEG", 5: "PNG"}
    if comp in names or bpp not in (24, 32) or comp not in (0, 3):
        raise ValueError(f"{path}: {names.get(comp, f'{bpp}-bit')} BMP is "
                         "not decoded (uncompressed 24- and 32-bit only)")
    top_down = h < 0
    h = abs(h)
    stride = (w * bpp // 8 + 3) & ~3
    rows = np.frombuffer(data, np.uint8, count=stride * h, offset=offset)
    px = rows.reshape(h, stride)[:, :w * bpp // 8].reshape(h, w, bpp // 8)
    if not top_down:
        px = px[::-1]
    rgba = np.full((h, w, 4), 255, np.uint8)
    if comp == 0:
        rgba[..., :3] = px[..., 2::-1]                   # BGR(X) -> RGB
    else:
        masks = struct.unpack("<IIII", data[54:70] if hsize >= 56
                              else data[54:66] + b"\0\0\0\0")
        if bpp != 32:
            raise ValueError(f"{path}: {bpp}-bit BI_BITFIELDS BMP is not "
                             "decoded")
        word = px.view("<u4")[..., 0].astype(np.uint64)
        for c, m in enumerate(masks):
            if m == 0:
                continue
            shift = (m & -m).bit_length() - 1
            top = (m >> shift)
            rgba[..., c] = (((word >> np.uint64(shift)) & np.uint64(top))
                            * 255 // top).astype(np.uint8)
    return rgba.astype(np.float32) / 255.0


# --------------------------------------------------------------------------
# Baseline JPEG
# --------------------------------------------------------------------------

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_SOF_NAMES = {0xC2: "progressive", 0xC3: "lossless", 0xC5: "hierarchical",
              0xC6: "hierarchical progressive", 0xC7: "hierarchical lossless",
              0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded progressive",
              0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded "
              "hierarchical", 0xCE: "arithmetic-coded hierarchical "
              "progressive", 0xCF: "arithmetic-coded hierarchical lossless"}


def _idct_matrix():
    k = np.arange(8)
    m = np.cos((2 * k[:, None] + 1) * k[None, :] * np.pi / 16) / 2
    m[:, 0] /= np.sqrt(2.0)
    return m                       # m[x, u] = C(u)/2 cos((2x+1) u pi/16)


_IDCT = _idct_matrix()


def _huffman_lut(counts, symbols):
    """16-bit-peek lookup of a canonical Huffman table: (symbol list,
    length list), each of 65,536 entries (length 0: no such code)."""
    sym = [0] * 65536
    length = [0] * 65536
    code = k = 0
    for n in range(1, 17):
        for _ in range(counts[n - 1]):
            lo = code << (16 - n)
            hi = (code + 1) << (16 - n)
            sym[lo:hi] = [symbols[k]] * (hi - lo)
            length[lo:hi] = [n] * (hi - lo)
            code += 1
            k += 1
        code <<= 1
    return sym, length


def _scan_segments(data: bytes, pos: int):
    """Entropy-coded data from `pos` cut at its restart markers, byte
    stuffing removed; returns (segments, position of the next marker)."""
    segs, start = [], pos
    while True:
        i = data.find(b"\xff", pos)
        if i < 0 or i + 1 >= len(data):
            raise ValueError("JPEG scan runs past the end of the file")
        nxt = data[i + 1]
        if nxt in (0x00, 0xFF):           # stuffed byte or fill byte
            pos = i + 1 if nxt == 0xFF else i + 2
            continue
        segs.append(data[start:i].replace(b"\xff\x00", b"\xff"))
        if 0xD0 <= nxt <= 0xD7:
            start = pos = i + 2
            continue
        return segs, i


def _decode_scan(segs, comps, interval, mcus_x, mcus_y):
    """Huffman-decode one scan; appends each block's coefficients to its
    component's c["coef"] = (indices, values), index = block * 64 +
    zigzag position.  An interleaved scan walks MCUs of h x v blocks per
    component; a single-component scan walks that component's blocks in
    raster order, one block an MCU."""
    if len(comps) == 1:
        c = comps[0]
        layout = [(c, 0, 0, 1, 1)]
        units = [(bx, by) for by in range(-(-c["rows"] // 8))
                 for bx in range(-(-c["cols"] // 8))]
    else:
        layout = [(c, dx, dy, c["h"], c["v"]) for c in comps
                  for dy in range(c["v"]) for dx in range(c["h"])]
        units = [(mx, my) for my in range(mcus_y) for mx in range(mcus_x)]
    per_seg = interval or len(units)
    for s_i, seg in enumerate(segs):
        todo = units[s_i * per_seg:(s_i + 1) * per_seg]
        if not todo:
            break
        d = seg + b"\0\0\0\0"
        pos = 0
        pred = [0] * len(comps)
        for ux, uy in todo:
            for c, dx, dy, sh, sv in layout:
                bx, by = ux * sh + dx, uy * sv + dy
                base = (by * c["bw"] + bx) * 64
                dsym, dlen = c["dc"]
                asym, alen = c["ac"]
                i = pos >> 3
                peek = (((d[i] << 16) | (d[i + 1] << 8) | d[i + 2])
                        >> (8 - (pos & 7))) & 0xFFFF
                n = dlen[peek]
                if n == 0:
                    raise ValueError("bad JPEG Huffman code")
                s = dsym[peek]
                pos += n
                diff = 0
                if s:
                    i = pos >> 3
                    v = ((((d[i] << 16) | (d[i + 1] << 8) | d[i + 2])
                          >> (8 - (pos & 7))) & 0xFFFF) >> (16 - s)
                    pos += s
                    diff = v if v >= 1 << (s - 1) else v - (1 << s) + 1
                ci = c["scan_pos"]
                pred[ci] += diff
                out_i, out_v = c["coef"]
                out_i.append(base)
                out_v.append(pred[ci])
                k = 1
                while k < 64:
                    i = pos >> 3
                    peek = (((d[i] << 16) | (d[i + 1] << 8) | d[i + 2])
                            >> (8 - (pos & 7))) & 0xFFFF
                    n = alen[peek]
                    if n == 0:
                        raise ValueError("bad JPEG Huffman code")
                    rs = asym[peek]
                    pos += n
                    r, s = rs >> 4, rs & 15
                    if s == 0:
                        if r != 15:
                            break                 # end of block
                        k += 16
                        continue
                    k += r
                    i = pos >> 3
                    v = ((((d[i] << 16) | (d[i + 1] << 8) | d[i + 2])
                          >> (8 - (pos & 7))) & 0xFFFF) >> (16 - s)
                    pos += s
                    if k < 64:
                        out_i.append(base + k)
                        out_v.append(v if v >= 1 << (s - 1)
                                     else v - (1 << s) + 1)
                    k += 1


def _fancy_sums(x, axis):
    """libjpeg's triangle ("fancy") 2x upsampling along `axis`, edges
    replicated, before its rounding: output 2i is 3 x[i] + x[i-1], output
    2i+1 is 3 x[i] + x[i+1]."""
    n = x.shape[axis]
    prev = np.take(x, np.r_[0, np.arange(n - 1)], axis=axis)
    nxt = np.take(x, np.r_[np.arange(1, n), n - 1], axis=axis)
    out = np.stack([3 * x + prev, 3 * x + nxt], axis=axis + 1)
    shape = list(x.shape)
    shape[axis] = 2 * n
    return out.reshape(shape)


def _upsample(plane, hf, vf):
    """A component plane (int64) up by (hf, vf) in {(1, 1), (2, 1),
    (2, 2)}, rounded as libjpeg's fancy upsampling (jdsample.c) rounds."""
    if (hf, vf) == (1, 1):
        return plane
    if vf == 1:                                        # h2v1
        return (_fancy_sums(plane, 1) + np.tile([1, 2], plane.shape[1])) >> 2
    s = _fancy_sums(_fancy_sums(plane, 0), 1)          # h2v2
    return (s + np.tile([8, 7], plane.shape[1])) >> 4


def _ycc_to_rgb(y, cb, cr):
    """libjpeg's fixed-point YCbCr -> RGB (jdcolor.c, 16 fraction bits)."""
    fix = lambda v: int(v * 65536 + 0.5)
    cb, cr = cb - 128, cr - 128
    half = 1 << 15
    r = y + ((fix(1.40200) * cr + half) >> 16)
    g = y + ((-fix(0.34414) * cb - fix(0.71414) * cr + half) >> 16)
    b = y + ((fix(1.77200) * cb + half) >> 16)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def load_jpeg(path: str) -> np.ndarray:
    """Baseline (sequential Huffman, 8-bit) JPEG -> (H, W, 4) float32 RGBA
    in [0, 1], alpha 1.  One (grey) or three (YCbCr, or RGB under an
    Adobe transform of 0) components, chroma at 4:4:4, 4:2:2 or 4:2:0,
    interleaved or single-component scans, restart intervals.  A float
    IDCT, then libjpeg's fancy upsampling and fixed-point colour
    conversion; other variants raise ValueError naming them."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: not a JPEG file")
    qt, huff, comps, frame = {}, {}, [], None
    interval, adobe, pos = 0, None, 2
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"{path}: JPEG marker expected at {pos}")
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker == 0xD9:
            break
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        body = data[pos + 4:pos + 2 + length]
        pos += 2 + length
        if marker in _SOF_NAMES:
            raise ValueError(f"{path}: {_SOF_NAMES[marker]} JPEG is not "
                             "decoded (baseline Huffman only)")
        if marker in (0xC0, 0xC1):
            prec, h, w, nc = struct.unpack(">BHHB", body[:6])
            if prec != 8:
                raise ValueError(f"{path}: {prec}-bit JPEG is not decoded")
            if nc not in (1, 3) or h == 0:
                raise ValueError(f"{path}: {nc}-component JPEG is not "
                                 "decoded")
            frame = (w, h)
            for k in range(nc):
                cid, hv, tq = body[6 + 3 * k:9 + 3 * k]
                comps.append(dict(id=cid, h=hv >> 4, v=hv & 15, tq=tq))
        elif marker == 0xDB:
            q = 0
            while q < len(body):
                pq, tq = body[q] >> 4, body[q] & 15
                n = 128 if pq else 64
                qt[tq] = np.frombuffer(body[q + 1:q + 1 + n],
                                       ">u2" if pq else np.uint8
                                       ).astype(np.int64)
                q += 1 + n
        elif marker == 0xC4:
            q = 0
            while q < len(body):
                tc, th = body[q] >> 4, body[q] & 15
                counts = list(body[q + 1:q + 17])
                total = sum(counts)
                huff[tc, th] = _huffman_lut(counts,
                                            list(body[q + 17:q + 17 + total]))
                q += 17 + total
        elif marker == 0xDD:
            (interval,) = struct.unpack(">H", body[:2])
        elif marker == 0xEE and body[:5] == b"Adobe":
            adobe = body[11]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError(f"{path}: JPEG scan before its frame")
            w, h = frame
            hmax = max(c["h"] for c in comps)
            vmax = max(c["v"] for c in comps)
            mcus_x, mcus_y = -(-w // (8 * hmax)), -(-h // (8 * vmax))
            for c in comps:
                if (hmax % c["h"] or vmax % c["v"] or (hmax // c["h"],
                        vmax // c["v"]) not in ((1, 1), (2, 1), (2, 2))):
                    raise ValueError(
                        f"{path}: JPEG sampling {c['h']}x{c['v']} of "
                        f"{hmax}x{vmax} is not decoded (4:4:4, 4:2:2 and "
                        "4:2:0 only)")
                c.setdefault("coef", ([], []))
                c.update(bw=mcus_x * c["h"], bh=mcus_y * c["v"],
                         cols=-(-w * c["h"] // hmax),
                         rows=-(-h * c["v"] // vmax))
            scan = []
            for k in range(body[0]):
                cid, tables = body[1 + 2 * k], body[2 + 2 * k]
                c = next(c for c in comps if c["id"] == cid)
                c.update(dc=huff[0, tables >> 4], ac=huff[1, tables & 15],
                         scan_pos=k)
                scan.append(c)
            segs, pos = _scan_segments(data, pos)
            _decode_scan(segs, scan, interval, mcus_x, mcus_y)
    if frame is None:
        raise ValueError(f"{path}: no JPEG frame")
    w, h = frame
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    planes = []
    for c in comps:
        idx, val = c["coef"]
        coef = np.zeros(c["bw"] * c["bh"] * 64, np.int64)
        coef[np.asarray(idx, np.int64)] = val
        zz = coef.reshape(-1, 64) * qt[c["tq"]][None, :]
        nat = np.zeros_like(zz)
        nat[:, _ZIGZAG] = zz
        blocks = _IDCT @ nat.reshape(-1, 8, 8).astype(np.float64) @ _IDCT.T
        px = np.clip(np.floor(blocks + 128.5), 0, 255).astype(np.int64)
        plane = px.reshape(c["bh"], c["bw"], 8, 8).transpose(0, 2, 1, 3)
        plane = plane.reshape(c["bh"] * 8, c["bw"] * 8)[:c["rows"], :c["cols"]]
        planes.append(_upsample(plane, hmax // c["h"], vmax // c["v"])
                      [:h, :w])
    rgba = np.full((h, w, 4), 255, np.uint8)
    if len(planes) == 1:
        rgba[..., :3] = planes[0][..., None]
    elif adobe == 0:
        rgba[..., :3] = np.stack(planes, -1)
    else:
        rgba[..., :3] = _ycc_to_rgb(*planes)
    return rgba.astype(np.float32) / 255.0


def _png_rgba(path: str) -> np.ndarray:
    img = load_png(path)
    if img.shape[-1] == 3:
        img = np.concatenate(
            [img, np.full(img.shape[:2] + (1,), 255, np.uint8)], axis=-1)
    return img.astype(np.float32) / 255.0


def load_image(path: str) -> np.ndarray | None:
    """Dispatch by extension; None (with a warning naming the cause) when
    the file cannot be decoded or is a variant the port does not decode."""
    ext = os.path.splitext(path)[1].lower()
    try:
        if ext == ".png":
            return _png_rgba(path)
        if ext == ".tga":
            return load_tga(path)
        if ext in (".hdr", ".pic"):
            return load_hdr(path)
        if ext == ".bmp":
            return load_bmp(path)
        if ext in (".jpg", ".jpeg"):
            return load_jpeg(path)
    except (OSError, ValueError, IndexError, KeyError, StopIteration,
            struct.error, zlib.error) as exc:
        logger.warning("cannot decode %s: %s", path, exc)
        return None
    return None


def magenta_placeholder(size: int = 4) -> np.ndarray:
    """Texture-load-failure placeholder: opaque magenta."""
    img = np.zeros((size, size, 4), np.float32)
    img[..., 0] = 1.0
    img[..., 2] = 1.0
    img[..., 3] = 1.0
    return img
