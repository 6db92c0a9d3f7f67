"""Frozen copy of the program's `scene/textures.py`, for the benchmark's plain
reference; its own description follows.

Texture atlas: all scene textures in one flat texel buffer (torch twin
of imbatracer_tpu.scene.textures).  Sampling: repeat wrap, v flipped,
bilinear over a (w-1, h-1) grid with wrap-around neighbours."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .tensors import TensorData


@dataclass
class TextureAtlas(TensorData):
    texels: torch.Tensor  # (T, 3) f32
    offset: torch.Tensor  # (K,) i32
    width: torch.Tensor   # (K,) i32
    height: torch.Tensor  # (K,) i32


def pack_textures(images: list, device) -> TextureAtlas:
    """Pack (H, W, >=3) float images into one atlas (a 1x1 white texel
    when there are none)."""
    if not images:
        images = [np.ones((1, 1, 3), np.float32)]
    offs, ws, hs, bufs = [], [], [], []
    cursor = 0
    for img in images:
        h, w = img.shape[:2]
        offs.append(cursor)
        ws.append(w)
        hs.append(h)
        bufs.append(np.asarray(img[..., :3], np.float32).reshape(-1, 3))
        cursor += w * h
    t = lambda a: torch.as_tensor(a, device=device)
    return TextureAtlas(texels=t(np.concatenate(bufs, axis=0)),
                        offset=t(np.asarray(offs, np.int32)),
                        width=t(np.asarray(ws, np.int32)),
                        height=t(np.asarray(hs, np.int32)))


def _wrap_uv(u, v):
    u = u - torch.floor(u)
    v = v - torch.floor(v)
    return u, 1.0 - v


def sample_bilinear(atlas: TextureAtlas, tex_id, u, v):
    """Bilinear sample; tex_id < 0 returns white."""
    tid = tex_id.clamp(min=0).long()
    w = atlas.width[tid].long()
    h = atlas.height[tid].long()
    off = atlas.offset[tid].long()
    u, v = _wrap_uv(u, v)
    kx = u * (w - 1).to(torch.float32)
    ky = v * (h - 1).to(torch.float32)
    x0 = kx.to(torch.int64)
    y0 = ky.to(torch.int64)
    x1 = torch.remainder(x0 + 1, w)
    y1 = torch.remainder(y0 + 1, h)
    gx = (kx - torch.floor(kx))[..., None]
    gy = (ky - torch.floor(ky))[..., None]
    tex = atlas.texels
    i00 = tex[off + y0 * w + x0]
    i10 = tex[off + y0 * w + x1]
    i01 = tex[off + y1 * w + x0]
    i11 = tex[off + y1 * w + x1]
    val = ((1 - gy) * ((1 - gx) * i00 + gx * i10)
           + gy * ((1 - gx) * i01 + gx * i11))
    return torch.where((tex_id >= 0)[..., None], val, 1.0)


def sample_mask(atlas: TextureAtlas, tex_id, u, v):
    """Binary transparency lookup, nearest neighbour: opaque where the
    texel is non-black.  tex_id < 0 is always opaque."""
    tid = tex_id.clamp(min=0).long()
    w = atlas.width[tid]
    h = atlas.height[tid]
    off = atlas.offset[tid]
    u, v = _wrap_uv(u, v)
    return _mask_texel_opaque(atlas, off, w, h, u, v) | (tex_id < 0)


class MaskTest:
    """Transparency test of masked traversal through the narrow
    per-triangle mask record (TriAttrs.mask_rec: mask texture, its width,
    height and atlas offset as int32 bits, and the three uvs), called as
    alpha_fn(prim, u, v) -> opaque: two gathers, a row and a texel, with
    sample_mask's texel lookup.  The record and the atlas are its
    attributes, so the traversal kernels run the same test themselves
    (ops/dispatch.py, csrc/shading.cuh mask_opaque)."""

    def __init__(self, mask_rec, textures: TextureAtlas):
        self.mask_rec = mask_rec
        self.textures = textures

    def __call__(self, prim, u, v):
        rec = self.mask_rec[prim.long()]
        bits = rec[:, 0:4].view(torch.int32)
        mt, w, h, off = bits[:, 0], bits[:, 1], bits[:, 2], bits[:, 3]
        w0 = 1.0 - u - v
        tu = w0 * rec[:, 4] + u * rec[:, 6] + v * rec[:, 8]
        tv = w0 * rec[:, 5] + u * rec[:, 7] + v * rec[:, 9]
        tu, tv = _wrap_uv(tu, tv)
        return (_mask_texel_opaque(self.textures, off, w, h, tu, tv)
                | (mt < 0))


def _mask_texel_opaque(atlas: TextureAtlas, off, w, h, u, v):
    """Nearest texel at wrapped (u, v) of a w x h image at `off` (i32
    tensors), binarised: non-black is opaque."""
    x = torch.minimum(torch.clamp((u * w.to(torch.float32)).to(torch.int32),
                                  min=0), w - 1)
    y = torch.minimum(torch.clamp((v * h.to(torch.float32)).to(torch.int32),
                                  min=0), h - 1)
    texel = atlas.texels[(off + y * w + x).long()]
    return torch.sum(texel, dim=-1) > 0.0
