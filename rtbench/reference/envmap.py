"""Frozen copy of the program's `render/envmap.py`, for the benchmark's plain
reference; its own description follows.

Lat-long HDR environment map with piecewise-constant importance
sampling (torch twin of imbatracer_tpu.render.envmap).

The tables are built on the host in NumPy, with the same float32
arithmetic as the JAX package, so both hold the same bits; lookups and
sampling are torch ops on the tables' device.

Directional convention:
    s = phi / 2pi,  phi = atan2(x, z) wrapped to [0, 2pi)
    t = theta / pi, theta = acos(y)
    dir(s, t) = (sin(pi t) sin(2pi s), cos(pi t), sin(pi t) cos(2pi s))
pdf conversion: p(w) = p(s,t) / (2 pi^2 sin(theta)).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .sampling import PI, concentric_disc_pdf
from .tensors import TensorData

ENV_KEYS = ("img", "pdf_table", "row_cdf", "marginal_cdf")


@dataclass
class EnvMapData(TensorData):
    img: torch.Tensor           # (H, W, 3) radiance, intensity pre-multiplied
    pdf_table: torch.Tensor     # (H, W) density over the unit (s, t) square
    row_cdf: torch.Tensor       # (H, W + 1) conditional cdf per row
    marginal_cdf: torch.Tensor  # (H + 1,)


def build_envmap(img_rgb: np.ndarray, intensity, device="cpu") -> EnvMapData:
    """Host-side table construction. img_rgb: (H, W, >=3) float32."""
    img = np.asarray(img_rgb[..., :3], np.float32) * np.asarray(intensity, np.float32)
    h, w = img.shape[:2]
    lum = 0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2]
    # 2x2 neighbourhood average, then sin(theta) weighting for the sphere
    # metric.
    func = 0.25 * (
        lum + np.roll(lum, -1, 0) + np.roll(lum, -1, 1) + np.roll(np.roll(lum, -1, 0), -1, 1)
    )
    sin_theta = np.sin(np.pi * (np.arange(h) + 0.5) / h).astype(np.float32)
    func = func * sin_theta[:, None]
    func = np.maximum(func, 1e-12)

    total = func.sum()
    pdf_table = func * (w * h / total)   # integrates to 1 over [0,1]^2

    row_sum = func.sum(axis=1)
    marginal_cdf = np.concatenate([[0.0], np.cumsum(row_sum)]) / total
    row_cdf = np.concatenate(
        [np.zeros((h, 1), np.float32), np.cumsum(func, axis=1)], axis=1
    ) / row_sum[:, None]

    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return EnvMapData(img=t(img), pdf_table=t(pdf_table),
                      row_cdf=t(row_cdf), marginal_cdf=t(marginal_cdf))


def _dir_to_st(d):
    phi = torch.atan2(d[..., 0], d[..., 2])
    phi = torch.where(phi < 0.0, phi + 2.0 * PI, phi)
    s = phi / (2.0 * PI)
    t = torch.acos(torch.clamp(d[..., 1], -1.0, 1.0)) / PI
    return s, t


def _st_pdf_w(env: EnvMapData, s, t):
    h, w = env.pdf_table.shape
    col = torch.clamp((s * w).to(torch.int32), 0, w - 1).long()
    row = torch.clamp((t * h).to(torch.int32), 0, h - 1).long()
    p_st = env.pdf_table[row, col]
    sin_t = torch.clamp(torch.sin(PI * t), min=1e-5)
    return p_st / (2.0 * PI * PI * sin_t)


def _lookup(env: EnvMapData, s, t):
    """Nearest texel at the reference's coordinates."""
    h, w = env.img.shape[:2]
    x = torch.clamp((s * (w - 1)).to(torch.int32), 0, w - 1).long()
    y = torch.clamp((t * (h - 1)).to(torch.int32), 0, h - 1).long()
    return env.img[y, x]


def radiance(env: EnvMapData, d, bsphere_inv_r2):
    """Env radiance + (pdf_direct_w, pdf_emit_w) for a unit direction."""
    s, t = _dir_to_st(d)
    li = _lookup(env, s, t)
    pdf_direct_w = _st_pdf_w(env, s, t)
    pdf_emit_w = concentric_disc_pdf() * bsphere_inv_r2 * pdf_direct_w
    return li, pdf_direct_w, pdf_emit_w


def sample_dir(env: EnvMapData, u1, u2):
    """Importance-sample a direction toward the environment.

    Returns (dir, radiance, pdf_w).  The per-row inverse cdf is one
    batched searchsorted over the gathered row cdfs."""
    h, w = env.pdf_table.shape
    row = torch.clamp(
        torch.searchsorted(env.marginal_cdf, u1.contiguous(), right=True) - 1,
        0, h - 1)
    # Stratified remap of the residual for the in-row coordinate.
    lo = env.marginal_cdf[row]
    hi = env.marginal_cdf[row + 1]
    v_res = torch.clamp((u1 - lo) / torch.clamp(hi - lo, min=1e-12),
                        0.0, 1.0 - 1e-7)

    cdf_rows = env.row_cdf[row]                            # (R, W+1)
    col = torch.clamp(
        torch.searchsorted(cdf_rows, u2[:, None].contiguous(),
                           right=True)[:, 0] - 1, 0, w - 1)
    c_lo = torch.gather(cdf_rows, 1, col[:, None])[:, 0]
    c_hi = torch.gather(cdf_rows, 1, col[:, None] + 1)[:, 0]
    u_res = torch.clamp((u2 - c_lo) / torch.clamp(c_hi - c_lo, min=1e-12),
                        0.0, 1.0 - 1e-7)

    s = (col.to(torch.float32) + u_res) / w
    t = (row.to(torch.float32) + v_res) / h

    theta = PI * t
    sin_t = torch.sin(theta)
    phi = 2.0 * PI * s
    d = torch.stack([sin_t * torch.sin(phi), torch.cos(theta),
                     sin_t * torch.cos(phi)], dim=-1)
    return d, _lookup(env, s, t), _st_pdf_w(env, s, t)
