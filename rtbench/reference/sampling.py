"""Frozen copy of the program's `core/sampling.py`, for the benchmark's plain
reference; its own description follows.

Monte-Carlo sampling primitives, fully batched (torch twin of
imbatracer_tpu.core.sampling).

Functions take uniform numbers of shape (...,) and return directions of
shape (..., 3) in the local frame (z = normal) unless noted, plus the
solid-angle pdf.  Branchless.
"""

from __future__ import annotations

import math

import torch

from .vecmath import luminance

PI = math.pi
INV_PI = 1.0 / math.pi


def local_coordinates(n):
    """Branchless ONB (Duff et al. 2017) from a unit normal -> (t, b)."""
    s = torch.where(n[..., 2] >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack(
        [1.0 + s * n[..., 0] * n[..., 0] * a, s * b, -s * n[..., 0]], dim=-1)
    bt = torch.stack([b, s + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return t, bt


def to_world(local_dir, n):
    """Local-frame (z = n) direction -> world space."""
    t, b = local_coordinates(n)
    return (local_dir[..., 0:1] * t + local_dir[..., 1:2] * b
            + local_dir[..., 2:3] * n)


def to_local(world_dir, n):
    """World direction -> local frame (z = n)."""
    t, b = local_coordinates(n)
    return torch.stack(
        [torch.sum(world_dir * t, dim=-1), torch.sum(world_dir * b, dim=-1),
         torch.sum(world_dir * n, dim=-1)], dim=-1)


def sample_cos_hemisphere(u1, u2):
    """Cosine-weighted hemisphere (local frame). pdf = cos(theta)/pi."""
    phi = 2.0 * PI * u1
    r = torch.sqrt(u2)
    z = torch.sqrt(torch.clamp(1.0 - u2, min=0.0))
    d = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
    return d, z * INV_PI


def cos_hemisphere_pdf(cos_theta):
    return torch.clamp(cos_theta, min=0.0) * INV_PI


def sample_power_cos_hemisphere(power, u1, u2):
    """Phong-lobe sampling: pdf = (n+1)/(2pi) * cos^n(theta)."""
    phi = 2.0 * PI * u1
    cos_t = torch.pow(u2, 1.0 / (power + 1.0))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    d = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t],
                    dim=-1)
    pdf = ((power + 1.0) / (2.0 * PI)
           * torch.pow(torch.clamp(cos_t, min=1e-20), power))
    return d, pdf


def sample_uniform_sphere(u1, u2):
    """Uniform direction on the full sphere. pdf = 1/(4pi)."""
    phi = 2.0 * PI * u1
    z = 1.0 - 2.0 * u2
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    d = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
    return d, torch.full_like(u1, 1.0 / (4.0 * PI))


def uniform_sphere_pdf():
    return 1.0 / (4.0 * PI)


def sample_uniform_triangle(u1, u2):
    """Barycentric (u, v) uniform over a triangle (sqrt warp)."""
    su = torch.sqrt(u1)
    return 1.0 - su, u2 * su


def sample_uniform_cone(cos_max, u1, u2):
    """Uniform direction in a cone around +z. pdf = 1/(2pi (1-cos_max))."""
    phi = 2.0 * PI * u1
    z = 1.0 - u2 * (1.0 - cos_max)
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    d = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
    pdf = 1.0 / (2.0 * PI * torch.clamp(1.0 - cos_max, min=1e-20))
    return d, torch.broadcast_to(pdf, u1.shape)


def uniform_cone_pdf(cos_max):
    return 1.0 / (2.0 * PI * torch.clamp(1.0 - cos_max, min=1e-20))


def sample_concentric_disc(u1, u2):
    """Shirley-Chiu concentric disc mapping, branchless."""
    ox = 2.0 * u1 - 1.0
    oy = 2.0 * u2 - 1.0
    zero = (ox == 0.0) & (oy == 0.0)
    use_x = torch.abs(ox) > torch.abs(oy)
    r = torch.where(use_x, ox, oy)
    theta = torch.where(
        use_x,
        (PI / 4.0) * (oy / torch.where(ox == 0.0, 1.0, ox)),
        (PI / 2.0) - (PI / 4.0) * (ox / torch.where(oy == 0.0, 1.0, oy)))
    x = torch.where(zero, 0.0, r * torch.cos(theta))
    y = torch.where(zero, 0.0, r * torch.sin(theta))
    return x, y


def concentric_disc_pdf():
    return INV_PI


def russian_roulette_prob(throughput):
    """Luminance-driven survival probability, clamped to [0, 1]."""
    return torch.clamp(2.0 * luminance(throughput), 0.0, 1.0)


def mis_power_heuristic(pdf_a, pdf_b):
    """Balance heuristic (power 1)."""
    return pdf_a / torch.clamp(pdf_a + pdf_b, min=1e-20)


__all__ = [
    "PI", "INV_PI", "local_coordinates", "to_world", "to_local",
    "sample_cos_hemisphere", "cos_hemisphere_pdf",
    "sample_power_cos_hemisphere", "sample_uniform_sphere",
    "uniform_sphere_pdf", "sample_uniform_triangle", "sample_uniform_cone",
    "uniform_cone_pdf", "sample_concentric_disc", "concentric_disc_pdf",
    "russian_roulette_prob", "mis_power_heuristic",
]
