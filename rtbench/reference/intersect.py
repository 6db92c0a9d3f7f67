"""Frozen copy of the program's `render/intersect.py`, for the benchmark's plain
reference; its own description follows.

Ray-triangle intersection (torch twin of imbatracer_tpu.render.intersect;
the program's brute-force intersector beside it is left out here)."""

from __future__ import annotations

import torch

BIG = 1e30


def ray_triangle(org, d, v0, e1, e2, tmin, tmax):
    """Moller-Trumbore, broadcastable; returns (t, u, v, hit), t = BIG on
    a miss."""
    pvec = torch.linalg.cross(d, e2, dim=-1)
    det = torch.sum(e1 * pvec, dim=-1)
    inv_det = torch.where(torch.abs(det) < 1e-12, 0.0, 1.0 / det)
    tvec = org - v0
    u = torch.sum(tvec * pvec, dim=-1) * inv_det
    qvec = torch.linalg.cross(tvec, e1, dim=-1)
    v = torch.sum(d * qvec, dim=-1) * inv_det
    t = torch.sum(e2 * qvec, dim=-1) * inv_det
    hit = ((inv_det != 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > tmin) & (t < tmax))
    return torch.where(hit, t, BIG), u, v, hit


