"""Frozen copy of the program's `core/vecmath.py`, for the benchmark's plain
reference; its own description follows.

Batched 3-vector helpers over the trailing axis (torch twin of
imbatracer_tpu.core.vecmath)."""

from __future__ import annotations

import torch


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def normalize(a, eps=1e-20):
    return a * torch.rsqrt(torch.clamp(torch.sum(a * a, dim=-1, keepdim=True),
                                       min=eps))


def luminance(rgb):
    """Rec.709 luma weights, as the JAX package uses."""
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]


def where3(cond, a, b):
    """Select vectors by a (...,)-shaped boolean condition."""
    return torch.where(cond[..., None], a, b)
