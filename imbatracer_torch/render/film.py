"""Film accumulation and tone mapping (torch twin of
imbatracer_tpu.render.film)."""

from __future__ import annotations

import torch

from ..ops import light_tail


def splat(contrib: torch.Tensor, pixel_id: torch.Tensor,
          num_pixels: int) -> torch.Tensor:
    """Scatter-add (R, 3) contributions into a fresh (num_pixels, 3) film;
    pixel_id < 0 is dropped (ops/light_tail.py: on the card its kernel,
    on the CPU its plain version, which routes them to a trash row)."""
    return light_tail.splat(contrib, pixel_id, num_pixels)


def tonemap(film: torch.Tensor, weight: float,
            gamma: float = 1.0 / 2.2) -> torch.Tensor:
    """`pow(v * weight, gamma)` clamped to [0, 1]."""
    v = torch.pow(torch.clamp(film * weight, min=0.0), gamma)
    return torch.clamp(v, 0.0, 1.0)
