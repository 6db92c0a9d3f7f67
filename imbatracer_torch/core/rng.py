"""Counter-based per-ray RNG, bitwise equal to imbatracer_tpu.core.rng.

The state is a 32-bit PCG word per ray, seeded by hashing (pixel, sample,
frame).  It is threaded through the renderer as data, so it *is* the
explicit generator: no torch.Generator is used on the render path.

PyTorch has no unsigned 32-bit `+` or `>>` on every backend, so states are
int64 tensors holding values in [0, 2**32) and every step masks back to 32
bits.  Products are split into 16-bit halves (`_mul32`) so no intermediate
leaves int64's range: the low 32 bits stay exact for any inputs, including
frame numbers up to 2**32 - 1.
"""

from __future__ import annotations

import torch

from ..utils import trace

_MASK = 0xFFFFFFFF


def _u32(x, device=None) -> torch.Tensor:
    """Any integer tensor / Python int -> int64 tensor of 32-bit words.
    A Python int's copy to the card waits for the queue to drain."""
    if not torch.is_tensor(x):
        with trace.span("wait:seed"):
            x = torch.tensor(x, dtype=torch.int64, device=device)
    return x.to(torch.int64) & _MASK


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for 32-bit words a and a constant c < 2**32."""
    lo = (a & 0xFFFF) * c
    hi = ((a >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _MASK


def hash_wang(x: torch.Tensor) -> torch.Tensor:
    """Wang-style integer hash; good avalanche for seed scrambling."""
    x = _u32(x)
    x = (x ^ 61) ^ (x >> 16)
    x = _mul32(x, 9)
    x = x ^ (x >> 4)
    x = _mul32(x, 0x27D4EB2D)
    x = x ^ (x >> 15)
    return x


def seed(pixel_id, sample_id, frame=0, device=None) -> torch.Tensor:
    """Per-ray RNG state from (pixel, sample, frame) ids."""
    if device is None:
        device = pixel_id.device if torch.is_tensor(pixel_id) else None
    pixel_id = _u32(pixel_id, device)
    sample_id = _u32(sample_id, device)
    frame = _u32(frame, device)
    s = hash_wang((pixel_id + _mul32((sample_id + 1) & _MASK, 0x9E3779B9))
                  & _MASK)
    s = hash_wang(s ^ ((_mul32(frame, 0x85EBCA6B) + 0xC2B2AE35) & _MASK))
    # Avoid the all-zeros fixed point of the LCG stream.
    return s | 1


def _pcg_step(state: torch.Tensor) -> torch.Tensor:
    return (_mul32(state, 747796405) + 2891336453) & _MASK


def _pcg_output(state: torch.Tensor) -> torch.Tensor:
    # PCG-RXS-M-XS output permutation on 32-bit state.
    word = _mul32((state >> ((state >> 28) + 4)) ^ state, 277803737)
    return (word >> 22) ^ word


def next_u32(state: torch.Tensor):
    """Advance and return (new_state, uniform 32-bit word)."""
    new_state = _pcg_step(state)
    return new_state, _pcg_output(new_state)


def next_float(state: torch.Tensor):
    """Advance and return (new_state, float32 in [0, 1))."""
    new_state, bits = next_u32(state)
    u = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return new_state, u


def next_floats(state: torch.Tensor, n: int):
    """Advance n times; returns (new_state, tuple of n float tensors)."""
    outs = []
    for _ in range(n):
        state, u = next_float(state)
        outs.append(u)
    return state, tuple(outs)
