"""Whether the timed window's films are right, against the plain
reference.

The window renders frames through the user's loop; a sample of them,
drawn from the seed as the window runs (reservoir sampling, so that any
frame of the window may be drawn whatever their number), keeps three
things: the frame's film as the program returned it, and the renderer's
accumulated film before and after it.  Once the window has closed and
the program's state is freed, the reference renders the same frame at a
sample of whole pixel rows drawn from the seed, and three numbers are
compared with their limits:

  mismatch_pct   share of the sampled pixels at which any channel of
                 the program's film differs from the reference's by
                 more than 1e-3 * max(1, |reference|);
  mean_gap_pct   |sum of the program's radiance - sum of the
                 reference's| over the sampled pixels, in % of the
                 reference's sum;
  accum_gap      the largest |after - (before + film)| / max(1, |after|)
                 over every pixel of a sampled frame: what the
                 accumulation added against the frame it was given.

A pixel's path depends only on its own random stream, so the program
and the reference trace the same paths but where rounding flips a
decision; a frame rendered wrong, dropped or half-rendered moves the
first two, a frame not accumulated the third.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field

import torch

PIXEL_RTOL = 1e-3


@dataclass
class Sample:
    index: int                 # the frame's place in the window
    frame: int                 # its frame number
    film: torch.Tensor         # (H*W, 3) as the program returned it
    before: torch.Tensor       # the accumulation before it
    after: torch.Tensor = None


@dataclass
class Sampler:
    """Reservoir sampling of `k` frames of the window, from `seed`."""

    k: int
    seed: int
    kept: list = field(default_factory=list)
    seen: int = 0
    pending: Sample = None

    def __post_init__(self):
        self.rng = random.Random(self.seed * 2654435761 % (1 << 61) + 17)

    def offer(self, index: int, frame: int, film, accum):
        self.seen += 1
        slot = None
        if len(self.kept) < self.k:
            self.kept.append(None)
            slot = len(self.kept) - 1
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                slot = j
        if slot is not None:
            self.pending = Sample(index, frame, film.clone(), accum)
            self.kept[slot] = self.pending

    def stepped(self, accum):
        if self.pending is not None:
            self.pending.after = accum
            self.pending = None


def sample_rows(height: int, rows: int, seed: int) -> list:
    rng = random.Random(seed * 11400714819323198485 % (1 << 63) + 29)
    return sorted(rng.sample(range(height), min(rows, height)))


def pixel_ids(rows, width: int, device):
    r = torch.as_tensor(rows, dtype=torch.int64, device=device)
    return (r[:, None] * width + torch.arange(width, device=device)).reshape(-1)


def accum_gap(s: Sample) -> float:
    after = s.after.float()
    want = s.before.float() + s.film.float()
    return float(((after - want).abs()
                  / torch.clamp(after.abs(), min=1.0)).max())


def compare(prog, ref) -> dict:
    """Mismatch share and mean gap of program rows against reference
    rows, both (P, 3)."""
    prog = prog.double()
    ref = ref.double()
    bad = ((prog - ref).abs() > PIXEL_RTOL * torch.clamp(ref.abs(), min=1.0)
           ).any(-1)
    rsum = float(ref.sum())
    return dict(pixels=int(ref.shape[0]), bad=int(bad.sum()),
                prog_sum=float(prog.sum()), ref_sum=rsum)


def judge(parts: list, gaps: list, limits: dict) -> dict:
    """The compared numbers, each with its limit, from the per-frame
    comparisons `parts` and accumulation gaps `gaps`."""
    pixels = sum(p["pixels"] for p in parts)
    bad = sum(p["bad"] for p in parts)
    psum = sum(p["prog_sum"] for p in parts)
    rsum = sum(p["ref_sum"] for p in parts)
    got = dict(
        mismatch_pct=100.0 * bad / max(pixels, 1),
        mean_gap_pct=100.0 * abs(psum - rsum) / max(abs(rsum), 1e-30),
        accum_gap=max(gaps) if gaps else float("inf"))
    return {k: dict(value=v, limit=float(limits[k])) for k, v in got.items()}


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
