"""Device-resident BVH for the streaming traversal kernels (torch twin of
imbatracer_tpu.accel.device.DeviceBvh in its "stream" and "stream2"
modes, the two the port has).

On Hopper every scene traverses through the hand-written kernels over
these tiles (ops/stream_traverse.py; ops/khit.py for alpha-masked flat
scenes; ops/pairs.py when the pairs switch is on), so the TPU's small-
scene modes ("dense", "densel", "vmem" routing, the XLA skip-link loop)
have no counterpart here.

  flat ("stream"): the packed leaf-order triangle arrays (kept for
      brute-force validation and tooling) and their tiles, one per
      super-chunk; ray origins are recentred by `center`.
  two-level ("stream2", accel/instancing.py): shared mesh-space tiles
      (T rows, T != S in general), world-space super-chunk boxes, and per
      super-chunk `tile_idx` / `inst_of` with the `(I, 16)` instance
      table `itab`; no packed triangles, `center` zero.

`bounds` is the (6,) [lo.xyz, hi.xyz] of the super-chunk boxes that the
sort keys quantise origins in (ops/dispatch.py), made when the BVH is:
not a field, so neither moved by `.to()` (which makes it anew) nor
stored in the BVH disk cache, and never made inside a captured graph.

`pairs` is the pairs switch: when True, unmasked sorted dispatches on
scenes of at least PAIRS_MIN_SUPERCHUNKS super-chunks take the pair-queue
route (render/traverse.py), as IMBA_USE_PAIRS=1 does in the JAX package.
Default off, as there.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..tensors import TensorData


@dataclass
class DeviceBvh(TensorData):
    sbox: torch.Tensor    # (S, 8) f32 super-chunk bboxes
    tiles: torch.Tensor   # (T, 24, 1024) f32 feature tiles (T == S if flat)
    center: torch.Tensor  # (3,) f32 recentring offset (zero if two-level)
    tri_v0: Optional[torch.Tensor] = None  # (P, 3) f32 packed leaf order
    tri_e1: Optional[torch.Tensor] = None  # (P, 3) f32
    tri_e2: Optional[torch.Tensor] = None  # (P, 3) f32
    tri_id: Optional[torch.Tensor] = None  # (P,) i32 flat id, -1 = padding
    tile_idx: Optional[torch.Tensor] = None  # (S,) i32 tile row
    inst_of: Optional[torch.Tensor] = None   # (S,) i32 instance
    itab: Optional[torch.Tensor] = None      # (I, 16) f32 instance table
    pairs: bool = False

    def __post_init__(self):
        from ..ops.dispatch import bounds_of

        self.bounds = (bounds_of(self.sbox) if self.sbox.shape[0] else
                       torch.zeros(6, dtype=torch.float32,
                                   device=self.sbox.device))

    @property
    def two_level(self) -> bool:
        return self.tile_idx is not None

    @property
    def mode(self) -> str:
        """The JAX package's name of this traversal mode."""
        return "stream2" if self.two_level else "stream"

    @property
    def inst(self):
        """(tile_idx, inst_of, itab) of a two-level BVH, else None: the
        `inst` argument of the traversal kernels."""
        if self.tile_idx is None:
            return None
        return (self.tile_idx, self.inst_of, self.itab)

    @staticmethod
    def from_packed(tri_v0, tri_e1, tri_e2, tri_id, device,
                    pairs: bool = False) -> "DeviceBvh":
        """Upload packed leaf-order triangles (NumPy) and their stream
        tiles."""
        from ..ops.stream_traverse import pack_stream_tiles

        sbox, tiles, center = pack_stream_tiles(tri_v0, tri_e1, tri_e2,
                                                tri_id)
        t = lambda a: torch.as_tensor(np.array(a), device=device)
        return DeviceBvh(tri_v0=t(tri_v0), tri_e1=t(tri_e1),
                         tri_e2=t(tri_e2), tri_id=t(tri_id), sbox=t(sbox),
                         tiles=t(tiles), center=t(center), pairs=pairs)

    @staticmethod
    def from_two_level(sbox, tiles, tile_idx, inst_of, itab, device,
                       pairs: bool = False) -> "DeviceBvh":
        """Upload accel/instancing.TwoLevelArrays' arrays (NumPy; tile_idx
        and inst_of in any shape holding S entries).  Raises on indices
        outside the tile set or the instance table: the kernels read
        through them unchecked."""
        tile_idx = np.asarray(tile_idx, np.int32).reshape(-1)
        inst_of = np.asarray(inst_of, np.int32).reshape(-1)
        num_s, num_t, num_i = sbox.shape[0], tiles.shape[0], itab.shape[0]
        if tile_idx.shape[0] != num_s or inst_of.shape[0] != num_s:
            raise ValueError("tile_idx / inst_of must hold one entry per "
                             "super-chunk")
        if num_s and not (0 <= tile_idx.min() and tile_idx.max() < num_t
                          and 0 <= inst_of.min() and inst_of.max() < num_i):
            raise ValueError("tile_idx / inst_of index past the tiles or "
                             "the instance table")
        t = lambda a: torch.as_tensor(np.array(a), device=device)
        return DeviceBvh(sbox=t(sbox), tiles=t(tiles),
                         center=torch.zeros(3, dtype=torch.float32,
                                            device=device),
                         tile_idx=t(tile_idx), inst_of=t(inst_of),
                         itab=t(np.asarray(itab, np.float32)), pairs=pairs)
