"""Device-resident BVH for the streaming traversal kernel (torch twin of
imbatracer_tpu.accel.device.DeviceBvh in its "stream" mode, the only
mode the port has).

On Hopper every non-instanced scene traverses through the hand-written
kernels over these tiles (ops/stream_traverse.py, and ops/khit.py for
alpha-masked scenes), so the TPU's small-scene
modes ("dense", "densel", "vmem" routing, the XLA skip-link loop) have no
counterpart here.  The packed leaf-order triangle arrays stay for
brute-force validation and tooling.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..tensors import TensorData


@dataclass
class DeviceBvh(TensorData):
    tri_v0: torch.Tensor  # (P, 3) f32 packed leaf-order triangles
    tri_e1: torch.Tensor  # (P, 3) f32
    tri_e2: torch.Tensor  # (P, 3) f32
    tri_id: torch.Tensor  # (P,) i32 flat id, -1 = padding
    sbox: torch.Tensor    # (S, 8) f32 super-chunk bboxes (recentred)
    tiles: torch.Tensor   # (S, 24, 1024) f32 feature tiles
    center: torch.Tensor  # (3,) f32 recentring offset

    @staticmethod
    def from_packed(tri_v0, tri_e1, tri_e2, tri_id, device) -> "DeviceBvh":
        """Upload packed leaf-order triangles (NumPy) and their stream
        tiles."""
        from ..ops.stream_traverse import pack_stream_tiles

        sbox, tiles, center = pack_stream_tiles(tri_v0, tri_e1, tri_e2,
                                                tri_id)
        t = lambda a: torch.as_tensor(np.array(a), device=device)
        return DeviceBvh(tri_v0=t(tri_v0), tri_e1=t(tri_e1),
                         tri_e2=t(tri_e2), tri_id=t(tri_id), sbox=t(sbox),
                         tiles=t(tiles), center=t(center))
