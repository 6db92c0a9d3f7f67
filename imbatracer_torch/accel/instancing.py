"""Two-level instanced acceleration for the streaming traversal kernel:
the port's own copy of imbatracer_tpu.accel.instancing (host side,
NumPy).

The stream kernel's "top level" is its flat per-super-chunk candidate
list, so instancing is metadata on the super-chunks:

  * every mesh keeps ONE set of mesh-space triangle tiles (memory in
    proportion to unique geometry);
  * every instance contributes its mesh's super-chunks to the global
    candidate set, with boxes transformed to world space;
  * per super-chunk, the shared tile row to read and the instance id; a
    small (I, 16) table carries each instance's world->mesh affine and
    its flat primitive-id offset.

Each mesh is built with the NumPy `build_bvh` (as the JAX package builds
it), so the tiles are bit-identical to the JAX package's.  Shading stays
on flat world-space per-instance records (scene/build.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .builder import build_bvh, triangle_bboxes
from .flatten import thread_bvh

BIG = 1e30


@dataclass
class TwoLevelArrays:
    sbox: np.ndarray       # (S_total, 8) world-space super-chunk bboxes
    tiles: np.ndarray      # (T, 24, 1024) shared mesh-space tiles
    tile_idx: np.ndarray   # (1, 1, S_total) i32 tile row per super-chunk
    inst_of: np.ndarray    # (1, 1, S_total) i32 instance per super-chunk
    itab: np.ndarray       # (I, 16) f32 [world->mesh 3x4 row-major (12),
                           #              flat prim-id offset (1), pad (3)]
    stats: dict


def _affine_inverse(m4: np.ndarray) -> np.ndarray:
    """3x4 world->mesh affine from a mesh->world 4x4."""
    inv = np.linalg.inv(m4)
    return inv[:3, :4].astype(np.float32)


def _transform_bbox(m4: np.ndarray, lo: np.ndarray, hi: np.ndarray):
    """Axis-aligned world bounds of mesh-space boxes under m4.

    lo/hi: (S, 3).  Empty boxes (lo > hi, padding super-chunks) stay
    empty."""
    corners = np.stack([
        np.stack([np.where(b & (1 << a), hi[:, a], lo[:, a])
                  for a in range(3)], axis=-1)
        for b in range(8)
    ])                                                   # (8, S, 3)
    w = corners @ m4[:3, :3].T + m4[:3, 3]
    wlo = w.min(axis=0).astype(np.float32)
    whi = w.max(axis=0).astype(np.float32)
    empty = (lo > hi).any(axis=-1)
    wlo[empty] = BIG
    whi[empty] = -BIG
    return wlo, whi


def build_two_level(mesh_tris: list, instances: list) -> TwoLevelArrays:
    """mesh_tris: per mesh (v0, v1, v2) float32 arrays in MESH space.
    instances: list of dicts {mesh_idx, matrix (4x4 mesh->world),
    face_base (flat primitive-id offset of this instance)}."""
    from ..ops.stream_traverse import pack_stream_tiles

    mesh_stream = []
    for (v0, v1, v2) in mesh_tris:
        lo, hi = triangle_bboxes(v0, v1, v2)
        t = thread_bvh(build_bvh(lo, hi), v0, v1, v2)
        mesh_stream.append(pack_stream_tiles(t.tri_v0, t.tri_e1, t.tri_e2,
                                             t.tri_id))

    tiles = np.concatenate([ts for _, ts, _ in mesh_stream], axis=0)
    tile_base = np.cumsum([0] + [ts.shape[0] for _, ts, _ in mesh_stream])

    sbox_rows, tidx_rows, inst_rows, itab_rows = [], [], [], []
    for i, inst in enumerate(instances):
        mi = inst["mesh_idx"]
        m4 = np.asarray(inst["matrix"], np.float64).reshape(4, 4)
        sbox_m, _, c_m = mesh_stream[mi]
        # Mesh tiles and boxes are recentred around c_m
        # (pack_stream_tiles): un-centre for the world box, and fold the
        # centring into the world->mesh affine so the kernel's mesh-space
        # coordinates match the tiles.
        wlo, whi = _transform_bbox(m4, sbox_m[:, 0:3] + c_m,
                                   sbox_m[:, 3:6] + c_m)
        s_m = sbox_m.shape[0]
        row = np.zeros((s_m, 8), np.float32)
        row[:, 0:3] = wlo
        row[:, 3:6] = whi
        sbox_rows.append(row)
        tidx_rows.append(np.arange(s_m, dtype=np.int32) + tile_base[mi])
        inst_rows.append(np.full(s_m, i, np.int32))
        aff = _affine_inverse(m4)
        aff[:, 3] -= c_m
        r = np.zeros(16, np.float32)
        r[0:12] = aff.reshape(12)
        r[12] = float(inst["face_base"])
        itab_rows.append(r)

    sbox = np.concatenate(sbox_rows, axis=0)
    tile_idx = np.concatenate(tidx_rows)[None, None, :]
    inst_of = np.concatenate(inst_rows)[None, None, :]
    itab = np.stack(itab_rows, axis=0)
    stats = dict(
        superchunks=int(sbox.shape[0]),
        tiles=int(tiles.shape[0]),
        instances=len(instances),
        unique_tris=int(sum(v0.shape[0] for v0, _, _ in mesh_tris)),
    )
    return TwoLevelArrays(sbox=sbox, tiles=tiles, tile_idx=tile_idx,
                          inst_of=inst_of, itab=itab, stats=stats)
