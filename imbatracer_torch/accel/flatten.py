"""BVH leaf packing (NumPy): the port's own copy of the parts of
imbatracer_tpu.accel.flatten that the port uses.

`thread_bvh` walks a DFS-ordered binary BVH and packs each leaf's
triangles into a fixed 4-slot packet in leaf order (the JAX package's
`octants=False` path, without the skip-link node records, which only its
XLA traversal loop reads).  `pack_chunks` cuts the packed triangles into
16-triangle chunks and 64-chunk super-chunks with their boxes, the input
of the stream-tile packing (ops/stream_traverse.pack_stream_tiles).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .builder import BvhNodes

LEAF_WIDTH = 4
CHUNK = 16
SUPER = 64


@dataclass
class PackedTriangles:
    """Leaf-order triangles in Moller-Trumbore form (v0, e1, e2) with the
    original primitive id; padding slots have id -1, v0 = 1e30 and zero
    edges, and never intersect."""

    tri_v0: np.ndarray        # (P, 3) f32
    tri_e1: np.ndarray        # (P, 3) f32
    tri_e2: np.ndarray        # (P, 3) f32
    tri_id: np.ndarray        # (P,) i32, -1 = padding
    stats: dict = field(default_factory=dict)


def thread_bvh(nodes: BvhNodes, v0: np.ndarray, v1: np.ndarray,
               v2: np.ndarray) -> PackedTriangles:
    """Pack leaf triangle packets in DFS leaf order.

    v0/v1/v2: (T, 3) world-space triangle vertices indexed by
    `nodes.prim_ids` entries."""
    n = nodes.right.shape[0]
    is_leaf = nodes.right == -1
    num_leaves = int(is_leaf.sum())
    packets = np.full((num_leaves * LEAF_WIDTH,), -1, np.int64)

    # DFS walk; left child = i + 1 by construction.
    leaf_cursor = 0
    stack = [0]
    while stack:
        i = stack.pop()
        if is_leaf[i]:
            cnt = int(nodes.count[i])
            if not 0 < cnt <= LEAF_WIDTH:
                raise ValueError(f"leaf {i} has {cnt} prims")
            base = leaf_cursor * LEAF_WIDTH
            ids = nodes.prim_ids[nodes.start[i]: nodes.start[i] + cnt]
            packets[base: base + cnt] = ids
            leaf_cursor += 1
        else:
            stack.append(int(nodes.right[i]))
            stack.append(i + 1)

    # Padding slots get a degenerate triangle far away.
    pad = packets < 0
    safe = np.where(pad, 0, packets)
    pv0 = v0[safe].astype(np.float32)
    pv1 = v1[safe].astype(np.float32)
    pv2 = v2[safe].astype(np.float32)
    pv0[pad] = 1e30
    pv1[pad] = 1e30
    pv2[pad] = 1e30
    return PackedTriangles(
        tri_v0=pv0, tri_e1=pv1 - pv0, tri_e2=pv2 - pv0,
        tri_id=packets.astype(np.int32),
        stats={"nodes": n, "leaves": num_leaves,
               "max_depth": _max_depth(nodes)})


def pack_chunks(tri_v0, tri_e1, tri_e2, tri_id):
    """Chunked arrays: triangles stay in BVH-leaf (DFS) order, so chunks
    are spatially coherent; each 16-tri chunk gets a bbox, every 64
    chunks get a super-chunk bbox.  Returns (sbox, cbox, tris12)."""
    num_t = tri_v0.shape[0]
    pad = (-num_t) % (CHUNK * SUPER)
    v0 = np.concatenate([tri_v0, np.full((pad, 3), 1e30, np.float32)]) if pad else tri_v0
    e1 = np.concatenate([tri_e1, np.zeros((pad, 3), np.float32)]) if pad else tri_e1
    e2 = np.concatenate([tri_e2, np.zeros((pad, 3), np.float32)]) if pad else tri_e2
    tid = (np.concatenate([tri_id, np.full(pad, -1, np.int32)]) if pad else tri_id)
    total = v0.shape[0]
    tris12 = np.zeros((total, 12), np.float32)
    tris12[:, 0:3] = v0
    tris12[:, 3:6] = e1
    tris12[:, 6:9] = e2
    tris12[:, 9] = tid.astype(np.float32)

    num_c = total // CHUNK
    va, vb, vc = v0, v0 + e1, v0 + e2
    lo = np.minimum(np.minimum(va, vb), vc).reshape(num_c, CHUNK, 3)
    hi = np.maximum(np.maximum(va, vb), vc).reshape(num_c, CHUNK, 3)
    valid = (tid >= 0).reshape(num_c, CHUNK, 1)
    lo = np.where(valid, lo, 1e30).min(axis=1)
    hi = np.where(valid, hi, -1e30).max(axis=1)
    cbox = np.zeros((num_c, 8), np.float32)
    cbox[:, 0:3] = lo
    cbox[:, 3:6] = hi

    num_s = num_c // SUPER
    slo = lo.reshape(num_s, SUPER, 3).min(axis=1)
    shi = hi.reshape(num_s, SUPER, 3).max(axis=1)
    sbox = np.zeros((num_s, 8), np.float32)
    sbox[:, 0:3] = slo
    sbox[:, 3:6] = shi
    return sbox, cbox, tris12


def _max_depth(nodes: BvhNodes) -> int:
    depth = 0
    stack = [(0, 1)]
    while stack:
        i, d = stack.pop()
        depth = max(depth, d)
        if nodes.right[i] != -1:
            stack.append((i + 1, d + 1))
            stack.append((int(nodes.right[i]), d + 1))
    return depth
