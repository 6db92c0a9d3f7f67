"""Binned-SAH BVH construction in NumPy: the port's own copy of
imbatracer_tpu.accel.builder (`BvhNodes`, `triangle_bboxes`,
`build_bvh`).

Scene assembly builds with the native C++ builder (accel/native.py);
`build_bvh` is kept as an explicit NumPy builder for the tests and is
never taken as a fallback.  Output is an implicit binary tree in depth-
first order, which accel/flatten.py threads into leaf-order triangles.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

NUM_BINS = 32
TRAVERSAL_COST = 1.0
LEAF_SIZE = 4          # triangles per leaf packet; fixed for static shapes


@dataclass
class BvhNodes:
    """Binary BVH in depth-first order.

    left child of an inner node is `i + 1`; `right[i]` is the index of the
    right child.  Leaves have `right[i] == -1` and reference
    `prim_ids[start[i] : start[i] + count[i]]`.
    """

    bbox_min: np.ndarray   # (N, 3) f32
    bbox_max: np.ndarray   # (N, 3) f32
    right: np.ndarray      # (N,) i32, -1 for leaf
    start: np.ndarray      # (N,) i32 into prim_ids (leaves only)
    count: np.ndarray      # (N,) i32 (leaves only)
    prim_ids: np.ndarray   # (P,) i32 permutation of input primitives


def _surface_area(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    d = np.maximum(hi - lo, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0])


def build_bvh(
    bbox_lo: np.ndarray,
    bbox_hi: np.ndarray,
    centers: np.ndarray | None = None,
    leaf_size: int = LEAF_SIZE,
    traversal_cost: float = TRAVERSAL_COST,
) -> BvhNodes:
    """Build a binary SAH BVH over primitive bounding boxes.

    Binned SAH evaluated on all three axes per node (the reference's fast
    builder bins only the longest axis, fast_bvh_builder.h:63-66; binning
    all axes costs little in NumPy and improves quality).
    """
    n = bbox_lo.shape[0]
    assert n > 0, "empty BVH input"
    bbox_lo = np.asarray(bbox_lo, np.float32)
    bbox_hi = np.asarray(bbox_hi, np.float32)
    if centers is None:
        centers = 0.5 * (bbox_lo + bbox_hi)
    centers = np.asarray(centers, np.float32)

    prim_ids = np.arange(n, dtype=np.int32)

    # Conservative capacity: full binary tree over ceil(n/1) leaves.
    cap = max(2 * n, 16)
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    node_right = np.full(cap, -1, np.int32)
    node_start = np.zeros(cap, np.int32)
    node_count = np.zeros(cap, np.int32)
    n_nodes = 0

    # Explicit DFS stack of (range_start, range_end, parent_slot_for_right).
    # Emitting in DFS order makes left-child == current+1 by construction.
    stack = [(0, n, -1)]
    while stack:
        lo_i, hi_i, parent_right_slot = stack.pop()
        ids = prim_ids[lo_i:hi_i]
        cnt = hi_i - lo_i
        node = n_nodes
        n_nodes += 1
        if parent_right_slot >= 0:
            node_right[parent_right_slot] = node

        b_lo = bbox_lo[ids].min(axis=0)
        b_hi = bbox_hi[ids].max(axis=0)
        node_min[node] = b_lo
        node_max[node] = b_hi

        make_leaf = cnt <= leaf_size
        best = None
        if not make_leaf:
            c = centers[ids]
            c_lo = c.min(axis=0)
            c_hi = c.max(axis=0)
            ext = c_hi - c_lo
            best_cost = np.inf
            for axis in range(3):
                if ext[axis] <= 1e-12:
                    continue
                scale = NUM_BINS * (1.0 - 1e-6) / ext[axis]
                bin_idx = ((c[:, axis] - c_lo[axis]) * scale).astype(np.int32)
                bin_idx = np.clip(bin_idx, 0, NUM_BINS - 1)
                counts = np.bincount(bin_idx, minlength=NUM_BINS)
                # Per-bin bbox via reduceat on sorted order.
                order = np.argsort(bin_idx, kind="stable")
                sl = bbox_lo[ids][order]
                sh = bbox_hi[ids][order]
                starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
                occupied = counts > 0
                occ_starts = starts[occupied]
                blo = np.minimum.reduceat(sl, occ_starts, axis=0)
                bhi = np.maximum.reduceat(sh, occ_starts, axis=0)
                bins_lo = np.full((NUM_BINS, 3), np.inf, np.float32)
                bins_hi = np.full((NUM_BINS, 3), -np.inf, np.float32)
                bins_lo[occupied] = blo
                bins_hi[occupied] = bhi
                # Sweep: left-to-right and right-to-left accumulated areas.
                acc_lo = np.minimum.accumulate(bins_lo, axis=0)
                acc_hi = np.maximum.accumulate(bins_hi, axis=0)
                racc_lo = np.minimum.accumulate(bins_lo[::-1], axis=0)[::-1]
                racc_hi = np.maximum.accumulate(bins_hi[::-1], axis=0)[::-1]
                n_left = np.cumsum(counts)[:-1]
                n_right = cnt - n_left
                area_l = _surface_area(acc_lo[:-1], acc_hi[:-1])
                area_r = _surface_area(racc_lo[1:], racc_hi[1:])
                cost = area_l * n_left + area_r * n_right
                valid = (n_left > 0) & (n_right > 0)
                cost = np.where(valid, cost, np.inf)
                k = int(np.argmin(cost))
                if cost[k] < best_cost:
                    best_cost = cost[k]
                    best = (axis, c_lo[axis], scale, k)
            # SAH termination: compare split cost against leaf cost.
            parent_area = max(_surface_area(b_lo[None], b_hi[None])[0], 1e-20)
            if best is None or (
                cnt <= 2 * leaf_size
                and best_cost / parent_area + traversal_cost >= float(cnt)
            ):
                if best is None:
                    make_leaf = True

        if make_leaf:
            node_start[node] = lo_i
            node_count[node] = cnt
            continue

        axis, origin, scale, k = best
        c_ax = centers[ids][:, axis]
        bin_idx = np.clip(((c_ax - origin) * scale).astype(np.int32), 0, NUM_BINS - 1)
        go_left = bin_idx <= k
        n_left = int(go_left.sum())
        if n_left == 0 or n_left == cnt:  # degenerate; median split fallback
            order = np.argsort(c_ax, kind="stable")
            prim_ids[lo_i:hi_i] = ids[order]
            n_left = cnt // 2
        else:
            prim_ids[lo_i:hi_i] = np.concatenate([ids[go_left], ids[~go_left]])
        mid = lo_i + n_left
        # Push right first so the left child is emitted next (DFS order).
        stack.append((mid, hi_i, node))
        stack.append((lo_i, mid, -2))  # -2: left child, implicit position
        # Fix: the left child's slot needs no patching; mark inner node.
        node_right[node] = -3  # placeholder, patched when right child pops

    return BvhNodes(
        bbox_min=node_min[:n_nodes].copy(),
        bbox_max=node_max[:n_nodes].copy(),
        right=node_right[:n_nodes].copy(),
        start=node_start[:n_nodes].copy(),
        count=node_count[:n_nodes].copy(),
        prim_ids=prim_ids,
    )


def triangle_bboxes(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray):
    lo = np.minimum(np.minimum(v0, v1), v2)
    hi = np.maximum(np.maximum(v0, v1), v2)
    return lo, hi


def validate_bvh(nodes: BvhNodes, bbox_lo: np.ndarray,
                 bbox_hi: np.ndarray) -> None:
    """Structural check of a depth-first BVH over primitive boxes: every
    primitive in exactly one leaf and inside its leaf's box, each inner
    node's right child after it, both children's boxes inside their
    parent's (within 1e-4).  Raises ValueError on the first breach."""
    n_nodes = nodes.right.shape[0]
    seen = np.zeros(bbox_lo.shape[0], np.int32)
    for i in range(n_nodes):
        lo, hi = nodes.bbox_min[i] - 1e-4, nodes.bbox_max[i] + 1e-4
        if nodes.right[i] == -1:
            ids = nodes.prim_ids[nodes.start[i]:nodes.start[i]
                                 + nodes.count[i]]
            np.add.at(seen, ids, 1)
            if not (np.all(bbox_lo[ids] >= lo) and np.all(bbox_hi[ids] <= hi)):
                raise ValueError(f"leaf {i}: a primitive lies outside its "
                                 f"box")
            continue
        right = int(nodes.right[i])
        if not i + 1 < right < n_nodes:
            raise ValueError(f"node {i}: right child {right} is not after "
                             f"its left child {i + 1}")
        for child in (i + 1, right):
            if not (np.all(nodes.bbox_min[child] >= lo)
                    and np.all(nodes.bbox_max[child] <= hi)):
                raise ValueError(f"node {i}: child {child}'s box is not "
                                 f"inside its parent's")
    if not np.all(seen == 1):
        bad = int(np.count_nonzero(seen != 1))
        raise ValueError(f"{bad} primitives are not in exactly one leaf")
