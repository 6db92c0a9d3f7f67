"""Split-BVH construction in NumPy: the port's own copy of
imbatracer_tpu.accel.sbvh (`build_sbvh`, `sah_cost`).

The reference's quality builder `SplitBvhBuilder` (reference:
core/sbvh_builder.h:26-165; spatial binning at :294-375), for static
scenes where long thin diagonal triangles make pure object partitioning
produce heavily overlapping children.  Spatial splits chop such
*references* at bin planes and place one clipped reference in each
child, shrinking overlap at the cost of duplicated leaf entries.  The
port's traversal kernels are exact on such a multiset: a closest or
any hit ties with itself, and khit keeps each triangle once
(ops/khit.py).

Scene assembly builds with the native copy of the same algorithm
(accel/native.build_sbvh_native, csrc/bvh_builder.cpp); this NumPy
version is the plain one the tests hold it against, and `sah_cost` the
builder-quality metric.

Algorithm (Stich et al., HPG 2009, as in the reference):
  1. per node, evaluate the binned object split on all three axes;
  2. if the object split's children overlap by more than ALPHA of the
     root surface area, also evaluate spatial splits with chopped
     per-bin bounds and entry/exit counts;
  3. take the cheaper split; spatial splits duplicate straddling
     references into both children (bounded by a global reference
     budget, reference sbvh_builder.h:52 `spatial_threshold`).
  Reference unsplitting (sbvh_builder.h:377-466) is not implemented —
  the budget cap bounds duplication instead.

Chopped bounds use the exact-candidate identity instead of the
reference's iterative polygon clipping: the vertices of a triangle
clipped to a slab are exactly the original vertices inside the slab plus
the edge/plane intersection points, so per-bin bounds reduce to
vectorised scatter-min/max over those candidate points for all
references and planes at once.  Bounds of multiply-chopped references
are additionally intersected with the parent reference box (slightly
conservative, never wrong).

Output is the DFS `BvhNodes` contract of builder.build_bvh, except that
`prim_ids` may contain duplicates (a multiset of references).
"""

from __future__ import annotations

import numpy as np

from .builder import BvhNodes, _surface_area

NUM_BINS = 32
LEAF_SIZE = 4
ALPHA = 1e-5          # overlap/root-area threshold enabling spatial tests
REF_BUDGET = 1.5      # max references as a multiple of the input count
_EDGES = np.array([[0, 1], [1, 2], [2, 0]])


def _chop_bounds(verts, x_lo, x_hi, axis):
    """Bounds of each triangle clipped to the slab [x_lo, x_hi] on axis.

    verts: (S, 3, 3); x_lo/x_hi: (S,).  Exact for a single chop: the
    clipped polygon's vertices are the triangle vertices inside the slab
    plus the edge intersections with the two planes."""
    s = verts.shape[0]
    vx = verts[:, :, axis]                                  # (S, 3)
    lo = np.full((s, 3), np.inf, np.float32)
    hi = np.full((s, 3), -np.inf, np.float32)

    inside = (vx >= x_lo[:, None]) & (vx <= x_hi[:, None])  # (S, 3)
    vin = np.where(inside[:, :, None], verts, np.inf)
    lo = np.minimum(lo, vin.min(axis=1))
    vin = np.where(inside[:, :, None], verts, -np.inf)
    hi = np.maximum(hi, vin.max(axis=1))

    a = verts[:, _EDGES[:, 0], :]                           # (S, 3, 3)
    b = verts[:, _EDGES[:, 1], :]
    ax_ = a[:, :, axis]
    bx_ = b[:, :, axis]
    den = bx_ - ax_
    for plane in (x_lo, x_hi):
        t = (plane[:, None] - ax_) / np.where(np.abs(den) < 1e-30, 1e-30, den)
        ok = (t >= 0.0) & (t <= 1.0) & (np.abs(den) >= 1e-30)
        p = a + t[:, :, None] * (b - a)                     # (S, 3, 3)
        pin = np.where(ok[:, :, None], p, np.inf)
        lo = np.minimum(lo, pin.min(axis=1))
        pin = np.where(ok[:, :, None], p, -np.inf)
        hi = np.maximum(hi, pin.max(axis=1))
    # clamp the split axis to the slab exactly
    lo[:, axis] = np.maximum(lo[:, axis], x_lo)
    hi[:, axis] = np.minimum(hi[:, axis], x_hi)
    return lo, hi


def _spatial_bins(verts, rlo, rhi, b0, b1, axis, lo_a, width):
    """Chopped per-bin bounds for one axis, vectorised over references
    and planes.  Returns (bins_lo, bins_hi) of shape (NUM_BINS, 3)."""
    s = verts.shape[0]
    bins_lo = np.full((NUM_BINS, 3), np.inf, np.float32)
    bins_hi = np.full((NUM_BINS, 3), -np.inf, np.float32)

    # Vertices scatter into the bin that contains them (clamped into the
    # reference's own bin range — the ref may be chopped already).
    vx = verts[:, :, axis]
    vbin = np.clip(((vx - lo_a) / width).astype(np.int32), 0, NUM_BINS - 1)
    vbin = np.clip(vbin, b0[:, None], b1[:, None])
    flat_bin = vbin.reshape(-1)
    flat_v = verts.reshape(-1, 3)
    # Only vertices inside the reference slab participate exactly;
    # clamping vbin keeps stray ones harmless (their coords are still
    # inside the triangle, the union over the ref is clamped later).
    for c in range(3):
        np.minimum.at(bins_lo[:, c], flat_bin, flat_v[:, c])
        np.maximum.at(bins_hi[:, c], flat_bin, flat_v[:, c])

    # Edge/plane intersections: planes j = 1..NUM_BINS-1 at
    # x = lo_a + j*width contribute to bins j-1 and j.
    a = verts[:, _EDGES[:, 0], :]
    b = verts[:, _EDGES[:, 1], :]
    ax_ = a[:, :, axis]
    bx_ = b[:, :, axis]
    den = (bx_ - ax_)[:, :, None]                           # (S, 3, 1)
    planes = (lo_a + width * np.arange(1, NUM_BINS)).astype(np.float32)
    t = (planes[None, None, :] - ax_[:, :, None]) / np.where(
        np.abs(den) < 1e-30, 1e-30, den
    )                                                       # (S, 3, P)
    jidx = np.arange(1, NUM_BINS)[None, None, :]
    ok = (
        (t >= 0.0) & (t <= 1.0) & (np.abs(den) >= 1e-30)
        # only planes interior to this reference's bin range matter
        & (jidx > b0[:, None, None]) & (jidx <= b1[:, None, None])
    )
    p = a[:, :, None, :] + t[:, :, :, None] * (b - a)[:, :, None, :]
    okf = ok.reshape(-1)
    pf = p.reshape(-1, 3)[okf]
    jf = np.broadcast_to(jidx, ok.shape).reshape(-1)[okf]
    for tgt in (jf - 1, jf):
        for c in range(3):
            np.minimum.at(bins_lo[:, c], tgt, pf[:, c])
            np.maximum.at(bins_hi[:, c], tgt, pf[:, c])

    # Clamp each bin to its slab on the split axis and to the union of
    # reference boxes overall.
    edges = lo_a + width * np.arange(NUM_BINS + 1)
    bins_lo[:, axis] = np.maximum(bins_lo[:, axis], edges[:-1])
    bins_hi[:, axis] = np.minimum(bins_hi[:, axis], edges[1:])
    all_lo = rlo.min(axis=0)
    all_hi = rhi.max(axis=0)
    bins_lo = np.maximum(bins_lo, all_lo[None, :])
    bins_hi = np.minimum(bins_hi, all_hi[None, :])
    empty = bins_lo[:, axis] > bins_hi[:, axis]
    bins_lo[empty] = np.inf
    bins_hi[empty] = -np.inf
    return bins_lo, bins_hi


def build_sbvh(
    bbox_lo: np.ndarray,
    bbox_hi: np.ndarray,
    tri_verts: np.ndarray,
    leaf_size: int = LEAF_SIZE,
    alpha: float = ALPHA,
    ref_budget: float = REF_BUDGET,
) -> BvhNodes:
    """Build a spatial-split BVH.

    tri_verts: (N, 3, 3) triangle vertices (needed for clipping).
    bbox_lo/hi: (N, 3) primitive bounds (= triangle bounds at the top).
    """
    n = bbox_lo.shape[0]
    assert n > 0
    bbox_lo = np.asarray(bbox_lo, np.float32)
    bbox_hi = np.asarray(bbox_hi, np.float32)
    tri_verts = np.asarray(tri_verts, np.float32)

    root_area = max(
        float(_surface_area(bbox_lo.min(0)[None], bbox_hi.max(0)[None])[0]),
        1e-20,
    )
    max_extra = int(n * (ref_budget - 1.0)) + 16
    ref_extra = 0

    out_min, out_max, out_right = [], [], []
    out_start, out_count = [], []
    out_prims: list[np.ndarray] = []
    out_len = 0

    stack = [(np.arange(n, dtype=np.int32), bbox_lo, bbox_hi, -1)]

    while stack:
        tri, rlo, rhi, parent_slot = stack.pop()
        cnt = tri.shape[0]
        node = len(out_right)
        if parent_slot >= 0:
            out_right[parent_slot] = node
        b_lo = rlo.min(axis=0)
        b_hi = rhi.max(axis=0)
        out_min.append(b_lo)
        out_max.append(b_hi)
        out_right.append(-1)
        out_start.append(0)
        out_count.append(0)

        if cnt <= leaf_size:
            out_start[node] = out_len
            out_count[node] = cnt
            out_prims.append(tri)
            out_len += cnt
            continue

        # ---- object split (binned SAH, all axes, over reference bounds)
        centers = 0.5 * (rlo + rhi)
        c_lo = centers.min(axis=0)
        c_hi = centers.max(axis=0)
        best_obj = None
        best_obj_cost = np.inf
        best_overlap = np.inf
        for axis in range(3):
            ext = c_hi[axis] - c_lo[axis]
            if ext <= 1e-12:
                continue
            scale = NUM_BINS * (1.0 - 1e-6) / ext
            bi = np.clip(((centers[:, axis] - c_lo[axis]) * scale)
                         .astype(np.int32), 0, NUM_BINS - 1)
            counts = np.bincount(bi, minlength=NUM_BINS)
            order = np.argsort(bi, kind="stable")
            sl, sh = rlo[order], rhi[order]
            starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
            occ = counts > 0
            bins_lo = np.full((NUM_BINS, 3), np.inf, np.float32)
            bins_hi = np.full((NUM_BINS, 3), -np.inf, np.float32)
            bins_lo[occ] = np.minimum.reduceat(sl, starts[occ], axis=0)
            bins_hi[occ] = np.maximum.reduceat(sh, starts[occ], axis=0)
            acc_lo = np.minimum.accumulate(bins_lo, axis=0)
            acc_hi = np.maximum.accumulate(bins_hi, axis=0)
            racc_lo = np.minimum.accumulate(bins_lo[::-1], axis=0)[::-1]
            racc_hi = np.maximum.accumulate(bins_hi[::-1], axis=0)[::-1]
            n_left = np.cumsum(counts)[:-1]
            n_right = cnt - n_left
            area_l = _surface_area(acc_lo[:-1], acc_hi[:-1])
            area_r = _surface_area(racc_lo[1:], racc_hi[1:])
            cost = np.where((n_left > 0) & (n_right > 0),
                            area_l * n_left + area_r * n_right, np.inf)
            k = int(np.argmin(cost))
            if cost[k] < best_obj_cost:
                ov_lo = np.maximum(acc_lo[k], racc_lo[k + 1])
                ov_hi = np.minimum(acc_hi[k], racc_hi[k + 1])
                best_obj_cost = cost[k]
                best_obj = (axis, c_lo[axis], scale, k)
                best_overlap = (
                    float(_surface_area(ov_lo[None], ov_hi[None])[0])
                    if np.all(ov_hi > ov_lo) else 0.0
                )

        # ---- spatial split (Stich criterion: only when children overlap)
        best_sp = None
        best_sp_cost = np.inf
        if (best_obj is not None and best_overlap / root_area > alpha
                and ref_extra < max_extra):
            for axis in range(3):
                lo_a, hi_a = float(b_lo[axis]), float(b_hi[axis])
                ext = hi_a - lo_a
                if ext <= 1e-9:
                    continue
                width = ext / NUM_BINS
                b0 = np.clip(((rlo[:, axis] - lo_a) / width)
                             .astype(np.int32), 0, NUM_BINS - 1)
                b1 = np.clip(((rhi[:, axis] - lo_a) / width)
                             .astype(np.int32), 0, NUM_BINS - 1)
                entry = np.bincount(b0, minlength=NUM_BINS)
                exit_ = np.bincount(b1, minlength=NUM_BINS)
                bins_lo, bins_hi = _spatial_bins(
                    tri_verts[tri], rlo, rhi, b0, b1, axis, lo_a, width
                )
                acc_lo = np.minimum.accumulate(bins_lo, axis=0)
                acc_hi = np.maximum.accumulate(bins_hi, axis=0)
                racc_lo = np.minimum.accumulate(bins_lo[::-1], axis=0)[::-1]
                racc_hi = np.maximum.accumulate(bins_hi[::-1], axis=0)[::-1]
                n_l = np.cumsum(entry)[:-1]
                n_r = cnt - np.cumsum(exit_)[:-1]
                area_l = _surface_area(acc_lo[:-1], acc_hi[:-1])
                area_r = _surface_area(racc_lo[1:], racc_hi[1:])
                cost = np.where((n_l > 0) & (n_r > 0),
                                area_l * n_l + area_r * n_r, np.inf)
                k = int(np.argmin(cost))
                if cost[k] < best_sp_cost:
                    best_sp_cost = cost[k]
                    best_sp = (axis, lo_a + width * (k + 1), k, width, lo_a)

        # ---- choose and partition
        if best_sp is not None and best_sp_cost < best_obj_cost:
            axis, plane, k, width, lo_a = best_sp
            b0 = np.clip(((rlo[:, axis] - lo_a) / width).astype(np.int32),
                         0, NUM_BINS - 1)
            b1 = np.clip(((rhi[:, axis] - lo_a) / width).astype(np.int32),
                         0, NUM_BINS - 1)
            go_l = b1 <= k
            go_r = b0 > k
            strad = ~(go_l | go_r)
            n_dup = int(strad.sum())
            n_l_tot = int(go_l.sum()) + n_dup
            n_r_tot = int(go_r.sum()) + n_dup
            # Termination: spatial splits with duplication consume the
            # global budget (at most max_extra such splits); without
            # duplication both children are strict subsets.
            if (ref_extra + n_dup <= max_extra
                    and n_l_tot > 0 and n_r_tot > 0
                    and (n_dup > 0 or (n_l_tot < cnt and n_r_tot < cnt))):
                ref_extra += n_dup
                si = np.where(strad)[0]
                v = tri_verts[tri[si]]
                llo, lhi = _chop_bounds(v, rlo[si, axis],
                                        np.full(n_dup, plane, np.float32),
                                        axis)
                rlo2, rhi2 = _chop_bounds(v,
                                          np.full(n_dup, plane, np.float32),
                                          rhi[si, axis], axis)
                llo = np.maximum(llo, rlo[si])
                lhi = np.minimum(lhi, rhi[si])
                rlo2 = np.maximum(rlo2, rlo[si])
                rhi2 = np.minimum(rhi2, rhi[si])
                tri_l = np.concatenate([tri[go_l], tri[si]])
                lo_l = np.concatenate([rlo[go_l], llo])
                hi_l = np.concatenate([rhi[go_l], lhi])
                tri_r = np.concatenate([tri[go_r], tri[si]])
                lo_r = np.concatenate([rlo[go_r], rlo2])
                hi_r = np.concatenate([rhi[go_r], rhi2])
                stack.append((tri_r, lo_r, hi_r, node))
                stack.append((tri_l, lo_l, hi_l, -2))
                out_right[node] = -3
                continue

        if best_obj is None:
            axis = int(np.argmax(b_hi - b_lo))
            order = np.argsort(centers[:, axis], kind="stable")
            mid = cnt // 2
            sel, ser = order[:mid], order[mid:]
        else:
            axis, origin, scale, k = best_obj
            bi = np.clip(((centers[:, axis] - origin) * scale)
                         .astype(np.int32), 0, NUM_BINS - 1)
            go_left = bi <= k
            if go_left.all() or not go_left.any():
                order = np.argsort(centers[:, axis], kind="stable")
                mid = cnt // 2
                sel, ser = order[:mid], order[mid:]
            else:
                sel = np.where(go_left)[0]
                ser = np.where(~go_left)[0]
        stack.append((tri[ser], rlo[ser], rhi[ser], node))
        stack.append((tri[sel], rlo[sel], rhi[sel], -2))
        out_right[node] = -3

    prim_ids = (np.concatenate(out_prims) if out_prims
                else np.zeros(0, np.int32)).astype(np.int32)
    return BvhNodes(
        bbox_min=np.asarray(out_min, np.float32),
        bbox_max=np.asarray(out_max, np.float32),
        right=np.asarray(out_right, np.int32),
        start=np.asarray(out_start, np.int32),
        count=np.asarray(out_count, np.int32),
        prim_ids=prim_ids,
    )


def sah_cost(nodes: BvhNodes) -> float:
    """Total SAH cost (sum over leaves of area * count + inner areas),
    normalised by the root area — the standard builder-quality metric."""
    area = _surface_area(nodes.bbox_min, nodes.bbox_max)
    leaf = nodes.right == -1
    c = float((area[leaf] * nodes.count[leaf]).sum() + area[~leaf].sum())
    return c / max(float(area[0]), 1e-20)
