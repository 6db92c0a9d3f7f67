"""Pair-queue traversal: closest hit / any hit over a sorted queue of
(ray, super-chunk) pairs -- the hand-written CUDA kernel
(`csrc/pairs_kernel.cu`), its plain PyTorch version, and the torch side
around them.

Replaces the TPU kernel
  imbatracer_tpu/ops/pallas_pairs.py::_make_span_kernel(occl, instanced)
in its four variants, behind the same pipeline as that module's
`closest_hit_pairs` / `any_hit_pairs`:

  1. `ray_candidates`: each ray's k = min(K_MAX, S) nearest super-chunks,
     front to back (stable on ties, so the lowest index first), with its
     true candidate count and `mindrop`, the entry t of the nearest one
     dropped.  Rays go in chunks of RAY_CHUNK so the (rays, S) entry
     matrix stays bounded.
  2. `build_queue`: one stable sort of the P = R * k pairs by
     super-chunk, the ray rows as payload; lanes past a ray's count get
     sc = -1 and tmax = -1.
  3. The kernel (`pairs_cuda`, or `pairs_plain` for CPU tensors): one
     lane per pair, the closest hit (or occlusion) of the lane's ray in
     its one super-chunk.
  4. Resolve: each ray's minimum-t lane of its k (the nearer candidate on
     a tie), or the OR of its k flags.
  5. Saturation fallback, when S > K_MAX: a ray with more than k
     candidates whose hit lies beyond `mindrop` (or that missed; for any
     hit, that is not yet occluded) is re-traced through the stream
     kernel (ops/stream_traverse), only those rays.  This is what makes
     the route exact.
The whole route runs behind the stream dispatch's Morton / octant sort
(`stream_traverse.sorted_call`), as the JAX package's runs behind its
`_sorted_dispatch`.

Not ported: the Pallas kernel's per-block [first, last] span walk, its
`lane_sc == ti` lane masking and its tile-DMA cache (Mosaic cannot index
per lane; a CUDA thread indexes its own tile), and the JAX module's A/B
knobs `PASSES = 2`, `SEL = "first" / "topk"` and `IMBA_SORT_KEY=chunk`.
"""

from __future__ import annotations

import ctypes

import torch

from ..libbuild import NativeLib
from . import stream_traverse as st

K_MAX = 8
RAY_CHUNK = 1 << 15
GROUP = 64           # super-chunk boxes slab-tested at once per ray chunk

# Launch counts, as ops/stream_traverse.LAUNCHES: one per kernel launch
# on the CUDA route, one per call of the plain version on the CPU route.
LAUNCHES = {"closest_hit": 0, "any_hit": 0, "closest_hit_instanced": 0,
            "any_hit_instanced": 0, "plain": 0}
# Saturation fallback: stream dispatches it made, and the rays it
# re-traced.
FALLBACK = {"dispatches": 0, "rays": 0}


def reset_launches():
    for d in (LAUNCHES, FALLBACK):
        for k in d:
            d[k] = 0


# --------------------------------------------------------------------------
# Candidates and the queue (plain torch ops on either device)
# --------------------------------------------------------------------------

def ray_candidates(rays, sbox, k_max: int = K_MAX):
    """Top-k super-chunks per ray, front to back, k = min(k_max, S).

    rays: (R, 8) rows.  Returns (idx (R, k) i32, -1 past the ray's count;
    ent (R, k) f32 entry t, clamped at 0, BIG where invalid; count (R,)
    i32, every super-chunk the ray enters (may exceed k); mindrop (R,)
    f32, the smallest entry t of a candidate not kept, BIG when none was
    dropped: a closest hit at t <= mindrop is exact even for a saturated
    ray)."""
    num_r, num_s = rays.shape[0], sbox.shape[0]
    k = min(k_max, num_s)
    outs = []
    for r0 in range(0, num_r, RAY_CHUNK):
        r = rays[r0:r0 + RAY_CHUNK]
        o, inv = r[:, None, 0:3], st._safe_inv(r[:, None, 4:7])
        tmin, tmax = r[:, 3, None], r[:, 7, None]
        cols = []
        for g in range(0, num_s, GROUP):
            tn, tf = st._slab(sbox[None, g:g + GROUP, 0:3],
                              sbox[None, g:g + GROUP, 3:6], o, inv)
            m = (tn <= tf) & (tf >= tmin) & (tn <= tmax)
            cols.append(torch.where(m, torch.clamp(tn, min=0.0), st.BIG))
        ent_all = torch.cat(cols, dim=1)                      # (Rc, S)
        count = (ent_all < st.BIG).sum(dim=1).to(torch.int32)
        srt, order = torch.sort(ent_all, dim=1, stable=True)
        valid = srt[:, :k] < st.BIG
        idx = torch.where(valid, order[:, :k].to(torch.int32), -1)
        ent = torch.where(valid, srt[:, :k], st.BIG)
        mindrop = (srt[:, k] if num_s > k else
                   torch.full_like(count, st.BIG, dtype=torch.float32))
        outs.append((idx, ent, count, mindrop))
    return tuple(torch.cat(x) for x in zip(*outs))


def build_queue(idx, rays, num_s: int):
    """One stable sort of the (ray, candidate) pairs by super-chunk.

    idx: (R, k) candidates (-1 invalid); rays: (R, 8).  Returns (rows
    (P, 8) the pairs' ray rows, tmax = -1 on invalid lanes; sc (P,) i32
    lane super-chunk, -1 invalid; order (P,) the pair index p = ray * k +
    j of each queue lane)."""
    k = idx.shape[1]
    sc = torch.where(idx >= 0, idx.long(), num_s).reshape(-1)
    sc_s, order = torch.sort(sc, stable=True)
    valid = sc_s < num_s
    rows = rays[order // k]
    rows[:, 7] = torch.where(valid, rows[:, 7], -1.0)
    return (rows.contiguous(), torch.where(valid, sc_s, -1).to(torch.int32),
            order)


# --------------------------------------------------------------------------
# The plain PyTorch version
# --------------------------------------------------------------------------

def pairs_plain(rows, sc, tiles, occl: bool, inst=None):
    """Plain PyTorch version of the kernel: for each lane, the closest hit
    (or occlusion) of its ray row in its one super-chunk, through the
    stream plain version's chunk walk and Moller-Trumbore test in the
    super-chunk's frame (stream_traverse._pair_triangles / walk_rows)."""
    LAUNCHES["plain"] += 1
    cbox = st.cbox_rows(tiles)

    def triangles(ray_idx):
        rr = ray_idx[sc[ray_idx] >= 0]
        yield from st._pair_triangles(rr, sc[rr].long(), rows, cbox, inst)

    return st.walk_rows(rows, tiles, inst, occl, triangles)


# --------------------------------------------------------------------------
# The CUDA kernel
# --------------------------------------------------------------------------

LIB = NativeLib("pairs_traverse", "pairs_kernel.cu",
                headers=("traverse_common.cuh",))

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(LIB.build())
        fn = lib.imba_pairs_traverse
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p] * 2
        _lib = lib
    return _lib


def check_inputs(rows, sc, tiles, inst=None):
    """Validate the (rows, sc, tiles[, inst]) the CUDA kernel reads."""
    num_p = rows.shape[0]
    st._check("rows", rows, torch.float32, (num_p, 8))
    st._check("sc", sc, torch.int32, (num_p,))
    st._check("tiles", tiles, torch.float32,
              (tiles.shape[0], st.TILE_ROWS, st.TRI_ROWS))
    named = [("rows", rows), ("sc", sc), ("tiles", tiles)]
    if inst is not None:
        tile_idx, inst_of, itab = inst
        st._check("tile_idx", tile_idx, torch.int32, (tile_idx.shape[0],))
        st._check("inst_of", inst_of, torch.int32, tile_idx.shape)
        st._check("itab", itab, torch.float32, (itab.shape[0], 16))
        named += [("tile_idx", tile_idx), ("inst_of", inst_of),
                  ("itab", itab)]
    for name, x in named:
        if x.device.type != "cuda" or x.device != rows.device:
            raise ValueError(f"{name}: must be on the rows' CUDA device")
    return num_p


def pairs_cuda(rows, sc, tiles, occl: bool, inst=None, work=None):
    """Launch the CUDA kernel on CUDA tensors (raises on anything else).
    With `work`, a zeroed (len(stream_traverse.WORK_SLOTS),) int64 tensor,
    the counting instantiation runs instead and adds its tallies."""
    num_p = check_inputs(rows, sc, tiles, inst)
    lib = _library()
    out = torch.empty((num_p, 8), dtype=torch.float32, device=rows.device)
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    err = lib.imba_pairs_traverse(
        rows.data_ptr(), sc.data_ptr(), tiles.data_ptr(), *st.inst_ptrs(inst),
        out.data_ptr(), num_p, int(occl), st.work_ptr(work, rows.device),
        stream)
    if err != 0:
        raise RuntimeError(f"pairs kernel launch failed: CUDA error {err}")
    LAUNCHES[st.launch_key(occl, inst)] += 1
    return out


def pairs(rows, sc, tiles, occl: bool, inst=None):
    """(P, 8) pair lanes -> (P, 8) hit rows: the kernel on CUDA tensors,
    the plain version on CPU tensors."""
    if rows.device.type == "cuda":
        return pairs_cuda(rows, sc, tiles, occl, inst)
    if rows.device.type == "cpu":
        return pairs_plain(rows, sc, tiles, occl, inst)
    raise ValueError(f"unsupported device {rows.device}")


# --------------------------------------------------------------------------
# The route: candidates, queue, kernel, resolve, fallback
# --------------------------------------------------------------------------

def pair_rows(rays, sbox, tiles, occl: bool, inst=None, k_max: int = K_MAX):
    """(R, 8) ray rows -> (R, 8) hit rows in the stream kernel's layout
    (closest: [t u v id], a miss t = tmax, id = -1; any: [flag]), exact
    for every ray through the saturation fallback."""
    num_r, num_s = rays.shape[0], sbox.shape[0]
    idx, _, count, mindrop = ray_candidates(rays, sbox, k_max)
    k = idx.shape[1]
    rows, sc, order = build_queue(idx, rays, num_s)
    lanes = pairs(rows, sc, tiles, occl, inst)
    res = torch.empty_like(lanes)
    res[order] = lanes
    res = res.view(num_r, k, 8)
    tmax = rays[:, 7]
    if occl:
        occ = (res[:, :, 0] > 0.0).any(dim=1)
        out = torch.zeros_like(rays)
        out[:, 0] = occ.to(torch.float32)
        sat = (count > k) & ~occ
    else:
        t = torch.where(res[:, :, 3] >= 0.0, res[:, :, 0], st.BIG)
        out = res[torch.arange(num_r, device=rays.device),
                  torch.argmin(t, dim=1)]
        found = out[:, 3] >= 0.0
        out[:, 0] = torch.where(found, out[:, 0], tmax)
        sat = (count > k) & (~found | (out[:, 0] > mindrop))
    sat = sat & (tmax >= 0.0)
    if num_s > k_max:
        n_sat = int(sat.sum())
        if n_sat:
            FALLBACK["dispatches"] += 1
            FALLBACK["rays"] += n_sat
            again = rays.clone()
            again[:, 7] = torch.where(sat, tmax, -1.0)
            redo = st.traverse(again, sbox, tiles, occl, inst)
            out = torch.where(sat[:, None], redo, out)
    return out


def closest_hit_pairs(sbox, tiles, org, d, tmin, tmax, active=None,
                      inst=None, k_max: int = K_MAX):
    """Ray arrays -> (num_r, 8) closest-hit rows through the pair queue,
    behind the sorted dispatch."""
    return st.sorted_call(
        lambda r: pair_rows(r, sbox, tiles, False, inst, k_max), sbox, org,
        d, tmin, tmax, active)


def any_hit_pairs(sbox, tiles, org, d, tmin, tmax, active=None, inst=None,
                  k_max: int = K_MAX):
    """Ray arrays -> (num_r, 8) occlusion rows through the pair queue,
    behind the sorted dispatch."""
    return st.sorted_call(
        lambda r: pair_rows(r, sbox, tiles, True, inst, k_max), sbox, org, d,
        tmin, tmax, active)
