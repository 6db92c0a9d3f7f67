"""Pair-queue traversal: closest hit / any hit over a queue of (ray,
super-chunk) pairs -- the hand-written CUDA kernels
(`csrc/pairs_kernel.cu`), their plain PyTorch versions, and the route.

Replaces the TPU kernel
  imbatracer_tpu/ops/pallas_pairs.py::_make_span_kernel(occl, instanced)
in its four variants, and the XLA-side steps around it, behind the same
pipeline as that module's `closest_hit_pairs` / `any_hit_pairs`:

  1. Candidates: each ray's k = min(K_MAX, S) nearest super-chunks, front
     to back (stable on ties, so the lowest index first), with its true
     candidate count and `mindrop`, the entry t of the nearest one
     dropped.  Kernel `candidates_cuda` (one thread a ray, the nearest
     entries in registers); plain version `ray_candidates` (in chunks of
     RAY_CHUNK rays, so the (rays, S) entry matrix stays bounded).
  2. The queue: the P = R * k pairs grouped by super-chunk, each run cut
     into segments of at most SEG lanes.  Kernels `queue_cuda` (the
     candidates launch counts each run and ranks its lanes; one block
     scans the counts into run offsets and the segment table; a scatter);
     plain versions `build_queue` (one stable sort; lanes past a ray's
     count get sc = -1 and tmax = -1) and `segment_table`.
  3. The pair kernel: the closest hit (or occlusion) of each lane's ray in
     its one super-chunk, written to the lane's pair slot p = ray * k + j.
     Kernel `pairs_cuda` (one block a segment: the stream kernel's block
     walk over that super-chunk); plain version `pairs_plain`.
  4. Resolve: each ray's minimum-t lane of its k (the nearer candidate on
     a tie), or the OR of its k flags, and the saturation flag.  Kernel
     `resolve_cuda`; plain version `resolve`.
  5. Saturation fallback, when S > K_MAX: a ray with more than k
     candidates whose hit lies beyond `mindrop` (or that missed; for any
     hit, that is not yet occluded) is re-traced through the stream
     kernel (ops/stream_traverse), only those rays.  This is what makes
     the route exact.  On the card the route makes one host sync, for the
     count of saturated rays.
The whole route runs behind the stream dispatch's Morton / octant sort
(`dispatch.sorted_call`), as the JAX package's runs behind its
`_sorted_dispatch`.  `pair_rows` runs the kernels for CUDA tensors and
the plain versions for CPU tensors; nothing falls back from one to the
other.

Not ported: the Pallas kernel's per-block [first, last] span walk, its
`lane_sc == ti` lane masking and its tile-DMA cache (Mosaic cannot index
per lane; a CUDA block takes one super-chunk's segment), and the JAX
module's A/B knobs `PASSES = 2`, `SEL = "first" / "topk"` and
`IMBA_SORT_KEY=chunk`.
"""

from __future__ import annotations

import ctypes

import torch

from ..libbuild import NativeLib
from . import dispatch
from . import stream_traverse as st

K_MAX = 8
RAY_CHUNK = 1 << 15
GROUP = 64           # super-chunk boxes slab-tested at once per ray chunk
SEG = st.BLK         # lanes a segment of the queue holds (one CUDA block)

# Launch counts, as ops/stream_traverse.LAUNCHES: one per wrapper call on
# the CUDA route (the pair kernel by variant, "candidates", "queue",
# "resolve"), one per call of a plain version (PLAIN_KEYS: pairs_plain,
# ray_candidates, build_queue, resolve).
LAUNCHES = {"closest_hit": 0, "any_hit": 0, "closest_hit_instanced": 0,
            "any_hit_instanced": 0, "candidates": 0, "queue": 0,
            "resolve": 0, "plain": 0, "candidates_plain": 0,
            "queue_plain": 0, "resolve_plain": 0}
PLAIN_KEYS = ("plain", "candidates_plain", "queue_plain", "resolve_plain")
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
    ray).  The plain version of candidates_cuda."""
    LAUNCHES["candidates_plain"] += 1
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
    j of each queue lane).  The plain version of queue_cuda's order, which
    groups the same lanes by super-chunk, in another order within a
    run."""
    LAUNCHES["queue_plain"] += 1
    k = idx.shape[1]
    sc = torch.where(idx >= 0, idx.long(), num_s).reshape(-1)
    sc_s, order = torch.sort(sc, stable=True)
    valid = sc_s < num_s
    rows = rays[order // k]
    rows[:, 7] = torch.where(valid, rows[:, 7], -1.0)
    return (rows.contiguous(), torch.where(valid, sc_s, -1).to(torch.int32),
            order)


def segment_table(counts, seg_len: int = SEG):
    """(N, 4) i32 rows [sc, start, length, 0]: the pair kernel's blocks.
    Super-chunk sc's run holds counts[sc] queue lanes from the exclusive
    prefix sum of counts (runs ascending) and is cut into segments of at
    most seg_len lanes.  The plain version of the table queue_cuda
    builds."""
    counts = counts.long()
    dev = counts.device
    nseg = (counts + seg_len - 1) // seg_len
    sc = torch.repeat_interleave(torch.arange(counts.shape[0], device=dev),
                                 nseg)
    j = torch.arange(sc.shape[0], device=dev) - (torch.cumsum(nseg, 0)
                                                 - nseg)[sc]
    start = (torch.cumsum(counts, 0) - counts)[sc] + j * seg_len
    length = torch.clamp(counts[sc] - j * seg_len, max=seg_len)
    return torch.stack([sc, start, length, torch.zeros_like(sc)],
                       1).to(torch.int32)


# --------------------------------------------------------------------------
# The plain PyTorch versions of the pair kernel and the resolve
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


def resolve(rays, lanes, count, mindrop, k: int, occl: bool):
    """(out (R, 8), sat (R,) bool) from the pair rows `lanes` (R * k, 8)
    at slots p = ray * k + j; slots j >= count are not read.  out: the
    closest hit [t u v id] of the ray's minimum-t lane (the lower j on a
    tie), a miss row [tmax 0 0 -1] where no lane hit; or [flag] the OR of
    its flags.  sat: a live ray with more than k candidates that missed or
    hit beyond mindrop (any hit: that is not occluded), which the stream
    kernel re-traces.  The plain version of resolve_cuda."""
    LAUNCHES["resolve_plain"] += 1
    num_r = rays.shape[0]
    res = lanes.view(num_r, k, 8)
    tmax = rays[:, 7]
    valid = (torch.arange(k, device=rays.device)[None, :]
             < count.long()[:, None])
    out = torch.zeros_like(rays)
    if occl:
        occ = ((res[:, :, 0] > 0.0) & valid).any(dim=1)
        out[:, 0] = occ.to(torch.float32)
        sat = (count > k) & ~occ
    else:
        hit = valid & (res[:, :, 3] >= 0.0)
        t = torch.where(hit, res[:, :, 0], st.BIG)
        j = torch.argmin(t, dim=1)
        ray = torch.arange(num_r, device=rays.device)
        found = hit[ray, j]
        best = res[ray, j, 0:4]
        miss = torch.stack([tmax, torch.zeros_like(tmax),
                            torch.zeros_like(tmax),
                            torch.full_like(tmax, -1.0)], 1)
        out[:, 0:4] = torch.where(found[:, None], best, miss)
        sat = (count > k) & (~found | (out[:, 0] > mindrop))
    return out, sat & (tmax >= 0.0)


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
        vp, i = ctypes.c_void_p, ctypes.c_int
        for name, args in (
                ("imba_pair_candidates", [vp, vp, i, i, i] + [vp] * 7),
                ("imba_pair_queue", [vp, vp, vp, i, i] + [vp] * 5),
                ("imba_pairs_traverse", [vp] * 9 + [i, i, vp, i, vp, vp]),
                ("imba_pair_resolve", [vp] * 4 + [i, i, i] + [vp] * 5),
                ("imba_pairs_resources", [i, i, i, vp])):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = args
        _lib = lib
    return _lib


def _on_card(rays, named):
    """Raise unless every tensor of `named` lies on the rays' CUDA device;
    sbox, tile and itab rows are copied 16 bytes at a time, so those must
    start on a 16-byte boundary."""
    for name, x in named:
        if x.device.type != "cuda" or x.device != rays.device:
            raise ValueError(f"{name}: must be on the rays' CUDA device")
        if name in ("sbox", "tiles", "itab") and x.data_ptr() % 16:
            raise ValueError(f"{name}: must start on a 16-byte boundary")


def _launched(err, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def candidates_cuda(rays, sbox, k_max: int = K_MAX):
    """ray_candidates' (idx, ent, count, mindrop) from the candidates
    kernel on CUDA tensors (raises on anything else), and the queue's
    input: hist (S,) i32, each super-chunk's candidates, and rank (R, k)
    i32, each candidate's place in its super-chunk's run, in the order the
    kernel's atomics were served."""
    num_r, num_s = rays.shape[0], sbox.shape[0]
    st._check("rays", rays, torch.float32, (num_r, 8))
    st._check("sbox", sbox, torch.float32, (num_s, 8))
    _on_card(rays, [("rays", rays), ("sbox", sbox)])
    if num_s < 1 or not 1 <= k_max <= K_MAX:
        raise ValueError(f"need S >= 1 and 1 <= k_max <= {K_MAX}")
    k = min(k_max, num_s)
    dev = rays.device
    idx = torch.empty((num_r, k), dtype=torch.int32, device=dev)
    ent = torch.empty((num_r, k), dtype=torch.float32, device=dev)
    count = torch.empty((num_r,), dtype=torch.int32, device=dev)
    mindrop = torch.empty((num_r,), dtype=torch.float32, device=dev)
    hist = torch.zeros((num_s,), dtype=torch.int32, device=dev)
    rank = torch.empty((num_r, k), dtype=torch.int32, device=dev)
    _launched(_library().imba_pair_candidates(
        rays.data_ptr(), sbox.data_ptr(), num_r, num_s, k, idx.data_ptr(),
        ent.data_ptr(), count.data_ptr(), mindrop.data_ptr(),
        hist.data_ptr(), rank.data_ptr(), _stream(rays)), "pair candidates")
    LAUNCHES["candidates"] += 1
    return idx, ent, count, mindrop, hist, rank


def queue_cuda(idx, rank, hist):
    """The queue on the card from candidates_cuda's idx, rank and hist:
    (order (P,) i32, the pair slots p = ray * k + j grouped by super-chunk,
    runs ascending, of which the first sum(hist) are written; seg (N, 4)
    i32, the segment table, of which the first nseg[0] rows are written
    (segment_table's rows); nseg (1,) i32).  Within a run the lanes come
    in the order the candidates kernel's atomics were served."""
    num_p, num_s = idx.numel(), hist.shape[0]
    dev = idx.device
    st._check("idx", idx, torch.int32, tuple(idx.shape))
    st._check("rank", rank, torch.int32, tuple(idx.shape))
    st._check("hist", hist, torch.int32, (num_s,))
    _on_card(idx, [("idx", idx), ("rank", rank), ("hist", hist)])
    off = torch.empty((num_s,), dtype=torch.int32, device=dev)
    order = torch.empty((num_p,), dtype=torch.int32, device=dev)
    seg = torch.empty((num_p // SEG + num_s + 1, 4), dtype=torch.int32,
                      device=dev)
    nseg = torch.empty((1,), dtype=torch.int32, device=dev)
    _launched(_library().imba_pair_queue(
        idx.data_ptr(), rank.data_ptr(), hist.data_ptr(), num_p, num_s,
        off.data_ptr(), order.data_ptr(), seg.data_ptr(), nseg.data_ptr(),
        _stream(idx)), "pair queue")
    LAUNCHES["queue"] += 1
    return order, seg, nseg


def pairs_cuda(rays, sbox, tiles, order, seg, nseg, k: int, occl: bool,
               inst=None, work=None):
    """Launch the pair kernel on CUDA tensors (raises on anything else):
    one block a row of the segment table, over the queue from queue_cuda.
    Returns (R * k, 8) rows, written at the queued pair slots only.  With
    `work`, a zeroed (len(stream_traverse.WORK_SLOTS),) int64 tensor, the
    counting instantiation runs instead and adds its tallies."""
    num_r, num_s = rays.shape[0], sbox.shape[0]
    st._check("rays", rays, torch.float32, (num_r, 8))
    st._check("sbox", sbox, torch.float32, (num_s, 8))
    st._check("tiles", tiles, torch.float32,
              (tiles.shape[0], st.TILE_ROWS, st.TRI_ROWS))
    st._check("order", order, torch.int32, (num_r * k,))
    st._check("seg", seg, torch.int32, (seg.shape[0], 4))
    st._check("nseg", nseg, torch.int32, (1,))
    named = [("rays", rays), ("sbox", sbox), ("tiles", tiles),
             ("order", order), ("seg", seg), ("nseg", nseg)]
    if inst is not None:
        for name, x, dtype in zip(("tile_idx", "inst_of", "itab"), inst,
                                  (torch.int32, torch.int32, torch.float32)):
            st._check(name, x, dtype, tuple(x.shape))
            named.append((name, x))
    _on_card(rays, named)
    out = torch.empty((num_r * k, 8), dtype=torch.float32, device=rays.device)
    _launched(_library().imba_pairs_traverse(
        rays.data_ptr(), sbox.data_ptr(), tiles.data_ptr(),
        *st.inst_ptrs(inst), order.data_ptr(), seg.data_ptr(),
        nseg.data_ptr(), seg.shape[0], k, out.data_ptr(), int(occl),
        st.work_ptr(work, rays.device), _stream(rays)), "pairs kernel")
    LAUNCHES[st.launch_key(occl, inst)] += 1
    return out


def resolve_cuda(rays, lanes, count, mindrop, k: int, occl: bool):
    """resolve's (out, sat) from the resolve kernel on CUDA tensors, and
    the fallback's input: (out (R, 8), again (R, 8) the rays with tmax -1
    where not saturated, sat (R,) bool, nsat (1,) i32 the saturated
    rays)."""
    num_r = rays.shape[0]
    st._check("rays", rays, torch.float32, (num_r, 8))
    st._check("lanes", lanes, torch.float32, (num_r * k, 8))
    st._check("count", count, torch.int32, (num_r,))
    st._check("mindrop", mindrop, torch.float32, (num_r,))
    _on_card(rays, [("rays", rays), ("lanes", lanes), ("count", count),
                    ("mindrop", mindrop)])
    dev = rays.device
    out = torch.empty_like(rays)
    again = torch.empty_like(rays)
    sat = torch.empty((num_r,), dtype=torch.bool, device=dev)
    nsat = torch.zeros((1,), dtype=torch.int32, device=dev)
    _launched(_library().imba_pair_resolve(
        rays.data_ptr(), lanes.data_ptr(), count.data_ptr(),
        mindrop.data_ptr(), num_r, k, int(occl), out.data_ptr(),
        again.data_ptr(), sat.data_ptr(), nsat.data_ptr(), _stream(rays)),
        "pair resolve")
    LAUNCHES["resolve"] += 1
    return out, again, sat, nsat


def resources(occl: bool, inst: bool, work: bool = False):
    """Registers, shared memory, spills and resident blocks an SM of the
    pair kernel (needs the card)."""
    return st._resources(_library().imba_pairs_resources, int(occl),
                         int(inst), int(work))


# --------------------------------------------------------------------------
# The route: candidates, queue, kernel, resolve, fallback
# --------------------------------------------------------------------------

def pair_rows(rays, sbox, tiles, occl: bool, inst=None, k_max: int = K_MAX):
    """(R, 8) ray rows -> (R, 8) hit rows in the stream kernel's layout
    (closest: [t u v id], a miss t = tmax, id = -1; any: [flag]), exact
    for every ray through the saturation fallback: the kernels on CUDA
    tensors, the plain versions on CPU tensors."""
    num_r, num_s = rays.shape[0], sbox.shape[0]
    k = min(k_max, num_s)
    if rays.device.type == "cuda":
        idx, _, count, mindrop, hist, rank = candidates_cuda(rays, sbox,
                                                             k_max)
        order, seg, nseg = queue_cuda(idx, rank, hist)
        lanes = pairs_cuda(rays, sbox, tiles, order, seg, nseg, k, occl,
                           inst)
        out, again, sat, nsat = resolve_cuda(rays, lanes, count, mindrop, k,
                                             occl)
        n_sat = int(nsat)                    # the route's one host sync
    elif rays.device.type == "cpu":
        idx, _, count, mindrop = ray_candidates(rays, sbox, k_max)
        rows, sc, order = build_queue(idx, rays, num_s)
        lanes = torch.empty((num_r * k, 8), dtype=torch.float32)
        lanes[order] = pairs_plain(rows, sc, tiles, occl, inst)
        out, sat = resolve(rays, lanes, count, mindrop, k, occl)
        n_sat = int(sat.sum())
        again = rays.clone()
        again[:, 7] = torch.where(sat, rays[:, 7], -1.0)
    else:
        raise ValueError(f"unsupported device {rays.device}")
    if n_sat:
        FALLBACK["dispatches"] += 1
        FALLBACK["rays"] += n_sat
        redo = st.traverse(again, sbox, tiles, occl, inst)
        out = torch.where(sat[:, None], redo, out)
    return out


def closest_hit_pairs(sbox, tiles, org, d, tmin, tmax, active=None,
                      inst=None, k_max: int = K_MAX):
    """Ray arrays -> (num_r, 8) closest-hit rows through the pair queue,
    behind the sorted dispatch."""
    return dispatch.sorted_call(
        lambda r: pair_rows(r, sbox, tiles, False, inst, k_max), sbox, org,
        d, tmin, tmax, active)


def any_hit_pairs(sbox, tiles, org, d, tmin, tmax, active=None, inst=None,
                  k_max: int = K_MAX):
    """Ray arrays -> (num_r, 8) occlusion rows through the pair queue,
    behind the sorted dispatch."""
    return dispatch.sorted_call(
        lambda r: pair_rows(r, sbox, tiles, True, inst, k_max), sbox, org, d,
        tmin, tmax, active)
