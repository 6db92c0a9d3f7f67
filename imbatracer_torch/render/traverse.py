"""Closest-hit and any-hit traversal (torch twin of the "stream" and
"stream2" routes of imbatracer_tpu.render.traverse).

Every scene traverses through the hand-written CUDA kernels for CUDA
tensors and their plain PyTorch versions for CPU tensors, routed as the
JAX package routes them except where the last item says:
  * unmasked: the stream kernel (ops/stream_traverse.py; its instanced
    variant on a two-level BVH), or, when the BVH's pairs switch is on,
    for sorted dispatches on scenes of at least PAIRS_MIN_SUPERCHUNKS
    super-chunks, the pair queue (ops/pairs.py);
  * masked (`alpha_fn`), flat BVH: the k-nearest-hit kernel of
    ops/khit.py under the exact re-trace `_closest_hit_masked_khit`;
  * masked, two-level BVH: the one-layer-per-round re-trace
    `_closest_hit_masked` over unmasked closest-hit dispatches (khit reads
    its tiles by super-chunk, a two-level BVH holds them per mesh, so
    khit never sees one), and for occlusion an unmasked any-hit dispatch
    before it (`_any_hit_masked`); the JAX package has no such any-hit
    dispatch, and its re-trace never takes the pair queue.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..accel.device import DeviceBvh
from ..ops import khit as khit_mod
from ..ops import pairs as pairs_mod
from ..ops import stream_traverse as st
from .intersect import BIG

# Runaway guard of the masked re-trace: tmin strictly advances every
# round, so the loop ends anyway; the guard caps an epsilon stall.
MASK_MAX_ROUNDS = 4096

# Below this super-chunk count the pair queue's sorts cost more than the
# divergence they save; the JAX package's threshold.
PAIRS_MIN_SUPERCHUNKS = 8

# Masked traversal counters: dispatches (masked closest / any hit calls),
# the empty ones among them (no active lane), and rounds summed over them
# (khit rounds on a flat BVH, stream dispatches of the re-trace on a
# two-level one); chip_smoke.py reports rounds per non-empty dispatch.
MASK_STATS = {"dispatches": 0, "empty": 0, "rounds": 0}


class Hit(NamedTuple):
    t: torch.Tensor        # (R,) f32; BIG on a miss
    prim_id: torch.Tensor  # (R,) i32 flat primitive id; -1 on a miss
    u: torch.Tensor        # (R,) f32 barycentric
    v: torch.Tensor        # (R,) f32 barycentric


def _recenter(bvh: DeviceBvh, org):
    """Shift ray origins into the tiles' recentred frame."""
    return org - bvh.center[None, :]


def _closest_hit_masked_khit(bvh: DeviceBvh, org, d, tmin, tmax, alpha_fn,
                             active) -> Hit:
    """Masked closest hit on the K-nearest-hit kernel.

    Each round fetches the K = 4 nearest hits of the lanes still
    unresolved and alpha-tests them together; a lane takes its first
    opaque hit, misses when it has fewer than K hits and none is opaque,
    and re-traces past its K-th hit only when all K were valid and masked
    out.  Exact, because the K-set is gap-free (ops/khit.py).  Each round
    dispatches only the unresolved lanes, re-sorted (khit_sorted), as the
    JAX loop re-sorts every round; the `need.any()` test of the Python
    loop is one host sync per round."""
    org = _recenter(bvh, org)
    num_r = org.shape[0]
    dev = org.device
    tmin = torch.as_tensor(tmin, dtype=torch.float32, device=dev)
    tmax = torch.as_tensor(tmax, dtype=torch.float32, device=dev)
    tmin, tmax = tmin.expand(num_r), tmax.expand(num_r)
    need = (torch.ones(num_r, dtype=torch.bool, device=dev)
            if active is None else active.clone())
    tcur = tmin.clone()
    ht = torch.full((num_r,), BIG, device=dev)
    hid = torch.full((num_r,), -1, dtype=torch.int32, device=dev)
    hu = torch.zeros((num_r,), device=dev)
    hv = torch.zeros((num_r,), device=dev)
    K = khit_mod.K

    MASK_STATS["dispatches"] += 1
    for k in range(MASK_MAX_ROUNDS):
        idx = need.nonzero(as_tuple=True)[0]
        if idx.numel() == 0:
            if k == 0:
                MASK_STATS["empty"] += 1
            break
        MASK_STATS["rounds"] += 1
        t4, u4, v4, id4 = khit_mod.khit_sorted(
            bvh.sbox, bvh.tiles, org[idx], d[idx], tcur[idx], tmax[idx])
        n = idx.shape[0]
        st_t = torch.full((n,), BIG, device=dev)
        st_id = torch.full((n,), -1, dtype=torch.int32, device=dev)
        st_u = torch.zeros((n,), device=dev)
        st_v = torch.zeros((n,), device=dev)
        found = torch.zeros((n,), dtype=torch.bool, device=dev)
        for j in range(K):
            ok = id4[:, j] >= 0
            opaque = alpha_fn(torch.clamp(id4[:, j], min=0), u4[:, j],
                              v4[:, j])
            take = ~found & ok & opaque
            st_t = torch.where(take, t4[:, j], st_t)
            st_u = torch.where(take, u4[:, j], st_u)
            st_v = torch.where(take, v4[:, j], st_v)
            st_id = torch.where(take, id4[:, j], st_id)
            found = found | take
        exhausted = ~found & (id4[:, K - 1] >= 0)
        ht[idx], hu[idx], hv[idx], hid[idx] = st_t, st_u, st_v, st_id
        last = t4[:, K - 1]
        tcur[idx] = torch.where(
            exhausted, last + 1e-3 * torch.clamp(last, min=1e-3), tcur[idx])
        need[idx] = exhausted
    return Hit(t=ht, prim_id=hid, u=hu, v=hv)


def _unmasked(bvh: DeviceBvh, org, d, tmin, tmax, active, occl: bool,
              sort: bool):
    """(R, 8) hit rows of an unmasked query: the pair queue for sorted
    dispatches when the pairs switch is on and the scene has enough
    super-chunks, else the stream kernel."""
    org = _recenter(bvh, org)
    if (sort and bvh.pairs
            and bvh.sbox.shape[0] >= PAIRS_MIN_SUPERCHUNKS):
        fn = pairs_mod.any_hit_pairs if occl else pairs_mod.closest_hit_pairs
        return fn(bvh.sbox, bvh.tiles, org, d, tmin, tmax, active,
                  inst=bvh.inst)
    return st.dispatch(bvh.sbox, bvh.tiles, org, d, tmin, tmax, active,
                       occl=occl, sort=sort, inst=bvh.inst)


def _full(x, num_r, dev):
    return torch.as_tensor(x, dtype=torch.float32, device=dev).expand(num_r)


def _closest_hit_masked(bvh: DeviceBvh, org, d, tmin, tmax, alpha_fn,
                        active, sort: bool) -> Hit:
    """Masked closest hit by one-layer-per-round re-tracing (the route of
    two-level BVHs, whose tiles khit cannot read).

    The first dispatch covers every active lane, sorted as the caller
    asks; a lane whose hit `alpha_fn` reports transparent re-traces from
    just past it (t + 1e-3 * max(t, 1e-3)) until it lands on an opaque
    hit or misses.  Each re-trace dispatches only the lanes still
    re-tracing, sorted, as the JAX loop re-sorts every round; the
    `idx.numel()` test of the Python loop is one host sync per round.
    Every dispatch is an unmasked closest hit (`_unmasked`: the instanced
    stream kernel, or the pair queue when the pairs switch is on; the JAX
    loop always takes the stream kernel).  Exact: every round returns the
    nearest hit past the last one."""
    num_r = org.shape[0]
    dev = org.device
    tmin, tmax = _full(tmin, num_r, dev), _full(tmax, num_r, dev)
    act = (torch.ones(num_r, dtype=torch.bool, device=dev)
           if active is None else active)

    MASK_STATS["dispatches"] += 1
    if not bool(act.any()):
        MASK_STATS["empty"] += 1
        return Hit(t=torch.full((num_r,), BIG, device=dev),
                   prim_id=torch.full((num_r,), -1, dtype=torch.int32,
                                      device=dev),
                   u=torch.zeros(num_r, device=dev),
                   v=torch.zeros(num_r, device=dev))
    MASK_STATS["rounds"] += 1
    out = _unmasked(bvh, org, d, tmin, tmax, act, False, sort)
    hid = out[:, 3].to(torch.int32)
    ht = torch.where(hid >= 0, out[:, 0], BIG)
    hu, hv = out[:, 1].clone(), out[:, 2].clone()

    def transparent(idx):
        got = hid[idx] >= 0
        opaque = alpha_fn(torch.clamp(hid[idx], min=0), hu[idx], hv[idx])
        return got & ~opaque

    idx = (act & (hid >= 0)).nonzero(as_tuple=True)[0]
    idx = idx[transparent(idx)]
    for _ in range(MASK_MAX_ROUNDS):
        if idx.numel() == 0:
            break
        MASK_STATS["rounds"] += 1
        t = ht[idx]
        out = _unmasked(bvh, org[idx], d[idx],
                        t + 1e-3 * torch.clamp(t, min=1e-3), tmax[idx], None,
                        False, True)
        rid = out[:, 3].to(torch.int32)
        hid[idx] = rid
        ht[idx] = torch.where(rid >= 0, out[:, 0], BIG)
        hu[idx] = out[:, 1]
        hv[idx] = out[:, 2]
        idx = idx[transparent(idx)]
    return Hit(t=ht, prim_id=hid, u=hu, v=hv)


def _any_hit_masked(bvh: DeviceBvh, org, d, tmin, tmax, alpha_fn, active,
                    sort: bool):
    """Masked occlusion on a two-level BVH: an unmasked any-hit dispatch
    first (a ray with no occluder at all has no opaque one), then the
    masked closest hit of only the rays it found occluded.  Exact, and
    the same function as the JAX package's masked any hit (the masked
    closest hit's `prim_id >= 0` over every lane); a shadow ray that sees
    nothing costs one any-hit walk, which stops at its first hit and
    culls by tmax, instead of a closest-hit walk."""
    num_r = org.shape[0]
    dev = org.device
    tmin, tmax = _full(tmin, num_r, dev), _full(tmax, num_r, dev)
    occ = _unmasked(bvh, org, d, tmin, tmax, active, True, sort)[:, 0] > 0.0
    idx = occ.nonzero(as_tuple=True)[0]
    hit = _closest_hit_masked(bvh, org[idx], d[idx], tmin[idx], tmax[idx],
                              alpha_fn, None, True)
    out = torch.zeros(num_r, dtype=torch.bool, device=dev)
    out[idx] = hit.prim_id >= 0
    return out


def closest_hit(bvh: DeviceBvh, org, d, tmin, tmax, alpha_fn=None,
                active=None, sort: bool = False) -> Hit:
    """Closest hit for a batch of rays.  org/d: (R, 3); tmin/tmax: scalar
    or (R,); lanes where `active` is False do nothing and miss.  `sort`
    orders the batch by direction octant + origin Morton code before the
    dispatch (exact; only block coherence changes).  With `alpha_fn(prim,
    u, v) -> opaque`, hits it reports transparent are passed through."""
    if alpha_fn is not None:
        if bvh.two_level:
            return _closest_hit_masked(bvh, org, d, tmin, tmax, alpha_fn,
                                       active, sort)
        return _closest_hit_masked_khit(bvh, org, d, tmin, tmax, alpha_fn,
                                        active)
    out = _unmasked(bvh, org, d, tmin, tmax, active, False, sort)
    prim_id = out[:, 3].to(torch.int32)
    t = torch.where(prim_id >= 0, out[:, 0], BIG)
    return Hit(t=t, prim_id=prim_id, u=out[:, 1], v=out[:, 2])


def any_hit(bvh: DeviceBvh, org, d, tmin, tmax, alpha_fn=None, active=None,
            sort: bool = False) -> torch.Tensor:
    """Occlusion query: True where any (opaque, under `alpha_fn`)
    primitive lies in (tmin, tmax).  Masked, it is the masked closest
    hit's `prim_id >= 0` (through `_any_hit_masked` on a two-level BVH)."""
    if alpha_fn is not None:
        if bvh.two_level:
            return _any_hit_masked(bvh, org, d, tmin, tmax, alpha_fn, active,
                                   sort)
        hit = _closest_hit_masked_khit(bvh, org, d, tmin, tmax, alpha_fn,
                                       active)
        return hit.prim_id >= 0
    return _unmasked(bvh, org, d, tmin, tmax, active, True, sort)[:, 0] > 0.0
