"""Closest-hit and any-hit traversal (torch twin of the stream-mode route
of imbatracer_tpu.render.traverse).

Every scene traverses through the hand-written CUDA kernels for CUDA
tensors and their plain PyTorch versions for CPU tensors:
ops/stream_traverse.py without alpha masks, and, with an `alpha_fn`, the
k-nearest-hit kernel of ops/khit.py under the exact masked re-trace
(`_closest_hit_masked_khit`).  Two-level instancing is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..accel.device import DeviceBvh
from ..ops import khit as khit_mod
from ..ops import stream_traverse as st
from .intersect import BIG

# Runaway guard of the masked re-trace: tmin strictly advances every
# round, so the loop ends anyway; the guard caps an epsilon stall.
MASK_MAX_ROUNDS = 4096

# Masked traversal counters: dispatches (masked closest / any hit calls),
# the empty ones among them (no active lane), and khit rounds summed over
# them; chip_smoke.py reports rounds per non-empty dispatch.
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


def closest_hit(bvh: DeviceBvh, org, d, tmin, tmax, alpha_fn=None,
                active=None, sort: bool = False) -> Hit:
    """Closest hit for a batch of rays.  org/d: (R, 3); tmin/tmax: scalar
    or (R,); lanes where `active` is False do nothing and miss.  `sort`
    orders the batch by direction octant + origin Morton code before the
    dispatch (exact; only block coherence changes).  With `alpha_fn(prim,
    u, v) -> opaque`, hits it reports transparent are passed through (the
    masked route always sorts)."""
    if alpha_fn is not None:
        return _closest_hit_masked_khit(bvh, org, d, tmin, tmax, alpha_fn,
                                        active)
    out = st.dispatch(bvh.sbox, bvh.tiles, _recenter(bvh, org), d, tmin,
                      tmax, active, occl=False, sort=sort)
    prim_id = out[:, 3].to(torch.int32)
    t = torch.where(prim_id >= 0, out[:, 0], BIG)
    return Hit(t=t, prim_id=prim_id, u=out[:, 1], v=out[:, 2])


def any_hit(bvh: DeviceBvh, org, d, tmin, tmax, alpha_fn=None, active=None,
            sort: bool = False) -> torch.Tensor:
    """Occlusion query: True where any (opaque, under `alpha_fn`)
    primitive lies in (tmin, tmax).  The masked query is the masked
    closest hit's `prim_id >= 0`."""
    if alpha_fn is not None:
        hit = _closest_hit_masked_khit(bvh, org, d, tmin, tmax, alpha_fn,
                                       active)
        return hit.prim_id >= 0
    out = st.dispatch(bvh.sbox, bvh.tiles, _recenter(bvh, org), d, tmin,
                      tmax, active, occl=True, sort=sort)
    return out[:, 0] > 0.0
