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

The masked re-trace has two forms.  The eager one loops until every
lane is resolved and reads the device each round (`nonzero`, `any`).
The graph-ready one, taken when the caller passes an `overflow`
counter, is JAX's device-side while loop: the first round covers every
lane, as the eager one does; the rounds past it run in
graphs.while_loop (a WHILE conditional node under CUDA graphs) while
some lane still needs one, up to KHIT_MAX_ROUNDS khit rounds on a flat
BVH or RETRACE_MAX_ROUNDS stream dispatches on a two-level one (the
first included), on `retrace_slots` lanes gathered without a host read
(`gather_slots`: torch.nonzero_static, so the lanes keep their order
and each dispatch sorts its live lanes as the eager loop's subset
does).  The loop's state (the slots' need flags, tcur and hits, and the
round count) lives in tensors made before it, which each pass updates
in place, so a skipped pass leaves them as they were.  Lanes still
unresolved at the cap, and lanes past the slots, are added to
`overflow`, a device int32 counter that the caller reads once a frame;
a frame that overflowed is rendered again on the eager route
(render/graphs.py).  With no overflow both forms run the same rounds
and return the same hits bit for bit.  CUDA graphs capture the
graph-ready form only.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..accel.device import DeviceBvh
from ..ops import khit as khit_mod
from ..ops import pairs as pairs_mod
from ..ops import stream_traverse as st
from . import graphs
from .intersect import BIG

# Runaway guard of the masked re-trace: tmin strictly advances every
# round, so the loop ends anyway; the guard caps an epsilon stall.
MASK_MAX_ROUNDS = 4096

# The graph-ready re-trace's caps on its rounds (khit rounds on a flat
# BVH, stream dispatches, the first included, on a two-level one): JAX's
# cap, since a round runs only while a lane needs it.  The share of a
# dispatch's lanes it carries past its first round is one in *_SLOT_DIV,
# at least one 128-ray block: several times the most lanes one carried
# past its first round in chip_smoke.py's eager frames ("max_lanes": 1
# of 262,144 on the still life, 21,816 on the instanced scene; PERF.md
# names the runs).
KHIT_MAX_ROUNDS = MASK_MAX_ROUNDS
KHIT_SLOT_DIV = 256
RETRACE_MAX_ROUNDS = MASK_MAX_ROUNDS
RETRACE_SLOT_DIV = 4

# Below this super-chunk count the pair queue's sorts cost more than the
# divergence they save; the JAX package's threshold.
PAIRS_MIN_SUPERCHUNKS = 8

# Masked traversal counters: dispatches (masked closest / any hit calls),
# the empty ones among them (no active lane), rounds summed over them
# (khit rounds on a flat BVH, stream dispatches of the re-trace on a
# two-level one), the most rounds one dispatch ran and the most lanes one
# dispatch carried past its first round (what the graph-ready form's
# slots are chosen from), and, on the graph-ready route, the lanes left
# unresolved past the gathered slots ("dropped") and at the cap of the
# rounds ("capped").  The graph-ready route runs the first round of an
# empty dispatch too, and counts it; chip_smoke.py reports rounds per
# non-empty dispatch.
MASK_STATS = {"dispatches": 0, "empty": 0, "rounds": 0, "max_rounds": 0,
              "max_lanes": 0, "dropped": 0, "capped": 0}


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
    tmin, tmax = _full(tmin, num_r, dev), _full(tmax, num_r, dev)
    need = (torch.ones(num_r, dtype=torch.bool, device=dev)
            if active is None else active.clone())
    tcur = tmin.clone()
    ht, hid, hu, hv = _miss(num_r, dev)
    K = khit_mod.K

    MASK_STATS["dispatches"] += 1
    for k in range(MASK_MAX_ROUNDS):
        idx = need.nonzero(as_tuple=True)[0]
        if idx.numel() == 0:
            if k == 0:
                MASK_STATS["empty"] += 1
            break
        _count_round(k + 1, idx.shape[0])
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


_full = st.full_lanes


def _count_round(k: int, lanes: int):
    """Count the k-th round of an eager masked dispatch, over `lanes`
    lanes."""
    MASK_STATS["rounds"] += 1
    MASK_STATS["max_rounds"] = max(MASK_STATS["max_rounds"], k)
    if k == 2:
        MASK_STATS["max_lanes"] = max(MASK_STATS["max_lanes"], lanes)


def _miss(num_r, dev) -> Hit:
    return Hit(t=torch.full((num_r,), BIG, device=dev),
               prim_id=torch.full((num_r,), -1, dtype=torch.int32,
                                  device=dev),
               u=torch.zeros(num_r, device=dev),
               v=torch.zeros(num_r, device=dev))


def retrace_plan(two_level: bool) -> tuple:
    """(cap on the rounds, slot share) of the graph-ready re-trace over a
    two-level or a flat BVH."""
    if two_level:
        return RETRACE_MAX_ROUNDS, RETRACE_SLOT_DIV
    return KHIT_MAX_ROUNDS, KHIT_SLOT_DIV


def retrace_slots(num_r: int, two_level: bool) -> int:
    """Lanes the graph-ready re-trace carries past its first round."""
    div = retrace_plan(two_level)[1]
    return min(num_r, max(st.BLK, -(-num_r // div)))


def gather_slots(need, slots: int):
    """The first `slots` lanes of `need`, in lane order, with no host
    read (torch.nonzero_static): (idx (slots,) int64, each slot's lane,
    0 for an empty slot; valid (slots,) bool; dropped, a 0-d count of
    the `need` lanes past the slots)."""
    idx = torch.nonzero_static(need, size=slots, fill_value=0)[:, 0]
    count = need.sum()
    valid = torch.arange(slots, device=need.device) < count
    return idx, valid, torch.clamp(count - slots, min=0)


def _rows(hit: Hit, idx) -> Hit:
    return Hit(*(x[idx] for x in hit))


def _merge_slots(idx, valid, hit: Hit, sub: Hit) -> Hit:
    """`hit` with the lane of each valid slot taken from `sub`: one
    scatter a field, the empty slots writing a spare row past the
    lanes."""
    num_r = hit.t.shape[0]
    to = torch.where(valid, idx, num_r)
    out = []
    for h, s in zip(hit, sub):
        row = torch.cat([h, h[:1]])
        row[to] = s
        out.append(row[:num_r])
    return Hit(*out)


def _retrace_loop(cond, body, cap: int, dev):
    """After a dispatch's first round, run body() while cond() and fewer
    than `cap` rounds have run (graphs.while_loop), counting each round
    and, on the device, the most rounds a dispatch ran."""
    rounds = torch.ones((), dtype=torch.int32, device=dev)

    def counted():
        MASK_STATS["rounds"] += 1
        body()
        rounds.add_(1)

    graphs.while_loop(lambda: cond() & (rounds < cap), counted)
    graphs.count(MASK_STATS, "max_rounds", rounds)


def _finish(overflow, need, dropped, unresolved):
    """Add the lanes past the slots (`dropped`) and those still
    unresolved at the cap to `overflow` and to their counts; `need`, the
    lanes the first round left unresolved, counts as the lanes carried
    past it."""
    graphs.count(MASK_STATS, "max_lanes", need.sum())
    left = unresolved.sum()
    graphs.count(MASK_STATS, "dropped", dropped)
    graphs.count(MASK_STATS, "capped", left)
    overflow.add_((dropped + left).to(overflow.dtype))


def _copy(dst, src):
    """Copy each tensor of `src` into its tensor of `dst` in place."""
    for a, b in zip(dst, src):
        a.copy_(b)


def _khit_round(bvh: DeviceBvh, org, d, tmin, tmax, alpha_fn, need, tcur,
                hit: Hit):
    """One round of the graph-ready khit re-trace (the JAX while loop's
    body): the K nearest hits past `tcur` of the `need` lanes, the
    others dispatched dead, alpha-tested together.  Returns (need, tcur,
    hit) for the next round."""
    K = khit_mod.K
    t4, u4, v4, id4 = khit_mod.khit_sorted(
        bvh.sbox, bvh.tiles, org, d, torch.where(need, tcur, tmin), tmax,
        active=need)
    ht, hu, hv, hid = hit.t, hit.u, hit.v, hit.prim_id
    # One alpha test of all K columns (an elementwise function, so the
    # same bits as K tests of one column).
    opaque = alpha_fn(torch.clamp(id4, min=0).reshape(-1), u4.reshape(-1),
                      v4.reshape(-1)).view(-1, K)
    found = torch.zeros_like(need)
    for j in range(K):
        take = need & ~found & (id4[:, j] >= 0) & opaque[:, j]
        ht = torch.where(take, t4[:, j], ht)
        hu = torch.where(take, u4[:, j], hu)
        hv = torch.where(take, v4[:, j], hv)
        hid = torch.where(take, id4[:, j], hid)
        found = found | take
    last = t4[:, K - 1]
    exhausted = need & ~found & (id4[:, K - 1] >= 0)
    tcur = torch.where(exhausted, last + 1e-3 * torch.clamp(last, min=1e-3),
                       tcur)
    return exhausted, tcur, Hit(t=ht, prim_id=hid, u=hu, v=hv)


def _closest_hit_masked_khit_graph(bvh: DeviceBvh, org, d, tmin, tmax,
                                   alpha_fn, active, overflow) -> Hit:
    """The graph-ready form of _closest_hit_masked_khit: the first round
    over every lane, then rounds over retrace_slots lanes gathered from
    those still unresolved while one is, up to KHIT_MAX_ROUNDS rounds in
    all; the lanes left unresolved and those past the slots are added to
    `overflow`."""
    org = _recenter(bvh, org)
    num_r = org.shape[0]
    dev = org.device
    tmin, tmax = _full(tmin, num_r, dev), _full(tmax, num_r, dev)
    need = (torch.ones(num_r, dtype=torch.bool, device=dev)
            if active is None else active)
    MASK_STATS["dispatches"] += 1
    MASK_STATS["rounds"] += 1
    graphs.count(MASK_STATS, "empty", ~need.any())
    need, tcur, hit = _khit_round(bvh, org, d, tmin, tmax, alpha_fn, need,
                                  tmin, _miss(num_r, dev))
    idx, valid, dropped = gather_slots(need, retrace_slots(num_r, False))
    sub = (org[idx], d[idx], tmin[idx], tmax[idx])
    s_need, s_tcur, s_hit = valid.clone(), tcur[idx], _rows(hit, idx)

    def body():
        n_need, n_tcur, n_hit = _khit_round(bvh, *sub, alpha_fn, s_need,
                                            s_tcur, s_hit)
        _copy((s_need, s_tcur, *s_hit), (n_need, n_tcur, *n_hit))

    _retrace_loop(s_need.any, body, KHIT_MAX_ROUNDS, dev)
    _finish(overflow, need, dropped, s_need)
    return _merge_slots(idx, valid, hit, s_hit)


def _transparent(alpha_fn, hit: Hit):
    """Lanes whose hit `alpha_fn` reports transparent."""
    opaque = alpha_fn(torch.clamp(hit.prim_id, min=0), hit.u, hit.v)
    return (hit.prim_id >= 0) & ~opaque


def _stream_hit(out) -> Hit:
    """Hit of (R, 8) closest-hit rows: t = BIG on a miss."""
    rid = out[:, 3].to(torch.int32)
    return Hit(t=torch.where(rid >= 0, out[:, 0], BIG), prim_id=rid,
               u=out[:, 1], v=out[:, 2])


def _closest_hit_masked_graph(bvh: DeviceBvh, org, d, tmin, tmax, alpha_fn,
                              active, sort: bool, overflow) -> Hit:
    """The graph-ready form of _closest_hit_masked: the first dispatch
    over every lane, then re-trace dispatches, sorted, over
    retrace_slots lanes gathered from those whose hit was transparent
    while one is (JAX's `active = retrace` body on the slots), up to
    RETRACE_MAX_ROUNDS dispatches in all; the lanes still re-tracing at
    the cap and those past the slots are added to `overflow`."""
    num_r = org.shape[0]
    dev = org.device
    tmin, tmax = _full(tmin, num_r, dev), _full(tmax, num_r, dev)
    act = (torch.ones(num_r, dtype=torch.bool, device=dev)
           if active is None else active)
    MASK_STATS["dispatches"] += 1
    MASK_STATS["rounds"] += 1
    graphs.count(MASK_STATS, "empty", ~act.any())
    hit = _stream_hit(_unmasked(bvh, org, d, tmin, tmax, act, False, sort))
    retrace = act & _transparent(alpha_fn, hit)
    idx, valid, dropped = gather_slots(retrace, retrace_slots(num_r, True))
    s_retrace = valid.clone()
    s_org, s_d, s_tmin, s_tmax = org[idx], d[idx], tmin[idx], tmax[idx]
    s_hit = _rows(hit, idx)

    def body():
        t = s_hit.t
        new = _stream_hit(_unmasked(
            bvh, s_org, s_d,
            torch.where(s_retrace, t + 1e-3 * torch.clamp(t, min=1e-3),
                        s_tmin),
            s_tmax, s_retrace, False, True))
        new = Hit(*(torch.where(s_retrace, n, h) for n, h in zip(new, s_hit)))
        again = s_retrace & _transparent(alpha_fn, new)
        _copy((s_retrace, *s_hit), (again, *new))

    _retrace_loop(s_retrace.any, body, RETRACE_MAX_ROUNDS, dev)
    _finish(overflow, retrace, dropped, s_retrace)
    return _merge_slots(idx, valid, hit, s_hit)


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
        return _miss(num_r, dev)
    _count_round(1, num_r)
    ht, hid, hu, hv = _stream_hit(_unmasked(bvh, org, d, tmin, tmax, act,
                                            False, sort))
    hu, hv = hu.clone(), hv.clone()

    def transparent(idx):
        return _transparent(alpha_fn, Hit(ht[idx], hid[idx], hu[idx],
                                          hv[idx]))

    idx = (act & (hid >= 0)).nonzero(as_tuple=True)[0]
    idx = idx[transparent(idx)]
    for k in range(2, MASK_MAX_ROUNDS + 2):
        if idx.numel() == 0:
            break
        _count_round(k, idx.shape[0])
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
                    sort: bool, overflow=None):
    """Masked occlusion on a two-level BVH: an unmasked any-hit dispatch
    first (a ray with no occluder at all has no opaque one), then the
    masked closest hit of only the rays it found occluded.  Exact, and
    the same function as the JAX package's masked any hit (the masked
    closest hit's `prim_id >= 0` over every lane); a shadow ray that sees
    nothing costs one any-hit walk, which stops at its first hit and
    culls by tmax, instead of a closest-hit walk.  With `overflow`, the
    graph-ready form: the masked closest hit over `active = occ`, sorted,
    with no `nonzero`."""
    num_r = org.shape[0]
    dev = org.device
    tmin, tmax = _full(tmin, num_r, dev), _full(tmax, num_r, dev)
    occ = _unmasked(bvh, org, d, tmin, tmax, active, True, sort)[:, 0] > 0.0
    if overflow is not None:
        return _closest_hit_masked_graph(bvh, org, d, tmin, tmax, alpha_fn,
                                         occ, True, overflow).prim_id >= 0
    idx = occ.nonzero(as_tuple=True)[0]
    hit = _closest_hit_masked(bvh, org[idx], d[idx], tmin[idx], tmax[idx],
                              alpha_fn, None, True)
    out = torch.zeros(num_r, dtype=torch.bool, device=dev)
    out[idx] = hit.prim_id >= 0
    return out


def closest_hit(bvh: DeviceBvh, org, d, tmin, tmax, alpha_fn=None,
                active=None, sort: bool = False, overflow=None) -> Hit:
    """Closest hit for a batch of rays.  org/d: (R, 3); tmin/tmax: scalar
    or (R,); lanes where `active` is False do nothing and miss.  `sort`
    orders the batch by direction octant + origin Morton code before the
    dispatch (exact; only block coherence changes).  With `alpha_fn(prim,
    u, v) -> opaque`, hits it reports transparent are passed through;
    with `overflow`, a 0-d int32 device tensor, through the graph-ready
    re-trace, which adds the lanes it left unresolved to it."""
    if alpha_fn is not None:
        if bvh.two_level:
            if overflow is not None:
                return _closest_hit_masked_graph(bvh, org, d, tmin, tmax,
                                                 alpha_fn, active, sort,
                                                 overflow)
            return _closest_hit_masked(bvh, org, d, tmin, tmax, alpha_fn,
                                       active, sort)
        if overflow is not None:
            return _closest_hit_masked_khit_graph(bvh, org, d, tmin, tmax,
                                                  alpha_fn, active, overflow)
        return _closest_hit_masked_khit(bvh, org, d, tmin, tmax, alpha_fn,
                                        active)
    return _stream_hit(_unmasked(bvh, org, d, tmin, tmax, active, False,
                                 sort))


def any_hit(bvh: DeviceBvh, org, d, tmin, tmax, alpha_fn=None, active=None,
            sort: bool = False, overflow=None) -> torch.Tensor:
    """Occlusion query: True where any (opaque, under `alpha_fn`)
    primitive lies in (tmin, tmax).  Masked, it is the masked closest
    hit's `prim_id >= 0` (through `_any_hit_masked` on a two-level BVH);
    `overflow` as in closest_hit."""
    if alpha_fn is not None:
        if bvh.two_level:
            return _any_hit_masked(bvh, org, d, tmin, tmax, alpha_fn, active,
                                   sort, overflow)
        return closest_hit(bvh, org, d, tmin, tmax, alpha_fn, active,
                           overflow=overflow).prim_id >= 0
    return _unmasked(bvh, org, d, tmin, tmax, active, True, sort)[:, 0] > 0.0


def graph_route(bvh: DeviceBvh, masked: bool) -> tuple:
    """The traversal route a graph-ready dispatch takes, as part of a
    captured graph's key: the BVH's kind and, masked, the re-trace with
    its cap on the rounds and its slot share."""
    kind = "two_level" if bvh.two_level else "flat"
    if not masked:
        return (kind,)
    return (kind, "masked") + retrace_plan(bvh.two_level)
