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
first included), on `retrace_slots` lanes selected without a host read
(`gather_slots`: the first lanes in need, in lane order, as
torch.nonzero_static gives them, so each dispatch sorts its live lanes
as the eager loop's subset does).  The loop's state (the slots' need
flags, tcur and hits, and the round count) lives in tensors made before
it, which each pass updates in place, so a skipped pass leaves them as
they were; its condition is a graphs.LoopTest, which the WHILE node's
flag kernel tests on the card, counting the rounds.  Lanes still
unresolved at the cap, and lanes past the slots, are added to
`overflow`, a device int32 counter that the caller reads once a frame;
a frame that overflowed is rendered again on the eager route
(render/graphs.py).  With no overflow both forms run the same rounds
and return the same hits bit for bit.  CUDA graphs capture the
graph-ready form only.

Each dispatch's glue is ops/dispatch.py's (CUDA kernels on the card):
the sort keys with the recentring fused in, the sorted ray rows read
through the round's slot map, and a resolve that reads the traversal's
sorted rows and writes each lane's hit, flags and tcur in place (the
khit round's alpha test and K-hit pick, the re-trace's select and alpha
test), as XLA fuses JAX's glue around its traversal calls.  Around the
graph-ready form's while loop, its slot selection and state, merge,
overflow and device counts are ops/dispatch.py's too (slot_gather, one
launch from the need flags to the slots; slot_finish, one launch from the
loop's exit to the merged hit and the counts); the library sort stays a
torch op.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..accel.device import DeviceBvh
from ..ops import dispatch as dp
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


def _dispatch(bvh: DeviceBvh, org, d, tmin, tmax, active, occl: bool,
              sort: bool, **kw):
    """One unmasked traversal dispatch of the slots (dispatch.prepare,
    with its `lanes`, `tcur`, `step` and `by_lane`): (Dispatch, (n_pad,
    8) hit rows in its order).  The pair queue for sorted dispatches when
    the pairs switch is on and the scene has enough super-chunks, else
    the stream kernel."""
    disp = dp.prepare(org, d, tmin, tmax, active, bounds=bvh.bounds,
                      center=bvh.center, sort=sort, **kw)
    if (sort and bvh.pairs
            and bvh.sbox.shape[0] >= PAIRS_MIN_SUPERCHUNKS):
        out = pairs_mod.pair_rows(disp.rows, bvh.sbox, bvh.tiles, occl,
                                  bvh.inst)
    else:
        out = st.traverse(disp.rows, bvh.sbox, bvh.tiles, occl, bvh.inst)
    return disp, out


def _khit_dispatch(bvh: DeviceBvh, org, d, tmin, tmax, active, **kw):
    """One sorted khit dispatch of the slots: (Dispatch, (n_pad, 8K)
    sorted K-nearest hit rows)."""
    disp = dp.prepare(org, d, tmin, tmax, active, bounds=bvh.bounds,
                      center=bvh.center, **kw)
    return disp, khit_mod.khit(disp.rows, bvh.sbox, bvh.tiles)


def _closest_hit_masked_khit(bvh: DeviceBvh, org, d, tmin, tmax, alpha_fn,
                             active) -> Hit:
    """Masked closest hit on the K-nearest-hit kernel.

    Each round fetches the K = 4 nearest hits of the lanes still
    unresolved and alpha-tests them together; a lane takes its first
    opaque hit, misses when it has fewer than K hits and none is opaque,
    and re-traces past its K-th hit only when all K were valid and masked
    out.  Exact, because the K-set is gap-free (ops/khit.py).  Each round
    dispatches only the unresolved lanes (their slot map), re-sorted, as
    the JAX loop re-sorts every round, and dispatch.khit_resolve writes
    their need flags, tcur and hits in place; the `nonzero` of the Python
    loop is one host sync per round."""
    num_r = org.shape[0]
    dev = org.device
    tmin, tmax = _full(tmin, num_r, dev), _full(tmax, num_r, dev)
    need = (torch.ones(num_r, dtype=torch.bool, device=dev)
            if active is None else active.clone())
    tcur = tmin.clone(memory_format=torch.contiguous_format)
    hit = _miss(num_r, dev)

    MASK_STATS["dispatches"] += 1
    for k in range(MASK_MAX_ROUNDS):
        idx = need.nonzero(as_tuple=True)[0]
        if idx.numel() == 0:
            if k == 0:
                MASK_STATS["empty"] += 1
            break
        _count_round(k + 1, idx.shape[0])
        disp, out = _khit_dispatch(bvh, org, d, tmin, tmax, None, lanes=idx,
                                   tcur=tcur, by_lane=True)
        dp.khit_resolve(disp, out, need, need, tcur, hit, alpha_fn)
    return hit


def _closest(bvh: DeviceBvh, org, d, tmin, tmax, active, sort: bool) -> Hit:
    """Unmasked closest hit: t = BIG on a miss."""
    disp, out = _dispatch(bvh, org, d, tmin, tmax, active, False, sort)
    hit = _hits(org.shape[0], org.device)
    dp.stream_resolve(disp, out, dp.CLOSEST, hit=hit)
    return hit


def _occluded(bvh: DeviceBvh, org, d, tmin, tmax, active, sort: bool):
    """Unmasked occlusion flags."""
    disp, out = _dispatch(bvh, org, d, tmin, tmax, active, True, sort)
    occ = torch.empty(org.shape[0], dtype=torch.bool, device=org.device)
    dp.stream_resolve(disp, out, dp.OCCLUSION, flag=occ)
    return occ


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


def _hits(num_r, dev) -> Hit:
    """A Hit to be written in full."""
    return Hit(t=torch.empty(num_r, device=dev),
               prim_id=torch.empty(num_r, dtype=torch.int32, device=dev),
               u=torch.empty(num_r, device=dev),
               v=torch.empty(num_r, device=dev))


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


def gather_slots(need, slots: int, hit: Hit, tcur=None) -> dp.Slots:
    """The first `slots` lanes of `need`, in lane order, and their state,
    with no host read (dispatch.slot_gather: on the card one launch of
    its kernel)."""
    return dp.slot_gather(need, slots, hit, tcur)


def _retrace_loop(s: dp.Slots, body, cap: int):
    """After a dispatch's first round, run body() while a slot needs a
    round and fewer than `cap` rounds have run (graphs.while_loop over a
    graphs.LoopTest: under a capture the WHILE node's flag kernel tests
    it and counts the rounds), counting each round; returns (the rounds
    run, a 0-d device int32; the counts a run of the body ticks, which
    _finish adds for all its runs)."""
    rounds = torch.empty((), dtype=torch.int32, device=s.need.device)
    test = graphs.LoopTest(s.need, s.count, rounds, cap)

    def counted():
        MASK_STATS["rounds"] += 1
        body()

    return rounds, graphs.while_loop(test, counted)


def _finish(overflow, act, slots: dp.Slots, loop, hit: Hit) -> Hit:
    """After the loop (dispatch.slot_finish: on the card one launch of its
    kernel): the lanes past the slots and those still unresolved at the
    cap added to `overflow`, and inside a capture the dispatch's device
    counts (empty, its rounds, the lanes carried past its first round,
    dropped, capped) and the counts of the loop's body (`loop`:
    _retrace_loop's rounds and per-run counts), times its runs; returns
    `hit` with the slots' hits merged in."""
    rounds, deltas = loop
    return dp.slot_finish(overflow, act, slots, rounds,
                          graphs.count_slots(MASK_STATS, dp.FINISH_KEYS),
                          deltas, hit=hit)


def _closest_hit_masked_khit_graph(bvh: DeviceBvh, org, d, tmin, tmax,
                                   alpha_fn, active, overflow) -> Hit:
    """The graph-ready form of _closest_hit_masked_khit (the JAX while
    loop): the first round over every lane, then rounds over
    retrace_slots lanes gathered from those still unresolved while one
    is, up to KHIT_MAX_ROUNDS rounds in all, each a khit dispatch of the
    slots' lanes and dispatch.khit_resolve updating the slots' need
    flags, tcur and hits in place; the lanes left unresolved and those
    past the slots are added to `overflow`."""
    num_r = org.shape[0]
    dev = org.device
    tmin, tmax = _full(tmin, num_r, dev), _full(tmax, num_r, dev)
    act = (torch.ones(num_r, dtype=torch.bool, device=dev)
           if active is None else active)
    MASK_STATS["dispatches"] += 1
    MASK_STATS["rounds"] += 1
    need = torch.empty(num_r, dtype=torch.bool, device=dev)
    # The resolve writes tcur where a lane is exhausted, and only those
    # lanes' tcur is read after it; an inactive lane keeps its miss.
    tcur = torch.empty(num_r, device=dev)
    hit = _miss(num_r, dev)
    disp, out = _khit_dispatch(bvh, org, d, tmin, tmax, act)
    dp.khit_resolve(disp, out, act, need, tcur, hit, alpha_fn)
    s = gather_slots(need, retrace_slots(num_r, False), hit, tcur)

    def body():
        disp, out = _khit_dispatch(bvh, org, d, tmin, tmax, s.need,
                                   lanes=s.idx, tcur=s.tcur)
        dp.khit_resolve(disp, out, s.need, s.need, s.tcur, s.hit, alpha_fn)

    loop = _retrace_loop(s, body, KHIT_MAX_ROUNDS)
    return _finish(overflow, act, s, loop, hit)


def _closest_hit_masked_graph(bvh: DeviceBvh, org, d, tmin, tmax, alpha_fn,
                              active, sort: bool, overflow) -> Hit:
    """The graph-ready form of _closest_hit_masked: the first dispatch
    over every lane, then re-trace dispatches, sorted, over
    retrace_slots lanes gathered from those whose hit was transparent
    while one is (JAX's `active = retrace` body on the slots: the
    dispatch from just past each slot's hit, dispatch.stream_resolve's
    re-trace mode updating its hit and flag in place), up to
    RETRACE_MAX_ROUNDS dispatches in all; the lanes still re-tracing at
    the cap and those past the slots are added to `overflow`."""
    num_r = org.shape[0]
    dev = org.device
    tmin, tmax = _full(tmin, num_r, dev), _full(tmax, num_r, dev)
    act = (torch.ones(num_r, dtype=torch.bool, device=dev)
           if active is None else active)
    MASK_STATS["dispatches"] += 1
    MASK_STATS["rounds"] += 1
    hit = _hits(num_r, dev)
    retrace = torch.empty(num_r, dtype=torch.bool, device=dev)
    disp, out = _dispatch(bvh, org, d, tmin, tmax, act, False, sort)
    dp.stream_resolve(disp, out, dp.RETRACE, hit=hit, flag=retrace,
                      retrace_in=act, alpha_fn=alpha_fn)
    s = gather_slots(retrace, retrace_slots(num_r, True), hit)

    def body():
        disp, out = _dispatch(bvh, org, d, tmin, tmax, s.need, False,
                              True, lanes=s.idx, tcur=s.hit.t, step=True)
        dp.stream_resolve(disp, out, dp.RETRACE, hit=s.hit, flag=s.need,
                          retrace_in=s.need, select=True, alpha_fn=alpha_fn)

    loop = _retrace_loop(s, body, RETRACE_MAX_ROUNDS)
    return _finish(overflow, act, s, loop, hit)


def _closest_hit_masked(bvh: DeviceBvh, org, d, tmin, tmax, alpha_fn,
                        active, sort: bool) -> Hit:
    """Masked closest hit by one-layer-per-round re-tracing (the route of
    two-level BVHs, whose tiles khit cannot read).

    The first dispatch covers every active lane, sorted as the caller
    asks; a lane whose hit `alpha_fn` reports transparent re-traces from
    just past it (t + 1e-3 * max(t, 1e-3)) until it lands on an opaque
    hit or misses (dispatch.stream_resolve's re-trace mode, which writes
    the hit and the re-trace flag in place).  Each re-trace dispatches
    only the lanes still re-tracing (their slot map), sorted, as the JAX
    loop re-sorts every round; the `nonzero` of the Python loop is one
    host sync per round.  Every dispatch is an unmasked closest hit
    (`_dispatch`: the instanced stream kernel, or the pair queue when the
    pairs switch is on; the JAX loop always takes the stream kernel).
    Exact: every round returns the nearest hit past the last one."""
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
    hit = _hits(num_r, dev)
    retrace = torch.empty(num_r, dtype=torch.bool, device=dev)
    disp, out = _dispatch(bvh, org, d, tmin, tmax, act, False, sort)
    dp.stream_resolve(disp, out, dp.RETRACE, hit=hit, flag=retrace,
                      retrace_in=act, alpha_fn=alpha_fn)
    for k in range(2, MASK_MAX_ROUNDS + 2):
        idx = retrace.nonzero(as_tuple=True)[0]
        if idx.numel() == 0:
            break
        _count_round(k, idx.shape[0])
        disp, out = _dispatch(bvh, org, d, tmin, tmax, None, False, True,
                              lanes=idx, tcur=hit.t, step=True, by_lane=True)
        dp.stream_resolve(disp, out, dp.RETRACE, hit=hit, flag=retrace,
                          retrace_in=retrace, select=True, alpha_fn=alpha_fn)
    return hit


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
    occ = _occluded(bvh, org, d, tmin, tmax, active, sort)
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
    return _closest(bvh, org, d, tmin, tmax, active, sort)


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
    return _occluded(bvh, org, d, tmin, tmax, active, sort)


def graph_route(bvh: DeviceBvh, masked: bool) -> tuple:
    """The traversal route a graph-ready dispatch takes, as part of a
    captured graph's key: the BVH's kind and, masked, the re-trace with
    its cap on the rounds and its slot share."""
    kind = "two_level" if bvh.two_level else "flat"
    if not masked:
        return (kind,)
    return (kind, "masked") + retrace_plan(bvh.two_level)
