"""The traversal dispatch glue and the masked re-trace's slot bookkeeping:
six hand-written CUDA kernels, their plain PyTorch versions, and the
sorted dispatch built on them.

No Pallas kernel stands behind these: JAX runs the glue around each
traversal call inside its compiled band programs, where XLA fuses it
around the Pallas calls.  The card's counterpart is one kernel a step
(csrc/dispatch.cu):

  * `keys`: a lane's sort key (imbatracer_tpu/ops/pallas_stream.py
    sort_keys), with the recentring of its origin fused in and the
    scene's bounds read from a (6,) tensor made once a BVH
    (DeviceBvh.bounds);
  * `rows`: the (R_pad, 8) ray rows in sorted order (_sorted_dispatch's
    gathers and _rays8t), padded with dead rows to a BLK multiple; on
    the card two threads a row, each storing a 16-byte half;
  * `khit_resolve`: the khit re-trace's round after its dispatch
    (imbatracer_tpu/render/traverse.py _closest_hit_masked_khit's while
    body): each sorted (R, 32) khit row's K hits alpha-tested, the first
    opaque one taken, the lane's need flag, tcur and hit written in
    place;
  * `stream_resolve`: a sorted (R, 8) stream row decoded into its lane's
    hit (closest_hit_stream), occlusion flag (any_hit_stream), or, in
    re-trace mode, the one-layer re-trace's body (_closest_hit_masked's
    while body): the hit selected by the lane's re-trace flag and the
    flag set again where the new hit is transparent.

Around the WHILE node of the graph-ready masked re-trace
(render/traverse.py), whose rounds past the first run on `slots` lanes,
the first lanes in need in lane order (JAX's rounds run at full width,
its while loop's carry fused by XLA into the loop body), two more:

  * `slot_gather`: the slots selected and their state after the first
    round, in one launch (class Slots: each slot's lane, as
    torch.nonzero_static gives them, valid and need flags, each slot's
    lane's tcur and hit, the lanes in need and those past the slots); on
    the card a single-pass ordered compaction whose tiles find their
    offsets by decoupled look-back;
  * `slot_finish`: after the loop, each valid slot's hit written into its
    lane of the dispatch's hit (the kernel in place; slot_merge_plain in
    the plain version), the lanes still unresolved and those past the
    slots added to the overflow counter, and, inside a capture, the
    dispatch's device counts (FINISH_KEYS of traverse.MASK_STATS, their
    slots from render/graphs.count_slots) and the counts the loop's body
    ticks a run (render/graphs.while_loop's deltas), added once a
    dispatch for all its runs; on the card one launch, a grid over the
    SMs whose blocks meet in one atomic word.

A dispatch covers n slots (class Dispatch): slot s is lane lanes[s] of
the ray arrays (every lane when `lanes` is None), and the state it reads
and writes (active flags, tcur, hits) is indexed by the lane with
`by_lane`, else by the slot.  Sorted row j holds slot perm[j] (`perm`
None: slot j).  So a re-trace round reads its lanes through the slot
map with no gather, and the resolves write the lanes with no un-permute.

The alpha test of a masked dispatch is a scene/textures.MaskTest (the
mask record: the kernels' own test, shading.cuh mask_opaque) or any
other callable alpha_fn(prim, u, v) -> opaque, which on CUDA tensors is
evaluated in torch on the sorted rows and handed to the resolve kernels
as flags (launch keys "*_flags").  The plain versions call either.

Dispatch: each function launches its kernel on CUDA tensors and runs its
plain version on CPU tensors; nothing falls back from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..libbuild import NativeLib
from ..scene.textures import MaskTest
from . import stream_traverse as st

BIG = st.BIG

# Launch counts: one per kernel launch on the CUDA route (the resolves'
# flags variants under keys of their own), one per call of a plain
# version.  chip_smoke.py reads them to show the main paths ran through
# the kernels.  "slot_merge" stays a key and reads 0: the merge runs in
# slot_finish's launch.
KERNELS = ("dispatch_keys", "dispatch_rows", "khit_resolve",
           "stream_resolve", "slot_gather", "slot_finish")
PLAIN_KEYS = ("keys_plain", "rows_plain", "khit_resolve_plain",
              "stream_resolve_plain", "slot_gather_plain",
              "slot_merge_plain", "slot_finish_plain")
LAUNCHES = dict.fromkeys(KERNELS + ("slot_merge", "khit_resolve_flags",
                                    "stream_resolve_flags") + PLAIN_KEYS, 0)

# stream_resolve's modes (csrc/dispatch.cu).
CLOSEST, OCCLUSION, RETRACE = 0, 1, 2

# The most lanes slot_gather's kernel selects from (csrc/dispatch.cu
# kSelMaxTiles tiles of kSelTile lanes).
SLOT_MAX_LANES = 1 << 25

# The device counts slot_finish adds to, in the kernel's order
# (csrc/dispatch.cu kFinishKeys): an empty dispatch (no active lane), the
# rounds it ran, the lanes in need after its first round, those past the
# slots and those left unresolved at the cap.
FINISH_KEYS = ("empty", "max_rounds", "max_lanes", "dropped", "capped")
# The most (slot, n) counts of a loop's body that slot_finish adds
# (csrc/dispatch.cu kMaxDeltas).
MAX_DELTAS = 16


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class Dispatch(NamedTuple):
    rows: torch.Tensor             # (n_pad, 8) the traversal's input rows
    perm: Optional[torch.Tensor]   # (n,) int64 slot of each sorted row
    n: int                         # slots
    lanes: Optional[torch.Tensor]  # (n,) int64 lane of each slot
    by_lane: bool                  # state indexed by lane (else by slot)


class Slots(NamedTuple):
    """The state of a graph-ready re-trace's rounds past its first."""
    idx: torch.Tensor              # (slots,) int64 lane; 0 when empty
    valid: torch.Tensor            # (slots,) bool: the slot holds a lane
    need: torch.Tensor             # (slots,) bool: the loop's flags
    tcur: Optional[torch.Tensor]   # (slots,) f32 the lane's tcur, or None
    hit: tuple                     # Hit (t, prim_id, u, v) of the lanes
    count: torch.Tensor            # () int32 lanes in need
    dropped: torch.Tensor          # () int32 lanes in need past the slots


def bounds_of(sbox):
    """(6,) [lo.xyz, hi.xyz] of the super-chunk boxes (st.scene_bounds)."""
    return torch.cat(st.scene_bounds(sbox))


def _where(n: int, perm, lanes, by_lane: bool, device):
    """(slot, lane, state index) of each sorted row (each slot when perm
    is None)."""
    s = perm if perm is not None else torch.arange(n, device=device)
    lane = s if lanes is None else lanes[s]
    return s, lane, lane if by_lane else s


# --------------------------------------------------------------------------
# The plain PyTorch versions
# --------------------------------------------------------------------------

def keys_plain(org, d, active, bounds, center=None, lanes=None,
               by_lane=False):
    """(n,) int32 sort keys of the slots (st.sort_keys on the recentred
    origins)."""
    LAUNCHES["keys_plain"] += 1
    n = org.shape[0] if lanes is None else lanes.shape[0]
    o, dd = (org, d) if lanes is None else (org[lanes], d[lanes])
    if center is not None:
        o = o - center
    if active is None:
        act = torch.ones(n, dtype=torch.bool, device=org.device)
    else:
        act = active[lanes] if by_lane and lanes is not None else active
    return st.sort_keys(o, dd, act, bounds[0:3], bounds[3:6])


def rows_plain(org, d, tmin, tmax, perm, n: int, active=None, center=None,
               lanes=None, tcur=None, step=False, by_lane=False):
    """(n_pad, 8) ray rows of the slots in sorted order (st.rays8): tmin'
    is tcur where a slot is active (past it, t + 1e-3 max(t, 1e-3), with
    `step`), else tmin; tmax -1 where inactive and on the padding."""
    LAUNCHES["rows_plain"] += 1
    s, lane, si = _where(n, perm, lanes, by_lane, org.device)
    o = org[lane]
    if center is not None:
        o = o - center
    act = None if active is None else active[si]
    lo = tmin[lane]
    if tcur is not None:
        c = tcur[si]
        if step:
            c = c + 1e-3 * torch.clamp(c, min=1e-3)
        lo = c if act is None else torch.where(act, c, lo)
    return st.rays8(o, d[lane], lo, tmax[lane], act)[0]


def _khit_columns(rows, k: int):
    """(t, u, v, id) of sorted khit rows, each (n, k)."""
    return (rows[:, 0::8], rows[:, 1::8], rows[:, 2::8],
            rows[:, 3::8].to(torch.int32))


def khit_opaque(rows, alpha_fn, k: int):
    """(n, k) opaque flags of the k hits of each khit row: one alpha test
    of all k columns (an elementwise function, so the same bits as k
    tests of one column)."""
    t4, u4, v4, id4 = _khit_columns(rows, k)
    return alpha_fn(torch.clamp(id4, min=0).reshape(-1), u4.reshape(-1),
                    v4.reshape(-1)).view(-1, k)


def khit_resolve_plain(disp: Dispatch, out, need_in, need_out, tcur, hit,
                       alpha_fn):
    """The khit re-trace's round after its dispatch, in place: for each
    slot whose need flag is set, the first hit of its K (sorted by t)
    that is present and opaque goes into `hit`; need_out is set where all
    K were present and none opaque (exhausted), and tcur then moves past
    the K-th hit.  A slot not in need gets need_out False."""
    LAUNCHES["khit_resolve_plain"] += 1
    n = disp.n
    k = out.shape[1] // 8
    rows = out[:n]
    _, _, si = _where(n, disp.perm, disp.lanes, disp.by_lane, out.device)
    t4, u4, v4, id4 = _khit_columns(rows, k)
    need = (torch.ones(n, dtype=torch.bool, device=out.device)
            if need_in is None else need_in[si])
    opaque = khit_opaque(rows, alpha_fn, k)
    ht, hu, hv, hid = hit.t[si], hit.u[si], hit.v[si], hit.prim_id[si]
    found = torch.zeros_like(need)
    for j in range(k):
        take = need & ~found & (id4[:, j] >= 0) & opaque[:, j]
        ht = torch.where(take, t4[:, j], ht)
        hu = torch.where(take, u4[:, j], hu)
        hv = torch.where(take, v4[:, j], hv)
        hid = torch.where(take, id4[:, j], hid)
        found = found | take
    last = t4[:, k - 1]
    exhausted = need & ~found & (id4[:, k - 1] >= 0)
    tc = torch.where(exhausted, last + 1e-3 * torch.clamp(last, min=1e-3),
                     tcur[si])
    hit.t[si], hit.u[si], hit.v[si], hit.prim_id[si] = ht, hu, hv, hid
    tcur[si] = tc
    need_out[si] = exhausted


def stream_opaque(rows, alpha_fn):
    """(n,) opaque flags of the hits of stream rows."""
    return alpha_fn(torch.clamp(rows[:, 3].to(torch.int32), min=0),
                    rows[:, 1], rows[:, 2])


def stream_resolve_plain(disp: Dispatch, out, mode: int, hit=None,
                         flag=None, retrace_in=None, select=False,
                         alpha_fn=None):
    """Stream rows into the slots, in place.  CLOSEST: `hit` (t = BIG on
    a miss).  OCCLUSION: `flag` = t > 0.  RETRACE: the closest hit, kept
    only where retrace_in is set with `select` (every slot without), and
    `flag` = retrace_in & the new hit present & not opaque under
    alpha_fn; retrace_in None counts as every slot set."""
    LAUNCHES["stream_resolve_plain"] += 1
    n = disp.n
    rows = out[:n]
    _, _, si = _where(n, disp.perm, disp.lanes, disp.by_lane, out.device)
    if mode == OCCLUSION:
        flag[si] = rows[:, 0] > 0.0
        return
    rid = rows[:, 3].to(torch.int32)
    new = (torch.where(rid >= 0, rows[:, 0], BIG), rid, rows[:, 1],
           rows[:, 2])
    if mode == RETRACE:
        sel = (torch.ones(n, dtype=torch.bool, device=out.device)
               if retrace_in is None else retrace_in[si])
        if select:
            new = tuple(torch.where(sel, a, b[si]) for a, b in
                        zip(new, (hit.t, hit.prim_id, hit.u, hit.v)))
        t, rid, u, v = new
        opaque = alpha_fn(torch.clamp(rid, min=0), u, v)
        flag[si] = sel & (rid >= 0) & ~opaque
    hit.t[si], hit.prim_id[si], hit.u[si], hit.v[si] = new


def slot_gather_plain(need, slots: int, hit, tcur=None) -> Slots:
    """The slots of the lanes set in `need` and their state: slot s holds
    the s-th lane in need (torch.nonzero_static, 0 past them) when s <
    count (the lanes in need, a 0-d int32), its need flag set; its tcur
    and hit are its lane's (lane 0's for an empty slot)."""
    LAUNCHES["slot_gather_plain"] += 1
    idx = torch.nonzero_static(need, size=slots, fill_value=0)[:, 0]
    count = need.sum(dtype=torch.int32)
    valid = torch.arange(slots, device=idx.device) < count
    return Slots(idx, valid, valid.clone(),
                 None if tcur is None else tcur[idx],
                 type(hit)(*(x[idx] for x in hit)), count,
                 torch.clamp(count - slots, min=0))


def slot_merge_plain(slots: Slots, hit):
    """`hit` with the lane of each valid slot taken from the slots' hit:
    one scatter a field, the empty slots writing a spare row past the
    lanes (a new Hit).  The plain half of slot_finish's merge."""
    LAUNCHES["slot_merge_plain"] += 1
    num_r = hit.t.shape[0]
    to = torch.where(slots.valid, slots.idx, num_r)
    out = []
    for h, s in zip(hit, slots.hit):
        row = torch.cat([h, h[:1]])
        row[to] = s
        out.append(row[:num_r])
    return type(hit)(*out)


def slot_finish_plain(overflow, active, slots: Slots, rounds, counts=None,
                      deltas=(), hit=None):
    """Add the lanes past the slots and those still in need (left
    unresolved at the cap) to `overflow`; with `counts` = (the device
    counts, the slot of each FINISH_KEYS entry, whether each is a
    maximum), add each (slot, n) of `deltas`, the counts a run of the
    loop's body ticks, n x (rounds - 1) times, then raise or add to the
    FINISH_KEYS counts: whether no lane was active, the rounds, the lanes
    in need after the first round, dropped and capped.  With `hit`, the
    dispatch's, returns it with the slots' hits merged in
    (slot_merge_plain), else None."""
    _check_deltas(counts, deltas)
    LAUNCHES["slot_finish_plain"] += 1
    left = slots.need.sum()
    if counts is not None:
        tensor, where, maxes = counts
        runs = rounds - 1
        for slot, n in deltas:
            c = tensor[slot]
            c.copy_(c + (n * runs).to(tensor.dtype))
        for slot, is_max, n in zip(where, maxes, (
                ~active.any(), rounds, slots.count, slots.dropped, left)):
            c, n = tensor[slot], n.to(tensor.dtype)
            c.copy_(torch.maximum(c, n) if is_max else c + n)
    overflow.add_((slots.dropped + left).to(overflow.dtype))
    return None if hit is None else slot_merge_plain(slots, hit)


def _check_deltas(counts, deltas):
    """Raise unless `deltas` fit slot_finish: at most MAX_DELTAS, only
    with the device counts and none at a maximum's slot (the kernel adds
    and raises the counts in no set order)."""
    if len(deltas) > MAX_DELTAS:
        raise ValueError(f"dispatch: {len(deltas)} per-run counts, past the "
                         f"{MAX_DELTAS} slot_finish adds")
    if deltas and counts is None:
        raise ValueError("dispatch: per-run counts need the device counts")
    if counts is not None and {s for s, m in zip(*counts[1:]) if m} & {
            s for s, _ in deltas}:
        raise ValueError("dispatch: a per-run count at a maximum's slot")


# --------------------------------------------------------------------------
# The CUDA kernels
# --------------------------------------------------------------------------

LIB = NativeLib("dispatch", "dispatch.cu",
                headers=("shading.cuh", "lookback.cuh"))

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(LIB.build())
        vp, i = ctypes.c_void_p, ctypes.c_int
        for name, args in (("imba_dispatch_keys", [vp] * 5),
                           ("imba_dispatch_rows", [vp] * 3 + [i, vp]),
                           ("imba_khit_resolve", [vp] * 10),
                           ("imba_stream_resolve", [vp] * 9),
                           ("imba_slot_gather",
                            [vp, ctypes.c_int64, i] + [vp] * 10),
                           ("imba_slot_finish",
                            [vp, ctypes.c_int64, vp, i] + [vp] * 11),
                           ("imba_dispatch_resources", [i, vp])):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = args
        _lib = lib
    return _lib


def _ptr(x):
    return None if x is None else x.data_ptr()


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _launched(err, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _check(x, dtype, what, optional=True):
    if x is None and optional:
        return None
    if x is None or x.device.type != "cuda" or x.dtype != dtype:
        raise ValueError(f"dispatch: {what} must be a CUDA {dtype} tensor, "
                         f"got {None if x is None else (x.dtype, x.device)}")
    return x


def _input(x, dtype, what):
    """A checked input the kernel reads, contiguous (None stays None)."""
    _check(x, dtype, what)
    return None if x is None else x.contiguous()


def _output(x, dtype, what, optional=False):
    """A checked tensor the kernel writes in place: it must be contiguous
    already."""
    _check(x, dtype, what, optional)
    if x is not None and not x.is_contiguous():
        raise ValueError(f"dispatch: {what} must be contiguous (it is "
                         f"written in place)")
    return x


def _shape(x, shape, what):
    """Raise unless tensor `x` (None passes) has `shape`."""
    if x is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"dispatch: {what} must have shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")


def _lane_stride(x, what):
    """A (R,) float32 lane array's stride, 0 or 1 (0 for None)."""
    if x is None:
        return 0
    _check(x, torch.float32, what, optional=False)
    if x.stride(0) not in (0, 1):
        raise ValueError(f"dispatch: {what} must have a stride of 0 or 1")
    return x.stride(0)


# Pointer arguments of the keys and rows launches (enum RayPtr of
# csrc/dispatch.cu), then the ints (enum RayInt).
RAY_PTRS = ("org", "d", "center", "tmin", "tmax", "active", "tcur", "perm",
            "lanes")


def _ray_args(org, d, tmin, tmax, active, center, tcur, perm, lanes, step,
              by_lane, n):
    org = _check(org, torch.float32, "org", optional=False).contiguous()
    d = _check(d, torch.float32, "d", optional=False).contiguous()
    num_r = org.shape[0]
    _shape(org, (num_r, 3), "org")
    _shape(d, (num_r, 3), "d")
    for x, what in ((tmin, "tmin"), (tmax, "tmax")):
        _shape(x, (num_r,), what)
    for x, what in ((perm, "perm"), (lanes, "lanes")):
        _shape(x, (n,), what)
    vals = dict(org=org, d=d, center=_input(center, torch.float32, "center"),
                tmin=tmin, tmax=tmax,
                active=_input(active, torch.bool, "active"),
                tcur=_input(tcur, torch.float32, "tcur"),
                perm=_input(perm, torch.int64, "perm"),
                lanes=_input(lanes, torch.int64, "lanes"))
    ptrs = (ctypes.c_void_p * len(RAY_PTRS))(*[_ptr(vals[k])
                                               for k in RAY_PTRS])
    ints = (ctypes.c_int * 5)(_lane_stride(tmin, "tmin"),
                              _lane_stride(tmax, "tmax"), int(step),
                              int(by_lane), n)
    return ptrs, ints, (org, d, vals)


def keys_cuda(org, d, active, bounds, center=None, lanes=None,
              by_lane=False):
    """Launch dispatch_keys_kernel on CUDA tensors (raises on anything
    else): keys_plain's keys."""
    n = org.shape[0] if lanes is None else lanes.shape[0]
    lib = _library()
    ptrs, ints, keep = _ray_args(org, d, None, None, active, center, None,
                                 None, lanes, False, by_lane, n)
    bounds = _check(bounds, torch.float32, "bounds",
                    optional=False).contiguous()
    keys = torch.empty((n,), dtype=torch.int32, device=org.device)
    _launched(lib.imba_dispatch_keys(ptrs, ints, bounds.data_ptr(),
                                     keys.data_ptr(), _stream(org)),
              "dispatch_keys")
    LAUNCHES["dispatch_keys"] += 1
    return keys


def rows_cuda(org, d, tmin, tmax, perm, n: int, active=None, center=None,
              lanes=None, tcur=None, step=False, by_lane=False):
    """Launch dispatch_rows_kernel on CUDA tensors (raises on anything
    else): rows_plain's rows."""
    lib = _library()
    ptrs, ints, keep = _ray_args(org, d, tmin, tmax, active, center, tcur,
                                 perm, lanes, step, by_lane, n)
    n_pad = n + (-n) % st.BLK
    out = torch.empty((n_pad, 8), dtype=torch.float32, device=org.device)
    _launched(lib.imba_dispatch_rows(ptrs, ints, out.data_ptr(), n_pad,
                                     _stream(org)), "dispatch_rows")
    LAUNCHES["dispatch_rows"] += 1
    return out


# Alpha arguments (make_alpha of csrc/dispatch.cu): the mask record, the
# atlas's texels, the flags; ints: the record's rows, the texels.
def _alpha_args(alpha_fn, flags):
    if flags is not None:
        ptrs, ints, keep = [None, None, flags.data_ptr()], [0, 0], (flags,)
    elif alpha_fn is not None:
        rec = alpha_fn.mask_rec.contiguous()
        tex = alpha_fn.textures.texels.contiguous()
        ptrs = [rec.data_ptr(), tex.data_ptr(), None]
        ints, keep = [rec.shape[0], tex.shape[0]], (rec, tex)
    else:
        ptrs, ints, keep = [None, None, None], [0, 0], ()
    return (ctypes.c_void_p * 3)(*ptrs), ints, keep


def _hit_args(hit, size):
    cols = (hit.t, hit.prim_id, hit.u, hit.v)
    for x, dt, what in zip(cols, (torch.float32, torch.int32, torch.float32,
                                  torch.float32), ("t", "prim_id", "u", "v")):
        _output(x, dt, f"hit.{what}")
        _shape(x, (size,), f"hit.{what}")
    return (ctypes.c_void_p * 4)(*[x.data_ptr() for x in cols])


def _mask_test(alpha_fn):
    """Whether the resolve kernels run alpha_fn themselves (a mask record)
    or take its flags."""
    return alpha_fn is None or isinstance(alpha_fn, MaskTest)


def khit_resolve_cuda(disp: Dispatch, out, need_in, need_out, tcur, hit,
                      alpha_fn):
    """Launch khit_resolve_kernel on CUDA tensors (raises on anything
    else): khit_resolve_plain's writes.  An alpha_fn other than a
    MaskTest is evaluated here on the sorted rows, its flags handed to
    the kernel."""
    if out.dim() != 2 or out.shape[1] != 32 or out.shape[0] < disp.n:
        raise ValueError("khit_resolve: the kernel takes K = 4 rows (R, 32), "
                         "one a slot at least")
    out = _input(out, torch.float32, "khit rows")
    lib = _library()
    flags = None
    if not _mask_test(alpha_fn):
        flags = khit_opaque(out[:disp.n], alpha_fn, 4).contiguous()
    aptrs, aints, keep = _alpha_args(alpha_fn, flags)
    ints = (ctypes.c_int * 4)(int(disp.by_lane), disp.n, *aints)
    need_out = _output(need_out, torch.bool, "need_out")
    need_in = (need_out if need_in is need_out
               else _input(need_in, torch.bool, "need_in"))
    size = need_out.shape[0]
    for x, what in ((need_in, "need_in"), (tcur, "tcur")):
        _shape(x, (size,), what)
    _launched(lib.imba_khit_resolve(
        out.data_ptr(), _ptr(disp.perm), _ptr(disp.lanes), _ptr(need_in),
        need_out.data_ptr(), _output(tcur, torch.float32, "tcur").data_ptr(),
        _hit_args(hit, size), aptrs, ints, _stream(out)), "khit_resolve")
    LAUNCHES["khit_resolve" if flags is None else "khit_resolve_flags"] += 1


def stream_resolve_cuda(disp: Dispatch, out, mode: int, hit=None, flag=None,
                        retrace_in=None, select=False, alpha_fn=None):
    """Launch stream_resolve_kernel on CUDA tensors (raises on anything
    else): stream_resolve_plain's writes.  An alpha_fn other than a
    MaskTest is evaluated here on the sorted rows, its flags handed to
    the kernel."""
    if out.dim() != 2 or out.shape[1] != 8 or out.shape[0] < disp.n:
        raise ValueError("stream_resolve: the kernel takes (R, 8) rows, one "
                         "a slot at least")
    out = _input(out, torch.float32, "stream rows")
    lib = _library()
    flags = None
    if mode == RETRACE and not _mask_test(alpha_fn):
        flags = stream_opaque(out[:disp.n], alpha_fn).contiguous()
    aptrs, aints, keep = _alpha_args(alpha_fn if mode == RETRACE else None,
                                     flags)
    if (mode != CLOSEST and flag is None) or (mode != OCCLUSION
                                              and hit is None):
        raise ValueError("stream_resolve: CLOSEST writes `hit`, OCCLUSION "
                         "`flag`, RETRACE both")
    size = (flag if mode == OCCLUSION else hit.t).shape[0]
    hptrs = (_hit_args(hit, size) if mode != OCCLUSION
             else (ctypes.c_void_p * 4)())
    ints = (ctypes.c_int * 6)(int(disp.by_lane), disp.n, mode, int(select),
                              *aints)
    flag = _output(flag, torch.bool, "flag", optional=True)
    retrace_in = (flag if retrace_in is flag
                  else _input(retrace_in, torch.bool, "retrace_in"))
    for x, what in ((flag, "flag"), (retrace_in, "retrace_in")):
        _shape(x, (size,), what)
    _launched(lib.imba_stream_resolve(
        out.data_ptr(), _ptr(disp.perm), _ptr(disp.lanes), _ptr(retrace_in),
        _ptr(flag), hptrs, aptrs, ints, _stream(out)), "stream_resolve")
    LAUNCHES["stream_resolve" if flags is None
             else "stream_resolve_flags"] += 1


def _hit_in(hit, size, what):
    """Pointers to the (t, prim_id, u, v) of a Hit the kernel reads."""
    cols = tuple(_input(x, dt, f"{what}.{k}") for x, dt, k in zip(
        hit, (torch.float32, torch.int32, torch.float32, torch.float32),
        ("t", "prim_id", "u", "v")))
    for x, k in zip(cols, ("t", "prim_id", "u", "v")):
        _shape(x, (size,), f"{what}.{k}")
    return (ctypes.c_void_p * 4)(*[x.data_ptr() for x in cols]), cols


def slot_gather_cuda(need, slots: int, hit, tcur=None) -> Slots:
    """Launch slot_gather_kernel on CUDA tensors (raises on anything
    else): slot_gather_plain's state."""
    need = _input(need, torch.bool, "need")
    num_r, dev = hit.t.shape[0], need.device
    _shape(need, (num_r,), "need")
    if slots < 0 or num_r > SLOT_MAX_LANES or (slots and not num_r):
        raise ValueError(f"dispatch: slot_gather selects {slots} slots from "
                         f"1 to {SLOT_MAX_LANES} lanes, got {num_r}")
    tcur = _input(tcur, torch.float32, "tcur")
    _shape(tcur, (num_r,), "tcur")
    hptrs, keep = _hit_in(hit, num_r, "hit")
    lib = _library()
    idx = torch.empty(slots, dtype=torch.int64, device=dev)
    valid = torch.empty(slots, dtype=torch.bool, device=dev)
    s_need = torch.empty_like(valid)
    s_tcur = None if tcur is None else torch.empty(slots, device=dev)
    s_hit = type(hit)(*(torch.empty(slots, dtype=x.dtype, device=dev)
                        for x in keep))
    count = torch.empty((), dtype=torch.int32, device=dev)
    dropped = torch.empty_like(count)
    _launched(lib.imba_slot_gather(
        need.data_ptr(), num_r, slots, _ptr(tcur), hptrs, idx.data_ptr(),
        valid.data_ptr(), s_need.data_ptr(), _ptr(s_tcur),
        _hit_args(s_hit, slots), count.data_ptr(), dropped.data_ptr(),
        _stream(need)), "slot_gather")
    LAUNCHES["slot_gather"] += 1
    return Slots(idx, valid, s_need, s_tcur, s_hit, count, dropped)


def slot_finish_cuda(overflow, active, slots: Slots, rounds, counts=None,
                     deltas=(), *, hit):
    """Launch slot_finish_kernel on CUDA tensors (raises on anything
    else): slot_finish_plain's overflow and counts, in place, and its
    merged hit (`hit`, a Hit over the lanes of `active`), written into
    `hit` in place and returned, in one launch."""
    _check_deltas(counts, deltas)
    for x, what in ((overflow, "overflow"), (slots.count, "count"),
                    (slots.dropped, "dropped"), (rounds, "rounds")):
        _check(x, torch.int32, what, optional=False)
        _shape(x, (), what)
    active = _check(active, torch.bool, "active",
                    optional=False).contiguous()
    need = _input(slots.need, torch.bool, "need")
    _shape(need, slots.idx.shape, "need")
    keys = len(FINISH_KEYS)
    ints, cptr = (ctypes.c_int * (2 * keys + 1 + 2 * MAX_DELTAS))(), None
    if counts is not None:
        tensor, where, maxes = counts
        _output(tensor, torch.int32, "counts")
        for slot in list(where) + [slot for slot, _ in deltas]:
            if not 0 <= slot < tensor.shape[0]:
                raise ValueError(f"dispatch: count slot {slot} out of range")
        for k, (slot, is_max) in enumerate(zip(where, maxes)):
            ints[k], ints[keys + k] = slot, int(is_max)
        ints[2 * keys] = len(deltas)
        for k, (slot, n) in enumerate(deltas):
            ints[2 * keys + 1 + 2 * k], ints[2 * keys + 2 + 2 * k] = slot, n
        cptr = tensor.data_ptr()
    n = need.shape[0]
    idx = _input(slots.idx, torch.int64, "idx")
    valid = _input(slots.valid, torch.bool, "valid")
    _shape(idx, (n,), "idx")
    _shape(valid, (n,), "valid")
    sub, keep = _hit_in(slots.hit, n, "slots.hit")
    lib = _library()
    _launched(lib.imba_slot_finish(
        active.data_ptr(), active.shape[0],
        need.data_ptr(), n, slots.count.data_ptr(),
        slots.dropped.data_ptr(), rounds.data_ptr(), overflow.data_ptr(),
        cptr, ints, valid.data_ptr(), idx.data_ptr(), sub,
        _hit_args(hit, active.shape[0]), _stream(need)), "slot_finish")
    LAUNCHES["slot_finish"] += 1
    return hit


def resources(which: str):
    """Registers, shared memory, spills and resident blocks an SM of one
    of the six kernels (KERNELS; needs the card)."""
    return st._resources(_library().imba_dispatch_resources,
                         KERNELS.index(which))


# --------------------------------------------------------------------------
# Dispatch
# --------------------------------------------------------------------------

def _on(x):
    if x.device.type in ("cuda", "cpu"):
        return x.device.type
    raise ValueError(f"unsupported device {x.device}")


def keys(org, d, active, bounds, center=None, lanes=None, by_lane=False):
    """Sort keys of the slots: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    fn = keys_cuda if _on(org) == "cuda" else keys_plain
    return fn(org, d, active, bounds, center, lanes, by_lane)


def rows(org, d, tmin, tmax, perm, n: int, **kw):
    """Sorted ray rows of the slots: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    fn = rows_cuda if _on(org) == "cuda" else rows_plain
    return fn(org, d, tmin, tmax, perm, n, **kw)


def khit_resolve(disp: Dispatch, out, need_in, need_out, tcur, hit,
                 alpha_fn):
    """The khit round's resolve in place: the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    fn = khit_resolve_cuda if _on(out) == "cuda" else khit_resolve_plain
    fn(disp, out, need_in, need_out, tcur, hit, alpha_fn)


def stream_resolve(disp: Dispatch, out, mode: int, **kw):
    """Stream rows into the slots in place: the kernel on CUDA tensors,
    the plain version on CPU tensors."""
    fn = stream_resolve_cuda if _on(out) == "cuda" else stream_resolve_plain
    fn(disp, out, mode, **kw)


def slot_gather(need, slots: int, hit, tcur=None) -> Slots:
    """The slots of a re-trace's lanes in need and their state after its
    first round: the kernel on CUDA tensors, the plain version on CPU
    tensors."""
    fn = slot_gather_cuda if _on(need) == "cuda" else slot_gather_plain
    return fn(need, slots, hit, tcur)


def slot_finish(overflow, active, slots: Slots, rounds, counts=None,
                deltas=(), *, hit):
    """The overflow counter and the device counts of a re-trace, the
    counts its loop's body ticks a run (`deltas`, (slot, n) each) added
    for all its runs, and the dispatch's hit `hit` with the slots' hits
    merged in, returned: the kernel (one launch, the hit in place) on
    CUDA tensors, the plain version on CPU tensors."""
    fn = slot_finish_cuda if _on(overflow) == "cuda" else slot_finish_plain
    return fn(overflow, active, slots, rounds, counts, deltas, hit=hit)


def prepare(org, d, tmin, tmax, active=None, *, bounds=None, sbox=None,
            center=None, lanes=None, tcur=None, step=False, by_lane=False,
            sort=True) -> Dispatch:
    """The rows of one traversal dispatch over the slots (every lane, or
    `lanes`), sorted by their keys with `sort` (torch.sort, stable: the
    library sort, as lax.sort is JAX's).  tmin and tmax: numbers or
    tensors (broadcast over the lanes); active and tcur: by state index;
    `bounds` the scene's (DeviceBvh.bounds), or computed from `sbox`."""
    num_r = org.shape[0]
    dev = org.device
    tmin = st.full_lanes(tmin, num_r, dev)
    tmax = st.full_lanes(tmax, num_r, dev)
    n = num_r if lanes is None else lanes.shape[0]
    perm = None
    if sort:
        if bounds is None:
            bounds = bounds_of(sbox)
        perm = torch.sort(keys(org, d, active, bounds, center, lanes,
                               by_lane), stable=True)[1]
    out = rows(org, d, tmin, tmax, perm, n, active=active, center=center,
               lanes=lanes, tcur=tcur, step=step, by_lane=by_lane)
    return Dispatch(out, perm, n, lanes, by_lane)


def sorted_call(fn, sbox, org, d, tmin, tmax, active):
    """Run `fn(rays (R', 8)) -> (R', 8)` on the ray rows ordered by their
    sort keys (prepare), so incoherent batches get coherent per-block
    candidate lists and dead lanes gather in trailing blocks; the output
    is un-permuted as one scatter.  Exact under any permutation.  Returns
    the (num_r, 8) rows."""
    disp = prepare(org, d, tmin, tmax, active, sbox=sbox)
    res = fn(disp.rows)
    out = torch.empty((disp.n, res.shape[1]), dtype=res.dtype,
                      device=res.device)
    out[disp.perm] = res[:disp.n]
    return out
