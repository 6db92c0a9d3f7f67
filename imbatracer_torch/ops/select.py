"""The VCM frame's collect selection and canonical order: two
hand-written CUDA kernels, their plain PyTorch versions, and their
dispatch.

No Pallas kernel stands behind these: JAX runs the selection as two
jitted programs once a frame, between the light bands and the camera
bands (imbatracer_tpu/render/light_cache.py `select_shallowest` :165 and
`canonicalize` :197):

  * `select_keys`: the sort key of each valid row, read from its
    (path_length, path_id) pair -- in the collect cache's (C + 1, 2)
    int32 key columns, which the collect append writes beside the rows
    (ops/light_tail.py), or for a cache without them in columns 21-22 of
    the packed (C, 24) rows (`key_pairs`: one kernel, the pairs' stride
    its argument) -- SHALLOW, the admission key (path_length, path_id),
    over the first `n` rows; CANONICAL, the layout key (path_id,
    path_length), over the rows an order names (the kept rows) or the
    first `n`;
  * `select_gather`: the working cache's rows in canonical order in one
    pass, both sorts' permutations composed (row i < kept is
    rec[order1[order2[i]]], the rows after it zero), their (rows, 4)
    position column (pos and a zero; zero past the kept rows), which the
    photon grid's keys read (ops/merge.py), and on the card the kept
    photons' box for the grid's scalars.

The sorts between them are the library's (torch.sort, stable), as
lax.sort is JAX's.  A key is exact in either width: int64 (major << 32)
+ minor always, int32 (major << bits) | minor when the caller's bounds
on both keys allow it (`key_bits`).

The plain versions are torch code of the same functions, on either
device; on CPU tensors the frame runs them, so its caches stay the
parent's bit for bit.  Dispatch: each function launches its kernel on
CUDA tensors and runs its plain version on CPU tensors; nothing falls
back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from ..libbuild import NativeLib
from . import stream_traverse as st

# Launch counts: one per call of a kernel wrapper on the CUDA route, one
# per call of a plain version.  chip_smoke.py reads them to show the
# main paths ran through the kernels.
KERNELS = ("select_keys", "select_gather")
PLAIN_KEYS = tuple(f"{k}_plain" for k in KERNELS)
LAUNCHES = dict.fromkeys(KERNELS + PLAIN_KEYS, 0)

REC_W = 24                   # render/light_cache.py REC_W (csrc kRecW)
POS_W = 4                    # the position column's width (x, y, z, 0)
COL_LENGTH, COL_ID = 21, 22  # path_length, path_id (int32 bits)
SHALLOW, CANONICAL = 1, 2    # key modes (csrc kShallow, kCanonical)


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def key_bits(major_bound, minor_bound):
    """The low bits of an int32 key (major << bits) | minor that orders
    as the pair when 0 <= minor < minor_bound and 0 <= major <
    major_bound; None (an int64 key) when either bound is unknown or the
    two do not fit in 31 bits."""
    if major_bound is None or minor_bound is None:
        return None
    bits = max(int(minor_bound) - 1, 1).bit_length()
    if int(major_bound) - 1 >= 1 << (31 - bits):
        return None
    return bits


# --------------------------------------------------------------------------
# The plain PyTorch versions
# --------------------------------------------------------------------------

def key_pairs(src):
    """The (C, 2) int32 (path_length, path_id) pairs of `src`: the key
    columns themselves ((C, 2) int32), or a view of columns 21-22 of the
    packed (C, 24) f32 rows (their stride 24 ints)."""
    if src.dtype == torch.int32:
        return src
    return src.view(torch.int32)[:, COL_LENGTH:COL_ID + 1]


def select_keys_plain(src, n: int, order, mode: int, bits):
    """(n,) sort keys of rows order[:n] (rows 0..n-1 without `order`) of
    `src`, the (C, 2) int32 key columns or the packed (C, 24) rows
    (`key_pairs`): int64 (major << 32) + minor with `bits` None, else
    int32 (major << bits) | minor; (major, minor) is (path_length,
    path_id) for SHALLOW, (path_id, path_length) for CANONICAL."""
    LAUNCHES["select_keys_plain"] += 1
    pairs = key_pairs(src)
    ints = pairs[:n] if order is None else pairs[order[:n]]
    length, pid = ints[:, 0], ints[:, 1]
    major, minor = (length, pid) if mode == SHALLOW else (pid, length)
    if bits is None:
        return major.to(torch.int64) * (1 << 32) + minor.to(torch.int64)
    return (major << bits) | minor


def select_gather_plain(rec, order1, order2, rows: int):
    """(out, box, pos): out the (rows, 24) packed rows, row i < kept =
    len(order2) rec[order1[order2[i]]] (rec[order2[i]] without
    `order1`), the rows after it zero; no box (the plain grid takes its
    own); pos the (rows, 4) position column, out[:, 0:3] and a zero
    column."""
    LAUNCHES["select_gather_plain"] += 1
    src = order2 if order1 is None else order1[order2]
    out = rec.new_zeros((rows, rec.shape[1]))
    out[:src.shape[0]] = rec[src]
    return out, None, torch.nn.functional.pad(out[:, 0:3], (0, POS_W - 3))


def box_plain(rows, kept: int):
    """The kept photons' box as floats, (min xyz, max xyz) of pos over
    rows[:kept] (+inf and -inf with none): what select_gather_cuda's box
    decodes to (`box_floats`)."""
    pos = rows[:kept, 0:3]
    if kept == 0:
        inf = torch.full((3,), float("inf"), device=rows.device)
        return torch.cat([inf, -inf])
    return torch.cat([pos.amin(dim=0), pos.amax(dim=0)])


def box_floats(box):
    """select_gather_cuda's (6,) int32 box decoded to floats, as box_plain
    gives them: the order-preserving bits undone, the min slots
    complemented first, a zero slot +inf or -inf."""
    u = box.to(torch.int64) & 0xFFFFFFFF
    u = torch.cat([(~u[:3]) & 0xFFFFFFFF, u[3:]])
    bits = torch.where(u >= 1 << 31, u - (1 << 31), (~u) & 0xFFFFFFFF)
    bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    f = bits.to(torch.int32).view(torch.float32)
    inf = float("inf")
    none = torch.tensor([inf] * 3 + [-inf] * 3, device=box.device)
    return torch.where(box == 0, none, f)


# --------------------------------------------------------------------------
# The CUDA kernels
# --------------------------------------------------------------------------

LIB = NativeLib("select", "select.cu")

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(LIB.build())
        vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        for name, args in (("imba_select_keys",
                            [vp, i64, vp, i64, i, i, i, vp, vp]),
                           ("imba_select_gather",
                            [vp, vp, vp, i64, i64, vp, vp, vp, vp]),
                           ("imba_select_resources", [i, vp])):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = args
        _lib = lib
    return _lib


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _launched(err, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _check(x, dtype, shape, what, aligned=False):
    """Raise unless `x` is a contiguous CUDA tensor of `dtype` and
    `shape` (a None dimension takes any size; 16-byte aligned with
    `aligned`)."""
    if (x.device.type != "cuda" or x.dtype != dtype or x.dim() != len(shape)
            or any(s is not None and s != t for s, t in zip(shape, x.shape))
            or not x.is_contiguous()):
        raise ValueError(f"select: {what} must be a contiguous CUDA "
                         f"{dtype} tensor of shape {tuple(shape)}, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if aligned and x.data_ptr() % 16:
        raise ValueError(f"select: {what} must be 16-byte aligned")
    return x


def select_keys_cuda(src, n: int, order, mode: int, bits):
    """Launch select_keys_kernel on CUDA tensors (raises on anything
    else): select_keys_plain's keys, from the key columns (stride 2) or
    the packed rows (stride 24)."""
    if src.dtype == torch.int32:
        _check(src, torch.int32, (None, 2), "keys")
    else:
        _check(src, torch.float32, (None, REC_W), "rec")
    if src.shape[0] < n:
        raise ValueError("select: fewer key rows than n")
    if order is not None:
        _check(order, torch.int64, (None,), "order")
        if order.shape[0] < n:
            raise ValueError("select: order names fewer rows than n")
    if mode not in (SHALLOW, CANONICAL):
        raise ValueError(f"select: unknown key mode {mode}")
    keys = torch.empty((n,), dtype=torch.int64 if bits is None
                       else torch.int32, device=src.device)
    if n == 0:
        return keys
    pairs = key_pairs(src)
    _launched(_library().imba_select_keys(
        pairs.data_ptr(), pairs.stride(0),
        None if order is None else order.data_ptr(), n, mode,
        int(bits is None), bits or 0, keys.data_ptr(), _stream(src)),
        "select_keys")
    LAUNCHES["select_keys"] += 1
    return keys


def select_gather_cuda(rec, order1, order2, rows: int):
    """Launch select_gather_kernel on CUDA tensors (raises on anything
    else): select_gather_plain's rows and position column, and the kept
    photons' box, (6,) int32 order-preserving bits (`box_floats` decodes
    them)."""
    _check(rec, torch.float32, (None, REC_W), "rec", aligned=True)
    _check(order2, torch.int64, (None,), "order2")
    if order1 is not None:
        _check(order1, torch.int64, (None,), "order1")
    kept = order2.shape[0]
    if kept > rows:
        raise ValueError("select: more kept rows than output rows")
    out = torch.empty((rows, REC_W), dtype=torch.float32, device=rec.device)
    box = torch.empty((6,), dtype=torch.int32, device=rec.device)
    pos = torch.empty((rows, POS_W), dtype=torch.float32, device=rec.device)
    _launched(_library().imba_select_gather(
        rec.data_ptr(), None if order1 is None else order1.data_ptr(),
        order2.data_ptr(), kept, rows, out.data_ptr(), box.data_ptr(),
        pos.data_ptr(), _stream(rec)), "select_gather")
    LAUNCHES["select_gather"] += 1
    return out, box, pos


def resources(which: str):
    """Registers, shared memory, spills and resident blocks an SM of
    "keys32", "keys64" or "gather" (needs the card)."""
    return st._resources(_library().imba_select_resources,
                         ("keys32", "keys64", "gather").index(which))


# --------------------------------------------------------------------------
# Dispatch
# --------------------------------------------------------------------------

def _cuda(x) -> bool:
    if x.device.type in ("cuda", "cpu"):
        return x.device.type == "cuda"
    raise ValueError(f"unsupported device {x.device}")


def select_keys(src, n: int, order, mode: int, bits):
    """The sort keys from the key columns or the packed rows (`src`): the
    kernel on CUDA tensors, the plain version on CPU tensors."""
    fn = select_keys_cuda if _cuda(src) else select_keys_plain
    return fn(src, n, order, mode, bits)


def select_gather(rec, order1, order2, rows: int):
    """(rows, box, pos): the kernel on CUDA tensors (with the box), the
    plain version on CPU tensors (box None)."""
    fn = select_gather_cuda if _cuda(rec) else select_gather_plain
    return fn(rec, order1, order2, rows)


def select_rows(rec, n: int, capacity: int, *, keys=None, paths=None,
                lengths=None):
    """The working cache's packed rows from the first `n` (valid) rows of
    the packed (C, 24) `rec`: the `capacity` shallowest by (path_length,
    path_id), in (path_id, path_length) order, as (capacity, 24) rows;
    with capacity >= C every valid row in that order, as (C, 24) rows
    (canonicalize).  Rows past the kept count are zero.  `keys`: the
    rows' (C, 2) int32 key columns, which the sort keys read where given
    (else the rows' own columns).  `paths` and `lengths` bound path_id
    and path_length from above (exclusive), which lets the keys take 32
    bits.  Returns (rows, box, pos): box the kept photons' box on the
    card, None on the CPU; pos the rows' (rows, 4) position column."""
    num_c = rec.shape[0]
    src = rec if keys is None else keys
    order1 = None
    if capacity < num_c:
        sk = select_keys(src, n, None, SHALLOW, key_bits(lengths, paths))
        order1 = torch.sort(sk, stable=True)[1][:capacity]
        n, rows = min(n, capacity), capacity
    else:
        rows = num_c
    sk = select_keys(src, n, order1, CANONICAL, key_bits(paths, lengths))
    order2 = torch.sort(sk, stable=True)[1]
    return select_gather(rec, order1, order2, rows)
