"""The light band's tail: the collect append and the camera splat as two
hand-written CUDA kernels, their plain PyTorch versions, and their
dispatch.

No Pallas kernel stands behind these: JAX runs both inside its compiled
light band (imbatracer_tpu/render/integrators/vcm.py `_vcm_light_band`),
where XLA compiles them as one scatter and one segment sum:

  * `collect_append`: light_cache.append_packed's scatter of the band's
    staged vertex rows after the cache's rows, each valid row to slot
    count + (valid rows before it), the rows past the capacity dropped
    (`mode="drop"`); here the rows that do not fit are counted in `lost`
    (render/light_cache.py says why), and each row's (path_length,
    path_id) pair is also written into the cache's (C + 1, 2) int32 key
    columns, as JAX's cache keeps both as columns of their own, for the
    selection's sort keys (ops/select.py);
  * `splat`: film.splat's segment_sum of the camera connections into a
    fresh film, rows with a pixel id below 0 dropped.

The plain versions are the torch code of render/light_cache.py and
render/film.py as it was, moved here: every row goes somewhere, the
invalid ones and those past the capacity to the collect buffer's trash
row C, the splats with no pixel to a trash pixel.  The kernels
(csrc/light_tail.cu) write only the valid rows; row C stays as it was,
and nothing reads it (CollectCache.cache slices it off).  The append is
one launch: its offsets come from a single-pass scan inside it, not from
the library's prefix sum.

Dispatch: each function launches its kernel on CUDA tensors and runs its
plain version on CPU tensors; nothing falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from ..libbuild import NativeLib
from . import stream_traverse as st
from .select import key_pairs

# Launch counts: one per call of a kernel wrapper on the CUDA route (one
# launch each), one per call of a plain version.  chip_smoke.py reads
# them to show the main paths ran through the kernels.
KERNELS = ("collect_append", "splat")
PLAIN_KEYS = tuple(f"{k}_plain" for k in KERNELS)
LAUNCHES = dict.fromkeys(KERNELS + PLAIN_KEYS, 0)

REC_W = 24                   # render/light_cache.py REC_W (csrc kRecW)
# The most staged rows one append takes: 8,192 tiles of 4,096 rows (csrc
# kMaxTiles, lookback.cuh kTile), the size of its status words.
APPEND_MAX_ROWS = 8192 * 4096


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------------
# The plain PyTorch versions
# --------------------------------------------------------------------------

def collect_append_plain(rec, count, lost, valid, rows, keys):
    """Append the `valid` rows of a packed (N, 24) batch after the first
    `count` rows of `rec` ((C + 1, 24), row C the trash row), in batch
    order, in place and with no host read: each valid row goes to slot
    count + (valid rows before it), a row past the capacity C to the
    trash row, where it adds to `lost`; count becomes min(total, C).
    `keys`, the (C + 1, 2) int32 key columns, take each row's
    (path_length, path_id) at the same slot."""
    LAUNCHES["collect_append_plain"] += 1
    cap = rec.shape[0] - 1
    v = valid.to(torch.int32)
    slot = count + (torch.cumsum(v, 0, dtype=torch.int32) - v)
    target = torch.where(valid & (slot < cap), slot, cap).long()
    rec.index_copy_(0, target, rows)
    keys.index_copy_(0, target, key_pairs(rows))
    total = count + v.sum(dtype=torch.int32)
    lost.add_(torch.clamp(total - cap, min=0))
    count.copy_(torch.clamp(total, max=cap))


def splat_plain(contrib, pixel_id, num_pixels: int):
    """Scatter-add (R, 3) contributions into a fresh (num_pixels, 3) film;
    pixel_id < 0 is dropped (routed to a trash row)."""
    LAUNCHES["splat_plain"] += 1
    pid = torch.where(pixel_id >= 0, pixel_id, num_pixels).long()
    film = torch.zeros((num_pixels + 1, 3), dtype=contrib.dtype,
                       device=contrib.device)
    film.index_add_(0, pid, contrib)
    return film[:num_pixels]


# --------------------------------------------------------------------------
# The CUDA kernels
# --------------------------------------------------------------------------

LIB = NativeLib("light_tail", "light_tail.cu", headers=("lookback.cuh",))

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(LIB.build())
        vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        for name, args in (("imba_collect_append",
                            [vp, vp, i64, vp, vp, i, vp, vp, vp]),
                           ("imba_splat", [vp, vp, i64, i, vp, vp]),
                           ("imba_light_tail_resources", [i, vp])):
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
    `shape` (16-byte aligned with `aligned`)."""
    if (x.device.type != "cuda" or x.dtype != dtype
            or tuple(x.shape) != tuple(shape) or not x.is_contiguous()):
        raise ValueError(f"light_tail: {what} must be a contiguous CUDA "
                         f"{dtype} tensor of shape {tuple(shape)}, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if aligned and x.data_ptr() % 16:
        raise ValueError(f"light_tail: {what} must be 16-byte aligned")
    return x


def collect_append_cuda(rec, count, lost, valid, rows, keys):
    """Launch collect_append_kernel on CUDA tensors, one launch (raises on
    anything else, and above APPEND_MAX_ROWS staged rows):
    collect_append_plain's rows `rec[:C]`, count, lost and key columns
    `keys[:C]`; row C is not written."""
    n = rows.shape[0]
    _check(rec, torch.float32, (rec.shape[0], REC_W), "rec", aligned=True)
    _check(rows, torch.float32, (n, REC_W), "rows", aligned=True)
    _check(valid, torch.bool, (n,), "valid")
    for x, what in ((count, "count"), (lost, "lost")):
        _check(x, torch.int32, (), what)
    _check(keys, torch.int32, (rec.shape[0], 2), "keys")
    if keys.data_ptr() % 8:
        raise ValueError("light_tail: keys must be 8-byte aligned")
    if n > APPEND_MAX_ROWS:
        raise ValueError(f"light_tail: an append takes at most "
                         f"{APPEND_MAX_ROWS} staged rows, got {n}")
    _launched(_library().imba_collect_append(
        rows.data_ptr(), valid.data_ptr(), n, count.data_ptr(),
        lost.data_ptr(), rec.shape[0] - 1, rec.data_ptr(), keys.data_ptr(),
        _stream(rows)),
        "collect_append")
    LAUNCHES["collect_append"] += 1


def splat_cuda(contrib, pixel_id, num_pixels: int):
    """Launch splat_kernel on CUDA tensors (raises on anything else): a
    fresh (num_pixels, 3) film of the rows with a pixel in [0,
    num_pixels), added with atomics."""
    n = contrib.shape[0]
    _check(contrib, torch.float32, (n, 3), "contrib")
    _check(pixel_id, torch.int32, (n,), "pixel_id")
    lib = _library()
    film = torch.zeros((num_pixels, 3), dtype=torch.float32,
                       device=contrib.device)
    _launched(lib.imba_splat(contrib.data_ptr(), pixel_id.data_ptr(), n,
                             num_pixels, film.data_ptr(), _stream(contrib)),
              "splat")
    LAUNCHES["splat"] += 1
    return film


def resources(which: str):
    """Registers, shared memory, spills and resident blocks an SM of
    "collect_append" or "splat" (needs the card)."""
    return st._resources(_library().imba_light_tail_resources,
                         ("collect_append", "splat").index(which))


# --------------------------------------------------------------------------
# Dispatch
# --------------------------------------------------------------------------

def _on(x):
    if x.device.type in ("cuda", "cpu"):
        return x.device.type
    raise ValueError(f"unsupported device {x.device}")


def collect_append(rec, count, lost, valid, rows, keys):
    """The collect append in place, its key columns `keys` too: the
    kernel on CUDA tensors, the plain version on CPU tensors."""
    fn = collect_append_cuda if _on(rows) == "cuda" else collect_append_plain
    fn(rec, count, lost, valid, rows, keys)


def splat(contrib, pixel_id, num_pixels: int):
    """The camera splat into a fresh film: the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    fn = splat_cuda if _on(contrib) == "cuda" else splat_plain
    return fn(contrib, pixel_id, num_pixels)
