"""Light-path vertex cache (torch twin of imbatracer_tpu.render.
light_cache): SoA, fixed capacity, on the cache's device.

The light pass appends its stored vertices in bulk, in the JAX module's
form: slots by an exclusive prefix sum over the valid mask, so the order
is deterministic, and one scatter of the rows into the packed record
buffer of the frame's collect cache (`CollectCache.append`, on the card
a hand-written kernel, ops/light_tail.py), in place and with no host
read, so a CUDA graph can hold it.  Each vertex keeps
what re-evaluating its BSDF at connection time needs (position,
outgoing direction, shading and geometric normals, uv, material id)
plus throughput and the dVC / dVCM / dVM partial MIS weights.

Unlike the JAX module, a cache that overflows raises instead of dropping
the rows past the capacity silently: the rows that did not fit are
counted on the device (`lost`), and the frame reads
that count once, after its light pass (`CollectCache.check`).  The
renderer sizes its collect cache to hold every vertex a frame can store
(vcm.py) and selects the working set with `select_shallowest`, so
nothing is lost.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops import light_tail
from ..tensors import TensorData

# Columns of the (C, 24) wide record (LightVertexCache.packed).
REC_W = 24
_INT_COLS = (14, 21, 22)          # mat_id, path_length, path_id (i32 bits)
_I32_MAX = 2 ** 31 - 1


@dataclass
class LightVertexCache(TensorData):
    pos: torch.Tensor          # (C, 3)
    w_out: torch.Tensor        # (C, 3) direction toward the previous vertex
    normal: torch.Tensor       # (C, 3)
    gn: torch.Tensor           # (C, 3)
    uv: torch.Tensor           # (C, 2)
    mat_id: torch.Tensor       # (C,) i32
    throughput: torch.Tensor   # (C, 3)
    d_vc: torch.Tensor         # (C,)
    d_vcm: torch.Tensor        # (C,)
    d_vm: torch.Tensor         # (C,)
    path_length: torch.Tensor  # (C,) i32
    path_id: torch.Tensor      # (C,) i32 global light-path index
    count: torch.Tensor        # () i32 number of valid vertices

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]

    def packed(self) -> torch.Tensor:
        """Wide-record view (C, 24): [pos(0:3), w_out(3:6), normal(6:9),
        gn(9:12), uv(12:14), mat_id(14, i32 bits), throughput(15:18),
        dVC(18), dVCM(19), dVM(20), path_length(21, i32 bits),
        path_id(22, i32 bits), pad(23)]."""
        return pack_batch(self.pos, self.w_out, self.normal, self.gn,
                          self.uv, self.mat_id, self.throughput, self.d_vc,
                          self.d_vcm, self.d_vm, self.path_length,
                          self.path_id)


def _bits(a):
    return a.to(torch.int32).view(torch.float32)[:, None]


def _from_rec(rec, count) -> LightVertexCache:
    ib = lambda c: rec[:, c].contiguous().view(torch.int32)
    return LightVertexCache(
        pos=rec[:, 0:3].contiguous(), w_out=rec[:, 3:6].contiguous(),
        normal=rec[:, 6:9].contiguous(), gn=rec[:, 9:12].contiguous(),
        uv=rec[:, 12:14].contiguous(), mat_id=ib(14),
        throughput=rec[:, 15:18].contiguous(), d_vc=rec[:, 18].contiguous(),
        d_vcm=rec[:, 19].contiguous(), d_vm=rec[:, 20].contiguous(),
        path_length=ib(21), path_id=ib(22), count=count)


def from_rows(rows: torch.Tensor, capacity: int) -> LightVertexCache:
    """A cache of max(len(rows), capacity) slots whose valid vertices are
    the packed (N, 24) `rows`, in their order; the slots after are zero,
    as an empty cache's are."""
    rec = rows.new_zeros((max(rows.shape[0], capacity), REC_W))
    rec[:rows.shape[0]] = rows
    return _from_rec(rec, torch.tensor(rows.shape[0], dtype=torch.int32,
                                       device=rows.device))


def empty_cache(capacity: int, device) -> LightVertexCache:
    rec = torch.zeros((capacity, REC_W), dtype=torch.float32, device=device)
    return _from_rec(rec, torch.zeros((), dtype=torch.int32, device=device))


def pack_batch(pos, w_out, normal, gn, uv, mat_id, throughput, d_vc, d_vcm,
               d_vm, path_length, path_id) -> torch.Tensor:
    """Pack a vertex batch into the (N, 24) wide-record layout of
    LightVertexCache.packed() (ints bitcast into float lanes)."""
    n = pos.shape[0]
    return torch.cat([
        pos, w_out, normal, gn, uv, _bits(mat_id), throughput,
        d_vc[:, None], d_vcm[:, None], d_vm[:, None], _bits(path_length),
        _bits(path_id), torch.zeros((n, 1), dtype=torch.float32,
                                    device=pos.device)], dim=1)


@dataclass
class CollectCache(TensorData):
    """A cache appended in place: packed rows, a row count and a count of
    the rows that did not fit, all on the device."""

    rec: torch.Tensor     # (C + 1, 24) packed rows; row C, the plain
                          # append's trash row, is read by no one
    count: torch.Tensor   # () i32 rows appended
    lost: torch.Tensor    # () i32 rows that did not fit

    @property
    def capacity(self) -> int:
        return self.rec.shape[0] - 1

    def append(self, valid, rows: torch.Tensor):
        """Append the `valid` rows of a packed (N, 24) batch in batch
        order after the current rows, with no host read: each valid row
        goes to slot count + (valid rows before it), and a row past the
        capacity adds to `lost` (ops/light_tail.py: on the card its
        kernel, which writes only the rows that fit; on the CPU its plain
        version, which sends the others to the trash row)."""
        light_tail.collect_append(self.rec, self.count, self.lost, valid,
                                  rows)

    def check(self):
        """Raise if rows did not fit (one host read)."""
        lost = int(self.lost)
        if lost:
            raise RuntimeError(
                f"light vertex cache overflow: {lost} vertices did not fit "
                f"its capacity of {self.capacity}")

    def cache(self) -> LightVertexCache:
        return _from_rec(self.rec[:-1], self.count)


def empty_collect(capacity: int, device) -> CollectCache:
    z = lambda: torch.zeros((), dtype=torch.int32, device=device)
    return CollectCache(torch.zeros((capacity + 1, REC_W),
                                    dtype=torch.float32, device=device),
                        z(), z())


def append_packed(cache: LightVertexCache, valid,
                  rec: torch.Tensor) -> LightVertexCache:
    """Append the `valid` rows of a packed (N, 24) record batch in batch
    order after the cache's current rows (CollectCache.append on a copy
    of the cache).  Raises if they do not fit (one host read)."""
    full = cache.packed()
    collect = CollectCache(torch.cat([full, full[:1]]), cache.count.clone(),
                           torch.zeros_like(cache.count))
    collect.append(valid, rec)
    collect.check()
    return collect.cache()


def append(cache: LightVertexCache, valid, pos, w_out, normal, gn, uv,
           mat_id, throughput, d_vc, d_vcm, d_vm, path_length,
           path_id) -> LightVertexCache:
    """pack_batch + append_packed."""
    return append_packed(
        cache, valid,
        pack_batch(pos, w_out, normal, gn, uv, mat_id, throughput, d_vc,
                   d_vcm, d_vm, path_length, path_id))


def _sorted_by(cache: LightVertexCache, major, minor, rows: int):
    """The first `rows` records in (major, minor) order, invalid rows
    (past the count) last; both keys are non-negative int32 on valid
    rows, so one int64 key orders them."""
    idx = torch.arange(cache.capacity, device=cache.pos.device)
    valid = idx < cache.count
    key = torch.where(valid, major.to(torch.int64) * (1 << 32)
                      + minor.to(torch.int64), _I32_MAX * (1 << 32) + _I32_MAX)
    order = torch.sort(key, stable=True)[1][:rows]
    return cache.packed()[order]


def canonicalize(cache: LightVertexCache) -> LightVertexCache:
    """Sort valid vertices into (path_id, path_length) order, which makes
    the layout, and the RNG-indexed vertex sampling downstream,
    independent of the band schedule."""
    rec = _sorted_by(cache, cache.path_id, cache.path_length, cache.capacity)
    return _from_rec(rec, cache.count)


def select_shallowest(cache: LightVertexCache,
                      capacity: int) -> LightVertexCache:
    """Depth-capped admission: keep the first `capacity` valid vertices in
    (path_length, path_id) order -- the set a single-band append-order
    truncation keeps, under any band schedule -- and return a
    `capacity`-size cache in canonical order."""
    if capacity >= cache.capacity:
        return canonicalize(cache)
    rec = _sorted_by(cache, cache.path_length, cache.path_id, capacity)
    kept = _from_rec(rec, torch.clamp(cache.count, max=capacity))
    return canonicalize(kept)
