"""Light-path vertex cache (torch twin of imbatracer_tpu.render.
light_cache): packed (C, 24) rows of fixed capacity, on the cache's
device, whose columns are views.

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
nothing is lost.  The append also writes each vertex's (path_length,
path_id) pair into the collect cache's (C + 1, 2) int32 key columns (as
the JAX cache keeps both as columns of their own), and the selection's
sort keys read those (on the card two hand-written kernels and the
library sort, ops/select.py); it writes the working cache's packed rows
once.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops import light_tail, select
from ..tensors import TensorData
from ..utils import trace

# Columns of the (C, 24) wide record (LightVertexCache.packed).
REC_W = 24


@dataclass
class LightVertexCache(TensorData):
    """A cache's packed rows and count; its columns are views of the rows
    (LightVertexCache.packed's layout), so nothing is copied to read
    them.  `box`: on the card, the kept photons' box that the selection
    reduced (ops/select.py), which the photon grid's build reads.
    `pos4`: a selected cache's (C, 4) position column (pos and a zero,
    zero past the count), which the photon grid's keys read.  `keys`: a
    collect cache's key columns (CollectCache.cache), whose first `count`
    rows hold the rows' (path_length, path_id), or None."""

    rec: torch.Tensor          # (C, 24) packed rows
    count: torch.Tensor        # () i32 number of valid vertices
    box: torch.Tensor = None   # (6,) i32 (ops/select.select_gather_cuda)
    keys: torch.Tensor = None  # (C, 2) i32 (path_length, path_id)
    pos4: torch.Tensor = None  # (C, 4) f32 (ops/select.select_gather)

    @property
    def capacity(self) -> int:
        return self.rec.shape[0]

    def packed(self) -> torch.Tensor:
        """Wide-record view (C, 24): [pos(0:3), w_out(3:6), normal(6:9),
        gn(9:12), uv(12:14), mat_id(14, i32 bits), throughput(15:18),
        dVC(18), dVCM(19), dVM(20), path_length(21, i32 bits),
        path_id(22, i32 bits), pad(23)]."""
        return self.rec

    pos = property(lambda self: self.rec[:, 0:3])
    w_out = property(lambda self: self.rec[:, 3:6])   # toward the previous
    normal = property(lambda self: self.rec[:, 6:9])
    gn = property(lambda self: self.rec[:, 9:12])
    uv = property(lambda self: self.rec[:, 12:14])
    mat_id = property(lambda self: self.rec[:, 14].view(torch.int32))
    throughput = property(lambda self: self.rec[:, 15:18])
    d_vc = property(lambda self: self.rec[:, 18])
    d_vcm = property(lambda self: self.rec[:, 19])
    d_vm = property(lambda self: self.rec[:, 20])
    path_length = property(lambda self: self.rec[:, 21].view(torch.int32))
    path_id = property(lambda self: self.rec[:, 22].view(torch.int32))


def _bits(a):
    return a.to(torch.int32).view(torch.float32)[:, None]


def from_rows(rows: torch.Tensor, capacity: int) -> LightVertexCache:
    """A cache of max(len(rows), capacity) slots whose valid vertices are
    the packed (N, 24) `rows`, in their order; the slots after are zero,
    as an empty cache's are."""
    rec = rows.new_zeros((max(rows.shape[0], capacity), REC_W))
    rec[:rows.shape[0]] = rows
    return LightVertexCache(rec, torch.tensor(
        rows.shape[0], dtype=torch.int32, device=rows.device))


def empty_cache(capacity: int, device) -> LightVertexCache:
    rec = torch.zeros((capacity, REC_W), dtype=torch.float32, device=device)
    return LightVertexCache(rec, torch.zeros((), dtype=torch.int32,
                                             device=device))


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
    """A cache appended in place: packed rows, a row count, a count of the
    rows that did not fit and the rows' key columns, all on the device.
    Nothing reads a key column past the count, so emptying the cache
    leaves them as they are."""

    rec: torch.Tensor     # (C + 1, 24) packed rows; row C, the plain
                          # append's trash row, is read by no one
    count: torch.Tensor   # () i32 rows appended
    lost: torch.Tensor    # () i32 rows that did not fit
    keys: torch.Tensor    # (C + 1, 2) i32 (path_length, path_id) of
                          # each row, row C the trash row

    @property
    def capacity(self) -> int:
        return self.rec.shape[0] - 1

    def append(self, valid, rows: torch.Tensor):
        """Append the `valid` rows of a packed (N, 24) batch in batch
        order after the current rows, with no host read: each valid row
        goes to slot count + (valid rows before it), its (path_length,
        path_id) to the same row of the key columns, and a row past the
        capacity adds to `lost` (ops/light_tail.py: on the card its
        kernel, which writes only the rows that fit; on the CPU its plain
        version, which sends the others to the trash row)."""
        light_tail.collect_append(self.rec, self.count, self.lost, valid,
                                  rows, self.keys)

    def check(self) -> int:
        """Raise if rows did not fit; else return the count of rows (one
        host read of both)."""
        with trace.span("wait:collect"):
            lost, count = torch.stack([self.lost, self.count]).tolist()
        if lost:
            raise RuntimeError(
                f"light vertex cache overflow: {lost} vertices did not fit "
                f"its capacity of {self.capacity}")
        return count

    def cache(self) -> LightVertexCache:
        """The rows as a cache (a view: row C, the trash row, left out),
        with their key columns."""
        return LightVertexCache(self.rec[:-1], self.count,
                                keys=self.keys[:-1])


def empty_collect(capacity: int, device) -> CollectCache:
    z = lambda: torch.zeros((), dtype=torch.int32, device=device)
    return CollectCache(torch.zeros((capacity + 1, REC_W),
                                    dtype=torch.float32, device=device),
                        z(), z(), torch.zeros((capacity + 1, 2),
                                              dtype=torch.int32,
                                              device=device))


def append_packed(cache: LightVertexCache, valid,
                  rec: torch.Tensor) -> LightVertexCache:
    """Append the `valid` rows of a packed (N, 24) record batch in batch
    order after the cache's current rows (CollectCache.append on a copy
    of the cache and of its key columns, or of its rows' own).  Raises if
    they do not fit (one host read)."""
    full = cache.packed()
    keys = select.key_pairs(full) if cache.keys is None else cache.keys
    collect = CollectCache(torch.cat([full, full[:1]]), cache.count.clone(),
                           torch.zeros_like(cache.count),
                           torch.cat([keys, keys[:1]]))
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


def canonicalize(cache: LightVertexCache) -> LightVertexCache:
    """Sort valid vertices into (path_id, path_length) order, which makes
    the layout, and the RNG-indexed vertex sampling downstream,
    independent of the band schedule (select_shallowest with no cut)."""
    return select_shallowest(cache, cache.capacity)


def select_shallowest(cache: LightVertexCache, capacity: int, *,
                      count: int = None, paths: int = None,
                      lengths: int = None) -> LightVertexCache:
    """Depth-capped admission: keep the first `capacity` valid vertices in
    (path_length, path_id) order -- the set a single-band append-order
    truncation keeps, under any band schedule -- and return a
    `capacity`-size cache in canonical order (where capacity >= the
    cache's, every valid vertex in a cache of its size).  The slots past
    the kept vertices are zero.  `count`: the cache's count if the
    caller has it on the host (else one host read); `paths` / `lengths`:
    exclusive bounds of path_id / path_length, for 32-bit sort keys.  On
    the card the keys and the gather are kernels (ops/select.py): the
    keys read the cache's key columns where it has them, else its rows'
    own, and the gather the packed rows as they are, writing the kept
    rows' position column beside them."""
    n = int(cache.count) if count is None else count
    rows, box, pos4 = select.select_rows(cache.rec, n, capacity,
                                         keys=cache.keys, paths=paths,
                                         lengths=lengths)
    kept = (cache.count if capacity >= cache.capacity
            else torch.clamp(cache.count, max=capacity))
    return LightVertexCache(rows, kept, box, pos4=pos4)
