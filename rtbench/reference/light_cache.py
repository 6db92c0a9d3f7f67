"""The light vertex caches and their selection: a frozen copy of the
program's `render/light_cache.py`, with the plain PyTorch versions of
`ops/select.py` (the selection's sort keys and gather) and
`ops/light_tail.py` (the collect append and the camera splat) that its
kernels compute on the card.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .tensors import TensorData

POS_W = 4                    # the position column's width (x, y, z, 0)
COL_LENGTH, COL_ID = 21, 22  # path_length, path_id (int32 bits)
SHALLOW, CANONICAL = 1, 2    # key modes (csrc kShallow, kCanonical)



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
    src = order2 if order1 is None else order1[order2]
    out = rec.new_zeros((rows, rec.shape[1]))
    out[:src.shape[0]] = rec[src]
    return out, None, torch.nn.functional.pad(out[:, 0:3], (0, POS_W - 3))



def collect_append_plain(rec, count, lost, valid, rows, keys):
    """Append the `valid` rows of a packed (N, 24) batch after the first
    `count` rows of `rec` ((C + 1, 24), row C the trash row), in batch
    order, in place and with no host read: each valid row goes to slot
    count + (valid rows before it), a row past the capacity C to the
    trash row, where it adds to `lost`; count becomes min(total, C).
    `keys`, the (C + 1, 2) int32 key columns, take each row's
    (path_length, path_id) at the same slot."""
    cap = rec.shape[0] - 1
    v = valid.to(torch.int32)
    slot = count + (torch.cumsum(v, 0, dtype=torch.int32) - v)
    target = torch.where(valid & (slot < cap), slot, cap).long()
    rec.index_copy_(0, target, rows)
    keys.index_copy_(0, target, key_pairs(rows))
    total = count + v.sum(dtype=torch.int32)
    lost.add_(torch.clamp(total - cap, min=0))
    count.copy_(torch.clamp(total, max=cap))


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
        sk = select_keys_plain(src, n, None, SHALLOW, key_bits(lengths, paths))
        order1 = torch.sort(sk, stable=True)[1][:capacity]
        n, rows = min(n, capacity), capacity
    else:
        rows = num_c
    sk = select_keys_plain(src, n, order1, CANONICAL, key_bits(paths, lengths))
    order2 = torch.sort(sk, stable=True)[1]
    return select_gather_plain(rec, order1, order2, rows)


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
        collect_append_plain(self.rec, self.count, self.lost, valid,
                                  rows, self.keys)

    def check(self) -> int:
        """Raise if rows did not fit; else return the count of rows (one
        host read of both)."""
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
    rows, box, pos4 = select_rows(cache.rec, n, capacity,
                                         keys=cache.keys, paths=paths,
                                         lengths=lengths)
    kept = (cache.count if capacity >= cache.capacity
            else torch.clamp(cache.count, max=capacity))
    return LightVertexCache(rows, kept, box, pos4=pos4)
