"""Vertex merging's photon gather: the photon grid, the query preparation,
the hand-written CUDA kernel and its plain PyTorch version.

Replaces the TPU kernel imbatracer_tpu/ops/pallas_merge.py::_make_kernel
(via _merge_call / merge_contrib): per query vertex, the sum over the
photons of its 2x2x2 cell block that lie within the merge radius of
throughput * f * w * max(1 - d^2 / r^2, 0), with f, pdf_dir and pdf_rev
the inline diffuse / glossy / Phong / Oren-Nayar BSDF terms and w the
partial MIS weight of vertex merging (w = 1 for PPM).

Photon grid (`build_merge_grid`, the JAX layout bit for bit): photons
sorted by the linear cell key (x * 256 + y) * 256 + z (256 cells an
axis, cell >= 2r), packed component-major into (T, 16, PT) tiles; photon
i's row r is tiles[i // PT, r, i % PT].  Rows: pos 0:3 (BIG for
padding), cell key 3 (PAD_KEY for padding), w_in 4:7, throughput 7:10,
d_vcm 10, d_vm 11, pad 12:16.

Queries (`prepare_queries`, and on the card `prepare_cuda`, as
merge_contrib prepares them): the (Q, 40) records of pallas_merge.py's
QREC layout, sorted by anchor key: pos 0:3,
tangent 3:6, bitangent 6:9, shading normal 9:12, geometric normal 12:15,
w_out in the local frame 15:18, s_o = w_out . gn 18, d_vcm 19, d_vm 20,
kind 21, kd 22:25, ks 25:28, ns 28, the four combo cell keys 29:33 (f32;
-2 = combo invalid or query inactive), active 33, pad 34:40.  A query
pairs with the photons whose key is k or k + 1 for one of its valid
combo keys k (the z pair of the 2x2x2 block is two adjacent keys).

Output rows (Q, 8): columns 0:3 the summed contribution, 3:8 zero.  A
query that is inactive, or whose kind is not one of the non-delta kinds
present in the scene (`kinds`, diffuse always on), sums nothing.

Photon grid on the card (`photon_grid` of a working cache's packed
rows): two hand-written kernels around the library's stable sort
(csrc/grid_build.cu), the counterpart of JAX's jitted build_merge_grid
(imbatracer_tpu/ops/pallas_merge.py:135): grid_keys_kernel writes the
cell keys from the position column the selection's gather writes and
the scalars from the box it reduced (ops/select.py), grid_tiles_kernel
the tiles and padded keys straight from the sorted order.  Their plain
versions are grid_keys_plain and grid_tiles_plain, build_merge_grid's
head and tail.

Dispatch: `merge_contrib` (query preparation, gather), `merge_rows`
(the gather on sorted rows) and `photon_grid` run the kernels
(csrc/merge_kernel.cu, csrc/grid_build.cu) for CUDA tensors and the
plain versions for CPU tensors; nothing falls back from one to the
other.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from ..core.sampling import local_coordinates
from ..libbuild import NativeLib
from ..tensors import TensorData
from . import stream_traverse as st

GRID = 256            # cells per axis (keys < 2^24, exact in f32)
PAD_KEY = 1 << 25     # > any real key, exact in f32
PT = 256              # photons per tile
PREC_ROWS = 16
QREC_W = 40
REC_W = 24            # a light-cache row (render/light_cache.py REC_W)
POS_W = 4             # the selection's position column (ops/select.py)
BIG = 1e30
INV_PI = 1.0 / math.pi
INVALID = -2
INACTIVE_KEY = 1 << 30   # an inactive query's sort key: after every cell

MAT_DIFFUSE = 0
MAT_GLOSSY = 3
MAT_PHONG = 4
MAT_OREN_NAYAR = 5
# Non-delta kinds the merge evaluates, in the kernel's kind-mask bits.
MERGE_KINDS = (MAT_DIFFUSE, MAT_GLOSSY, MAT_PHONG, MAT_OREN_NAYAR)

# Launch counts: one per kernel launch on the CUDA route ("merge" the
# gather, PREP_KERNELS the query preparation's sort keys, inverse
# permutation and rows, "grid_keys" and "grid_tiles" the photon grid's
# build), one per call of a plain version (PLAIN_KEYS).  chip_smoke.py
# reads them to show the main path ran through the kernels.
PREP_KERNELS = ("prep_keys", "prep_inverse", "prep_rows")
GRID_KERNELS = ("grid_keys", "grid_tiles")
PLAIN_KEYS = ("plain", "prep_plain", "prep_keys_plain", "prep_inverse_plain",
              "grid_keys_plain", "grid_tiles_plain")
LAUNCHES = dict.fromkeys(("merge",) + PREP_KERNELS + GRID_KERNELS
                         + PLAIN_KEYS, 0)

# Counter slots of a counting launch (csrc/merge_kernel.cu): photons
# examined (in a combo key range of a live query), those within the
# radius, those on the query's side by the query's kind (the BSDF
# evaluations), and the pairs accepted into the sum.
WORK_SLOTS = ("examined", "in_radius", "bsdf_diffuse", "bsdf_glossy",
              "bsdf_phong", "bsdf_oren_nayar", "accepted")


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclass
class MergeGrid(TensorData):
    """Photon store of one frame (build_merge_grid)."""

    tiles: torch.Tensor       # (T, 16, PT) f32 component-major photon tiles
    keys: torch.Tensor        # (T*PT,) i32 sorted cell keys, PAD at the end
    bbox_min: torch.Tensor    # (3,)
    inv_cell: torch.Tensor    # ()
    radius_sqr: torch.Tensor  # ()


def build_merge_grid(pos, valid, radius, w_in, throughput, d_vcm,
                     d_vm) -> MergeGrid:
    """Sort photons by linear cell key and pack the tiles.  pos (P, 3);
    valid (P,) bool; radius scalar; w_in / throughput (P, 3); d_vcm /
    d_vm (P,).  P is padded up to a PT multiple.  The plain version of
    the grid's build: grid_keys_plain, the library's stable sort,
    grid_tiles_plain."""
    radius = torch.as_tensor(radius, dtype=torch.float32, device=pos.device)
    key, bbox_min, inv_cell = grid_keys_plain(pos, valid, radius)
    keys_sorted, order = torch.sort(key, stable=True)
    tiles, keys = grid_tiles_plain(keys_sorted, order, pos, valid, w_in,
                                   throughput, d_vcm, d_vm)
    return MergeGrid(tiles=tiles, keys=keys, bbox_min=bbox_min,
                     inv_cell=inv_cell, radius_sqr=radius * radius)


def grid_keys_plain(pos, valid, radius):
    """The grid build's head: (key (P,) i32 linear cell keys, PAD_KEY for
    an invalid photon; bbox_min (3,); inv_cell ()), radius a 0-d f32
    tensor."""
    LAUNCHES["grid_keys_plain"] += 1
    v3 = valid[:, None]
    bbox_min = torch.where(v3, pos, BIG).amin(dim=0)
    bbox_max = torch.where(v3, pos, -BIG).amax(dim=0)
    any_valid = valid.any()
    bbox_min = torch.where(any_valid, bbox_min, 0.0)
    bbox_max = torch.where(any_valid, bbox_max, 1.0)
    ext = bbox_max - bbox_min
    # bbox_min - ext * 1e-3 rounded once, as the fused multiply-add XLA
    # makes of it, so that the grid is the JAX package's bit for bit.
    eps = torch.tensor(1e-3, dtype=torch.float32).item()
    bbox_min = (bbox_min.double() - ext.double() * eps).float() - 1e-6
    # Cell >= 2r (the 2x2x2 cover) and large enough that the grid fits
    # GRID^3: cells beyond the clamp would alias into boundary cells.
    cell = torch.maximum(2.0 * radius, ext.amax() * 1.01 / GRID)
    inv_cell = 1.0 / torch.clamp(cell, min=1e-12)

    c = _clamp_cells(torch.floor((pos - bbox_min) * inv_cell))
    key = (c[:, 0] * GRID + c[:, 1]) * GRID + c[:, 2]
    return torch.where(valid, key, PAD_KEY), bbox_min, inv_cell


def grid_tiles_plain(keys_sorted, order, pos, valid, w_in, throughput, d_vcm,
                     d_vm):
    """The grid build's tail: (tiles (T, 16, PT), keys (T * PT,) i32) of
    the photons in the sorted order (keys_sorted, order: the stable sort
    of grid_keys_plain's keys), padded to whole tiles."""
    LAUNCHES["grid_tiles_plain"] += 1
    dev = pos.device
    num_p = pos.shape[0]
    vs = valid[order]
    rec = torch.cat([
        torch.where(vs[:, None], pos[order], BIG),
        keys_sorted.to(torch.float32)[:, None],
        w_in[order], throughput[order], d_vcm[order][:, None],
        d_vm[order][:, None],
        torch.zeros((num_p, PREC_ROWS - 12), dtype=torch.float32, device=dev),
    ], dim=1)
    pad = (-num_p) % PT
    if pad:
        prow = torch.zeros((pad, PREC_ROWS), dtype=torch.float32, device=dev)
        prow[:, 0:3] = BIG
        prow[:, 3] = float(PAD_KEY)
        rec = torch.cat([rec, prow], dim=0)
        keys_sorted = torch.cat([keys_sorted, torch.full(
            (pad,), PAD_KEY, dtype=torch.int32, device=dev)])
    num_t = rec.shape[0] // PT
    tiles = rec.T.reshape(PREC_ROWS, num_t, PT).permute(1, 0, 2).contiguous()
    return tiles, keys_sorted.to(torch.int32).contiguous()


def _to_cells(f):
    """Floored cell coordinates -> int32, saturated to [-1, GRID] first so
    the cast stays in range (the JAX cast saturates)."""
    return torch.clamp(f, -1.0, float(GRID)).to(torch.int32)


def _clamp_cells(f):
    return torch.clamp(_to_cells(f), 0, GRID - 1)


# --------------------------------------------------------------------------
# Query preparation (torch ops on either device)
# --------------------------------------------------------------------------

def combo_keys(grid: MergeGrid, qpos, active):
    """(Q, 4) i32 keys of the 2x2x2 block's four (x, y) combos, anchored
    at floor(cell - 0.5); z rides as key + 1.  Combos that the clamp
    collapsed onto an earlier one, and every combo of an inactive query,
    are INVALID."""
    m = _to_cells(torch.floor((qpos - grid.bbox_min) * grid.inv_cell - 0.5))
    a0 = torch.clamp(m, 0, GRID - 1)
    a1 = torch.clamp(m + 1, 0, GRID - 1)
    x0, y0, z0 = a0[:, 0], a0[:, 1], a0[:, 2]
    x1, y1 = a1[:, 0], a1[:, 1]
    k00 = (x0 * GRID + y0) * GRID + z0
    k01 = (x0 * GRID + y1) * GRID + z0
    k10 = (x1 * GRID + y0) * GRID + z0
    k11 = (x1 * GRID + y1) * GRID + z0
    same_x, same_y = x1 == x0, y1 == y0
    k01 = torch.where(same_y, INVALID, k01)
    k10 = torch.where(same_x, INVALID, k10)
    k11 = torch.where(same_x | same_y, INVALID, k11)
    keys = torch.stack([k00, k01, k10, k11], dim=1)
    return torch.where(active[:, None], keys, INVALID)


def _anchor_sort_key(keys, active):
    return torch.where(active, keys[:, 0], INACTIVE_KEY)


def sort_keys_plain(grid: MergeGrid, qpos, active):
    """(Q,) i32 anchor sort keys: each query's first combo key,
    INACTIVE_KEY for an inactive one.  The plain version of
    sort_keys_cuda."""
    LAUNCHES["prep_keys_plain"] += 1
    return _anchor_sort_key(combo_keys(grid, qpos, active), active)


def inverse_plain(perm):
    """(Q,) i32 inv with inv[perm[i]] = i.  The plain version of
    inverse_cuda."""
    LAUNCHES["prep_inverse_plain"] += 1
    inv = torch.empty(perm.shape, dtype=torch.int32, device=perm.device)
    inv[perm] = torch.arange(perm.shape[0], dtype=torch.int32,
                             device=perm.device)
    return inv


def prepare_queries(grid: MergeGrid, qpos, normal, gn, w_out, params, d_vcm,
                    d_vm, active):
    """(qrec (Q, 40) sorted by anchor key, perm (Q,) int64): the gather's
    input rows, row i for the caller's query perm[i].  The plain version
    of prepare_cuda."""
    LAUNCHES["prep_plain"] += 1
    num_q = qpos.shape[0]
    keys = combo_keys(grid, qpos, active)
    perm = torch.sort(_anchor_sort_key(keys, active), stable=True)[1]

    t, b = local_coordinates(normal)
    proj = lambda v, a: (v[:, 0] * a[:, 0] + v[:, 1] * a[:, 1]
                         + v[:, 2] * a[:, 2])[:, None]
    qrec = torch.cat([
        qpos, t, b, normal, gn,
        proj(w_out, t), proj(w_out, b), proj(w_out, normal), proj(w_out, gn),
        d_vcm[:, None], d_vm[:, None],
        params["kind"].to(torch.float32)[:, None],
        params["kd"], params["ks"], params["ns"][:, None],
        keys.to(torch.float32), active.to(torch.float32)[:, None],
        torch.zeros((num_q, QREC_W - 34), dtype=torch.float32,
                    device=qpos.device),
    ], dim=1)
    return qrec[perm].contiguous(), perm


def kind_mask(kinds: tuple) -> int:
    """The kernel's kind bits: diffuse always, and each non-delta kind
    present in `kinds` (all of them for `()`)."""
    present = MERGE_KINDS if not kinds else kinds
    return (1 << MAT_DIFFUSE) | sum(1 << k for k in MERGE_KINDS[1:]
                                    if k in present)


def scalars(grid: MergeGrid, mis_eta_vc):
    """The kernel's (2,) f32 scalar row [r^2, eta_vc] on the grid's
    device."""
    eta = torch.as_tensor(mis_eta_vc, dtype=torch.float32,
                          device=grid.tiles.device)
    return torch.stack([grid.radius_sqr.reshape(()), eta.reshape(())])


# --------------------------------------------------------------------------
# The plain PyTorch version
# --------------------------------------------------------------------------

def pair_terms(q, p, r2, eta_vc, mask: int, ppm: bool):
    """Per (query, photon) pair: (contribution (N, 3), in_radius,
    same_side, accepted).  q: (N, 40) query rows, p: (N, 16) photon rows.
    Every product and sum is its own op, in the kernel's order."""
    col = lambda c: q[:, c]
    row = lambda r: p[:, r]
    dxx, dyy, dzz = row(0) - col(0), row(1) - col(1), row(2) - col(2)
    d2 = dxx * dxx + dyy * dyy + dzz * dzz
    in_radius = d2 <= r2

    wix, wiy, wiz = row(4), row(5), row(6)
    li_x = wix * col(3) + wiy * col(4) + wiz * col(5)
    li_y = wix * col(6) + wiy * col(7) + wiz * col(8)
    li_z = wix * col(9) + wiy * col(10) + wiz * col(11)
    s_i = wix * col(12) + wiy * col(13) + wiz * col(14)
    lox, loy, loz = col(15), col(16), col(17)
    same = in_radius & (col(18) * s_i > 0.0) & (loz * li_z > 0.0)

    kind, ns = col(21), col(28)
    abs_liz, abs_loz = torch.abs(li_z), torch.abs(loz)
    pdf_cos_dir = abs_liz * INV_PI
    pdf_cos_rev = abs_loz * INV_PI
    zero = torch.zeros_like(d2)
    is_diff = kind == float(MAT_DIFFUSE)
    a_term = torch.where(is_diff, INV_PI, zero)
    b_term = zero
    pdf_dir = torch.where(is_diff, pdf_cos_dir, zero)
    pdf_rev = torch.where(is_diff, pdf_cos_rev, zero)

    if mask & (1 << MAT_GLOSSY):
        hx, hy, hz = lox + li_x, loy + li_y, loz + li_z
        h_len = torch.sqrt(torch.clamp(hx * hx + hy * hy + hz * hz,
                                       min=1e-20))
        hzn = hz / h_len
        o_dot_h = (lox * hx + loy * hy + loz * hz) / h_len
        i_dot_h = (li_x * hx + li_y * hy + li_z * hz) / h_len
        c2 = i_dot_h * i_dot_h
        nn1 = 1.0 + ns * ns
        ekc = nn1 * c2
        two_ec = 2.0 * i_dot_h
        fr = 0.5 * ((ekc - two_ec + 1.0) / (ekc + two_ec + 1.0)
                    + (nn1 - two_ec + c2) / (nn1 + two_ec + c2))
        abs_hz = torch.abs(hzn)
        pow_h = torch.pow(torch.clamp(abs_hz, min=1e-12), ns)
        d_blinn = (ns + 2.0) / (2.0 * math.pi) * pow_h
        odh = torch.clamp(o_dot_h, min=1e-12)
        g = torch.clamp(torch.minimum(2.0 * abs_hz * abs_loz / odh,
                                      2.0 * abs_hz * abs_liz / odh), max=1.0)
        ct = (d_blinn * g * fr) / (
            4.0 * torch.clamp(abs_liz * abs_loz, min=1e-12))
        pdf_h = torch.where(o_dot_h > 0.0, (ns + 1.0) * pow_h / (
            2.0 * math.pi * 4.0 * odh), zero)
        idh = torch.clamp(i_dot_h, min=1e-12)
        pdf_h_rev = torch.where(i_dot_h > 0.0, (ns + 1.0) * pow_h / (
            2.0 * math.pi * 4.0 * idh), zero)
        is_gl = kind == float(MAT_GLOSSY)
        a_term = torch.where(is_gl, 0.5 * INV_PI, a_term)
        b_term = torch.where(is_gl, 0.5 * ct, b_term)
        pdf_dir = torch.where(is_gl, 0.5 * (pdf_h + pdf_cos_dir), pdf_dir)
        pdf_rev = torch.where(is_gl, 0.5 * (pdf_h_rev + pdf_cos_rev), pdf_rev)

    if mask & (1 << MAT_PHONG):
        cos_ro = torch.clamp(-li_x * lox - li_y * loy + li_z * loz, 0.0, 1.0)
        powc = torch.pow(cos_ro, ns)
        is_ph = kind == float(MAT_PHONG)
        a_term = torch.where(is_ph, zero, a_term)
        b_term = torch.where(is_ph, (ns + 2.0) / (2.0 * math.pi) * powc,
                             b_term)
        pdf_ph = (ns + 1.0) / (2.0 * math.pi) * powc
        pdf_dir = torch.where(is_ph, pdf_ph, pdf_dir)
        pdf_rev = torch.where(is_ph, pdf_ph, pdf_rev)

    if mask & (1 << MAT_OREN_NAYAR):
        sigma = ns * (math.pi / 180.0)
        s2 = sigma * sigma
        a_on = 1.0 - s2 / (2.0 * (s2 + 0.33))
        b_on = 0.45 * s2 / (s2 + 0.09)
        st_i = torch.sqrt(torch.clamp(1.0 - li_z * li_z, min=0.0))
        st_o = torch.sqrt(torch.clamp(1.0 - loz * loz, min=0.0))
        denom = torch.clamp(st_i * st_o, min=1e-6)
        cos_dphi = (li_x * lox + li_y * loy) / denom
        max_cos = torch.where((st_i > 1e-4) & (st_o > 1e-4),
                              torch.clamp(cos_dphi, min=0.0), zero)
        big_i = abs_liz > abs_loz
        sin_alpha = torch.where(big_i, st_o, st_i)
        tan_beta = torch.where(big_i, st_i / torch.clamp(abs_liz, min=1e-6),
                               st_o / torch.clamp(abs_loz, min=1e-6))
        is_on = kind == float(MAT_OREN_NAYAR)
        a_term = torch.where(
            is_on, INV_PI * (a_on + b_on * max_cos * sin_alpha * tan_beta),
            a_term)
        pdf_dir = torch.where(is_on, pdf_cos_dir, pdf_dir)
        pdf_rev = torch.where(is_on, pdf_cos_rev, pdf_rev)

    f = torch.stack([col(22 + c) * a_term + col(25 + c) * b_term
                     for c in range(3)], dim=1)
    ok = (same & (pdf_dir > 0.0) & (pdf_rev > 0.0)
          & ((f[:, 0] != 0.0) | (f[:, 1] != 0.0) | (f[:, 2] != 0.0)))
    if ppm:
        w = torch.ones_like(d2)
    else:
        w_light = row(10) * eta_vc + row(11) * pdf_dir
        w_cam = col(19) * eta_vc + col(20) * pdf_rev
        w = 1.0 / (w_light + 1.0 + w_cam)
    epan = torch.clamp(1.0 - d2 * (1.0 / torch.clamp(r2, min=1e-30)),
                       min=0.0)
    wk = torch.where(ok, w * epan, zero)
    contrib = torch.stack([row(7 + c) * f[:, c] * wk for c in range(3)],
                          dim=1)
    return contrib, in_radius, same, ok


def live_rows(qrec, mask: int):
    """(Q,) bool: the queries that sum something (active, and of a kind
    the kernel's mask enables)."""
    kind = qrec[:, 21]
    enabled = torch.zeros_like(kind, dtype=torch.bool)
    for k in MERGE_KINDS:
        if mask & (1 << k):
            enabled = enabled | (kind == float(k))
    return (qrec[:, 33] > 0.5) & enabled


def photon_ranges(qrec, keys, mask: int):
    """(lo, hi) (Q, 4) int64: the photon index range [lo, hi) of each
    combo key pair {k, k + 1}; empty for invalid combos and for queries
    that sum nothing."""
    k = qrec[:, 29:33].to(torch.int32).contiguous()
    ok = (k >= 0) & live_rows(qrec, mask)[:, None]
    lo = torch.searchsorted(keys, k)
    hi = torch.searchsorted(keys, k + 2)
    return lo, torch.where(ok, hi, lo)


def photon_rows(grid: MergeGrid):
    """(T*PT, 16) view of the tiles, one row per photon slot."""
    return grid.tiles.permute(0, 2, 1).reshape(-1, PREC_ROWS)


def pair_chunks(qrec, keys, mask: int, pair_batch: int = 1 << 20):
    """Yields (query index, photon index) of every pair of the combo
    ranges (photon_ranges), in the kernel's order (query-major, combo
    0..3, ascending photon index), at most `pair_batch` pairs at a time."""
    lo, hi = photon_ranges(qrec, keys, mask)
    counts = (hi - lo).reshape(-1)                    # (Q*4,) query-major
    ends = torch.cumsum(counts, 0)
    starts = ends - counts
    total = int(ends[-1]) if counts.numel() else 0
    lo_flat = lo.reshape(-1)
    for p0 in range(0, total, pair_batch):
        pair = torch.arange(p0, min(p0 + pair_batch, total),
                            device=qrec.device)
        seg = torch.searchsorted(ends, pair, right=True)
        yield seg // 4, lo_flat[seg] + (pair - starts[seg])


def merge_plain(qrec, grid: MergeGrid, scal, kinds: tuple, ppm: bool,
                work=None, pair_batch: int = 1 << 20):
    """Plain PyTorch version of the kernel: every (query, photon) pair of
    `pair_chunks` through the kernel's arithmetic (pair_terms), summed
    per query.  With `work`, adds the kernel's WORK_SLOTS tallies to it."""
    LAUNCHES["plain"] += 1
    dev = qrec.device
    num_q = qrec.shape[0]
    mask = kind_mask(kinds)
    r2, eta_vc = scal[0], scal[1]
    photons = photon_rows(grid)
    out = torch.zeros((num_q, 8), dtype=torch.float32, device=dev)
    tallies = torch.zeros(len(WORK_SLOTS), dtype=torch.int64, device=dev)
    for qi, pidx in pair_chunks(qrec, grid.keys, mask, pair_batch):
        q = qrec[qi]
        contrib, in_r, same, ok = pair_terms(q, photons[pidx], r2, eta_vc,
                                             mask, ppm)
        out[:, 0:3].index_add_(0, qi, contrib)
        kind = q[:, 21]
        tallies += torch.stack([
            torch.tensor(qi.shape[0], device=dev), in_r.sum(),
            *[(same & (kind == float(k))).sum() for k in MERGE_KINDS],
            ok.sum()])
    if work is not None:
        work += tallies
    return out


# --------------------------------------------------------------------------
# The CUDA kernel
# --------------------------------------------------------------------------

LIB = NativeLib("merge_kernel", "merge_kernel.cu")

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(LIB.build())
        vp, i = ctypes.c_void_p, ctypes.c_int
        for name, args in (
                ("imba_merge", [vp, i, vp, i, vp, vp, i, i, vp, vp, vp, vp]),
                ("imba_merge_sort_keys", [vp] * 4 + [i, vp, vp]),
                ("imba_merge_inverse", [vp, i, vp, vp]),
                ("imba_merge_query_rows", [vp] * 14 + [i, vp, vp])):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = args
        _lib = lib
    return _lib


def _check(name, x, dtype, shape, device):
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if x.device.type != "cuda" or x.device != device:
        raise ValueError(f"{name}: must be on the queries' CUDA device")


def _launched(err, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


# The preparation's query columns in the order of imba_merge_query_rows.
PREP_COLUMNS = ("qpos", "normal", "gn", "w_out", "kind", "kd", "ks", "ns",
                "d_vcm", "d_vm", "active")


def prep_inputs(grid: MergeGrid, qpos, normal, gn, w_out, params, d_vcm,
                d_vm, active):
    """The preparation kernels' inputs by name (PREP_COLUMNS, bbox_min,
    inv_cell), checked: f32 but kind int32 and active bool, contiguous,
    on the queries' CUDA device (raises otherwise).  Columns that already
    are so are passed as they are: the camera pass's are, so nothing is
    copied on the frame's path."""
    dev = qpos.device
    num_q = qpos.shape[0]
    f32 = lambda x: x.to(torch.float32).contiguous()
    args = dict(qpos=f32(qpos), normal=f32(normal), gn=f32(gn),
                w_out=f32(w_out), kind=params["kind"].to(
                    torch.int32).contiguous(), kd=f32(params["kd"]),
                ks=f32(params["ks"]), ns=f32(params["ns"]), d_vcm=f32(d_vcm),
                d_vm=f32(d_vm), active=active.to(torch.bool).contiguous(),
                bbox_min=f32(grid.bbox_min), inv_cell=f32(grid.inv_cell))
    shapes = dict(kind=(num_q,), ns=(num_q,), d_vcm=(num_q,), d_vm=(num_q,),
                  active=(num_q,), bbox_min=(3,), inv_cell=())
    for name, x in args.items():
        _check(name, x, x.dtype, shapes.get(name, (num_q, 3)), dev)
    return args


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def sort_keys_cuda(args):
    """Launch merge_sort_key_kernel on prep_inputs' `args`: sort_keys_plain's
    (Q,) i32 keys."""
    q = args["qpos"]
    sort_key = torch.empty((q.shape[0],), dtype=torch.int32, device=q.device)
    _launched(_library().imba_merge_sort_keys(
        q.data_ptr(), args["active"].data_ptr(), args["bbox_min"].data_ptr(),
        args["inv_cell"].data_ptr(), q.shape[0], sort_key.data_ptr(),
        _stream(q.device)), "merge sort keys")
    LAUNCHES["prep_keys"] += 1
    return sort_key


def inverse_cuda(perm):
    """Launch merge_inverse_kernel on a CUDA permutation (Q,) int64
    (raises on anything else): inverse_plain's (Q,) i32."""
    num_q = perm.numel()
    _check("perm", perm, torch.int64, (num_q,), perm.device)
    inv = torch.empty((num_q,), dtype=torch.int32, device=perm.device)
    _launched(_library().imba_merge_inverse(
        perm.data_ptr(), num_q, inv.data_ptr(), _stream(perm.device)),
        "merge inverse")
    LAUNCHES["prep_inverse"] += 1
    return inv


def query_rows_cuda(args, inv):
    """Launch merge_query_rows_kernel on prep_inputs' `args` and the
    inverse permutation `inv` (Q,) int32 of the sort: (Q, 40) rows, query
    q's in row inv[q]."""
    dev = args["qpos"].device
    num_q = args["qpos"].shape[0]
    _check("inv", inv, torch.int32, (num_q,), dev)
    qrec = torch.empty((num_q, QREC_W), dtype=torch.float32, device=dev)
    _launched(_library().imba_merge_query_rows(
        inv.data_ptr(), *(args[k].data_ptr() for k in PREP_COLUMNS),
        args["bbox_min"].data_ptr(), args["inv_cell"].data_ptr(), num_q,
        qrec.data_ptr(), _stream(dev)), "merge query rows")
    LAUNCHES["prep_rows"] += 1
    return qrec


def prepare_cuda(grid: MergeGrid, qpos, normal, gn, w_out, params, d_vcm,
                 d_vm, active):
    """prepare_queries' (qrec, perm) on CUDA tensors (raises on anything
    else): a kernel writes each query's anchor sort key, torch.sort orders
    them (stable), a kernel inverts the permutation, and a kernel writes
    each query's row, in query order, to its sorted place."""
    args = prep_inputs(grid, qpos, normal, gn, w_out, params, d_vcm, d_vm,
                       active)
    perm = torch.sort(sort_keys_cuda(args), stable=True)[1]
    return query_rows_cuda(args, inverse_cuda(perm)), perm


def merge_cuda(qrec, grid: MergeGrid, scal, kinds: tuple, ppm: bool,
               work=None, perm=None):
    """Launch the gather on CUDA tensors (raises on anything else): (Q, 8)
    rows, query i's in row i, or with `perm` (Q,) int64 in row perm[i].
    With `work`, a zeroed (len(WORK_SLOTS),) int64 tensor, the counting
    instantiation runs instead and adds its tallies to it."""
    dev = qrec.device
    num_q = qrec.shape[0]
    num_t = grid.tiles.shape[0]
    _check("qrec", qrec, torch.float32, (num_q, QREC_W), dev)
    _check("tiles", grid.tiles, torch.float32, (num_t, PREC_ROWS, PT), dev)
    _check("keys", grid.keys, torch.int32, (num_t * PT,), dev)
    _check("scal", scal, torch.float32, (2,), dev)
    if work is not None:
        _check("work", work, torch.int64, (len(WORK_SLOTS),), dev)
    if perm is not None:
        _check("perm", perm, torch.int64, (num_q,), dev)
    lib = _library()
    out = torch.empty((num_q, 8), dtype=torch.float32, device=dev)
    _launched(lib.imba_merge(
        qrec.data_ptr(), num_q, grid.keys.data_ptr(), num_t * PT,
        grid.tiles.data_ptr(), scal.data_ptr(), int(ppm), kind_mask(kinds),
        None if perm is None else perm.data_ptr(), out.data_ptr(),
        None if work is None else work.data_ptr(),
        _stream(dev)), "merge kernel")
    LAUNCHES["merge"] += 1
    return out


def merge_rows(qrec, grid: MergeGrid, scal, kinds: tuple, ppm: bool):
    """(Q, 40) sorted query rows -> (Q, 8) rows: the kernel on CUDA
    tensors, the plain version on CPU tensors."""
    if qrec.device.type == "cuda":
        return merge_cuda(qrec, grid, scal, kinds, ppm)
    if qrec.device.type == "cpu":
        return merge_plain(qrec, grid, scal, kinds, ppm)
    raise ValueError(f"unsupported device {qrec.device}")


def merge_contrib(grid: MergeGrid, qpos, normal, gn, w_out, params, d_vcm,
                  d_vm, active, mis_eta_vc, *, kinds: tuple, ppm: bool):
    """Per-query merged photon contribution (Q, 3) in the caller's order;
    the caller applies throughput and the 2 / (pi r^2 n_paths)
    normalisation.  On CUDA tensors the preparation kernels and the gather,
    which writes each sum straight to its caller's row; on CPU tensors
    their plain versions."""
    args = (grid, qpos, normal, gn, w_out, params, d_vcm, d_vm, active)
    scal = scalars(grid, mis_eta_vc)
    if qpos.device.type == "cuda":
        qrec, perm = prepare_cuda(*args)
        return merge_cuda(qrec, grid, scal, kinds, ppm, perm=perm)[:, 0:3]
    if qpos.device.type == "cpu":
        qrec, perm = prepare_queries(*args)
        out = torch.empty((qrec.shape[0], 8), dtype=torch.float32)
        out[perm] = merge_plain(qrec, grid, scal, kinds, ppm)
        return out[:, 0:3]
    raise ValueError(f"unsupported device {qpos.device}")


# --------------------------------------------------------------------------
# The photon grid's build (csrc/grid_build.cu)
# --------------------------------------------------------------------------

GRID_LIB = NativeLib("grid_build", "grid_build.cu")

_grid_lib = None


def _grid_library():
    global _grid_lib
    if _grid_lib is None:
        lib = ctypes.CDLL(GRID_LIB.build())
        vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        for name, args in (("imba_grid_keys", [vp] * 4 + [i64, vp, vp, vp]),
                           ("imba_grid_tiles", [vp] * 4 + [i64, vp, vp, vp]),
                           ("imba_grid_resources", [i, vp])):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = args
        _grid_lib = lib
    return _grid_lib


def grid_keys_cuda(pos4, count, box, radius):
    """Launch grid_keys_kernel on CUDA tensors (raises on anything else):
    grid_keys_plain's (key, bbox_min, inv_cell) of the first `count`
    (0-d i32) photons of the (P, 4) position column `pos4` (zero past the
    count), from `box` (6,) i32, both the selection's
    (ops/select.select_gather_cuda); radius a 0-d f32 tensor.  Also
    returns radius_sqr; the scalars are views of one (5,) tensor."""
    dev = pos4.device
    rows = pos4.shape[0]
    _check("pos4", pos4, torch.float32, (rows, POS_W), dev)
    if pos4.data_ptr() % 16:
        raise ValueError("pos4: must be 16-byte aligned")
    _check("count", count, torch.int32, (), dev)
    _check("box", box, torch.int32, (6,), dev)
    _check("radius", radius, torch.float32, (), dev)
    key = torch.empty((rows,), dtype=torch.int32, device=dev)
    scal = torch.empty((5,), dtype=torch.float32, device=dev)
    _launched(_grid_library().imba_grid_keys(
        pos4.data_ptr(), count.data_ptr(), box.data_ptr(), radius.data_ptr(),
        rows, key.data_ptr(), scal.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream), "grid keys kernel")
    LAUNCHES["grid_keys"] += 1
    return key, scal[0:3], scal[3], scal[4]


def grid_tiles_cuda(rec, count, keys_sorted, order):
    """Launch grid_tiles_kernel on CUDA tensors (raises on anything else):
    grid_tiles_plain's (tiles, keys) of the packed (P, 24) `rec`, its
    first `count` (0-d i32) rows valid, in the order of the stable sort
    (keys_sorted, order) of grid_keys_cuda's keys."""
    dev = rec.device
    rows = rec.shape[0]
    _check("rec", rec, torch.float32, (rows, REC_W), dev)
    if rec.data_ptr() % 16:
        raise ValueError("rec: must be 16-byte aligned")
    _check("count", count, torch.int32, (), dev)
    _check("keys_sorted", keys_sorted, torch.int32, (rows,), dev)
    _check("order", order, torch.int64, (rows,), dev)
    num_t = -(-rows // PT)
    tiles = torch.empty((num_t, PREC_ROWS, PT), dtype=torch.float32,
                        device=dev)
    keys = torch.empty((num_t * PT,), dtype=torch.int32, device=dev)
    _launched(_grid_library().imba_grid_tiles(
        rec.data_ptr(), count.data_ptr(), keys_sorted.data_ptr(),
        order.data_ptr(), rows, tiles.data_ptr(), keys.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream), "grid tiles kernel")
    LAUNCHES["grid_tiles"] += 1
    return tiles, keys


def grid_resources(which: str):
    """Registers, shared memory, spills and resident blocks an SM of
    "keys" or "tiles" (needs the card)."""
    return st._resources(_grid_library().imba_grid_resources,
                         ("keys", "tiles").index(which))


def photon_grid(rec, count, radius, box=None, pos4=None) -> MergeGrid:
    """The merge grid of a working cache: the first `count` (0-d i32) of
    its packed (P, 24) rows `rec` are the photons (pos 0:3, w_in 3:6,
    throughput 15:18, d_vcm 19, d_vm 20).  On CUDA tensors the two
    kernels around the library sort, with `box` and the (P, 4) position
    column `pos4`, the selection's (render/light_cache.py
    LightVertexCache.box, .pos4); on CPU tensors build_merge_grid on the
    rows' columns."""
    radius = torch.as_tensor(radius, dtype=torch.float32, device=rec.device)
    if rec.device.type == "cpu":
        valid = torch.arange(rec.shape[0]) < count
        return build_merge_grid(rec[:, 0:3], valid, radius, rec[:, 3:6],
                                rec[:, 15:18], rec[:, 19], rec[:, 20])
    if rec.device.type != "cuda":
        raise ValueError(f"unsupported device {rec.device}")
    if box is None or pos4 is None:
        raise ValueError("photon_grid: the card's grid reads the box and "
                         "the position column that the selection's gather "
                         "writes (box or pos4 None)")
    key, bbox_min, inv_cell, radius_sqr = grid_keys_cuda(pos4, count, box,
                                                         radius)
    keys_sorted, order = torch.sort(key, stable=True)
    tiles, keys = grid_tiles_cuda(rec, count, keys_sorted, order)
    return MergeGrid(tiles=tiles, keys=keys, bbox_min=bbox_min,
                     inv_cell=inv_cell, radius_sqr=radius_sqr)
