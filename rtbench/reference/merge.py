"""The photon merge: a frozen copy of the plain PyTorch versions in the
program's `ops/merge.py` (the photon grid's build, the query
preparation, the exact fixed-radius gather with the Epanechnikov kernel
and its MIS weights), which its hand-written kernels compute on the
card.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .sampling import local_coordinates
from .tensors import TensorData

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


def prepare_queries(grid: MergeGrid, qpos, normal, gn, w_out, params, d_vcm,
                    d_vm, active):
    """(qrec (Q, 40) sorted by anchor key, perm (Q,) int64): the gather's
    input rows, row i for the caller's query perm[i].  The plain version
    of prepare_cuda."""
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
                pair_batch: int = 1 << 20):
    """Plain PyTorch version of the kernel: every (query, photon) pair of
    `pair_chunks` through the kernel's arithmetic (pair_terms), summed
    per query."""
    dev = qrec.device
    num_q = qrec.shape[0]
    mask = kind_mask(kinds)
    r2, eta_vc = scal[0], scal[1]
    photons = photon_rows(grid)
    out = torch.zeros((num_q, 8), dtype=torch.float32, device=dev)
    for qi, pidx in pair_chunks(qrec, grid.keys, mask, pair_batch):
        q = qrec[qi]
        contrib, _, _, _ = pair_terms(q, photons[pidx], r2, eta_vc, mask,
                                      ppm)
        out[:, 0:3].index_add_(0, qi, contrib)
    return out


def merge_contrib(grid: MergeGrid, qpos, normal, gn, w_out, params, d_vcm,
                  d_vm, active, mis_eta_vc, *, kinds: tuple, ppm: bool):
    """Per-query merged photon contribution (Q, 3) in the caller's order;
    the caller applies throughput and the 2 / (pi r^2 n_paths)
    normalisation (the program's plain route)."""
    args = (grid, qpos, normal, gn, w_out, params, d_vcm, d_vm, active)
    scal = scalars(grid, mis_eta_vc)
    qrec, perm = prepare_queries(*args)
    out = torch.empty((qrec.shape[0], 8), dtype=torch.float32,
                      device=qpos.device)
    out[perm] = merge_plain(qrec, grid, scal, kinds, ppm)
    return out[:, 0:3]


def photon_grid(rec, count, radius) -> MergeGrid:
    """The merge grid of a working cache: the first `count` (0-d i32) of
    its packed (P, 24) rows `rec` are the photons (pos 0:3, w_in 3:6,
    throughput 15:18, d_vcm 19, d_vm 20)."""
    radius = torch.as_tensor(radius, dtype=torch.float32, device=rec.device)
    valid = torch.arange(rec.shape[0], device=rec.device) < count
    return build_merge_grid(rec[:, 0:3], valid, radius, rec[:, 3:6],
                            rec[:, 15:18], rec[:, 19], rec[:, 20])
