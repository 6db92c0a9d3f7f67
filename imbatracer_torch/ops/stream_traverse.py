"""Streaming closest-hit / any-hit traversal over super-chunk feature
tiles: the hand-written CUDA kernel, its plain PyTorch version, and the
torch-side machinery around them (tile packing, per-block candidate
lists, ray sort keys, the sorted dispatch).

Replaces the two TPU kernels of the main path:
  imbatracer_tpu/ops/pallas_stream.py::_make_kernel (instanced=False)
  imbatracer_tpu/ops/pallas_vmem.py::_make_vmem_kernel
Both compute one function over the same `(sbox, tiles)` packing, and so
does `csrc/stream_traverse.cu` (its header note says what bounds it).

Layouts (shared with the JAX package):
  rays  : (R, 8) f32 rows [ox oy oz tmin dx dy dz tmax], R % BLK == 0,
          origins recentred (minus `center`); tmax < 0 marks a lane that
          does nothing
  sbox  : (S, 8) f32 super-chunk bboxes [lo.xyz, hi.xyz, pad2]
  tiles : (S, 24, 1024) f32; triangle slot j of super-chunk s in lane j:
            rows 0..2 n = e1 x e2, 3 v0.n, 4 id (f32), 5 mask id,
            8..10 v0 x e2, 11..13 e2, 16..18 e1 x v0, 19..21 -e1;
          chunk c = slots 16c..16c+15, its bbox in rows 6,7,14 (lo.xyz)
          and 15,22,23 (hi.xyz), lane c (c < 64)
  out   : (R, 8) f32 rows [t u v id 0 0 0 0] (closest hit; on a miss
          t = tmax, u = v = 0, id = -1) or [flag 0 ...] (any hit)

Dispatch: `traverse` runs the kernel for CUDA tensors and the plain
version for CPU tensors; nothing falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..accel.flatten import pack_chunks
from ..libbuild import NativeLib

BLK = 128          # rays per candidate list == threads per CUDA block
CHUNK = 16
SUPER = 64
TRI_ROWS = CHUNK * SUPER
TILE_ROWS = 24
BIG = 1e30

_CBOX_ROWS = (6, 7, 14, 15, 22, 23)
# Feature rows read by the Möller-Trumbore test, in the order _mt uses.
_FEAT_ROWS = (0, 1, 2, 3, 4, 8, 9, 10, 11, 12, 13, 16, 17, 18, 19, 20, 21)

# Launch counts: one per kernel launch on the CUDA route, one per call of
# the plain version on the CPU route.  chip_smoke.py reads them to show
# the main path ran through the kernel.
LAUNCHES = {"closest_hit": 0, "any_hit": 0, "plain": 0}

# Counter slots of a counting launch (csrc/traverse_common.cuh): slab
# tests, then Moller-Trumbore tests by the stage they ended at.
WORK_SLOTS = ("slab", "mt_empty", "mt_det", "mt_t", "mt_u", "mt_v",
              "mt_hit")


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------------
# Host-side tile packing (NumPy; same layout as the JAX package)
# --------------------------------------------------------------------------

def pack_stream_tiles(tri_v0, tri_e1, tri_e2, tri_id):
    """(sbox (S,8), tiles (S,24,1024), center (3,)) from packed leaf-order
    triangles.  Geometry is recentred on the scene bbox centre; callers
    subtract `center` from ray origins."""
    valid = tri_id >= 0
    if valid.any():
        va = tri_v0[valid]
        vb = va + tri_e1[valid]
        vc = va + tri_e2[valid]
        lo = np.minimum(np.minimum(va.min(0), vb.min(0)), vc.min(0))
        hi = np.maximum(np.maximum(va.max(0), vb.max(0)), vc.max(0))
        center = ((lo + hi) * 0.5).astype(np.float32)
    else:
        center = np.zeros(3, np.float32)

    sbox, cbox, tris12 = pack_chunks(tri_v0 - center, tri_e1, tri_e2, tri_id)
    num_s = sbox.shape[0]
    t = tris12.reshape(num_s, TRI_ROWS, 12)
    v0, e1, e2, tid = t[:, :, 0:3], t[:, :, 3:6], t[:, :, 6:9], t[:, :, 9]
    # Padding slots carry v0 = 1e30 with zero edges: zero the position so
    # the v0-products stay finite.
    v0 = np.where((tid < 0.0)[:, :, None], 0.0, v0)

    n = np.cross(e1, e2)
    tiles = np.zeros((num_s, TILE_ROWS, TRI_ROWS), np.float32)
    tiles[:, 3, :] = (v0 * n).sum(-1)
    tiles[:, 4, :] = tid
    tiles[:, 5, :] = -1.0
    v0xe2 = np.cross(v0, e2)
    e1xv0 = np.cross(e1, v0)
    for c in range(3):
        tiles[:, 0 + c, :] = n[:, :, c]
        tiles[:, 8 + c, :] = v0xe2[:, :, c]
        tiles[:, 11 + c, :] = e2[:, :, c]
        tiles[:, 16 + c, :] = e1xv0[:, :, c]
        tiles[:, 19 + c, :] = -e1[:, :, c]
    cb = cbox.reshape(num_s, SUPER, 8)
    for c in range(6):
        tiles[:, _CBOX_ROWS[c], :SUPER] = cb[:, :, c]
    return sbox, tiles, center


# --------------------------------------------------------------------------
# Ray rows, sort keys, candidate lists (plain torch ops on either device)
# --------------------------------------------------------------------------

def _safe_inv(x):
    s = torch.where(x >= 0.0, 1.0, -1.0)
    return s / torch.clamp(torch.abs(x), min=1e-12)


def _slab(lo, hi, o, inv):
    """Slab entry/exit over the trailing xyz axis (exact min/max, so the
    reduction order does not matter)."""
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    return (torch.amax(torch.minimum(t0, t1), dim=-1),
            torch.amin(torch.maximum(t0, t1), dim=-1))


def rays8(org, d, tmin, tmax, active):
    """(R, 8) ray rows padded to a BLK multiple; inactive and padding
    lanes get tmax = -1.  Returns (rays, num_r)."""
    num_r = org.shape[0]
    dev = org.device
    tmin = torch.as_tensor(tmin, dtype=torch.float32, device=dev)
    tmax = torch.as_tensor(tmax, dtype=torch.float32, device=dev)
    tmin = tmin.expand(num_r)
    tmax = tmax.expand(num_r)
    if active is not None:
        tmax = torch.where(active, tmax, -1.0)
    pad = (-num_r) % BLK
    rays = torch.zeros((num_r + pad, 8), dtype=torch.float32, device=dev)
    rays[:num_r, 0:3] = org
    rays[:num_r, 3] = tmin
    rays[:num_r, 4:7] = d
    rays[:num_r, 7] = tmax
    rays[num_r:, 7] = -1.0
    return rays, num_r


def _part1by2(x):
    """Spread 8 bits of x to every third bit (Morton interleave)."""
    x = x & 0xFF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def sort_keys(org, d, active, lo, hi):
    """Per-ray sort key: direction octant major, Morton code of the
    quantised origin (8 bits an axis) minor; inactive lanes get the max
    key so they gather in trailing blocks."""
    span = torch.clamp(hi - lo, min=1e-6)
    q = torch.clamp(((org - lo) / span) * 256.0, 0.0, 255.0).to(torch.int32)
    m = ((_part1by2(q[:, 0]) << 2) | (_part1by2(q[:, 1]) << 1)
         | _part1by2(q[:, 2]))
    octant = ((d[:, 0] < 0).to(torch.int32) + 2 * (d[:, 1] < 0).to(torch.int32)
              + 4 * (d[:, 2] < 0).to(torch.int32))
    key = (octant << 24) | m
    return torch.where(active, key, 2 ** 30)


def scene_bounds(sbox):
    return torch.amin(sbox[:, 0:3], dim=0), torch.amax(sbox[:, 3:6], dim=0)


def superchunk_candidates(rays, sbox, blk: int = BLK):
    """Per-block candidate super-chunks, sorted front-to-back.

    Returns (slist (B,S) i32, skey (B,S) f32, scount (B,) i32):
    slist[b, :scount[b]] are the super-chunks any ray of block b can hit,
    ordered by the block-min entry t, which skey carries (BIG past the
    count).  Slab tests run in groups of 8 super-chunks to bound the
    (8, 3, R) intermediates."""
    num_b = rays.shape[0] // blk
    o, tmin, tmax = rays[:, None, 0:3], rays[:, 3, None], rays[:, 7, None]
    inv = _safe_inv(rays[:, None, 4:7])
    hit_rows, key_rows = [], []
    for g in range(0, sbox.shape[0], 8):
        tn, tf = _slab(sbox[None, g:g + 8, 0:3], sbox[None, g:g + 8, 3:6],
                       o, inv)                             # (R, G)
        m = (tn <= tf) & (tf >= tmin) & (tn <= tmax)
        G = m.shape[1]
        hit_rows.append(m.view(num_b, blk, G).any(dim=1))
        key = torch.where(m, torch.clamp(tn, min=0.0), BIG)
        key_rows.append(key.view(num_b, blk, G).amin(dim=1))
    hit = torch.cat(hit_rows, dim=1)                       # (B, S)
    key = torch.cat(key_rows, dim=1)
    skey, order = torch.sort(torch.where(hit, key, BIG), dim=1, stable=True)
    count = hit.sum(dim=1).to(torch.int32)
    return (order.to(torch.int32).contiguous(), skey.contiguous(),
            count.contiguous())


# --------------------------------------------------------------------------
# The plain PyTorch version
# --------------------------------------------------------------------------

def _mt(f, o, d, c, tmin, limit):
    """Möller-Trumbore in feature-dot form.  f: (..., 17) feature rows
    (_FEAT_ROWS order); o, d, c = o x d: (..., 3) broadcastable; every
    product and sum is its own op, in the kernel's order, so each value
    rounds as the kernel's does.  Returns (t, u, v, tid, ok)."""
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    cx, cy, cz = c[..., 0], c[..., 1], c[..., 2]
    nx, ny, nz, v0n, tid = f[..., 0], f[..., 1], f[..., 2], f[..., 3], f[..., 4]
    ax, ay, az = f[..., 5], f[..., 6], f[..., 7]           # v0 x e2
    e2x, e2y, e2z = f[..., 8], f[..., 9], f[..., 10]
    bx, by, bz = f[..., 11], f[..., 12], f[..., 13]        # e1 x v0
    m1x, m1y, m1z = f[..., 14], f[..., 15], f[..., 16]     # -e1
    det = -(dx * nx + dy * ny + dz * nz)
    u_num = cx * e2x + cy * e2y + cz * e2z + dx * ax + dy * ay + dz * az
    v_num = cx * m1x + cy * m1y + cz * m1z + dx * bx + dy * by + dz * bz
    t_num = ox * nx + oy * ny + oz * nz - v0n
    inv_det = torch.where(torch.abs(det) < 1e-12, 0.0, 1.0 / det)
    t = t_num * inv_det
    u = u_num * inv_det
    v = v_num * inv_det
    ok = ((inv_det != 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > tmin) & (t < limit) & (tid >= 0.0))
    return t, u, v, tid, ok


def _cross_od(o, d):
    return torch.stack([o[..., 1] * d[..., 2] - o[..., 2] * d[..., 1],
                        o[..., 2] * d[..., 0] - o[..., 0] * d[..., 2],
                        o[..., 0] * d[..., 1] - o[..., 1] * d[..., 0]], -1)


def _triangle_batches(ray_idx, rays, sbox, cbox, inv, ray_batch=8192,
                      pair_batch=32768, tri_batch=131072):
    """Yield (rr (T,), slot (T, 16)): for each ray of `ray_idx` and each
    chunk whose super-chunk box and chunk box its [tmin, tmax] interval
    enters, the ray index and the chunk's 16 triangle slots.  Batched so
    the intermediates stay bounded."""
    o, tmin, tmax = rays[:, 0:3], rays[:, 3], rays[:, 7]
    lane = torch.arange(CHUNK, device=rays.device)

    def enters(lo, hi, r):
        tn, tf = _slab(lo, hi, o[r, None], inv[r, None])
        return (tn <= tf) & (tf >= tmin[r, None]) & (tn <= tmax[r, None])

    for r0 in range(0, ray_idx.shape[0], ray_batch):
        rb = ray_idx[r0:r0 + ray_batch]
        q1, s1 = enters(sbox[None, :, 0:3], sbox[None, :, 3:6],
                        rb).nonzero(as_tuple=True)
        r1 = rb[q1]
        for p0 in range(0, r1.shape[0], pair_batch):
            rp, sp = r1[p0:p0 + pair_batch], s1[p0:p0 + pair_batch]
            cb = cbox[sp]                                   # (P, 64, 6)
            q2, c2 = enters(cb[..., 0:3], cb[..., 3:6],
                            rp).nonzero(as_tuple=True)
            r2 = rp[q2]
            base = sp[q2] * TRI_ROWS + c2 * CHUNK
            for t0 in range(0, r2.shape[0], tri_batch):
                yield (r2[t0:t0 + tri_batch],
                       base[t0:t0 + tri_batch, None] + lane)


def traverse_plain(rays, sbox, tiles, occl: bool):
    """Plain PyTorch version of the kernel: the same function, as a
    vectorised walk over super-chunk, then chunk, then triangle
    (_triangle_batches), with the kernel's feature-dot Möller-Trumbore
    test (_mt).  The closest hit is the smallest t, ties going to the
    lowest triangle slot, whose t/u/v are recomputed from that one
    triangle."""
    LAUNCHES["plain"] += 1
    dev = rays.device
    num_r = rays.shape[0]
    num_s = sbox.shape[0]
    cbox = tiles[:, list(_CBOX_ROWS), :SUPER].permute(0, 2, 1)  # (S,64,6)
    feat = tiles[:, list(_FEAT_ROWS), :].permute(0, 2, 1)
    feat = feat.reshape(num_s * TRI_ROWS, len(_FEAT_ROWS))      # (S*1024,17)
    o, tmin, d, tmax = rays[:, 0:3], rays[:, 3], rays[:, 4:7], rays[:, 7]
    inv = _safe_inv(d)
    c = _cross_od(o, d)

    def test(rr, slot):
        return _mt(feat[slot], o[rr, None], d[rr, None], c[rr, None],
                   tmin[rr, None], tmax[rr, None])

    live = (tmax >= 0.0).nonzero(as_tuple=True)[0]
    out = torch.zeros((num_r, 8), dtype=torch.float32, device=dev)
    if occl:
        for rr, slot in _triangle_batches(live, rays, sbox, cbox, inv):
            ok = test(rr, slot)[4]
            out[rr[ok.any(dim=1)], 0] = 1.0
        return out

    best_t = torch.full((num_r,), float("inf"), device=dev)
    for rr, slot in _triangle_batches(live, rays, sbox, cbox, inv):
        t, _, _, _, ok = test(rr, slot)
        best_t.scatter_reduce_(
            0, rr, torch.where(ok, t, float("inf")).amin(dim=1), "amin")
    hit_r = torch.isfinite(best_t).nonzero(as_tuple=True)[0]
    none = feat.shape[0]
    best_slot = torch.full((num_r,), none, dtype=torch.int64, device=dev)
    for rr, slot in _triangle_batches(hit_r, rays, sbox, cbox, inv):
        t, _, _, _, ok = test(rr, slot)
        win = torch.where(ok & (t == best_t[rr, None]), slot, none)
        best_slot.scatter_reduce_(0, rr, win.amin(dim=1), "amin")

    out[:, 0] = tmax
    out[:, 3] = -1.0
    t, u, v, tid, _ = test(hit_r, best_slot[hit_r, None])
    out[hit_r, 0] = t[:, 0]
    out[hit_r, 1] = u[:, 0]
    out[hit_r, 2] = v[:, 0]
    out[hit_r, 3] = tid[:, 0]
    return out


# --------------------------------------------------------------------------
# The CUDA kernel
# --------------------------------------------------------------------------

LIB = NativeLib("stream_traverse", "stream_traverse.cu",
                headers=("traverse_common.cuh",))

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(LIB.build())
        fn = lib.imba_stream_traverse
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p] * 2
        _lib = lib
    return _lib


def _check(name, x, dtype, shape):
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_inputs(rays, sbox, tiles):
    """Validate the (rays, sbox, tiles) triple a CUDA kernel reads."""
    num_r, num_s = rays.shape[0], sbox.shape[0]
    _check("rays", rays, torch.float32, (num_r, 8))
    _check("sbox", sbox, torch.float32, (num_s, 8))
    _check("tiles", tiles, torch.float32, (num_s, TILE_ROWS, TRI_ROWS))
    if num_r % BLK:
        raise ValueError(f"rays: row count {num_r} is not a multiple of "
                         f"{BLK}")
    for name, x in (("rays", rays), ("sbox", sbox), ("tiles", tiles)):
        if x.device.type != "cuda" or x.device != rays.device:
            raise ValueError(f"{name}: must be on the rays' CUDA device")
    return num_r, num_s


def work_ptr(work, device):
    """The kernel's `work` argument: None, or the address of a
    (len(WORK_SLOTS),) int64 counter tensor on `device`."""
    if work is None:
        return None
    _check("work", work, torch.int64, (len(WORK_SLOTS),))
    if work.device != device:
        raise ValueError("work: must be on the rays' CUDA device")
    return work.data_ptr()


def traverse_cuda(rays, sbox, tiles, occl: bool, lists=None, work=None):
    """Launch the CUDA kernel on CUDA tensors (raises on anything else).

    `lists` is superchunk_candidates(rays, sbox), computed here unless
    given.  With `work`, a zeroed (len(WORK_SLOTS),) int64 tensor, the
    counting instantiation runs instead and adds its tallies to it."""
    num_r, num_s = check_inputs(rays, sbox, tiles)
    lib = _library()
    if lists is None:
        lists = superchunk_candidates(rays, sbox)
    slist, skey, scount = lists
    out = torch.empty((num_r, 8), dtype=torch.float32, device=rays.device)
    stream = torch.cuda.current_stream(rays.device).cuda_stream
    err = lib.imba_stream_traverse(
        rays.data_ptr(), sbox.data_ptr(), tiles.data_ptr(), slist.data_ptr(),
        skey.data_ptr(), scount.data_ptr(), out.data_ptr(), num_r, num_s,
        BLK, int(occl), work_ptr(work, rays.device), stream)
    if err != 0:
        raise RuntimeError(f"stream_traverse kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["any_hit" if occl else "closest_hit"] += 1
    return out


def traverse(rays, sbox, tiles, occl: bool):
    """(R, 8) rays -> (R, 8) hit rows: the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if rays.device.type == "cuda":
        return traverse_cuda(rays, sbox, tiles, occl)
    if rays.device.type == "cpu":
        return traverse_plain(rays, sbox, tiles, occl)
    raise ValueError(f"unsupported device {rays.device}")


def dispatch(sbox, tiles, org, d, tmin, tmax, active, occl: bool,
             sort: bool):
    """Ray arrays -> (num_r, 8) hit rows.  With `sort`, rays are ordered
    by sort_keys first (the ray record is permuted as one gather, the
    output un-permuted as one scatter), so incoherent batches get
    coherent per-block candidate lists and dead lanes gather in trailing
    blocks.  Exact under any permutation."""
    num_r = org.shape[0]
    if active is None:
        active = torch.ones(num_r, dtype=torch.bool, device=org.device)
    rays, _ = rays8(org, d, tmin, tmax, active)
    if not sort:
        return traverse(rays, sbox, tiles, occl)[:num_r]
    lo, hi = scene_bounds(sbox)
    perm = torch.sort(sort_keys(org, d, active, lo, hi), stable=True)[1]
    pad = rays.shape[0] - num_r
    if pad:
        perm = torch.cat([perm, torch.arange(num_r, num_r + pad,
                                             device=org.device)])
    res = traverse(rays[perm], sbox, tiles, occl)
    out = torch.empty_like(res)
    out[perm] = res
    return out[:num_r]
