"""Streaming closest-hit / any-hit traversal over super-chunk feature
tiles: the hand-written CUDA kernel, its plain PyTorch version, and the
torch-side machinery around them (tile packing, per-block candidate
lists, and the plain versions of the ray sort keys and ray rows, which
ops/dispatch.py's sorted dispatch runs on CPU tensors).

Replaces the TPU kernels
  imbatracer_tpu/ops/pallas_stream.py::_make_kernel (instanced=False and
      instanced=True)
  imbatracer_tpu/ops/pallas_vmem.py::_make_vmem_kernel
which compute one function over the same `(sbox, tiles)` packing, and so
does `csrc/stream_traverse.cu` (its header note says what bounds it).
Each launch builds its blocks' candidate lists on the card
(csrc/traverse_common.cuh block_candidates) in shared memory; above
MAX_SUPER super-chunks a list launch of its own writes them to a global
scratch buffer (list_scratch), which the walk launch reads.
`superchunk_candidates` is that stage's plain version, and
`block_candidates` runs the stage alone.

Layouts (shared with the JAX package):
  rays  : (R, 8) f32 rows [ox oy oz tmin dx dy dz tmax], R % BLK == 0,
          origins recentred (minus `center`); tmax < 0 marks a lane that
          does nothing
  sbox  : (S, 8) f32 super-chunk bboxes [lo.xyz, hi.xyz, pad2]
  tiles : (T, 24, 1024) f32 (T == S on a flat BVH); triangle slot j of
          tile s in lane j:
            rows 0..2 n = e1 x e2, 3 v0.n, 4 id (f32), 5 mask id,
            8..10 v0 x e2, 11..13 e2, 16..18 e1 x v0, 19..21 -e1;
          chunk c = slots 16c..16c+15, its bbox in rows 6,7,14 (lo.xyz)
          and 15,22,23 (hi.xyz), lane c (c < 64)
  inst  : None (flat), or under two-level instancing the tuple
          (tile_idx (S,) i32, inst_of (S,) i32, itab (I, 16) f32):
          super-chunk s reads tile tile_idx[s] in the mesh space of
          instance inst_of[s], whose row of itab holds the world->mesh
          3x4 affine (columns 0..11, row-major) and the instance's flat
          primitive-id offset (column 12).  Boxes in sbox are world
          space and origins are not recentred (center is zero).
  out   : (R, 8) f32 rows [t u v id 0 0 0 0] (closest hit; on a miss
          t = tmax, u = v = 0, id = -1) or [flag 0 ...] (any hit).  Ids
          are carried in float32 (the tiles' id row, plus the instance
          offset as a float add), so they are exact below 2^24 flat
          triangles.

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
# Super-chunk boxes slab-tested at once when building candidate lists.
CAND_GROUP = 32
# The most super-chunks a CUDA block's candidate list holds in shared
# memory (csrc/traverse_common.cuh kMaxSuper; above it the lists go through
# a global scratch buffer), and the bytes of a block's other staging
# buffers (kTailBytes: two candidate buffers of 1,632 bytes, two feature
# batches of 8 chunks x 17 rows x 16 floats).
MAX_SUPER = 16384
_SMEM_TAIL = 2 * 1632 + 2 * 8 * 17 * 16 * 4

_CBOX_ROWS = (6, 7, 14, 15, 22, 23)
# Feature rows read by the Möller-Trumbore test, in the order _mt uses.
_FEAT_ROWS = (0, 1, 2, 3, 4, 8, 9, 10, 11, 12, 13, 16, 17, 18, 19, 20, 21)

# Launch counts: one per kernel launch on the CUDA route, one per call of
# the plain version on the CPU route ("candidates": the candidate stage
# launched alone; "candidates_plain": superchunk_candidates).
# chip_smoke.py reads them to show the main path ran through the kernel.
LAUNCHES = {"closest_hit": 0, "any_hit": 0, "closest_hit_instanced": 0,
            "any_hit_instanced": 0, "candidates": 0, "plain": 0,
            "candidates_plain": 0}
PLAIN_KEYS = ("plain", "candidates_plain")

# Counter slots of a counting launch (csrc/traverse_common.cuh): the
# walk's slab tests (super-chunk and non-padding chunk boxes), the
# first-pass Moller-Trumbore tests by the stage they ended at, the
# candidate stage's slab tests (group and super-chunk boxes), and the
# walk's second looks (chunk boxes against a thread's current bound, the
# re-run of a slot that hit in the first pass).
WORK_SLOTS = ("slab", "mt_empty", "mt_det", "mt_t", "mt_u", "mt_v",
              "mt_hit", "cand_slab", "retest")


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


def full_lanes(x, num_r: int, device):
    """(num_r,) float32 lanes of `x`, a tensor (broadcast) or a Python
    number, at a stride of 0 (one value) or 1, as the dispatch kernels
    read them (ops/dispatch.py); a number is a fill on `device`, so no
    host-to-device copy: a CUDA graph can capture it."""
    if not torch.is_tensor(x):
        x = torch.full((1,), x, dtype=torch.float32, device=device)
    x = x.to(device=device, dtype=torch.float32)
    if x.numel() == 1:
        return x.reshape(1).expand(num_r)
    return x.expand(num_r).contiguous()


def rays8(org, d, tmin, tmax, active):
    """(R, 8) ray rows padded to a BLK multiple; inactive and padding
    lanes get tmax = -1.  Returns (rays, num_r)."""
    num_r = org.shape[0]
    dev = org.device
    tmin = full_lanes(tmin, num_r, dev)
    tmax = full_lanes(tmax, num_r, dev)
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
    count).  Slab tests run in groups of CAND_GROUP super-chunks to bound
    the (R, CAND_GROUP, 3) intermediates (the reductions are exact, so
    the group size does not change the lists).  This is the plain
    version of the CUDA kernels' candidate stage."""
    LAUNCHES["candidates_plain"] += 1
    num_b = rays.shape[0] // blk
    o, tmin, tmax = rays[:, None, 0:3], rays[:, 3, None], rays[:, 7, None]
    inv = _safe_inv(rays[:, None, 4:7])
    hit_rows, key_rows = [], []
    for g in range(0, sbox.shape[0], CAND_GROUP):
        tn, tf = _slab(sbox[None, g:g + CAND_GROUP, 0:3],
                       sbox[None, g:g + CAND_GROUP, 3:6], o, inv)  # (R, G)
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


def tile_of(ss, inst):
    """Tile rows of super-chunks `ss` (int64): the super-chunk itself on
    a flat BVH, `tile_idx[ss]` under two-level instancing."""
    return ss if inst is None else inst[0][ss].long()


def instance_ray(m, o, d):
    """Mesh-space origin and direction under (P, 16) instance rows `m`
    (world->mesh 3x4 affine in columns 0..11): each product and sum
    rounded on its own, left to right, as the kernels compute them.
    Directions stay unnormalised, so t is the same in both spaces."""
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    po = [m[:, 4 * r] * ox + m[:, 4 * r + 1] * oy + m[:, 4 * r + 2] * oz
          + m[:, 4 * r + 3] for r in range(3)]
    pd = [m[:, 4 * r] * dx + m[:, 4 * r + 1] * dy + m[:, 4 * r + 2] * dz
          for r in range(3)]
    return torch.stack(po, -1), torch.stack(pd, -1)


def pair_frame(rays, rr, ss, inst):
    """(o, d, inv, o x d) of rays `rr` (rows of `rays`) in the frame of
    super-chunks `ss`: world space on a flat BVH, the super-chunk's
    instance's mesh space under two-level instancing."""
    o, d = rays[rr, 0:3], rays[rr, 4:7]
    if inst is not None:
        _, inst_of, itab = inst
        o, d = instance_ray(itab[inst_of[ss].long()], o, d)
    return o, d, _safe_inv(d), _cross_od(o, d)


def _ray_superchunks(ray_idx, rays, sbox, ray_batch=8192):
    """Yield (rr, ss): the rays of `ray_idx` and the super-chunks whose
    world-space box their [tmin, tmax] interval enters.  Batched so the
    (rays, S) intermediates stay bounded."""
    o, tmin, tmax = rays[:, 0:3], rays[:, 3], rays[:, 7]
    inv = _safe_inv(rays[:, 4:7])
    for r0 in range(0, ray_idx.shape[0], ray_batch):
        rb = ray_idx[r0:r0 + ray_batch]
        tn, tf = _slab(sbox[None, :, 0:3], sbox[None, :, 3:6], o[rb, None],
                       inv[rb, None])
        q, ss = ((tn <= tf) & (tf >= tmin[rb, None])
                 & (tn <= tmax[rb, None])).nonzero(as_tuple=True)
        yield rb[q], ss


def _pair_triangles(rr, ss, rays, cbox, inst, pair_batch=32768,
                    tri_batch=131072):
    """Yield (r, s, slot (T, 16)): for each (ray, super-chunk) pair of
    (rr, ss) and each chunk of the super-chunk's tile that the ray, in
    the super-chunk's frame, enters over [tmin, tmax], the ray, the
    super-chunk and the chunk's 16 triangle slots within the tile."""
    tmin, tmax = rays[:, 3], rays[:, 7]
    lane = torch.arange(CHUNK, device=rays.device)
    for p0 in range(0, rr.shape[0], pair_batch):
        rp, sp = rr[p0:p0 + pair_batch], ss[p0:p0 + pair_batch]
        o, _, inv, _ = pair_frame(rays, rp, sp, inst)
        cb = cbox[tile_of(sp, inst)]                       # (P, 64, 6)
        tn, tf = _slab(cb[..., 0:3], cb[..., 3:6], o[:, None], inv[:, None])
        q, c = ((tn <= tf) & (tf >= tmin[rp, None])
                & (tn <= tmax[rp, None])).nonzero(as_tuple=True)
        r2, s2, base = rp[q], sp[q], c * CHUNK
        for t0 in range(0, r2.shape[0], tri_batch):
            yield (r2[t0:t0 + tri_batch], s2[t0:t0 + tri_batch],
                   base[t0:t0 + tri_batch, None] + lane)


def walk_rows(rays, tiles, inst, occl: bool, triangles):
    """(R, 8) hit rows of a plain triangle walk.  `triangles(ray_idx)`
    yields (r, s, slot) batches of the triangles each ray of `ray_idx`
    may hit (_pair_triangles), and is walked twice for a closest hit:
    once for the smallest t, once for the lowest (super-chunk, slot) at
    that t, whose t/u/v/id are then recomputed from that one triangle.
    Under two-level instancing the id is offset by the instance's flat
    primitive-id base, a float add as in the kernels."""
    dev = rays.device
    num_r = rays.shape[0]
    feat = tiles[:, list(_FEAT_ROWS), :].permute(0, 2, 1)
    feat = feat.reshape(-1, len(_FEAT_ROWS))                # (T*1024, 17)
    tmin, tmax = rays[:, 3], rays[:, 7]

    def test(rr, ss, slot):
        o, d, _, c = pair_frame(rays, rr, ss, inst)
        f = feat[tile_of(ss, inst)[:, None] * TRI_ROWS + slot]
        return _mt(f, o[:, None], d[:, None], c[:, None], tmin[rr, None],
                   tmax[rr, None])

    live = (tmax >= 0.0).nonzero(as_tuple=True)[0]
    out = torch.zeros((num_r, 8), dtype=torch.float32, device=dev)
    if occl:
        for rr, ss, slot in triangles(live):
            ok = test(rr, ss, slot)[4]
            out[rr[ok.any(dim=1)], 0] = 1.0
        return out

    best_t = torch.full((num_r,), float("inf"), device=dev)
    for rr, ss, slot in triangles(live):
        t, _, _, _, ok = test(rr, ss, slot)
        best_t.scatter_reduce_(
            0, rr, torch.where(ok, t, float("inf")).amin(dim=1), "amin")
    hit_r = torch.isfinite(best_t).nonzero(as_tuple=True)[0]
    none = torch.iinfo(torch.int64).max
    best_key = torch.full((num_r,), none, dtype=torch.int64, device=dev)
    for rr, ss, slot in triangles(hit_r):
        t, _, _, _, ok = test(rr, ss, slot)
        key = ss[:, None] * TRI_ROWS + slot
        win = torch.where(ok & (t == best_t[rr, None]), key, none)
        best_key.scatter_reduce_(0, rr, win.amin(dim=1), "amin")

    out[:, 0] = tmax
    out[:, 3] = -1.0
    wk = best_key[hit_r]
    ws = wk // TRI_ROWS
    t, u, v, tid, _ = test(hit_r, ws, (wk % TRI_ROWS)[:, None])
    tid = tid[:, 0]
    if inst is not None:
        tid = tid + inst[2][inst[1][ws].long(), 12]
    out[hit_r, 0] = t[:, 0]
    out[hit_r, 1] = u[:, 0]
    out[hit_r, 2] = v[:, 0]
    out[hit_r, 3] = tid
    return out


def cbox_rows(tiles):
    """(T, 64, 6) chunk boxes [lo.xyz, hi.xyz] of every tile."""
    return tiles[:, list(_CBOX_ROWS), :SUPER].permute(0, 2, 1)


def traverse_plain(rays, sbox, tiles, occl: bool, inst=None):
    """Plain PyTorch version of the kernel: the same function, as a
    vectorised walk over super-chunk (world-space box), then chunk, then
    triangle (in the super-chunk's frame), with the kernel's feature-dot
    Möller-Trumbore test (_mt).  The closest hit is the smallest t, ties
    going to the lowest (super-chunk, slot)."""
    LAUNCHES["plain"] += 1
    cbox = cbox_rows(tiles)

    def triangles(ray_idx):
        for rr, ss in _ray_superchunks(ray_idx, rays, sbox):
            yield from _pair_triangles(rr, ss, rays, cbox, inst)

    return walk_rows(rays, tiles, inst, occl, triangles)


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
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p] * 4
        fn = lib.imba_block_candidates
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        fn = lib.imba_stream_resources
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
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


def list_stride(num_s: int) -> int:
    """Entries of one block's candidate list: a power of two >= max(S, 2)
    (csrc/traverse_common.cuh list_stride)."""
    return 1 << (max(num_s, 2) - 1).bit_length()


def block_smem_bytes(num_s: int) -> int:
    """Dynamic shared memory of a stream or khit block at S = num_s
    (csrc/traverse_common.cuh block_smem_bytes): the sorted candidate list,
    8 bytes an entry over list_stride(S) (none above MAX_SUPER, where the
    list is global), and the staging buffers."""
    return (0 if num_s > MAX_SUPER else 8 * list_stride(num_s)) + _SMEM_TAIL


def list_scratch_bytes(num_r: int, num_s: int) -> int:
    """Bytes of the global candidate-list buffer a launch over num_r rays
    at S = num_s needs: none up to MAX_SUPER, else one list_stride(S) row
    of 8-byte entries for each 128-ray block."""
    if num_s <= MAX_SUPER:
        return 0
    return (num_r // BLK) * list_stride(num_s) * 8


def check_capacity(num_s: int, num_r: int = BLK, limit: int = None):
    """Raise before a launch over num_r rays at S = num_s that cannot run:
    a BVH with no super-chunk, or a global list buffer (above MAX_SUPER)
    of more than `limit` bytes, the card's memory."""
    if num_s < 1:
        raise ValueError("sbox: the BVH has no super-chunk")
    need = list_scratch_bytes(num_r, num_s)
    if limit is not None and need > limit:
        raise ValueError(
            f"sbox: the candidate lists of {num_r} rays over {num_s} "
            f"super-chunks need a global buffer of {need:,} bytes, more than "
            f"the card's {limit:,}")


def _card_memory(device):
    """Bytes of memory of the card `device` is on (None off a card)."""
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(device).total_memory


def list_scratch(num_r: int, num_s: int, device):
    """(glist, gcount) buffers of a launch above MAX_SUPER (None, None at
    or below it): num_r / 128 rows of list_stride(S) int64 entries, and
    one int32 count a row."""
    if num_s <= MAX_SUPER:
        return None, None
    num_b = num_r // BLK
    return (torch.empty((num_b * list_stride(num_s),), dtype=torch.int64,
                        device=device),
            torch.empty((num_b,), dtype=torch.int32, device=device))


def _ptr(x):
    return None if x is None else x.data_ptr()


def check_inputs(rays, sbox, tiles, inst=None):
    """Validate the (rays, sbox, tiles[, inst]) a CUDA kernel reads (tiles
    None: the candidate stage alone).  On a flat BVH tiles has one row per
    super-chunk; with `inst` any number, and tile_idx / inst_of hold one
    int32 per super-chunk and itab 16 floats per instance (their values
    are checked when the BVH is built, accel/device.py).  The kernels copy
    sbox, tile and itab rows 16 bytes at a time, so those tensors must
    start on a 16-byte boundary."""
    num_r, num_s = rays.shape[0], sbox.shape[0]
    _check("rays", rays, torch.float32, (num_r, 8))
    _check("sbox", sbox, torch.float32, (num_s, 8))
    check_capacity(num_s, num_r, _card_memory(rays.device))
    named = [("rays", rays), ("sbox", sbox)]
    if tiles is not None:
        num_t = num_s if inst is None else tiles.shape[0]
        _check("tiles", tiles, torch.float32, (num_t, TILE_ROWS, TRI_ROWS))
        named.append(("tiles", tiles))
    if num_r % BLK:
        raise ValueError(f"rays: row count {num_r} is not a multiple of "
                         f"{BLK}")
    if inst is not None:
        tile_idx, inst_of, itab = inst
        _check("tile_idx", tile_idx, torch.int32, (num_s,))
        _check("inst_of", inst_of, torch.int32, (num_s,))
        _check("itab", itab, torch.float32, (itab.shape[0], 16))
        named += [("tile_idx", tile_idx), ("inst_of", inst_of),
                  ("itab", itab)]
    for name, x in named:
        if x.device.type != "cuda" or x.device != rays.device:
            raise ValueError(f"{name}: must be on the rays' CUDA device")
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: must start on a 16-byte boundary")
    return num_r, num_s


def inst_ptrs(inst):
    """The kernels' (tile_idx, inst_of, itab) pointer arguments: null on a
    flat BVH."""
    if inst is None:
        return None, None, None
    return tuple(x.data_ptr() for x in inst)


def launch_key(occl: bool, inst) -> str:
    return (("any_hit" if occl else "closest_hit")
            + ("" if inst is None else "_instanced"))


def work_ptr(work, device):
    """The kernel's `work` argument: None, or the address of a
    (len(WORK_SLOTS),) int64 counter tensor on `device`."""
    if work is None:
        return None
    _check("work", work, torch.int64, (len(WORK_SLOTS),))
    if work.device != device:
        raise ValueError("work: must be on the rays' CUDA device")
    return work.data_ptr()


def traverse_cuda(rays, sbox, tiles, occl: bool, work=None, inst=None):
    """Launch the CUDA kernel on CUDA tensors (raises on anything else):
    one launch, which builds each block's candidate list and walks it (two
    above MAX_SUPER: the lists, then the walk, through list_scratch).

    With `work`, a zeroed (len(WORK_SLOTS),) int64 tensor, the counting
    instantiation runs instead and adds its tallies to it.  `inst` selects
    the two-level instanced variant."""
    num_r, num_s = check_inputs(rays, sbox, tiles, inst)
    lib = _library()
    out = torch.empty((num_r, 8), dtype=torch.float32, device=rays.device)
    glist, gcount = list_scratch(num_r, num_s, rays.device)
    stream = torch.cuda.current_stream(rays.device).cuda_stream
    err = lib.imba_stream_traverse(
        rays.data_ptr(), sbox.data_ptr(), tiles.data_ptr(), *inst_ptrs(inst),
        out.data_ptr(), num_r, num_s, int(occl), _ptr(glist), _ptr(gcount),
        work_ptr(work, rays.device), stream)
    if err != 0:
        raise RuntimeError(f"stream_traverse kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES[launch_key(occl, inst)] += 1
    return out


def candidates_cuda(rays, sbox):
    """The kernels' candidate stage launched alone on CUDA tensors:
    (slist (B, S) i32, skey (B, S) f32, scount (B,) i32) as
    superchunk_candidates returns them for BLK = 128.  Entries past a
    block's count are slist -1 and skey BIG (superchunk_candidates' skey
    is BIG there too; its slist holds the other super-chunks)."""
    num_r, num_s = check_inputs(rays, sbox, None)
    lib = _library()
    num_b = num_r // BLK
    dev = rays.device
    slist = torch.full((num_b, num_s), -1, dtype=torch.int32, device=dev)
    skey = torch.full((num_b, num_s), BIG, dtype=torch.float32, device=dev)
    scount = torch.empty((num_b,), dtype=torch.int32, device=dev)
    glist, _ = list_scratch(num_r, num_s, dev)
    err = lib.imba_block_candidates(
        rays.data_ptr(), sbox.data_ptr(), slist.data_ptr(), skey.data_ptr(),
        scount.data_ptr(), _ptr(glist), num_r, num_s,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"block_candidates kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["candidates"] += 1
    return slist, skey, scount


def candidate_mismatches(got, ref):
    """(count, list, key) mismatches of candidate lists `got` against
    `ref`, each (slist, skey, scount) on one device: the blocks whose
    counts differ, and the list entries and keys (compared as bits, a -0
    key as +0) that differ up to each block's count."""
    (gl, gk, gc), (rl, rk, rc) = got, ref
    n = torch.minimum(gc, rc).long()
    upto = torch.arange(gl.shape[1], device=gl.device)[None, :] < n[:, None]
    gbits, rbits = ((k + 0.0).view(torch.int32) for k in (gk, rk))
    return (int((gc != rc).sum()), int(((gl != rl) & upto).sum()),
            int(((gbits != rbits) & upto).sum()))


def block_candidates(rays, sbox):
    """Per-block candidate lists: the kernels' stage on CUDA tensors, its
    plain version (superchunk_candidates) on CPU tensors."""
    if rays.device.type == "cuda":
        return candidates_cuda(rays, sbox)
    if rays.device.type == "cpu":
        return superchunk_candidates(rays, sbox)
    raise ValueError(f"unsupported device {rays.device}")


def resources(occl: bool, inst: bool, num_s: int, work: bool = False):
    """Registers, shared memory, spills and resident blocks an SM of the
    stream kernel a launch at S = num_s runs (needs the card)."""
    return _resources(_library().imba_stream_resources, int(occl),
                      int(inst), int(work), num_s)


def _resources(fn, *args):
    out = (ctypes.c_int * 5)()
    err = fn(*args, out)
    if err != 0:
        raise RuntimeError(f"kernel resource query failed: CUDA error {err}")
    return dict(zip(("registers", "static_smem", "dynamic_smem",
                     "local_bytes", "blocks_per_sm"), out))


def traverse(rays, sbox, tiles, occl: bool, inst=None):
    """(R, 8) rays -> (R, 8) hit rows: the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if rays.device.type == "cuda":
        return traverse_cuda(rays, sbox, tiles, occl, inst=inst)
    if rays.device.type == "cpu":
        return traverse_plain(rays, sbox, tiles, occl, inst=inst)
    raise ValueError(f"unsupported device {rays.device}")
