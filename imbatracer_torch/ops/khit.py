"""K-nearest-hit traversal (alpha masks): the hand-written CUDA kernel,
its plain PyTorch version, and the sorted dispatch around them.

Replaces the TPU kernel imbatracer_tpu/ops/pallas_khit.py::_khit_kernel
(via _khit_call / khit_sorted): per ray, the K = 4 nearest hits on
distinct triangles in (tmin, tmax), sorted by t.  The set is gap-free:
no hit closer than the K-th returned one is missing.  A triangle that a
split BVH references from several leaves counts once, as in the Pallas
kernel's resolve.  render/traverse.py alpha-tests the K hits together
and re-traces only rays whose K hits were all masked out.

Layouts: rays (R, 8), sbox and tiles as in ops/stream_traverse.py; out
(R, 8K) f32, hit k in columns 8k..8k+3 = [t u v id]; an absent hit is
t = BIG, u = v = 0, id = -1.

Dispatch: `khit` runs the kernel (csrc/khit_traverse.cu) for CUDA
tensors and the plain version for CPU tensors; nothing falls back from
one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from ..libbuild import NativeLib
from . import dispatch
from . import stream_traverse as st

# Hits returned per dispatch (the JAX package's IMBA_KHIT_K default).
K = 4
BIG = st.BIG

# Launch counts: one per kernel launch on the CUDA route, one per call of
# the plain version.  chip_smoke.py reads them to show the main path ran
# through the kernel.
LAUNCHES = {"khit": 0, "plain": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------------
# The plain PyTorch version
# --------------------------------------------------------------------------

def khit_plain(rays, sbox, tiles, k: int = K):
    """Plain PyTorch version of the kernel: every (ray, triangle)
    candidate of the super-chunk / chunk walk (stream_traverse.
    _ray_superchunks and _pair_triangles) goes through the kernel's
    feature-dot Moller-Trumbore test (_mt, same rounding), and each ray
    keeps its k smallest t over distinct triangle ids (ties to the lowest
    triangle slot).  `k` other than K serves the checks that look one hit
    past the K-th."""
    LAUNCHES["plain"] += 1
    dev = rays.device
    num_r = rays.shape[0]
    num_s = sbox.shape[0]
    cbox = st.cbox_rows(tiles)
    feat = tiles[:, list(st._FEAT_ROWS), :].permute(0, 2, 1)
    feat = feat.reshape(num_s * st.TRI_ROWS, len(st._FEAT_ROWS))
    o, tmin, d, tmax = rays[:, 0:3], rays[:, 3], rays[:, 4:7], rays[:, 7]
    c = st._cross_od(o, d)

    parts = []
    live = (tmax >= 0.0).nonzero(as_tuple=True)[0]
    for r1, s1 in st._ray_superchunks(live, rays, sbox):
        for rr, ss, local in st._pair_triangles(r1, s1, rays, cbox, None):
            slot = ss[:, None] * st.TRI_ROWS + local
            t, u, v, tid, ok = st._mt(feat[slot], o[rr, None], d[rr, None],
                                      c[rr, None], tmin[rr, None],
                                      tmax[rr, None])
            q, j = ok.nonzero(as_tuple=True)
            parts.append((rr[q], slot[q, j], t[q, j], u[q, j], v[q, j],
                          tid[q, j]))

    out = torch.zeros((num_r, 8 * k), dtype=torch.float32, device=dev)
    out[:, 0::8] = BIG
    out[:, 3::8] = -1.0
    if not sum(len(part[0]) for part in parts):
        return out
    hr, hslot, ht, hu, hv, hid = (torch.cat(x) for x in zip(*parts))
    # Order by (ray, t, slot): stable sorts from the minor key up.
    order = torch.sort(hslot, stable=True)[1]
    order = order[torch.sort(ht[order], stable=True)[1]]
    order = order[torch.sort(hr[order], stable=True)[1]]
    hr, ht, hu, hv, hid = hr[order], ht[order], hu[order], hv[order], hid[order]
    # A triangle referenced from several leaves (a split BVH) counts once:
    # its references carry identical tile rows, so they tie in t, and the
    # first of each (ray, id) pair in this order stays.
    pair = hr * (int(hid.max()) + 1) + hid.long()
    by_pair = torch.sort(pair, stable=True)[1]
    first = torch.ones_like(pair, dtype=torch.bool)
    first[1:] = pair[by_pair[1:]] != pair[by_pair[:-1]]
    keep = torch.empty_like(first)
    keep[by_pair] = first
    hr, ht, hu, hv, hid = hr[keep], ht[keep], hu[keep], hv[keep], hid[keep]
    counts = torch.bincount(hr, minlength=num_r)
    first = torch.cumsum(counts, 0) - counts
    rank = torch.arange(hr.shape[0], device=dev) - first[hr]
    keep = rank < k
    hr, col = hr[keep], 8 * rank[keep]
    for f, vals in enumerate((ht, hu, hv, hid)):
        out[hr, col + f] = vals[keep]
    return out


# --------------------------------------------------------------------------
# The CUDA kernel
# --------------------------------------------------------------------------

LIB = NativeLib("khit_traverse", "khit_traverse.cu",
                headers=("traverse_common.cuh",))

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(LIB.build())
        fn = lib.imba_khit_traverse
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p] * 4
        fn = lib.imba_khit_resources
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p]
        _lib = lib
    return _lib


def khit_cuda(rays, sbox, tiles, work=None):
    """Launch the CUDA kernel (K = 4) on CUDA tensors (raises on anything
    else): one launch, which builds each block's candidate list and walks
    it (two above stream_traverse.MAX_SUPER, through its list_scratch).
    `work` as in stream_traverse.traverse_cuda."""
    num_r, num_s = st.check_inputs(rays, sbox, tiles)
    lib = _library()
    out = torch.empty((num_r, 8 * K), dtype=torch.float32,
                      device=rays.device)
    glist, gcount = st.list_scratch(num_r, num_s, rays.device)
    stream = torch.cuda.current_stream(rays.device).cuda_stream
    err = lib.imba_khit_traverse(
        rays.data_ptr(), sbox.data_ptr(), tiles.data_ptr(), out.data_ptr(),
        num_r, num_s, K, st._ptr(glist), st._ptr(gcount),
        st.work_ptr(work, rays.device), stream)
    if err != 0:
        raise RuntimeError(f"khit kernel launch failed: CUDA error {err}")
    LAUNCHES["khit"] += 1
    return out


def resources(num_s: int, work: bool = False):
    """Registers, shared memory, spills and resident blocks an SM of the
    khit kernel a launch at S = num_s runs (needs the card)."""
    return st._resources(_library().imba_khit_resources, int(work), num_s)


def khit(rays, sbox, tiles):
    """(R, 8) rays -> (R, 8K) sorted K-nearest hit rows: the kernel on
    CUDA tensors, the plain version on CPU tensors."""
    if rays.device.type == "cuda":
        return khit_cuda(rays, sbox, tiles)
    if rays.device.type == "cpu":
        return khit_plain(rays, sbox, tiles)
    raise ValueError(f"unsupported device {rays.device}")


def khit_sorted(sbox, tiles, org, d, tmin, tmax, active=None):
    """K nearest hits per ray through the Morton-sorted dispatch
    (ops/dispatch.py).

    org must be recentred (minus the BVH's `center`).  Returns (t, u, v,
    id), each (R, K), sorted by t per ray; id < 0 (and t = BIG) marks an
    absent hit.  The masked re-trace (render/traverse.py) reads khit's
    sorted rows itself (dispatch.khit_resolve)."""
    disp = dispatch.prepare(org, d, tmin, tmax, active, sbox=sbox)
    res = khit(disp.rows, sbox, tiles)[:disp.n]
    out = torch.empty_like(res)
    out[disp.perm] = res
    return (out[:, 0::8], out[:, 1::8], out[:, 2::8],
            out[:, 3::8].to(torch.int32))
