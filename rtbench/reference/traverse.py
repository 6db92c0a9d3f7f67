"""Plain closest-hit and any-hit over the reference's triangle clusters.

No BVH.  A flat scene: every ray's slab test runs against every
cluster's box (`scene.Clusters`), and each ray is tested against every
triangle of each cluster its ray segment meets, with the frozen
Moller-Trumbore test of `intersect.py`.  A scene of instances
(`scene.Instances`), as the upstream renderer's two-level BVH does it:
each ray against every instance's world box; where it meets one, the
ray is taken into that instance's mesh space by the instance's inverse
affine (the direction unnormalised, so t is the world's) and tested
against the mesh's clusters and triangles there.  Alpha-masked
triangles count only where the mask record's texel is opaque
(`textures.MaskTest`), so the closest hit is the nearest opaque one,
whatever order a traversal finds them in.  The work is cut into blocks
of rays and of ray-triangle tests so that it fits beside nothing else
on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .intersect import BIG, ray_triangle
from .textures import MaskTest

# Elements of the largest (rays x clusters) and (tests) blocks.
SLAB_BLOCK = 1 << 24
TEST_BLOCK = 1 << 22


class Hit(NamedTuple):
    t: torch.Tensor        # (R,) BIG on a miss
    u: torch.Tensor
    v: torch.Tensor
    prim_id: torch.Tensor  # (R,) i32, -1 on a miss


def _safe_inv(d):
    tiny = torch.where(d < 0, -1e-20, 1e-20)
    return 1.0 / torch.where(torch.abs(d) < 1e-20, tiny, d)


def _candidates(lo, hi, org, d, tmin, tmax):
    """(ray, box) pairs whose box (lo, hi: (B, 3)) the ray's segment
    meets, in blocks of rays: yields (ray indices, box indices)."""
    block = max(1, SLAB_BLOCK // max(lo.shape[0], 1))
    inv = _safe_inv(d)
    for s in range(0, org.shape[0], block):
        o, iv = org[s:s + block, None], inv[s:s + block, None]
        t0 = (lo[None] - o) * iv
        t1 = (hi[None] - o) * iv
        tn = torch.minimum(t0, t1).amax(-1)
        tf = torch.maximum(t0, t1).amin(-1)
        meet = ((tn <= tf) & (tf >= tmin[s:s + block, None])
                & (tn <= tmax[s:s + block, None]))
        ri, ci = torch.nonzero(meet, as_tuple=True)
        yield ri + s, ci


def _cluster_tests(cl, org, d, tmin, tmax, alpha_fn, base=None):
    """Every (ray, triangle) test of the clusters `cl` that each ray
    meets, in blocks: yields (ray index, t with BIG where no opaque hit,
    u, v, flat triangle id, hit).  `base` (R,) is added to the local
    ids of an instance's mesh."""
    S = cl.size
    tri = cl.tri
    lane = torch.arange(S, device=org.device)
    per = max(1, TEST_BLOCK // S)
    for ri, ci in _candidates(cl.lo, cl.hi, org, d, tmin, tmax):
        for s in range(0, ri.shape[0], per):
            r = ri[s:s + per, None].expand(-1, S).reshape(-1)
            k = (cl.start[ci[s:s + per], None] + lane).reshape(-1)
            t, u, v, hit = ray_triangle(org[r], d[r], tri["v0"][k],
                                        tri["e1"][k], tri["e2"][k],
                                        tmin[r], tmax[r])
            pid = tri["id"][k]
            if base is not None:
                pid = torch.where(pid >= 0, pid + base[r], pid)
            if alpha_fn is not None:
                m = hit & tri["masked"][k]
                if bool(m.any()):
                    idx = torch.nonzero(m, as_tuple=True)[0]
                    opaque = alpha_fn(pid[idx], u[idx], v[idx])
                    hit = hit.clone()
                    hit[idx] = opaque
                    t = torch.where(hit, t, BIG)
            yield r, t, u, v, pid, hit


def _tests(scene, org, d, tmin, tmax, alpha_fn):
    """Every (ray, triangle) test the scene's clusters or instances
    call for: yields as `_cluster_tests`, with ray indices into org."""
    if scene.instances is None:
        yield from _cluster_tests(scene.clusters, org, d, tmin, tmax,
                                  alpha_fn)
        return
    inst = scene.instances
    for ri, ii in _candidates(inst.lo, inst.hi, org, d, tmin, tmax):
        of = inst.mesh[ii]
        for m, cl in enumerate(inst.meshes):
            sel = torch.nonzero(of == m, as_tuple=True)[0]
            if sel.numel() == 0:
                continue
            r, i = ri[sel], ii[sel]
            rot = inst.rot[i]
            o = (rot @ org[r, :, None])[..., 0] + inst.off[i]
            dd = (rot @ d[r, :, None])[..., 0]
            for p, t, u, v, pid, hit in _cluster_tests(
                    cl, o, dd, tmin[r], tmax[r], alpha_fn, inst.base[i]):
                yield r[p], t, u, v, pid, hit


def closest_hit(scene, org, d, tmin, tmax, active, masked: bool) -> Hit:
    """The nearest opaque hit of each active ray in (tmin, tmax); misses
    and inactive rays read t = BIG, prim_id = -1."""
    R = org.shape[0]
    dev = org.device
    best_t = torch.full((R,), BIG, device=dev)
    best_u = torch.zeros((R,), device=dev)
    best_v = torch.zeros((R,), device=dev)
    best_id = torch.full((R,), -1, dtype=torch.int64, device=dev)
    lanes = torch.nonzero(active, as_tuple=True)[0]
    if lanes.numel() == 0:
        return Hit(best_t, best_u, best_v, best_id.to(torch.int32))
    tmax = torch.as_tensor(tmax, dtype=torch.float32, device=dev).expand(R)
    alpha_fn = _alpha(scene) if masked else None
    o, dd, t0, t1 = org[lanes], d[lanes], tmin[lanes], tmax[lanes]
    bt = torch.full((lanes.shape[0],), BIG, device=dev)
    bu, bv = torch.zeros_like(bt), torch.zeros_like(bt)
    bid = torch.full(bt.shape, -1, dtype=torch.int64, device=dev)
    for r, t, u, v, pid, _ in _tests(scene, o, dd, t0, t1, alpha_fn):
        m = torch.full_like(bt, BIG).scatter_reduce(0, r, t, "amin")
        # Among the block's tests at the minimum, the lowest triangle id.
        win = (t == m[r]) & (t < BIG)
        big = torch.iinfo(torch.int64).max
        key = torch.where(win, pid, big)
        kmin = torch.full_like(bid, big).scatter_reduce(0, r, key, "amin")
        pick = win & (pid == kmin[r])
        pr, nt, nid = r[pick], t[pick], pid[pick]
        rep = (nt < bt[pr]) | ((nt == bt[pr]) & (nid < bid[pr]))
        pr = pr[rep]
        bt[pr] = nt[rep]
        bu[pr] = u[pick][rep]
        bv[pr] = v[pick][rep]
        bid[pr] = nid[rep]
    best_t[lanes], best_u[lanes], best_v[lanes] = bt, bu, bv
    best_id[lanes] = bid
    return Hit(best_t, best_u, best_v, best_id.to(torch.int32))


def any_hit(scene, org, d, tmin, tmax, active, masked: bool):
    """Whether each active ray meets an opaque triangle in (tmin, tmax)."""
    R = org.shape[0]
    occluded = torch.zeros((R,), dtype=torch.bool, device=org.device)
    lanes = torch.nonzero(active, as_tuple=True)[0]
    if lanes.numel() == 0:
        return occluded
    alpha_fn = _alpha(scene) if masked else None
    occ = torch.zeros((lanes.shape[0],), dtype=torch.bool, device=org.device)
    for r, _, _, _, _, hit in _tests(scene, org[lanes], d[lanes],
                                      tmin[lanes], tmax[lanes], alpha_fn):
        occ[r[hit]] = True
    occluded[lanes] = occ
    return occluded


def _alpha(scene):
    return MaskTest(scene.attrs.mask_rec, scene.textures)
