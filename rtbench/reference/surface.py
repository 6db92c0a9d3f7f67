"""Frozen copy of the program's `render/surface.py`, for the benchmark's plain
reference; its own description follows.

Surface interaction assembly from traversal hits (torch twin of
imbatracer_tpu.render.surface).

One row fetch of the joined shade record per hit (plain indexing; the
TPU's gather-free fetch tiers in ops/take.py have no counterpart here),
attribute lerp with weights (1-u-v, u, v), optional bump mapping, and the
shading normal flipped into the geometric normal's hemisphere.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .sampling import local_coordinates
from .vecmath import dot, normalize
from .textures import sample_bilinear
from . import materials as mat_mod


class SurfaceInteraction(NamedTuple):
    pos: torch.Tensor       # (R, 3)
    w_out: torch.Tensor     # (R, 3) toward the ray origin
    normal: torch.Tensor    # (R, 3) shading normal (bumped, hemisphere-fixed)
    gn: torch.Tensor        # (R, 3) geometric normal
    uv: torch.Tensor        # (R, 2)
    mat_id: torch.Tensor    # (R,) i32
    light_id: torch.Tensor  # (R,) i32, -1 unless emitter
    emit: torch.Tensor      # (R, 3)
    area: torch.Tensor      # (R,)
    params: dict


def make_interaction(scene, hit, org, d,
                     has_bump: bool = False) -> SurfaceInteraction:
    """Per-hit shading data.  Rows with hit.prim_id < 0 hold garbage that
    callers mask."""
    rec = scene.attrs.shade_rec[hit.prim_id.clamp(min=0).long()]
    cpos = {c: i for i, c in enumerate(scene.attrs.shade_cols)}
    zero1 = hit.t * 0.0

    def row1(c):
        return rec[:, cpos[c]] if c in cpos else zero1

    def row3(c):
        if c in cpos:
            return rec[:, cpos[c]:cpos[c] + 3]
        return zero1[:, None].expand(-1, 3)

    def row2(c):
        return rec[:, cpos[c]:cpos[c] + 2]

    def bits(c, absent=-1):
        if c in cpos:
            return rec[:, cpos[c]].contiguous().view(torch.int32)
        return torch.full_like(zero1, absent, dtype=torch.int32)

    w0 = (1.0 - hit.u - hit.v)[..., None]
    wu = hit.u[..., None]
    wv = hit.v[..., None]
    if 12 in cpos:
        uv = w0 * row2(12) + wu * row2(14) + wv * row2(16)
    else:
        uv = zero1[:, None].expand(-1, 2)
    n = normalize(w0 * row3(0) + wu * row3(3) + wv * row3(6))
    gn = row3(9)

    kd = row3(23)
    kd_tex = bits(38)
    has_textures = scene.textures.texels.shape[0] > 1
    if has_textures:
        kd = torch.where((kd_tex >= 0)[..., None],
                         sample_bilinear(scene.textures, kd_tex, uv[..., 0],
                                         uv[..., 1]), kd)
    params = mat_mod.MatParams(
        kind=bits(22), kd=kd, ks=row3(26), tf=row3(29), ns=row1(32),
        ior=row1(33), emit=row3(34), kd_tex=kd_tex, bump_tex=bits(39),
        mask_tex=bits(40))

    if has_bump and has_textures:
        n = _bump_normal(scene, params["bump_tex"], uv, n)
    n = torch.where(dot(gn, n)[..., None] < 0.0, -n, n)

    return SurfaceInteraction(
        pos=org + hit.t[..., None] * d, w_out=-normalize(d), normal=n, gn=gn,
        uv=uv, mat_id=bits(18), light_id=bits(19), emit=row3(34),
        area=row1(37), params=params)


def _bump_normal(scene, bump_tex, uv, n):
    """Central-difference bump mapping; du = dv = 1e-3, vscale = 0.02."""
    du = 1e-3
    vscale = 0.02
    u, v = uv[..., 0], uv[..., 1]
    s = lambda uu, vv: sample_bilinear(scene.textures, bump_tex, uu, vv)[..., 0]
    h0 = s(u, v)
    diff_u = vscale * (s(u + du, v) - h0) / du
    diff_v = vscale * (s(u, v + du) - h0) / du
    t, b = local_coordinates(n)
    t2 = normalize(t + diff_u[..., None] * n)
    b2 = normalize(b + diff_v[..., None] * n)
    n_bumped = normalize(torch.linalg.cross(t2, b2, dim=-1))
    return torch.where((bump_tex >= 0)[..., None], n_bumped, n)
