"""Frozen copy of the program's `render/lights.py`, for the benchmark's plain
reference; its own description follows.

Batched NEE light sampling over an SoA light table (torch twin of
imbatracer_tpu.render.lights).

Kinds: TRI (area emitter), POINT, DIR(ectional), SPOT, ENV.  The
`{radiance, cos_out, pdf_emit_w, pdf_direct_w|a}` contract and the kind
select order follow the JAX module: `sample_direct` for NEE shadow rays,
`sample_emit` for the light paths of the VCM family.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .sampling import (PI, concentric_disc_pdf, cos_hemisphere_pdf,
                             local_coordinates, sample_concentric_disc,
                             sample_cos_hemisphere, sample_uniform_cone,
                             sample_uniform_sphere, sample_uniform_triangle,
                             to_world, uniform_cone_pdf, uniform_sphere_pdf)
from .vecmath import dot, normalize, where3
from .tensors import TensorData
from . import envmap as envmap_mod

LIGHT_TRI = 0
LIGHT_POINT = 1
LIGHT_DIR = 2
LIGHT_SPOT = 3
LIGHT_ENV = 4

FAR = 1e30


@dataclass
class LightTable(TensorData):
    """SoA light storage.  `rec` layout: [kind(0, i32 bits), p0(1:4),
    p1(4:7), p2(7:10), normal(10:13), intensity(13:16), area(16),
    cos_angle(17), pad(18:24)]."""

    rec: torch.Tensor        # (L, 24) f32
    kind: torch.Tensor       # (L,) i32
    p0: torch.Tensor         # (L, 3)
    p1: torch.Tensor         # (L, 3)
    p2: torch.Tensor         # (L, 3)
    normal: torch.Tensor     # (L, 3)
    intensity: torch.Tensor  # (L, 3)
    area: torch.Tensor       # (L,)
    cos_angle: torch.Tensor  # (L,)


@dataclass
class BSphere(TensorData):
    center: torch.Tensor          # (3,)
    radius: torch.Tensor          # ()
    inv_radius_sqr: torch.Tensor  # ()


class DirectSample(NamedTuple):
    dir: torch.Tensor
    distance: torch.Tensor
    radiance: torch.Tensor
    cos_out: torch.Tensor
    pdf_emit_w: torch.Tensor
    pdf_direct_w: torch.Tensor
    is_delta: torch.Tensor


class EmitSample(NamedTuple):
    """One photon-emission sample."""

    pos: torch.Tensor
    dir: torch.Tensor
    radiance: torch.Tensor
    cos_out: torch.Tensor
    pdf_emit_w: torch.Tensor
    pdf_direct_a: torch.Tensor
    is_finite: torch.Tensor
    is_delta: torch.Tensor


def _has(kinds, K) -> bool:
    return (not kinds) or (K in kinds)


def _chain(kind, pairs):
    """Ordered (kind_id, value) select chain; the first pair is the base."""
    if not pairs:
        raise ValueError("empty kind-select chain: the kinds tuple does not "
                         "cover the light table")
    acc = pairs[0][1]
    for K, v in pairs[1:]:
        m = kind == K
        acc = where3(m, v, acc) if acc.dim() == kind.dim() + 1 else \
            torch.where(m, v, acc)
    return acc


def is_delta_kind(kind):
    return (kind == LIGHT_POINT) | (kind == LIGHT_DIR) | (kind == LIGHT_SPOT)


def is_finite_kind(kind):
    return (kind != LIGHT_DIR) & (kind != LIGHT_ENV)


def _fetch(lights: LightTable, light_idx):
    """Per-ray light rows: (kind, p0, p1, p2, n, intensity, area,
    cos_angle)."""
    rec = lights.rec[light_idx.clamp(min=0).long()]
    return (rec[:, 0].contiguous().view(torch.int32), rec[:, 1:4],
            rec[:, 4:7], rec[:, 7:10], rec[:, 10:13], rec[:, 13:16],
            rec[:, 16], rec[:, 17])


def sample_emit(lights: LightTable, light_idx, u1, u2, u3, u4,
                bsphere: BSphere, env=None, kinds: tuple = ()) -> EmitSample:
    """Sample an outgoing photon ray from light `light_idx` (the light
    pass).  `kinds`: the scene's static light-kind set; `env`: the
    scene's EnvMapData, which an ENV light samples."""
    if env is None and LIGHT_ENV in kinds:
        raise ValueError("the light table holds an environment light but "
                         "no environment map was given")
    kind, p0, p1, p2, n, intensity, area_row, cos_angle = _fetch(lights,
                                                                 light_idx)
    has = lambda K: _has(kinds, K)
    poss, dirss, rads, pdf_es, pdf_das, cos_outs = [], [], [], [], [], []
    ones = torch.ones_like(area_row)

    if has(LIGHT_TRI):
        area = torch.clamp(area_row, min=1e-12)
        tu, tv = sample_uniform_triangle(u1, u2)
        pos_t = (tu[..., None] * p0 + tv[..., None] * p1
                 + (1.0 - tu - tv)[..., None] * p2)
        d_loc, pdf_cos = sample_cos_hemisphere(u3, u4)
        dir_t = to_world(d_loc, n)
        degen = pdf_cos <= 0.0
        poss.append((LIGHT_TRI, pos_t))
        dirss.append((LIGHT_TRI, dir_t))
        rads.append((LIGHT_TRI, torch.where(
            degen[..., None], 0.0, intensity * (area * PI)[..., None])))
        pdf_es.append((LIGHT_TRI, torch.where(degen, 1.0, pdf_cos / area)))
        pdf_das.append((LIGHT_TRI, torch.where(degen, 1.0, 1.0 / area)))
        cos_outs.append((LIGHT_TRI, torch.where(degen, 0.0, d_loc[..., 2])))

    if has(LIGHT_POINT):
        d_sph, pdf_sph = sample_uniform_sphere(u3, u4)
        poss.append((LIGHT_POINT, p0))
        dirss.append((LIGHT_POINT, d_sph))
        rads.append((LIGHT_POINT, intensity))
        pdf_es.append((LIGHT_POINT, pdf_sph))
        pdf_das.append((LIGHT_POINT, ones))
        cos_outs.append((LIGHT_POINT, ones))

    has_env = env is not None and has(LIGHT_ENV)
    if has(LIGHT_DIR) or has_env:
        dx, dy = sample_concentric_disc(u1, u2)
    if has(LIGHT_DIR):
        # A disc on the bounding sphere, facing along the light.
        t_dir, b_dir = local_coordinates(n)
        pos_d = bsphere.center + bsphere.radius * (
            -n + b_dir * dx[..., None] + t_dir * dy[..., None])
        pdf_emit_d = concentric_disc_pdf() * bsphere.inv_radius_sqr
        poss.append((LIGHT_DIR, pos_d))
        dirss.append((LIGHT_DIR, torch.broadcast_to(n, p0.shape)))
        rads.append((LIGHT_DIR, intensity / pdf_emit_d))
        pdf_es.append((LIGHT_DIR, torch.broadcast_to(pdf_emit_d, ones.shape)))
        pdf_das.append((LIGHT_DIR, ones))
        cos_outs.append((LIGHT_DIR, ones))

    if has(LIGHT_SPOT):
        d_cone, pdf_cone = sample_uniform_cone(cos_angle, u3, u4)
        poss.append((LIGHT_SPOT, p0))
        dirss.append((LIGHT_SPOT, to_world(d_cone, n)))
        rads.append((LIGHT_SPOT, intensity / pdf_cone[..., None]))
        pdf_es.append((LIGHT_SPOT, pdf_cone))
        pdf_das.append((LIGHT_SPOT, ones))
        cos_outs.append((LIGHT_SPOT, ones))

    if has_env:
        env_dir, env_li, env_pdf = envmap_mod.sample_dir(env, u3, u4)
        inward = -env_dir
        te, be = local_coordinates(inward)
        pos_e = bsphere.center + bsphere.radius * (
            -inward + be * dx[..., None] + te * dy[..., None])
        pdf_emit_e = concentric_disc_pdf() * bsphere.inv_radius_sqr * env_pdf
        poss.append((LIGHT_ENV, pos_e))
        dirss.append((LIGHT_ENV, inward))
        rads.append((LIGHT_ENV, env_li / torch.clamp(
            pdf_emit_e, min=1e-20)[..., None]))
        pdf_es.append((LIGHT_ENV, pdf_emit_e))
        pdf_das.append((LIGHT_ENV, env_pdf))
        cos_outs.append((LIGHT_ENV, ones))

    return EmitSample(
        pos=_chain(kind, poss),
        dir=normalize(_chain(kind, dirss)),
        radiance=_chain(kind, rads),
        cos_out=_chain(kind, cos_outs),
        pdf_emit_w=_chain(kind, pdf_es),
        pdf_direct_a=_chain(kind, pdf_das),
        is_finite=is_finite_kind(kind),
        is_delta=is_delta_kind(kind),
    )


def sample_direct(lights: LightTable, light_idx, from_pos, u1, u2,
                  bsphere: BSphere, env=None,
                  kinds: tuple = ()) -> DirectSample:
    """Sample a point / direction on light `light_idx` for NEE shadow
    rays.  `kinds`: the scene's static light-kind set; `env`: the
    scene's EnvMapData, which an ENV light samples."""
    if env is None and LIGHT_ENV in kinds:
        raise ValueError("the light table holds an environment light but "
                         "no environment map was given")
    kind, p0, p1, p2, n, intensity, area, cos_angle = _fetch(lights,
                                                             light_idx)
    has = lambda K: _has(kinds, K)
    dirs, dists, rads, pdf_es, pdf_ds, cos_outs = [], [], [], [], [], []
    ones = torch.ones_like(area)

    if has(LIGHT_TRI):
        tu, tv = sample_uniform_triangle(u1, u2)
        pos = (tu[..., None] * p0 + tv[..., None] * p1
               + (1.0 - tu - tv)[..., None] * p2)
        to_l = pos - from_pos
        distsq_t = torch.clamp(dot(to_l, to_l), min=1e-12)
        dist_t = torch.sqrt(distsq_t)
        dir_t = to_l / dist_t[..., None]
        cos_out_t = dot(n, -dir_t)
        front = (cos_out_t > 0.0) & (cos_out_t < 1.0)
        rad_t = torch.where(
            front[..., None],
            intensity * (cos_out_t * area / distsq_t)[..., None], 0.0)
        pdf_emit_t = torch.where(
            front, cos_hemisphere_pdf(cos_out_t) / torch.clamp(area, min=1e-12),
            1.0)
        pdf_dir_t = torch.where(
            front, distsq_t / torch.clamp(area * cos_out_t, min=1e-12), 1.0)
        cos_out_t = torch.where(front, cos_out_t, 1.0)
        dirs.append((LIGHT_TRI, dir_t))
        dists.append((LIGHT_TRI, dist_t))
        rads.append((LIGHT_TRI, rad_t))
        pdf_es.append((LIGHT_TRI, pdf_emit_t))
        pdf_ds.append((LIGHT_TRI, pdf_dir_t))
        cos_outs.append((LIGHT_TRI, cos_out_t))

    if has(LIGHT_POINT) or has(LIGHT_SPOT):
        to_p = p0 - from_pos
        distsq_p = torch.clamp(dot(to_p, to_p), min=1e-12)
        dist_p = torch.sqrt(distsq_p)
        dir_p = to_p / dist_p[..., None]
    if has(LIGHT_POINT):
        rad_p = intensity / (4.0 * PI * distsq_p)[..., None]
        dirs.append((LIGHT_POINT, dir_p))
        dists.append((LIGHT_POINT, dist_p))
        rads.append((LIGHT_POINT, rad_p))
        pdf_es.append((LIGHT_POINT, torch.full_like(distsq_p,
                                                    uniform_sphere_pdf())))
        pdf_ds.append((LIGHT_POINT, distsq_p))
        cos_outs.append((LIGHT_POINT, ones))

    if has(LIGHT_DIR):
        dirs.append((LIGHT_DIR, -n))
        dists.append((LIGHT_DIR, torch.full_like(ones, FAR)))
        rads.append((LIGHT_DIR, intensity))
        pdf_es.append((LIGHT_DIR, (concentric_disc_pdf()
                                   * bsphere.inv_radius_sqr).expand(ones.shape)))
        pdf_ds.append((LIGHT_DIR, ones))
        cos_outs.append((LIGHT_DIR, ones))

    if has(LIGHT_SPOT):
        cos_o_s = -dot(dir_p, n)
        in_cone = cos_o_s >= cos_angle
        rad_s = torch.where(in_cone[..., None],
                            intensity / distsq_p[..., None], 0.0)
        pdf_emit_s = torch.where(in_cone, uniform_cone_pdf(cos_angle), 0.0)
        dirs.append((LIGHT_SPOT, dir_p))
        dists.append((LIGHT_SPOT, dist_p))
        rads.append((LIGHT_SPOT, rad_s))
        pdf_es.append((LIGHT_SPOT, pdf_emit_s))
        pdf_ds.append((LIGHT_SPOT, distsq_p))
        cos_outs.append((LIGHT_SPOT, ones))

    if env is not None and has(LIGHT_ENV):
        env_dir, env_li, env_pdf = envmap_mod.sample_dir(env, u1, u2)
        dirs.append((LIGHT_ENV, env_dir))
        dists.append((LIGHT_ENV, torch.full_like(ones, FAR)))
        rads.append((LIGHT_ENV,
                     env_li / torch.clamp(env_pdf, min=1e-20)[..., None]))
        pdf_es.append((LIGHT_ENV, concentric_disc_pdf()
                       * bsphere.inv_radius_sqr * env_pdf))
        pdf_ds.append((LIGHT_ENV, env_pdf))
        cos_outs.append((LIGHT_ENV, ones))

    return DirectSample(
        dir=_chain(kind, dirs),
        distance=_chain(kind, dists),
        radiance=_chain(kind, rads),
        cos_out=_chain(kind, cos_outs),
        pdf_emit_w=_chain(kind, pdf_es),
        pdf_direct_w=_chain(kind, pdf_ds),
        is_delta=is_delta_kind(kind),
    )


def build_light_table(rows: list[dict], device) -> LightTable:
    """Host-side table assembly from a list of per-light dicts; an empty
    list gives one black point light so the table is never empty."""
    L = max(len(rows), 1)

    def arr(key, default, width=None):
        shape = (L,) if width is None else (L, width)
        out = np.full(shape, default, np.float32)
        for i, r in enumerate(rows):
            if key in r:
                out[i] = r[key]
        return out

    kind = np.full((L,), LIGHT_POINT, np.int32)
    for i, r in enumerate(rows):
        kind[i] = r["kind"]

    rec = np.zeros((L, 24), np.float32)
    rec[:, 0] = kind.view(np.float32)
    rec[:, 1:4] = arr("p0", 0.0, 3)
    rec[:, 4:7] = arr("p1", 0.0, 3)
    rec[:, 7:10] = arr("p2", 0.0, 3)
    rec[:, 10:13] = arr("normal", 0.0, 3)
    rec[:, 13:16] = arr("intensity", 0.0, 3)
    rec[:, 16] = arr("area", 1.0)
    rec[:, 17] = arr("cos_angle", 0.0)
    t = lambda a: torch.as_tensor(a, device=device)
    return LightTable(
        rec=t(rec), kind=t(kind), p0=t(arr("p0", 0.0, 3)),
        p1=t(arr("p1", 0.0, 3)), p2=t(arr("p2", 0.0, 3)),
        normal=t(arr("normal", 0.0, 3)),
        intensity=t(arr("intensity", 0.0, 3)), area=t(arr("area", 1.0)),
        cos_angle=t(arr("cos_angle", 0.0)))
