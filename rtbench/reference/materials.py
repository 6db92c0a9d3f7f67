"""Frozen copy of the program's `render/materials.py`, for the benchmark's plain
reference; its own description follows.

Branchless, batched BSDF evaluation / sampling / pdf for all six
material kinds (torch twin of imbatracer_tpu.render.materials).

Every present kind's formula block is evaluated for every lane and the
result selected by kind id.  The static `kinds` tuple (the scene's kind
set, DeviceScene.mat_kinds) skips the blocks of absent kinds; `()` means
"unknown, evaluate all".  The formulas, the geometric-side checks and the
select order follow the JAX module line by line; see its docstring for
the model references.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .sampling import (INV_PI, PI, cos_hemisphere_pdf,
                             local_coordinates, sample_cos_hemisphere,
                             sample_power_cos_hemisphere, to_local, to_world)
from .vecmath import dot, where3
from .tensors import TensorData

MAT_DIFFUSE = 0
MAT_MIRROR = 1
MAT_GLASS = 2
MAT_GLOSSY = 3
MAT_PHONG = 4
MAT_OREN_NAYAR = 5


@dataclass
class MaterialTable(TensorData):
    """SoA material storage, one row per scene material.  `rec` layout:
    [kind(0, i32 bits), kd(1:4), ks(4:7), tf(7:10), ns(10), ior(11),
     emit(12:15), kd_tex(15), bump_tex(16), mask_tex(17) (i32 bits),
     pad(18:24)]."""

    rec: torch.Tensor       # (M, 24) f32
    kind: torch.Tensor      # (M,) i32
    kd: torch.Tensor        # (M, 3)
    ks: torch.Tensor        # (M, 3)
    tf: torch.Tensor        # (M, 3)
    ns: torch.Tensor        # (M,)
    ior: torch.Tensor       # (M,)
    emit: torch.Tensor      # (M, 3)
    kd_tex: torch.Tensor    # (M,) i32
    bump_tex: torch.Tensor  # (M,) i32
    mask_tex: torch.Tensor  # (M,) i32


class MatParams(dict):
    """Per-ray material parameters: kind, kd (post-texture), ks, tf, ns,
    ior, emit and the texture ids."""


def gather_params(table: MaterialTable, mat_id) -> MatParams:
    """Per-ray parameters from one row gather of the wide record."""
    rec = table.rec[mat_id.clamp(min=0).long()]
    bits = lambda c: rec[:, c].contiguous().view(torch.int32)
    return MatParams(
        kind=bits(0), kd=rec[:, 1:4], ks=rec[:, 4:7], tf=rec[:, 7:10],
        ns=rec[:, 10], ior=rec[:, 11], emit=rec[:, 12:15], kd_tex=bits(15),
        bump_tex=bits(16), mask_tex=bits(17))


def is_specular(p: MatParams) -> torch.Tensor:
    return (p["kind"] == MAT_MIRROR) | (p["kind"] == MAT_GLASS)


def _has(kinds, K) -> bool:
    return (not kinds) or (K in kinds)


def _pos(x):
    return torch.clamp(x, min=0.0)


# ---------------------------------------------------------------- fresnel

def fresnel_conductor(cos_i, eta, kappa):
    c2 = cos_i * cos_i
    ekc = (eta * eta + kappa * kappa) * c2
    two_ec = 2.0 * eta * cos_i
    par = (ekc - two_ec + 1.0) / (ekc + two_ec + 1.0)
    ek = eta * eta + kappa * kappa
    perp = (ek - two_ec + c2) / (ek + two_ec + c2)
    return 0.5 * (par + perp)


def fresnel_dielectric(cos_i_signed, eta_outside, eta_inside):
    entering = cos_i_signed > 0.0
    eta_i = torch.where(entering, eta_outside, eta_inside)
    eta_t = torch.where(entering, eta_inside, eta_outside)
    cos_i = torch.abs(cos_i_signed)
    sin_t = eta_i / eta_t * torch.sqrt(_pos(1.0 - cos_i * cos_i))
    tir = sin_t >= 1.0
    cos_t = torch.sqrt(_pos(1.0 - sin_t * sin_t))
    par = (eta_t * cos_i - eta_i * cos_t) / torch.clamp(
        eta_t * cos_i + eta_i * cos_t, min=1e-20)
    perp = (eta_i * cos_i - eta_t * cos_t) / torch.clamp(
        eta_i * cos_i + eta_t * cos_t, min=1e-20)
    fr = 0.5 * (par * par + perp * perp)
    return torch.where(tir, 1.0, fr)


# ------------------------------------------------------------ cook-torrance

def _ct_g(lo, li, h):
    o_dot_h = torch.clamp(torch.sum(lo * h, dim=-1), min=1e-12)
    a = 2.0 * torch.abs(h[..., 2]) * torch.abs(lo[..., 2]) / o_dot_h
    b = 2.0 * torch.abs(h[..., 2]) * torch.abs(li[..., 2]) / o_dot_h
    return torch.clamp(torch.minimum(a, b), max=1.0)


def _half(lo, li):
    h = lo + li
    h_len = torch.sqrt(torch.clamp(torch.sum(h * h, dim=-1, keepdim=True),
                                   min=1e-20))
    return h / h_len


def _ct_eval(ks, ns, lo, li):
    """Cook-Torrance with Blinn D."""
    h = _half(lo, li)
    cos_half = torch.sum(li * h, dim=-1)
    fr = fresnel_conductor(cos_half, 1.0, ns)
    d = (ns + 2.0) / (2.0 * PI) * torch.pow(
        torch.clamp(torch.abs(h[..., 2]), min=1e-12), ns)
    g = _ct_g(lo, li, h)
    denom = 4.0 * torch.clamp(torch.abs(li[..., 2]) * torch.abs(lo[..., 2]),
                              min=1e-12)
    same_hemi = lo[..., 2] * li[..., 2] > 0.0
    val = ks * ((d * g * fr) / denom)[..., None]
    return torch.where(same_hemi[..., None], val, 0.0)


def _ct_pdf(ns, lo, li):
    """Blinn half-vector pdf."""
    h = _half(lo, li)
    o_dot_h = torch.sum(lo * h, dim=-1)
    same_hemi = lo[..., 2] * li[..., 2] > 0.0
    pdf = (ns + 1.0) * torch.pow(torch.clamp(torch.abs(h[..., 2]), min=1e-12),
                                 ns) / (
        2.0 * PI * 4.0 * torch.clamp(o_dot_h, min=1e-12))
    return torch.where(same_hemi & (o_dot_h > 0.0), pdf, 0.0)


def _ct_sample(ns, lo, u1, u2):
    """Sample the Blinn distribution, reflect about the half vector."""
    c_theta = torch.pow(u1, 1.0 / (ns + 1.0))
    s_theta = torch.sqrt(_pos(1.0 - c_theta * c_theta))
    phi = u2 * 2.0 * PI
    h = torch.stack([s_theta * torch.cos(phi), s_theta * torch.sin(phi),
                     c_theta], dim=-1)
    flip = (lo[..., 2] * h[..., 2]) <= 0.0
    h = torch.where(flip[..., None], -h, h)
    o_dot_h = torch.sum(lo * h, dim=-1)
    li = -lo + 2.0 * o_dot_h[..., None] * h
    pdf = (ns + 1.0) * torch.pow(c_theta, ns) / (
        2.0 * PI * 4.0 * torch.clamp(o_dot_h, min=1e-12))
    return li, torch.where(o_dot_h > 0.0, pdf, 1.0)


def _ct_eval_pdf2(ks, ns, lo, li):
    """Cook-Torrance eval + Blinn pdf in both directions, sharing the
    half vector and the lobe power."""
    h = _half(lo, li)
    o_dot_h_f = torch.sum(lo * h, dim=-1)
    o_dot_h_r = torch.sum(li * h, dim=-1)
    same_hemi = lo[..., 2] * li[..., 2] > 0.0
    pow_h = torch.pow(torch.clamp(torch.abs(h[..., 2]), min=1e-12), ns)

    fr = fresnel_conductor(o_dot_h_r, 1.0, ns)
    d = (ns + 2.0) / (2.0 * PI) * pow_h
    g = _ct_g(lo, li, h)
    denom = 4.0 * torch.clamp(torch.abs(li[..., 2]) * torch.abs(lo[..., 2]),
                              min=1e-12)
    f = ks * ((d * g * fr) / denom)[..., None]
    f = torch.where(same_hemi[..., None], f, 0.0)

    def bpdf(o_dot_h):
        pdf = (ns + 1.0) * pow_h / (2.0 * PI * 4.0
                                    * torch.clamp(o_dot_h, min=1e-12))
        return torch.where(same_hemi & (o_dot_h > 0.0), pdf, 0.0)

    return f, bpdf(o_dot_h_f), bpdf(o_dot_h_r)


# ------------------------------------------------------------------ phong

def _mirror_local(v):
    return torch.stack([-v[..., 0], -v[..., 1], v[..., 2]], dim=-1)


def _phong_eval(ks, ns, lo, li):
    cos_ro = torch.clamp(torch.sum(_mirror_local(li) * lo, dim=-1), 0.0, 1.0)
    same = lo[..., 2] * li[..., 2] > 0.0
    val = ks * ((ns + 2.0) / (2.0 * PI) * torch.pow(cos_ro, ns))[..., None]
    return torch.where(same[..., None], val, 0.0)


def _phong_pdf(ns, lo, li):
    """Power-cosine pdf about the mirror direction of `lo`."""
    c = _pos(torch.sum(_mirror_local(lo) * li, dim=-1))
    return (ns + 1.0) / (2.0 * PI) * torch.pow(c, ns)


def _phong_sample(ns, lo, u1, u2):
    d_loc, pdf = sample_power_cos_hemisphere(ns, u1, u2)
    return to_world(d_loc, _mirror_local(lo)), pdf


def _phong_eval_pdf2(ks, ns, lo, li, same_hemi):
    m = torch.sum(_mirror_local(li) * lo, dim=-1)
    cos_ro = torch.clamp(m, 0.0, 1.0)
    val = ks * ((ns + 2.0) / (2.0 * PI) * torch.pow(cos_ro, ns))[..., None]
    f = torch.where(same_hemi[..., None], val, 0.0)
    pdf = (ns + 1.0) / (2.0 * PI) * torch.pow(_pos(m), ns)
    return f, pdf


# -------------------------------------------------------------- oren-nayar

def _oren_nayar_eval(kd, sigma_deg, lo, li):
    sigma = sigma_deg * (PI / 180.0)
    s2 = sigma * sigma
    a = 1.0 - s2 / (2.0 * (s2 + 0.33))
    b = 0.45 * s2 / (s2 + 0.09)

    def sin_theta(v):
        return torch.sqrt(_pos(1.0 - v[..., 2] * v[..., 2]))

    st_i = sin_theta(li)
    st_o = sin_theta(lo)
    denom = torch.clamp(st_i * st_o, min=1e-6)
    cos_dphi = (li[..., 0] * lo[..., 0] + li[..., 1] * lo[..., 1]) / denom
    max_cos = torch.where((st_i > 1e-4) & (st_o > 1e-4), _pos(cos_dphi), 0.0)

    abs_ci = torch.abs(li[..., 2])
    abs_co = torch.abs(lo[..., 2])
    sin_alpha = torch.where(abs_ci > abs_co, st_o, st_i)
    tan_beta = torch.where(abs_ci > abs_co,
                           st_i / torch.clamp(abs_ci, min=1e-6),
                           st_o / torch.clamp(abs_co, min=1e-6))
    same = lo[..., 2] * li[..., 2] > 0.0
    val = kd * (INV_PI * (a + b * max_cos * sin_alpha * tan_beta))[..., None]
    return torch.where(same[..., None], val, 0.0)


def _lambert_eval(kd, lo, li):
    same = lo[..., 2] * li[..., 2] > 0.0
    return torch.where(same[..., None], kd * INV_PI, 0.0)


# ---------------------------------------------------------------- eval/pdf

def pdf_bsdf(p: MatParams, n, gn, wo, wi, kinds: tuple = ()):
    """Solid-angle pdf of sample_bsdf picking wi; zero for delta kinds."""
    lo = to_local(wo, n)
    li = to_local(wi, n)
    same_geom = dot(wo, gn) * dot(wi, gn) > 0.0
    same_hemi = lo[..., 2] * li[..., 2] > 0.0
    pdf_cos = torch.where(same_hemi,
                          cos_hemisphere_pdf(torch.abs(li[..., 2])), 0.0)
    kind = p["kind"]
    pdf = torch.zeros_like(pdf_cos)
    if _has(kinds, MAT_DIFFUSE):
        pdf = torch.where(kind == MAT_DIFFUSE, pdf_cos, pdf)
    if _has(kinds, MAT_GLOSSY):
        pdf = torch.where(kind == MAT_GLOSSY,
                          0.5 * (_ct_pdf(p["ns"], lo, li) + pdf_cos), pdf)
    if _has(kinds, MAT_PHONG):
        pdf = torch.where(kind == MAT_PHONG, _phong_pdf(p["ns"], lo, li), pdf)
    if _has(kinds, MAT_OREN_NAYAR):
        pdf = torch.where(kind == MAT_OREN_NAYAR, pdf_cos, pdf)
    return torch.where(same_geom, pdf, 0.0)


def eval_pdf_bsdf(p: MatParams, n, gn, wo, wi, kinds: tuple = ()):
    """Fused BSDF value + forward pdf + reverse pdf; zero for delta kinds.
    Returns (f, pdf_fwd, pdf_rev)."""
    t, b = local_coordinates(n)

    def proj(v):
        return torch.stack([torch.sum(v * t, dim=-1), torch.sum(v * b, dim=-1),
                            torch.sum(v * n, dim=-1)], dim=-1)

    lo = proj(wo)
    li = proj(wi)
    same_geom = dot(wo, gn) * dot(wi, gn) > 0.0
    same_hemi = lo[..., 2] * li[..., 2] > 0.0
    kind = p["kind"]

    f_diff = _lambert_eval(p["kd"], lo, li)
    pdf_cos_f = torch.where(same_hemi,
                            cos_hemisphere_pdf(torch.abs(li[..., 2])), 0.0)
    pdf_cos_r = torch.where(same_hemi,
                            cos_hemisphere_pdf(torch.abs(lo[..., 2])), 0.0)

    f = torch.zeros_like(f_diff)
    pdf_f = torch.zeros_like(pdf_cos_f)
    pdf_r = torch.zeros_like(pdf_cos_r)

    def sel(K, fv, pf, pr):
        nonlocal f, pdf_f, pdf_r
        m = kind == K
        f = where3(m, fv, f)
        pdf_f = torch.where(m, pf, pdf_f)
        pdf_r = torch.where(m, pr, pdf_r)

    if _has(kinds, MAT_DIFFUSE):
        sel(MAT_DIFFUSE, f_diff, pdf_cos_f, pdf_cos_r)
    if _has(kinds, MAT_GLOSSY):
        ct_f, ct_pdf_f, ct_pdf_r = _ct_eval_pdf2(p["ks"], p["ns"], lo, li)
        sel(MAT_GLOSSY, 0.5 * (ct_f + f_diff),
            0.5 * (ct_pdf_f + pdf_cos_f), 0.5 * (ct_pdf_r + pdf_cos_r))
    if _has(kinds, MAT_PHONG):
        ph_f, ph_pdf = _phong_eval_pdf2(p["ks"], p["ns"], lo, li, same_hemi)
        sel(MAT_PHONG, ph_f, ph_pdf, ph_pdf)
    if _has(kinds, MAT_OREN_NAYAR):
        sel(MAT_OREN_NAYAR, _oren_nayar_eval(p["kd"], p["ns"], lo, li),
            pdf_cos_f, pdf_cos_r)

    f = where3(same_geom, f, torch.zeros_like(f))
    pdf_f = torch.where(same_geom, pdf_f, 0.0)
    pdf_r = torch.where(same_geom, pdf_r, 0.0)
    return f, pdf_f, pdf_r


# ------------------------------------------------------------------ sample

def sample_bsdf(p: MatParams, n, gn, wo, u1, u2, u3, adjoint: bool = False,
                kinds: tuple = ()):
    """Sample an incoming direction.  Returns (wi, f, pdf, specular,
    valid); `f` excludes the cosine term, `pdf` includes the
    component-choice probabilities.  `adjoint` (light paths) drops the
    (eta_i / eta_t)^2 radiance scaling of glass transmission."""
    lo = to_local(wo, n)
    kind = p["kind"]
    has = lambda K: _has(kinds, K)
    need_cos = has(MAT_DIFFUSE) or has(MAT_GLOSSY) or has(MAT_OREN_NAYAR)
    need_mirror_dir = has(MAT_MIRROR) or has(MAT_GLASS)

    li_sel, f_sel, pdf_sel = [], [], []

    if need_cos:
        sign_o = torch.where(lo[..., 2] >= 0.0, 1.0, -1.0)
        d_cos, _ = sample_cos_hemisphere(u1, u2)
        d_cos = torch.cat([d_cos[..., :2], d_cos[..., 2:3] * sign_o[..., None]],
                          dim=-1)

    if has(MAT_GLOSSY):
        li_blinn, _ = _ct_sample(p["ns"], lo, u1, u2)
        li_glossy = where3(u3 < 0.5, li_blinn, d_cos)

    if need_mirror_dir:
        li_mirror = torch.stack([-lo[..., 0], -lo[..., 1], lo[..., 2]], dim=-1)
    if has(MAT_MIRROR):
        fr_cond = fresnel_conductor(lo[..., 2], 1.0, p["ns"])
        f_mirror = p["ks"] * (fr_cond / torch.clamp(torch.abs(lo[..., 2]),
                                                    min=1e-12))[..., None]

    if has(MAT_GLASS):
        ior = p["ior"]
        fr_diel = fresnel_dielectric(lo[..., 2], torch.ones_like(ior), ior)
        btdf_prob = 1.0 - fr_diel
        choose_trans = u3 < btdf_prob
        entering = lo[..., 2] > 0.0
        eta_i = torch.where(entering, 1.0, ior)
        eta_t = torch.where(entering, ior, 1.0)
        eta_frac = eta_i / eta_t
        sin_i_sqr = _pos(1.0 - lo[..., 2] * lo[..., 2])
        sin_t_sqr = eta_frac * eta_frac * sin_i_sqr
        tir = sin_t_sqr >= 1.0
        cos_t = torch.sqrt(_pos(1.0 - sin_t_sqr))
        cos_t = torch.where(entering, -cos_t, cos_t)
        li_trans = torch.stack([-eta_frac * lo[..., 0],
                                -eta_frac * lo[..., 1], cos_t], dim=-1)
        li_trans = torch.where(tir[..., None], li_mirror, li_trans)
        # Radiance transport scales transmission by (eta_i / eta_t)^2, the
        # adjoint (light tracing) does not.
        radiance_factor = 1.0 if adjoint else eta_frac * eta_frac
        f_trans = p["tf"] * (
            radiance_factor * (1.0 - fr_diel)
            / torch.clamp(torch.abs(li_trans[..., 2]), min=1e-12))[..., None]
        f_trans = torch.where(tir[..., None], 0.0, f_trans)
        f_glass_refl = p["ks"] * (fr_diel / torch.clamp(
            torch.abs(lo[..., 2]), min=1e-12))[..., None]
        li_glass = where3(choose_trans, li_trans, li_mirror)
        f_glass = where3(choose_trans, f_trans, f_glass_refl)
        pdf_glass = torch.where(choose_trans, btdf_prob, 1.0 - btdf_prob)

    if has(MAT_PHONG):
        li_phong, _ = _phong_sample(p["ns"], lo, u1, u2)

    if has(MAT_DIFFUSE):
        li_sel.append((MAT_DIFFUSE, d_cos))
    if has(MAT_GLOSSY):
        li_sel.append((MAT_GLOSSY, li_glossy))
    if has(MAT_MIRROR):
        li_sel.append((MAT_MIRROR, li_mirror))
    if has(MAT_GLASS):
        li_sel.append((MAT_GLASS, li_glass))
    if has(MAT_PHONG):
        li_sel.append((MAT_PHONG, li_phong))
    if has(MAT_OREN_NAYAR):
        li_sel.append((MAT_OREN_NAYAR, d_cos))
    li = li_sel[0][1]
    for K, v in li_sel[1:]:
        li = where3(kind == K, v, li)

    wi = to_world(li, n)

    if need_cos:
        f_diff = _lambert_eval(p["kd"], lo, li)
        pdf_diff = torch.where(lo[..., 2] * li[..., 2] > 0.0,
                               cos_hemisphere_pdf(torch.abs(li[..., 2])), 0.0)
    if has(MAT_DIFFUSE):
        f_sel.append((MAT_DIFFUSE, f_diff))
        pdf_sel.append((MAT_DIFFUSE, pdf_diff))
    if has(MAT_GLOSSY):
        f_glossy = 0.5 * (_ct_eval(p["ks"], p["ns"], lo, li)
                          + _lambert_eval(p["kd"], lo, li))
        pdf_glossy = 0.5 * (_ct_pdf(p["ns"], lo, li) + pdf_diff)
        f_sel.append((MAT_GLOSSY, f_glossy))
        pdf_sel.append((MAT_GLOSSY, pdf_glossy))
    if has(MAT_MIRROR):
        f_sel.append((MAT_MIRROR, f_mirror))
        pdf_sel.append((MAT_MIRROR, torch.ones_like(lo[..., 2])))
    if has(MAT_GLASS):
        f_sel.append((MAT_GLASS, f_glass))
        pdf_sel.append((MAT_GLASS, pdf_glass))
    if has(MAT_PHONG):
        f_sel.append((MAT_PHONG, _phong_eval(p["ks"], p["ns"], lo, li)))
        pdf_sel.append((MAT_PHONG, _phong_pdf(p["ns"], lo, li)))
    if has(MAT_OREN_NAYAR):
        f_sel.append((MAT_OREN_NAYAR,
                      _oren_nayar_eval(p["kd"], p["ns"], lo, li)))
        pdf_sel.append((MAT_OREN_NAYAR, pdf_diff))

    f = torch.zeros_like(p["kd"])
    for K, v in f_sel:
        f = where3(kind == K, v, f)
    pdf = torch.zeros_like(lo[..., 2])
    for K, v in pdf_sel:
        pdf = torch.where(kind == K, v, pdf)

    spec = is_specular(p)
    same_geom = dot(wo, gn) * dot(wi, gn) > 0.0
    if has(MAT_GLASS):
        is_transmission = (kind == MAT_GLASS) & choose_trans & ~tir
        side_ok = torch.where(is_transmission, ~same_geom, same_geom)
    else:
        side_ok = same_geom
    valid = side_ok & (pdf > 0.0) & torch.any(f != 0.0, dim=-1)
    return wi, f, pdf, spec, valid
