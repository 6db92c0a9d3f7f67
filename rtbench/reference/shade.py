"""The PT bounce's shading: a frozen copy of the plain PyTorch versions
in the program's `ops/shade.py` (`pt_shade_plain`,
`pt_shade_finish_plain`), the arithmetic the program's two shading
kernels compute.  Between its traversal calls the reference runs
exactly this, so its random numbers are drawn in the program's order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import envmap as envmap_mod
from . import lights as light_mod
from . import materials as mat_mod
from . import rng as rng_mod
from .intersect import BIG
from .sampling import mis_power_heuristic, russian_roulette_prob
from .surface import make_interaction
from .vecmath import dot, normalize


class ShadowRay(NamedTuple):
    pos: torch.Tensor    # (R, 3) origin, the shading point
    dir: torch.Tensor    # (R, 3) toward the sampled light
    tmin: torch.Tensor   # (R,) the offset
    tmax: torch.Tensor   # (R,) the light's distance less the offset
    ok: torch.Tensor     # (R,) bool: the lanes that cast it


def pt_shade_plain(scene, c, hit, *, has_bump: bool, max_len: int):
    """The bounce's shading on the carry `c` and its closest hit `hit`:
    (next carry, ShadowRay, contrib (R, 3)).  The next carry's radiance
    holds the env and emitter terms, its n_rays the closest-hit rays;
    pt_shade_finish adds the NEE term and the shadow rays."""
    num_lights = scene.lights.kind.shape[0]
    first = c["depth"] == 0
    n_rays = c["n_rays"] + c["active"].sum()

    # ---- environment misses ----------------------------------------------
    miss = c["active"] & (hit.prim_id < 0)
    radiance = c["radiance"]
    if scene.env is not None:
        li, pdf_direct_w, _ = envmap_mod.radiance(
            scene.env, normalize(c["d"]), scene.bsphere.inv_radius_sqr)
        pdf_di = pdf_direct_w / num_lights
        w = torch.where(first | c["last_specular"], 1.0,
                        mis_power_heuristic(c["last_pdf"], pdf_di))
        radiance = radiance + torch.where(
            miss[..., None], c["throughput"] * li * w[..., None], 0.0)
    active = c["active"] & ~miss

    isect = make_interaction(scene, hit, c["org"], c["d"], has_bump=has_bump)

    # ---- emitter hits ----------------------------------------------------
    is_emitter = active & (isect.light_id >= 0)
    cos_geom = dot(isect.gn, isect.w_out)
    cos_shade = dot(isect.normal, isect.w_out)
    area = torch.clamp(isect.area, min=1e-12)
    d_sqr = hit.t * hit.t
    pdf_di_emit = (1.0 / area) / num_lights * d_sqr / torch.where(
        cos_shade <= 0.0, 1.0, cos_shade)
    w_emit = torch.where(first | c["last_specular"], 1.0,
                         mis_power_heuristic(c["last_pdf"], pdf_di_emit))
    emit_ok = is_emitter & (cos_geom > 0.0) & (cos_shade > 0.0)
    radiance = radiance + torch.where(
        emit_ok[..., None], c["throughput"] * isect.emit * w_emit[..., None],
        0.0)
    active = active & ~is_emitter

    # ---- next-event estimation -------------------------------------------
    st, (ul, ua, ub) = rng_mod.next_floats(c["state"], 3)
    light_idx = torch.clamp((ul * num_lights).to(torch.int32),
                            max=num_lights - 1)
    ds = light_mod.sample_direct(scene.lights, light_idx, isect.pos, ua, ub,
                                 scene.bsphere, scene.env,
                                 kinds=scene.light_kinds)
    f_nee, pdf_hit, _ = mat_mod.eval_pdf_bsdf(
        isect.params, isect.normal, isect.gn, isect.w_out, ds.dir,
        kinds=scene.mat_kinds)
    pdf_lightpick = 1.0 / num_lights
    pdf_di = pdf_lightpick * ds.pdf_direct_w
    w_nee = torch.where(ds.is_delta, 1.0,
                        pdf_di / torch.clamp(pdf_di + pdf_hit, min=1e-20))
    contrib = (c["throughput"] * f_nee * ds.radiance
               * (torch.abs(dot(isect.normal, ds.dir)) * w_nee
                  / pdf_lightpick)[..., None])
    shadow_ok = (active & (pdf_hit > 0.0) & (pdf_di > 0.0)
                 & torch.any(contrib > 0.0, dim=-1))
    offset = 1e-3 * torch.where(ds.distance >= BIG, 1.0, ds.distance)
    shadow = ShadowRay(isect.pos, ds.dir, offset, ds.distance - offset,
                       shadow_ok)

    # ---- bounce ----------------------------------------------------------
    st, (urr, u1, u2, u3) = rng_mod.next_floats(st, 4)
    rr_pdf = russian_roulette_prob(c["throughput"])
    survive = urr < rr_pdf
    wi, f, pdf, spec, valid = mat_mod.sample_bsdf(
        isect.params, isect.normal, isect.gn, isect.w_out, u1, u2, u3,
        kinds=scene.mat_kinds)
    cos_term = torch.abs(dot(isect.normal, wi))
    new_throughput = c["throughput"] * f * (
        cos_term / torch.clamp(pdf * rr_pdf, min=1e-20))[..., None]
    active = active & survive & valid & (c["depth"] + 1 < max_len)
    a3 = active[..., None]
    nxt = dict(
        org=torch.where(a3, isect.pos, c["org"]),
        d=torch.where(a3, wi, c["d"]),
        tmin=torch.where(active, 1e-3 * hit.t, c["tmin"]),
        throughput=torch.where(a3, new_throughput, c["throughput"]),
        radiance=radiance,
        active=active,
        depth=torch.where(active, c["depth"] + 1, c["depth"]),
        last_pdf=torch.where(active, pdf, c["last_pdf"]),
        last_specular=torch.where(active, spec, c["last_specular"]),
        state=st,
        n_rays=n_rays,
    )
    return nxt, shadow, contrib


def pt_shade_finish_plain(radiance, contrib, shadow_ok, occluded, n_rays):
    """(radiance plus contrib where the shadow ray was cast and not
    occluded, n_rays plus the shadow rays)."""
    radiance = radiance + torch.where((shadow_ok & ~occluded)[..., None],
                                      contrib, 0.0)
    return radiance, n_rays + shadow_ok.sum()
