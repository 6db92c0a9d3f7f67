"""Vertex Connection and Merging and its sub-algorithms (BPT / PPM / LT /
PT') as one template over the `algo` flag (torch twin of
imbatracer_tpu.render.integrators.vcm, its default schedule).

The MIS algebra is the partial-weight scheme of the VCM technical report
as the JAX module transcribes it: per-frame progressive radius and
eta constants, light-path and camera-path dVC / dVCM / dVM recursions,
NEE, vertex connection through a uniformly sampled cached light vertex,
light-to-camera connections splatted to the film, and vertex merging
with the Epanechnikov kernel through the photon-merge kernel
(ops/merge.py).  Light paths terminate at emitter surfaces, as in the
JAX module (its docstring gives the reason).

A frame: the light pass in bands of BAND_RAYS paths (sample_emit,
closest-hit traversal, vertices logged per bounce and appended to the
collect cache once per band, camera connections splatted once per
band), the collect cache's overflow read once, then `select_shallowest`
down to the working cache capacity and
`build_merge_grid`, then the camera pass in bands of BAND_RAYS rays,
each a lockstep loop of `max_len` bounces (env and emitter hits, NEE
and vertex connections with one batched any-hit dispatch, merging,
BSDF sampling with Russian roulette).  On a CUDA device a camera pass
of several bands is compacted mid-frame as the PT frame is
(render/integrators/pt.py): VCM_COMPACT_DEPTH bounces a band, the
lanes sorted live-first, the remaining bounces on the bands the live
lanes fill.  Banding is estimator-neutral:
the RNG is keyed by global path and pixel ids, the light-path count
normalises every light-side estimate, and the collect cache holds every
vertex a frame can store (`max_len` a path), so the selected cache is
the same under any band size.

CUDA graphs (the JAX module's compiled band programs, render/graphs.py):
on a CUDA device every light band replays one captured graph of all its
bounces, its vertex logging, its sync-free append and its camera
splat (`light_bands`, JAX's `_vcm_light_band`), and every camera band
one captured phase of its bounces (`camera_film`: `_vcm_camera_band`,
or compacted `_vcm_camera_phase1` / `_phase2`), so the bounce index is
a Python constant in each capture.  The graphs read the frame's
constants, camera, working cache and photon grid from static copies
(`FrameInputs.static`); the camera rays, the collect selection, the
photon grid and the compaction stay eager.  Short bands are padded with
dead lanes.  The masked re-trace takes its graph-ready form, whose
rounds past the first run in a WHILE conditional node while a lane
needs one; its overflow counter and the device launch counts are read
once, at the frame's end; a frame that overflowed is rendered again on
the eager route.  A frame that records
merge queries, and the pairs switch's frames, are eager by rule.

Not ported (schedule variants of the same estimator, off by default or
TPU-only in the JAX package): deferred merging, deferred shadow rays,
the connect slice, the masked band cap, the windowed hash-grid merge
route and `debug_light_pass`.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ...core import rng as rng_mod
from ...core.sampling import PI, russian_roulette_prob
from ...core.vecmath import dot, normalize
from ...ops import merge as merge_mod
from ...scene.textures import sample_bilinear
from .. import envmap as envmap_mod
from .. import graphs as graphs_mod
from .. import lights as light_mod
from .. import materials as mat_mod
from .. import traverse as tt
from ..camera import Camera, raster_to_id, world_to_raster
from ..film import splat
from ..intersect import BIG
from ..light_cache import (CollectCache, empty_collect, pack_batch,
                           select_shallowest)
from ..surface import make_interaction
from ..traverse import any_hit, closest_hit
from . import pt as pt_mod
from .pt import (BAND_RAYS, alpha_fn_for, camera_rays, run_bands,
                 use_compact)

ALGOS = ("vcm", "bpt", "ppm", "lt", "pt")
# Camera bounces every band of a compacted camera pass runs before its
# lanes are sorted.
VCM_COMPACT_DEPTH = 4

# Sampling-technique tags for the MIS debugger: each tag gates one
# contribution site while the RNG streams stay identical, so renders of
# single techniques sum to the full render.
TECHNIQUES = ("light_hit", "next_event", "connect", "merge", "cam_connect")

LIGHT_SEED = 0x1157A9


def shading_normal_adjoint(normal, gn, w_out, w_in):
    """Veach's adjoint-BSDF cosine correction."""
    denom = dot(w_out, gn)
    denom = torch.where(torch.abs(denom) < 1e-9,
                        torch.where(denom < 0, -1e-9, 1e-9), denom)
    return dot(w_out, normal) * dot(w_in, gn) / denom


def _vertex_from_rec(scene, rec):
    """Unpack gathered (R, 24) cache records (LightVertexCache.packed)."""
    bits = lambda c: rec[:, c].contiguous().view(torch.int32)
    mat_id = bits(14)
    uv = rec[:, 12:14]
    params = mat_mod.gather_params(scene.materials, mat_id)
    if scene.textures.texels.shape[0] > 1:
        params["kd"] = torch.where(
            (params["kd_tex"] >= 0)[..., None],
            sample_bilinear(scene.textures, params["kd_tex"], uv[:, 0],
                            uv[:, 1]), params["kd"])
    return dict(pos=rec[:, 0:3], w_out=rec[:, 3:6], normal=rec[:, 6:9],
                gn=rec[:, 9:12], params=params, throughput=rec[:, 15:18],
                d_vc=rec[:, 18], d_vcm=rec[:, 19], d_vm=rec[:, 20],
                path_length=bits(21))


def auto_cache_capacity(light_path_count: int, max_len: int) -> int:
    """Default working cache capacity: 2x light_path_count (at most
    max_len - 1 vertices a path).  `select_shallowest` keeps the
    shallowest vertices, i.e. depth-capped admission, whose quality the
    JAX package measured (its auto_cache_capacity docstring)."""
    return max(int(min(2, max(max_len - 1, 1)) * light_path_count), 1)


def pixel_area(cam: Camera) -> float:
    """A pixel's area on the image plane, in the plane's pixel units: the
    camera maps raster y to (w / h)(y - h / 2) (render/camera.py), so a
    pixel is 1 wide and w / h tall.  The camera's solid-angle pdf and its
    importance divide by it.  The JAX package, like the reference, takes
    it as 1, which scales light tracing by w / h on non-square images and
    tilts the MIS of BPT / VCM there; on square images the two agree."""
    return cam.width / cam.height


def _mis_constants(frame, base_radius, light_path_count: int, algo: str):
    """Progressive radius r_i = r0 / i^(0.5 (1 - 0.75)) and the MIS
    constants eta_vcm = pi r^2 n_light_paths, eta_vc = 1 / eta_vcm,
    eta_vm = eta_vcm (0 for BPT)."""
    iteration = frame.to(torch.float32) + 1.0
    pm_radius = base_radius / torch.pow(iteration, 0.5 * (1.0 - 0.75))
    pm_radius = torch.clamp(pm_radius, min=1e-7)
    eta_vcm = PI * pm_radius * pm_radius * light_path_count
    mis_eta_vc = 1.0 / eta_vcm
    mis_eta_vm = torch.zeros_like(eta_vcm) if algo == "bpt" else eta_vcm
    return pm_radius, mis_eta_vc, mis_eta_vm


# ======================================================================
#  Light pass
# ======================================================================

def _light_pass(scene, cam: Camera, frame, mis_eta_vc, mis_eta_vm, collect,
                *, algo, num_pixels, light_path_count, max_len, alpha_fn,
                has_bump, techniques=TECHNIQUES, path_start=0, band_paths=0,
                path_end=None, overflow=None):
    """One band of light paths: lane k traces path path_start + k
    (`path_start` an int or a 0-d int32 tensor).  Returns the film
    (num_pixels, 3) of its light-to-camera connections and appends its
    vertices to `collect`, a CollectCache (None for LT), in place.  With
    `path_end`, the lanes of paths at or past it are padding: dead from
    the start, they log and splat nothing.  With `overflow`, masked
    traversal takes the graph-ready re-trace and the band reads nothing
    on the host (render/graphs.py captures it)."""
    dev = cam.pos.device
    num_lights = scene.lights.kind.shape[0]
    L = band_paths if band_paths > 0 else light_path_count
    pdf_lightpick = 1.0 / num_lights

    path_id = path_start + torch.arange(L, dtype=torch.int32, device=dev)
    state = rng_mod.seed(path_id, frame, torch.full(
        (), LIGHT_SEED, dtype=torch.int64, device=dev))
    # Uniform split of the GLOBAL path index over the lights, so banding
    # never changes which light a path samples (clamped for padding).
    light_idx = torch.clamp((path_id * num_lights) // light_path_count,
                            max=num_lights - 1)
    state, (u1, u2, u3, u4) = rng_mod.next_floats(state, 4)
    es = light_mod.sample_emit(scene.lights, light_idx, u1, u2, u3, u4,
                               scene.bsphere, scene.env,
                               kinds=scene.light_kinds)

    throughput = es.radiance / pdf_lightpick
    d_vcm = es.pdf_direct_a / torch.clamp(es.pdf_emit_w, min=1e-20)
    d_vc = torch.where(es.is_delta, 0.0, es.cos_out / torch.clamp(
        es.pdf_emit_w * pdf_lightpick, min=1e-20))
    d_vm = d_vc * mis_eta_vc
    org, d = es.pos, es.dir
    tmin = torch.full((L,), 1e-3, dtype=torch.float32, device=dev)
    active = (es.pdf_emit_w > 0.0) & torch.any(es.radiance != 0.0, dim=-1)
    if path_end is not None:
        active = active & (path_id < path_end)

    use_cc = algo != "ppm" and "cam_connect" in techniques
    use_cache = collect is not None
    vrecs, vstores, cc_rows, cc_pix = [], [], [], []
    for i in range(max_len):
        hit = closest_hit(scene.bvh, org, d, tmin, BIG, alpha_fn=alpha_fn,
                          active=active, sort=True, overflow=overflow)
        # Light rays ignore the environment.
        active = active & (hit.prim_id >= 0)
        isect = make_interaction(scene, hit, org, d, has_bump=has_bump)
        cos_o = torch.abs(dot(isect.w_out, isect.normal))
        # Terminate at emitter surfaces (the camera pass does too).
        active = active & (cos_o > 0.0) & (isect.light_id < 0)

        # Complete the partial weights.
        t_sqr = hit.t * hit.t
        d_vcm = d_vcm * (t_sqr if i > 0 else torch.where(es.is_finite, t_sqr,
                                                          1.0))
        inv_cos = 1.0 / torch.clamp(cos_o, min=1e-9)
        d_vcm = d_vcm * inv_cos
        d_vc = d_vc * inv_cos
        d_vm = d_vm * inv_cos
        non_spec = ~mat_mod.is_specular(isect.params)

        if use_cache:
            vrecs.append(pack_batch(
                isect.pos, isect.w_out, isect.normal, isect.gn, isect.uv,
                isect.mat_id, throughput, d_vc, d_vcm, d_vm,
                torch.full((L,), i + 2, dtype=torch.int32, device=dev),
                path_id))
            vstores.append(active & non_spec)
        if use_cc:
            # Normalised by the GLOBAL light-path count, not the band.
            contrib, pix = _connect_to_camera(
                scene, cam, isect, throughput, d_vc, d_vcm,
                active & non_spec, mis_eta_vm, light_path_count, algo,
                alpha_fn, overflow)
            cc_rows.append(contrib)
            cc_pix.append(pix)

        (org, d, tmin, throughput, active, d_vc, d_vcm, d_vm,
         state) = _bounce(scene, isect, throughput, d_vc, d_vcm, d_vm,
                          active, state, hit, mis_eta_vc, mis_eta_vm,
                          adjoint=True, algo=algo,
                          last_bounce=(i + 1 >= max_len))

    # One splat and one append per band, in (bounce, path) order.
    if use_cache:
        collect.append(torch.cat(vstores), torch.cat(vrecs))
    if use_cc:
        return splat(torch.cat(cc_rows), torch.cat(cc_pix), num_pixels)
    return torch.zeros((num_pixels, 3), dtype=torch.float32, device=dev)


def _connect_to_camera(scene, cam, isect, throughput, d_vc, d_vcm, valid,
                       mis_eta_vm, light_path_count, algo, alpha_fn,
                       overflow=None):
    """Light vertex -> camera connection: (contrib (R, 3), pixel id (R,),
    -1 where nothing lands)."""
    to_cam = cam.pos - isect.pos
    in_front = dot(-to_cam, cam.forward) >= 0.0
    rx, ry, _ = world_to_raster(cam, isect.pos)
    pixel = raster_to_id(cam, rx, ry)
    valid = valid & in_front & (pixel >= 0)

    dist_sqr = torch.clamp(dot(to_cam, to_cam), min=1e-12)
    dist = torch.sqrt(dist_sqr)
    dir_c = to_cam / dist[..., None]
    cos_cam = torch.abs(dot(cam.forward, -dir_c))
    cos_surf = torch.abs(shading_normal_adjoint(isect.normal, isect.gn,
                                                isect.w_out, dir_c))
    f, _, pdf_rev = mat_mod.eval_pdf_bsdf(
        isect.params, isect.normal, isect.gn, isect.w_out, dir_c,
        kinds=scene.mat_kinds)
    valid = valid & (pdf_rev > 0.0)

    ipd = cam.img_plane_dist
    img_to_surf = (ipd * ipd * cos_surf) / torch.clamp(
        dist_sqr * cos_cam * cos_cam * cos_cam, min=1e-12) / pixel_area(cam)
    w_light = (img_to_surf / light_path_count) * (
        mis_eta_vm + d_vcm + d_vc * pdf_rev)
    w = 1.0 if algo == "lt" else 1.0 / (w_light + 1.0)
    contrib = throughput * f * (w * img_to_surf / light_path_count)[..., None]
    valid = valid & torch.any(contrib > 0.0, dim=-1)

    offset = dist * 1e-3
    occluded = any_hit(scene.bvh, isect.pos, dir_c, offset, dist - offset,
                       alpha_fn=alpha_fn, active=valid, sort=True,
                       overflow=overflow)
    ok = valid & ~occluded
    return torch.where(ok[..., None], contrib, 0.0), torch.where(ok, pixel, -1)


def _bounce(scene, isect, throughput, d_vc, d_vcm, d_vm, active, state, hit,
            mis_eta_vc, mis_eta_vm, *, adjoint, algo, last_bounce):
    """Shared camera / light bounce with the partial-weight updates."""
    state, (urr, u1, u2, u3) = rng_mod.next_floats(state, 4)
    rr_pdf = russian_roulette_prob(throughput)
    survive = urr < rr_pdf
    p = isect.params
    wi, f, pdf_dir, spec, valid = mat_mod.sample_bsdf(
        p, isect.normal, isect.gn, isect.w_out, u1, u2, u3, adjoint=adjoint,
        kinds=scene.mat_kinds)
    if algo == "ppm" and not adjoint:
        # PPM camera paths follow specular chains only.
        valid = valid & mat_mod.is_specular(p)
    pdf_rev = torch.where(spec, pdf_dir, mat_mod.pdf_bsdf(
        p, isect.normal, isect.gn, wi, isect.w_out, kinds=scene.mat_kinds))
    if adjoint:
        cos_i = torch.abs(shading_normal_adjoint(isect.normal, isect.gn,
                                                 isect.w_out, wi))
    else:
        cos_i = torch.abs(dot(wi, isect.normal))

    safe_pdf = torch.clamp(pdf_dir, min=1e-20)
    ratio = cos_i / safe_pdf
    new_d_vc = torch.where(spec, d_vc * cos_i,
                           ratio * (d_vc * pdf_rev + d_vcm + mis_eta_vm))
    new_d_vm = torch.where(spec, d_vm * cos_i,
                           ratio * (d_vm * pdf_rev + d_vcm * mis_eta_vc + 1.0))
    new_d_vcm = torch.where(spec, 0.0, 1.0 / safe_pdf)
    new_throughput = throughput * f * (cos_i / (rr_pdf * safe_pdf))[..., None]
    active = active & survive & valid
    if last_bounce:
        active = torch.zeros_like(active)

    a3 = active[..., None]
    return (torch.where(a3, isect.pos, 0.0), torch.where(a3, wi, 0.0),
            hit.t * 1e-4, torch.where(a3, new_throughput, throughput), active,
            torch.where(active, new_d_vc, d_vc),
            torch.where(active, new_d_vcm, d_vcm),
            torch.where(active, new_d_vm, d_vm), state)


# ======================================================================
#  Camera pass
# ======================================================================

def vcm_compact_depth(max_len: int) -> int:
    """Phase-1 bounces of a compacted camera pass: VCM_COMPACT_DEPTH
    within [1, max_len - 1]."""
    return max(1, min(VCM_COMPACT_DEPTH, max_len - 1))


def use_vcm_compact(device, num_bands: int, max_len: int) -> bool:
    """Whether a camera pass of `num_bands` bands is compacted by
    default: the PT frame's rule (pt.use_compact), on a CUDA device with
    more than one band and max_len >= 2."""
    return use_compact(device, num_bands, max_len)


def _camera_carry(cam: Camera, frame, *, width, height, spp,
                  light_path_count, start_pixel, band_pixels):
    """The primary-ray carry of one band of camera paths."""
    org, d, state, _ = camera_rays(cam, width, height, spp, frame,
                                   start_pixel=start_pixel, count=band_pixels)
    # dVCM init: the pixel pdf converted to solid angle.
    cos_o = dot(d, cam.forward)
    a = cam.img_plane_dist / cos_o
    zero1 = torch.zeros_like(org[:, 0])
    return dict(org=org, d=d, tmin=zero1, throughput=torch.ones_like(org),
                radiance=torch.zeros_like(org),
                active=torch.ones_like(zero1, dtype=torch.bool),
                d_vc=zero1,
                d_vcm=light_path_count / (a * a / cos_o / pixel_area(cam)),
                d_vm=zero1, state=state)


def _camera_bounce(scene, c, i, *, cache_count, cache_rec, grid, pm_radius,
                   base_radius, mis_eta_vc, mis_eta_vm, algo, max_len,
                   light_path_count, num_connections, has_bump, alpha_fn,
                   techniques, mat_kinds, record=None, overflow=None):
    """Camera bounce `i` of every lane of the carry.  The lanes are
    lockstep: every live lane is at bounce `i`, which the first-vertex
    weights, the connections' path length and the last bounce read.
    With `record`, a list, the arguments of the bounce's merge call are
    appended to it.  With "n_rays" in the carry, the bounce adds its
    traced rays (closest hit + shadow) to it.  `overflow` as in
    _light_pass."""
    org, d, throughput, active, state = (c["org"], c["d"], c["throughput"],
                                         c["active"], c["state"])
    d_vc, d_vcm, d_vm, radiance = c["d_vc"], c["d_vcm"], c["d_vm"], \
        c["radiance"]
    num_lights = scene.lights.kind.shape[0]
    ppm = algo == "ppm"
    hit = closest_hit(scene.bvh, org, d, c["tmin"], BIG, alpha_fn=alpha_fn,
                      active=active, sort=True, overflow=overflow)
    rays = [active.sum()] if "n_rays" in c else None
    # --- environment misses -----------------------------------------
    # The template's PT variant weights the first vertex fully, as the
    # dedicated path tracer does (the JAX module's deviation).
    miss = active & (hit.prim_id < 0)
    if scene.env is not None and "light_hit" in techniques:
        li, pdf_direct_w, pdf_emit_w = envmap_mod.radiance(
            scene.env, normalize(d), scene.bsphere.inv_radius_sqr)
        w_cam = ((pdf_direct_w / num_lights) * d_vcm
                 + (pdf_emit_w / num_lights) * d_vc)
        if ppm or (algo == "pt" and i == 0):
            w = torch.ones_like(w_cam)
        else:
            w = 1.0 / (w_cam + 1.0)
        radiance = radiance + torch.where(
            miss[..., None], throughput * li * w[..., None], 0.0)
    active = active & ~miss

    isect = make_interaction(scene, hit, org, d, has_bump=has_bump)
    cos_o = torch.abs(dot(isect.w_out, isect.normal))
    inv_cos = 1.0 / torch.clamp(cos_o, min=1e-9)
    d_vcm = d_vcm * (hit.t * hit.t) * inv_cos
    d_vc = d_vc * inv_cos
    d_vm = d_vm * inv_cos
    active = active & (cos_o > 0.0)

    # --- emitter hits -------------------------------------------------
    is_emitter = active & (isect.light_id >= 0)
    area = torch.clamp(isect.area, min=1e-12)
    cos_geom = dot(isect.gn, isect.w_out)
    front = cos_geom > 0.0
    li = torch.where(front[..., None], isect.emit, 0.0)
    pdf_direct_a = torch.where(front, 1.0 / area, 1.0)
    # The area emitter's pdf_emit_w is measured about the geometric
    # normal.
    pdf_emit_w = torch.where(
        front, torch.clamp(cos_geom, min=0.0) / PI / area, 1.0)
    w_cam = ((pdf_direct_a / num_lights) * d_vcm
             + (pdf_emit_w / num_lights) * d_vc)
    if ppm or i == 0:
        w_emit = torch.ones_like(w_cam)
    else:
        w_emit = 1.0 / (w_cam + 1.0)
    if "light_hit" in techniques:
        radiance = radiance + torch.where(
            is_emitter[..., None], throughput * li * w_emit[..., None],
            0.0)
    active = active & ~is_emitter
    non_spec = ~mat_mod.is_specular(isect.params)

    # --- NEE + vertex connections: one any-hit dispatch ---------------
    shadow = []
    if algo != "ppm":
        state = _direct_illum(
            scene, isect, throughput, d_vc, d_vcm, active, state,
            mis_eta_vm, num_lights, algo, shadow,
            enabled="next_event" in techniques)
    if algo in ("vcm", "bpt"):
        for _ in range(num_connections):
            state = _connect(
                scene, cache_count, cache_rec, isect, throughput, d_vc, d_vcm,
                active & non_spec, state, mis_eta_vm, light_path_count,
                num_connections, max_len, i + 1, base_radius, shadow,
                enabled="connect" in techniques)
    if shadow:
        cat = lambda k: torch.cat([s[k] for s in shadow])
        ok_all = cat(4)
        occ = any_hit(scene.bvh, cat(0), cat(1), cat(2), cat(3),
                      alpha_fn=alpha_fn, active=ok_all, sort=True,
                      overflow=overflow)
        if rays is not None:
            rays.append(ok_all.sum())
        n = shadow[0][4].shape[0]
        for k, (_, _, _, _, ok, contrib) in enumerate(shadow):
            hit_ok = ok & ~occ[k * n:(k + 1) * n]
            radiance = radiance + torch.where(hit_ok[..., None], contrib,
                                              0.0)

    # --- vertex merging -------------------------------------------------
    if algo in ("vcm", "ppm") and "merge" in techniques:
        radiance = _vertex_merging(
            grid, isect, throughput, d_vcm, d_vm, active & non_spec,
            radiance, mis_eta_vc, pm_radius, light_path_count, algo,
            mat_kinds, record=record)

    (org, d, tmin, throughput, active, d_vc, d_vcm, d_vm,
     state) = _bounce(scene, isect, throughput, d_vc, d_vcm, d_vm,
                      active, state, hit, mis_eta_vc, mis_eta_vm,
                      adjoint=False, algo=algo,
                      last_bounce=(i + 1 >= max_len))
    out = dict(org=org, d=d, tmin=tmin, throughput=throughput,
               radiance=radiance, active=active, d_vc=d_vc, d_vcm=d_vcm,
               d_vm=d_vm, state=state)
    if rays is not None:
        out["n_rays"] = c["n_rays"] + sum(rays)
    return out


def _direct_illum(scene, isect, throughput, d_vc, d_vcm, active, state,
                  mis_eta_vm, num_lights, algo, shadow, enabled=True):
    """NEE: appends (org, dir, tmin, tmax, ok, contrib) to `shadow` when
    `enabled`; the RNG advances either way.  Returns the new state."""
    state, (ul, ua, ub) = rng_mod.next_floats(state, 3)
    light_idx = torch.clamp((ul * num_lights).to(torch.int32),
                            max=num_lights - 1)
    ds = light_mod.sample_direct(scene.lights, light_idx, isect.pos, ua, ub,
                                 scene.bsphere, scene.env,
                                 kinds=scene.light_kinds)
    cos_i = torch.abs(dot(isect.normal, ds.dir))
    f, pdf_dir, pdf_rev = mat_mod.eval_pdf_bsdf(
        isect.params, isect.normal, isect.gn, isect.w_out, ds.dir,
        kinds=scene.mat_kinds)
    ok = active & (pdf_dir > 0.0) & (pdf_rev > 0.0)

    pdf_forward = torch.where(ds.is_delta, 0.0, pdf_dir)
    w_light = pdf_forward * num_lights / torch.clamp(ds.pdf_direct_w,
                                                     min=1e-20)
    w_cam = (ds.pdf_emit_w * cos_i / torch.clamp(
        ds.pdf_direct_w * ds.cos_out, min=1e-20)) * (
        mis_eta_vm + d_vcm + d_vc * pdf_rev)
    w = (torch.ones_like(w_cam) if algo == "pt"
         else 1.0 / (w_cam + 1.0 + w_light))
    contrib = throughput * f * ds.radiance * (w * cos_i * num_lights)[..., None]
    ok = ok & torch.any(contrib > 0.0, dim=-1)
    offset = 1e-3 * torch.where(ds.distance >= BIG, 1.0, ds.distance)
    if enabled:
        shadow.append((isect.pos, ds.dir, offset, ds.distance - offset, ok,
                       contrib))
    return state


def _connect(scene, count, cache_rec, isect, throughput, d_vc, d_vcm, active,
             state, mis_eta_vm, light_path_count, num_connections, max_len,
             cam_path_length, base_radius, shadow, enabled=True):
    """One vertex connection per ray to a uniformly picked cached light
    vertex (`count` rows of `cache_rec`); appends its shadow ray to
    `shadow` when `enabled`.  Returns the new state."""
    state, (uc,) = rng_mod.next_floats(state, 1)
    j = torch.minimum((uc * count.to(torch.float32)).to(torch.int32),
                      torch.clamp(count - 1, min=0))
    v = _vertex_from_rec(scene, cache_rec[j.long()])
    ok = active & (count > 0) & (v["path_length"] + cam_path_length <= max_len)

    to_v = v["pos"] - isect.pos
    dist_sq = torch.clamp(dot(to_v, to_v), min=1e-20)
    dist = torch.sqrt(dist_sq)
    cdir = to_v / dist[..., None]
    ok = ok & (dist >= base_radius)

    f_cam, pdf_cam, pdf_cam_rev = mat_mod.eval_pdf_bsdf(
        isect.params, isect.normal, isect.gn, isect.w_out, cdir,
        kinds=scene.mat_kinds)
    vn, vgn, vout = v["normal"], v["gn"], v["w_out"]
    f_light, pdf_light, pdf_light_rev = mat_mod.eval_pdf_bsdf(
        v["params"], vn, vgn, vout, -cdir, kinds=scene.mat_kinds)
    ok = (ok & (pdf_cam > 0) & (pdf_cam_rev > 0) & (pdf_light > 0)
          & (pdf_light_rev > 0))

    cos_cam = torch.abs(dot(isect.normal, cdir))
    cos_light = torch.abs(shading_normal_adjoint(vn, vgn, vout, -cdir))
    geom = cos_cam * cos_light / dist_sq
    ok = ok & (geom > 0.0)
    pdf_cam_a = pdf_cam * cos_light / dist_sq
    pdf_light_a = pdf_light * cos_cam / dist_sq
    w_light = pdf_cam_a * (mis_eta_vm + v["d_vcm"] + v["d_vc"] * pdf_light_rev)
    w_cam = pdf_light_a * (mis_eta_vm + d_vcm + d_vc * pdf_cam_rev)
    w = 1.0 / (w_cam + 1.0 + w_light)
    vc_weight = count.to(torch.float32) / (light_path_count * num_connections)
    contrib = (throughput * v["throughput"] * f_cam * f_light
               * (w * geom * vc_weight)[..., None])
    ok = ok & torch.any(contrib > 0.0, dim=-1)
    offset = 1e-3 * dist
    if enabled:
        shadow.append((isect.pos, cdir, offset, dist - offset, ok, contrib))
    return state


def _vertex_merging(grid, isect, throughput, d_vcm, d_vm, active, radiance,
                    mis_eta_vc, pm_radius, light_path_count, algo, mat_kinds,
                    record=None):
    """Fixed-radius photon gather with the Epanechnikov kernel: the exact,
    unbounded walk of the merge kernel (ops/merge.py).  With `record`, a
    list, merge_contrib's arguments are appended to it by name."""
    radius_sqr = torch.clamp(pm_radius * pm_radius, min=1e-20)
    kinds = mat_kinds if mat_kinds is not None else merge_mod.MERGE_KINDS
    args = dict(grid=grid, qpos=isect.pos, normal=isect.normal, gn=isect.gn,
                w_out=isect.w_out, params=isect.params, d_vcm=d_vcm,
                d_vm=d_vm, active=active, mis_eta_vc=mis_eta_vc, kinds=kinds,
                ppm=(algo == "ppm"))
    if record is not None:
        record.append(args)
    contrib = merge_mod.merge_contrib(**args)
    norm = 2.0 / (PI * radius_sqr * light_path_count)
    return radiance + torch.where(active[..., None],
                                  throughput * contrib * norm, 0.0)


# ======================================================================
#  Frame entry point
# ======================================================================

def frame_constants(cam: Camera, frame, base_radius, *, algo: str,
                    num_pixels: int, light_path_count: int, max_len: int):
    """A frame's constants on the camera's device: (frame, base_radius,
    light_path_count (its default resolved), cache_capacity, pm_radius,
    mis_eta_vc, mis_eta_vm)."""
    if algo not in ALGOS:
        raise ValueError(f"unknown algorithm {algo!r}")
    dev = cam.pos.device
    frame = torch.as_tensor(frame, device=dev).to(torch.int64)
    base_radius = torch.as_tensor(base_radius, dtype=torch.float32,
                                  device=dev)
    if light_path_count <= 0:
        light_path_count = num_pixels // 2
    cache_capacity = auto_cache_capacity(light_path_count, max_len)
    return (frame, base_radius, light_path_count, cache_capacity,
            *_mis_constants(frame, base_radius, light_path_count, algo))


@dataclasses.dataclass
class FrameInputs:
    """What a frame's bands read besides the scene: the camera, the
    frame's constants (frame_constants) and, once the light pass has
    run, the working cache's row count and packed (C, 24) rows and the
    photon grid (None where the algorithm has none)."""

    cam: Camera
    frame: torch.Tensor
    base_radius: torch.Tensor
    pm_radius: torch.Tensor
    mis_eta_vc: torch.Tensor
    mis_eta_vm: torch.Tensor
    cache_count: torch.Tensor = None
    cache_rec: torch.Tensor = None
    grid: merge_mod.MergeGrid = None

    def static(self, ins) -> "FrameInputs":
        """The same inputs as the static tensors of `ins`
        (graphs.StaticInputs), this frame's values copied into them."""
        held = {}
        for pre, obj in (("", self), ("cam_", self.cam),
                         ("grid_", self.grid)):
            if obj is None:
                continue
            names = [f.name for f in dataclasses.fields(obj)
                     if torch.is_tensor(getattr(obj, f.name))]
            ins.load(**{pre + n: getattr(obj, n) for n in names})
            held[pre] = dataclasses.replace(
                obj, **{n: ins[pre + n] for n in names})
        return dataclasses.replace(held[""], cam=held["cam_"],
                                   grid=held.get("grid_"))


def use_vcm_graphs(device, bvh, record: bool) -> bool:
    """Whether a VCM-family frame replays captured light bands and camera
    phases by default: PT's rule (pt.use_graphs: a CUDA device, the
    BVH's pairs switch off), and no merge_queries `record` (its bounce-0
    merge arguments are a band's own tensors, so such a frame is eager by
    rule)."""
    return pt_mod.use_graphs(device, bvh) and not record


def resolve_graph(graph, device, bvh, record: bool) -> bool:
    """`graph` resolved: None -> use_vcm_graphs; True where graphs cannot
    run raises."""
    if graph is None:
        return use_vcm_graphs(device, bvh, record)
    if graph and not use_vcm_graphs(device, bvh, record):
        raise ValueError("graph=True needs a CUDA device, the BVH's pairs "
                         "switch off and no merge_queries record")
    return graph


def statics_key(width, height, light_path_count, max_len, collect_capacity,
                 cache_capacity) -> tuple:
    """The key of a frame shape's static inputs in the scene's graphs; it
    leads the key of every graph that reads them."""
    return ("vcm", width, height, light_path_count, max_len,
            collect_capacity, cache_capacity)


def frame_collect(sg, key, capacity: int, device) -> CollectCache:
    """An empty collect cache of `capacity` rows: a new one, or with `sg`
    (the scene's SceneGraphs) the static one of `key`, emptied."""
    if sg is None:
        return empty_collect(capacity, device)
    ins = sg.inputs(key)
    if "collect_rec" not in ins:
        c = empty_collect(capacity, device)
        ins.update(collect_rec=c.rec, collect_count=c.count,
                   collect_lost=c.lost)
    c = CollectCache(ins["collect_rec"], ins["collect_count"],
                     ins["collect_lost"])
    for t in (c.rec, c.count, c.lost):
        t.zero_()
    return c


def _args_key(kw) -> tuple:
    """The hashable arguments of a band function (its alpha_fn stands in
    as its presence)."""
    return tuple(sorted((k, v if k != "alpha_fn" else v is not None)
                        for k, v in kw.items()))


def light_bands(scene, fi: FrameInputs, collect, *, sg, key, lanes: int,
                **kw):
    """band(start, n) -> the light film (num_pixels, 3) of paths [start,
    start + n), their vertices appended to `collect`; n <= `lanes`.
    Eager (`sg` None): one _light_pass a band.  Graphed: one replay of
    the scene's light graph of `lanes` lanes (JAX's `_vcm_light_band`)
    over `fi`'s static inputs, a short band padded with dead lanes; its
    film is the graph's static buffer, to be read before the next band.
    `kw`: _light_pass's keyword arguments."""
    if sg is None:
        return lambda start, n: _light_pass(
            scene, fi.cam, fi.frame, fi.mis_eta_vc, fi.mis_eta_vm, collect,
            path_start=start, band_paths=n, **kw)
    ins = sg.inputs(key)
    dev = fi.frame.device
    if "light_film" not in ins:
        ins.update(light_film=torch.zeros((kw["num_pixels"], 3),
                                          dtype=torch.float32, device=dev),
                   path_start=torch.zeros((), dtype=torch.int32, device=dev),
                   path_end=torch.zeros((), dtype=torch.int32, device=dev))
    state = {"film": ins["light_film"]}
    if collect is not None:
        state.update(rec=collect.rec, count=collect.count, lost=collect.lost)

    def step(st, overflow):
        col = (CollectCache(st["rec"], st["count"], st["lost"])
               if "rec" in st else None)
        st["film"].copy_(_light_pass(
            scene, fi.cam, fi.frame, fi.mis_eta_vc, fi.mis_eta_vm, col,
            path_start=ins["path_start"], band_paths=lanes,
            path_end=ins["path_end"], overflow=overflow, **kw))

    gkey = key + ("light", lanes, _args_key(kw),
                  tt.graph_route(scene.bvh, kw["alpha_fn"] is not None))

    def band(start, n):
        ins["path_start"].fill_(start)
        ins["path_end"].fill_(start + n)
        sg.phase(gkey, step, state).replay()
        return ins["light_film"]
    return band


def working_cache(fi: FrameInputs, cache, grid, sg, key) -> FrameInputs:
    """`fi` with the working cache's count and rows and the photon grid
    (static copies with `sg`)."""
    fi = dataclasses.replace(
        fi, grid=grid, cache_count=None if cache is None else cache.count,
        cache_rec=None if cache is None else cache.packed())
    return fi if sg is None else fi.static(sg.inputs(key))


def render_vcm_frame(scene, cam: Camera, frame, base_radius, *,
                     algo: str = "vcm", width: int = 512, height: int = 512,
                     spp: int = 1, max_len: int = 10,
                     light_path_count: int = 0, num_connections: int = 1,
                     has_masks: bool = False,
                     has_bump: bool = False, techniques: tuple = TECHNIQUES,
                     mat_kinds: tuple = None, light_band: int = BAND_RAYS,
                     camera_band: int = BAND_RAYS, stats: dict = None,
                     compact: bool = None, graph: bool = None):
    """One progressive VCM-family frame; returns the un-normalised
    (H*W, 3) film (divide by frames * spp for display).  `frame` is the
    frame number (Python int or integer tensor), `base_radius` the
    frame-0 merge radius.

    The light pass runs once a frame, whatever `spp`, and its film (light
    tracing, and the light-side splats of BPT and VCM) is weighted by
    `spp` before the camera pass adds its spp samples a pixel, so that the
    division by frames * spp leaves it at full weight.  Each of a pixel's
    spp camera samples pairs with the same light paths, so the camera-side
    techniques are averaged over spp samples while the light splats come
    from one pass.  The MIS weights of all techniques still sum to one,
    so the estimator stays unbiased, although at spp > 1 the weights no
    longer follow the balance heuristic for the actual sample counts.  At
    spp 1 nothing changes.  (The JAX package adds the light film once, so
    at spp > 1 its light tracing is 1/spp of this one.)

    `mat_kinds`: the scene's material kinds (the merge kernel skips absent
    ones; None = every non-delta kind).
    `light_band` / `camera_band` are the band sizes (estimator-neutral).
    `compact`: mid-frame compaction of the camera pass (None:
    `use_vcm_compact`, on for a CUDA device and more than one band).
    `graph`: the light bands and camera phases replay captured graphs
    (render/graphs.py; None: `use_vcm_graphs`, on for a CUDA device;
    True where graphs cannot run raises); a failed capture raises, and a
    graphed frame whose masked re-trace overflowed is rendered again on
    the eager route, counted in graphs.GRAPH_STATS["reruns"] and logged.
    With `stats`, a dict, it records the collected and kept vertex
    counts ("collected", "cache") and the photon count ("photons"); if
    it holds a list under "merge_queries", each camera band appends the
    arguments of its camera bounce-1 merge call (merge_contrib's, by
    name) to it (such a frame is eager), and if it holds a dict under
    "route", camera_film records the camera pass's rays and band counts
    there."""
    dev = cam.pos.device
    num_pixels = width * height
    record = stats is not None and "merge_queries" in stats
    graph = resolve_graph(graph, dev, scene.bvh, record)
    (frame, base_radius, light_path_count, cache_capacity, pm_radius,
     mis_eta_vc, mis_eta_vm) = frame_constants(
        cam, frame, base_radius, algo=algo, num_pixels=num_pixels,
        light_path_count=light_path_count, max_len=max_len)
    alpha_fn = alpha_fn_for(scene) if has_masks else None
    inputs = FrameInputs(cam, frame, base_radius, pm_radius, mis_eta_vc,
                         mis_eta_vm)
    # The collect cache holds every vertex a frame can store (one a path
    # per bounce), so nothing is dropped before the selection.
    collect_capacity = light_path_count * max_len
    key = statics_key(width, height, light_path_count, max_len,
                       collect_capacity, cache_capacity)

    def render(sg):
        fi = inputs if sg is None else inputs.static(sg.inputs(key))
        film = torch.zeros((num_pixels, 3), dtype=torch.float32, device=dev)
        cache = grid = None
        if algo != "pt":
            collect = (frame_collect(sg, key, collect_capacity, dev)
                       if algo != "lt" else None)
            band = light_bands(
                scene, fi, collect, sg=sg, key=key,
                lanes=min(light_band, light_path_count), algo=algo,
                num_pixels=num_pixels, light_path_count=light_path_count,
                max_len=max_len, alpha_fn=alpha_fn, has_bump=has_bump,
                techniques=techniques)
            for start in range(0, light_path_count, light_band):
                film = film + band(start, min(light_band,
                                              light_path_count - start))
            film = film * float(spp)
            if collect is not None:
                collect.check()
                # Canonical (path, bounce) layout of the shallowest
                # vertices: the same set and order under any band schedule.
                cache = select_shallowest(collect.cache(), cache_capacity)
                if stats is not None:
                    stats["collected"] = collect.count.clone()
                    stats["cache"] = cache.count.clone()
                del collect
            if algo in ("vcm", "ppm"):
                grid = photon_grid(cache, pm_radius, stats)
        if algo == "lt":
            return film
        band = max(1, camera_band // max(spp, 1))
        bands = [(start, min(band, num_pixels - start))
                 for start in range(0, num_pixels, band)]
        return film + camera_film(
            scene, working_cache(fi, cache, grid, sg, key), bands,
            stats=stats, algo=algo, width=width, height=height, spp=spp,
            max_len=max_len, light_path_count=light_path_count,
            num_connections=num_connections, has_bump=has_bump,
            alpha_fn=alpha_fn, techniques=techniques, mat_kinds=mat_kinds,
            compact=compact, sg=sg, key=key)

    return graphs_mod.render_frame(scene, graph, render, "VCM frame")


def photon_grid(cache, pm_radius, stats=None):
    """The merge kernel's photon grid over the cache's valid vertices;
    records the photon count in `stats` ("photons")."""
    valid = torch.arange(cache.capacity, device=cache.pos.device) < cache.count
    grid = merge_mod.build_merge_grid(
        cache.pos, valid, pm_radius, cache.w_out, cache.throughput,
        cache.d_vcm, cache.d_vm)
    if stats is not None:
        stats["photons"] = valid.sum()
    return grid


def camera_film(scene, fi: FrameInputs, bands, *, stats, width, height, spp,
                max_len, light_path_count, compact=None, sg=None, key=(),
                **kw):
    """The camera pass over `bands`, (start_pixel, pixels) pairs of
    consecutive pixels, concatenated in order: (sum of pixels, 3).
    `compact`: mid-frame lane compaction (None: use_vcm_compact on the
    camera's device).  `sg`, the scene's SceneGraphs, or None for the
    eager route: each band replays one captured phase of its bounces over
    `fi`'s static inputs (JAX's `_vcm_camera_band`; compacted, one graph
    for bounces [0, depth0) and one for [depth0, max_len), JAX's
    `_vcm_camera_phase1` / `_phase2`), of the widest band's lanes, the
    others padded with dead lanes; `key` leads the graphs' keys.
    `stats`, a dict or None: if it holds a list under "merge_queries"
    (eager only), each band appends the arguments of its bounce-1 merge
    call to it; if it holds a dict under "route", the pass records there
    its traced rays ("camera_rays": closest hit + shadow) and
    pt.run_bands' counts of lanes and band-bounces.  `kw`:
    _camera_bounce's algo, num_connections, has_bump, alpha_fn,
    techniques and mat_kinds."""
    cam = fi.cam
    dev = cam.pos.device
    if not bands:
        return torch.zeros((0, 3), dtype=torch.float32, device=dev)
    if compact is None:
        compact = use_vcm_compact(dev, len(bands), max_len)
    depth0 = vcm_compact_depth(max_len) if compact else max_len
    record = stats.get("merge_queries") if stats is not None else None
    route = stats.get("route") if stats is not None else None
    if record is not None and sg is not None:
        raise ValueError("merge_queries records an eager camera pass only")
    bounce = functools.partial(
        _camera_bounce, scene, cache_count=fi.cache_count,
        cache_rec=fi.cache_rec, grid=fi.grid, pm_radius=fi.pm_radius,
        base_radius=fi.base_radius, mis_eta_vc=fi.mis_eta_vc,
        mis_eta_vm=fi.mis_eta_vm, max_len=max_len,
        light_path_count=light_path_count, **kw)
    counts = []

    def carry0(start, n):
        return _camera_carry(cam, fi.frame, width=width, height=height,
                             spp=spp, light_path_count=light_path_count,
                             start_pixel=start, band_pixels=n)

    def counted(c):
        return dict(c, n_rays=torch.zeros((), dtype=torch.int64, device=dev))

    if sg is None:
        def tally(c):
            if route is not None:
                counts.append(c.pop("n_rays"))
            return c

        def phase1(start, n):
            c = carry0(start, n)
            c = counted(c) if route is not None else c
            for i in range(depth0):
                c = bounce(c, i, record=record if i == 0 else None)
            return tally(c)

        def phase2(c):
            c = counted(c) if route is not None else c
            for i in range(depth0, max_len):
                c = bounce(c, i)
            return tally(c)
    else:
        lanes = max(n for _, n in bands) * spp
        gkey = key + ("camera", lanes, spp, max_len, light_path_count,
                      _args_key(kw),
                      tt.graph_route(scene.bvh, kw["alpha_fn"] is not None))

        def run(c, a, b):
            def step(carry, overflow):
                for i in range(a, b):
                    carry = bounce(carry, i, overflow=overflow)
                return carry
            g = sg.bounce(gkey + (a, b), step, counted(c), lanes)
            g.load(c)
            g.replay()
            counts.append(g.carry["n_rays"].clone())
            return g.carry

        def phase1(start, n):
            c = run(carry0(start, n), 0, depth0)
            if not compact:
                return {"radiance": c["radiance"][:n * spp]}
            return {k: v[:n * spp].clone() for k, v in c.items()
                    if k != "n_rays"}

        def phase2(c):
            n = c["active"].shape[0]
            return {"radiance": run(c, depth0, max_len)["radiance"][:n]}

    film = run_bands(bands, spp=spp, width=width, max_len=max_len,
                     depth0=depth0, compact=compact, phase1=phase1,
                     phase2=phase2, stats=route)
    if route is not None:
        route["camera_rays"] = sum(counts)
    return film
