"""The VCM family's light and camera bounces' shading: a frozen copy of
the plain PyTorch versions in the program's `ops/vcm_shade.py` (a light
band's start, a light bounce with its camera connection, a camera
bounce with NEE, the vertex connections and the merge query, and the
finishes after the any hits), the arithmetic its four shading kernels
compute on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import envmap as envmap_mod
from . import lights as light_mod
from . import materials as mat_mod
from . import rng as rng_mod
from . import shade as sh
from .camera import raster_to_id, world_to_raster
from .intersect import BIG
from .light_cache import REC_W, pack_batch
from .sampling import PI, russian_roulette_prob
from .surface import make_interaction
from .textures import sample_bilinear
from .vecmath import dot, normalize

# The algorithms of the family and the MIS debugger's technique tags, in
# the kernels' order (enum Algo, and bit k of the technique mask for
# TECHNIQUES[k]): each tag gates one contribution site while the RNG
# streams stay identical, so renders of single techniques sum to the full
# render.
ALGOS = ("vcm", "bpt", "ppm", "lt", "pt")
TECHNIQUES = ("light_hit", "next_event", "connect", "merge", "cam_connect")

LIGHT_SEED = 0x1157A9



class ShadowSets(NamedTuple):
    """A camera bounce's shadow rays: one set for NEE, then one set per
    connection, `lanes` rows each (the sets the techniques enable)."""

    pos: torch.Tensor      # (S R, 3) origin, the shading point
    dir: torch.Tensor      # (S R, 3)
    tmin: torch.Tensor     # (S R,)
    tmax: torch.Tensor     # (S R,)
    ok: torch.Tensor       # (S R,) bool: the rays cast
    contrib: torch.Tensor  # (S R, 3) added where the ray is not occluded


# A shadow set's row of a lane dead on entry (its carry's active flag
# false): no ray is cast and no light is added.  The camera kernel returns
# before NEE and the connections on such a lane and writes these
# (csrc/vcm_shade.cu kDead*); nothing reads them but the any hit, which
# skips a row that is not ok.
DEAD_SHADOW = ShadowSets(pos=0.0, dir=0.0, tmin=0.0, tmax=0.0, ok=False,
                         contrib=0.0)


class DeadLight(NamedTuple):
    """A light bounce's rows of a lane that does not go on: its vertex
    row and store flag, its camera connection and pixel, its shadow
    ray."""

    rec: float
    store: bool
    cc: float
    pixel: int
    pos: float
    dir: float
    tmin: float
    tmax: float
    ok: bool


# A light bounce's rows of a lane that does not go on past the hit test
# (dead on entry, a miss, a grazing hit or an emitter): no vertex is
# stored, no connection made and no shadow ray cast.  The light kernel
# finishes such a lane in its first phase and writes these
# (csrc/vcm_shade.cu kDeadLight*); nothing reads them but the collect
# append, which drops a row whose store flag is false, the any hit, which
# skips a ray that is not ok, and the light finish, which keeps a
# connection only where its ray was ok.
DEAD_LIGHT = DeadLight(rec=0.0, store=False, cc=0.0, pixel=-1, pos=0.0,
                       dir=0.0, tmin=0.0, tmax=0.0, ok=False)


def _dead_where(dead, x, value):
    """x with the rows of the `dead` lanes set to `value`."""
    return torch.where(dead.view(-1, *[1] * (x.dim() - 1)), value, x)


class MergeQuery(NamedTuple):
    """What a camera bounce's merge reads: the shading point (with the
    material's kind, kd, ks and ns in `params`), the completed partial
    weights, the lanes that merge and the throughput before the bounce."""

    pos: torch.Tensor
    normal: torch.Tensor
    gn: torch.Tensor
    w_out: torch.Tensor
    params: dict
    d_vcm: torch.Tensor
    d_vm: torch.Tensor
    active: torch.Tensor
    throughput: torch.Tensor


class LightRows(NamedTuple):
    """A light band's staging buffers, (max_len * lanes) rows in (bounce,
    path) order: the packed vertex rows and their store flags (None for
    LT), the camera connections' contributions and pixel ids (None
    without them)."""

    rec: torch.Tensor
    store: torch.Tensor
    cc: torch.Tensor
    pixel: torch.Tensor

    def at(self, i: int, lanes: int) -> "LightRows":
        """The rows of bounce i (views)."""
        sl = slice(i * lanes, (i + 1) * lanes)
        return LightRows(*(None if x is None else x[sl] for x in self))


def light_rows(lanes: int, max_len: int, use_cache: bool, use_cc: bool,
               device) -> LightRows:
    n = lanes * max_len
    f32 = dict(dtype=torch.float32, device=device)
    return LightRows(
        torch.empty((n, REC_W), **f32) if use_cache else None,
        torch.empty(n, dtype=torch.bool, device=device) if use_cache
        else None,
        torch.empty((n, 3), **f32) if use_cc else None,
        torch.empty(n, dtype=torch.int32, device=device) if use_cc else None)


# --------------------------------------------------------------------------
# The plain PyTorch versions
# --------------------------------------------------------------------------

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


def light_start_plain(scene, frame, mis_eta_vc, *, lanes, light_path_count,
                      path_start=0, path_end=None):
    """The carry of a band of `lanes` light paths from path `path_start`
    (an int or a 0-d int32 tensor): org, d, tmin, throughput, active,
    d_vc, d_vcm, d_vm, state, finite (the emitter's is_finite) and
    path_id.  The lanes of paths at or past `path_end` are dead."""
    dev = scene.lights.rec.device
    num_lights = scene.lights.kind.shape[0]
    pdf_lightpick = 1.0 / num_lights
    path_id = path_start + torch.arange(lanes, dtype=torch.int32, device=dev)
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
    active = (es.pdf_emit_w > 0.0) & torch.any(es.radiance != 0.0, dim=-1)
    if path_end is not None:
        active = active & (path_id < path_end)
    return dict(org=es.pos, d=es.dir,
                tmin=torch.full((lanes,), 1e-3, dtype=torch.float32,
                                device=dev),
                throughput=throughput, active=active, d_vc=d_vc, d_vcm=d_vcm,
                d_vm=d_vm, state=state, finite=es.is_finite, path_id=path_id)


def light_shade_plain(scene, cam, c, hit, i, rows: LightRows, *, mis_eta_vc,
                      mis_eta_vm, algo, light_path_count, max_len, has_bump,
                      pixel_area):
    """Light bounce `i` of the carry `c` after its closest hit `hit`:
    writes the bounce's vertex rows and store flags and its camera
    connections (before occlusion) into `rows` (LightRows.at(i)); returns
    (next carry, the connections' shadow ray (shade.ShadowRay) or None).
    A lane that does not go on past the hit test writes DEAD_LIGHT's rows
    and keeps its carry: inactive, no ray, its throughput and partial
    weights, tmin from its hit, its RNG word past the bounce's 4 draws."""
    lanes = c["active"].shape[0]
    # Light rays ignore the environment.
    active = c["active"] & (hit.prim_id >= 0)
    isect = make_interaction(scene, hit, c["org"], c["d"], has_bump=has_bump)
    cos_o = torch.abs(dot(isect.w_out, isect.normal))
    # Terminate at emitter surfaces (the camera pass does too).
    active = active & (cos_o > 0.0) & (isect.light_id < 0)
    dead = ~active

    # Complete the partial weights.
    t_sqr = hit.t * hit.t
    d_vcm = c["d_vcm"] * (t_sqr if i > 0 else torch.where(c["finite"], t_sqr,
                                                          1.0))
    inv_cos = 1.0 / torch.clamp(cos_o, min=1e-9)
    d_vcm = d_vcm * inv_cos
    d_vc = c["d_vc"] * inv_cos
    d_vm = c["d_vm"] * inv_cos
    non_spec = ~mat_mod.is_specular(isect.params)

    if rows.rec is not None:
        rows.rec.copy_(_dead_where(dead, pack_batch(
            isect.pos, isect.w_out, isect.normal, isect.gn, isect.uv,
            isect.mat_id, c["throughput"], d_vc, d_vcm, d_vm,
            torch.full((lanes,), i + 2, dtype=torch.int32,
                       device=active.device), c["path_id"]),
            DEAD_LIGHT.rec))
        rows.store.copy_(active & non_spec)
    shadow = None
    if rows.cc is not None:
        # Normalised by the GLOBAL light-path count, not the band.
        contrib, pixel, shadow = _connect_to_camera(
            scene, cam, isect, c["throughput"], d_vc, d_vcm,
            active & non_spec, mis_eta_vm, light_path_count, algo,
            pixel_area)
        rows.cc.copy_(_dead_where(dead, contrib, DEAD_LIGHT.cc))
        rows.pixel.copy_(_dead_where(dead, pixel, DEAD_LIGHT.pixel))
        shadow = sh.ShadowRay(*(
            _dead_where(dead, x, getattr(DEAD_LIGHT, k))
            for k, x in zip(sh.ShadowRay._fields, shadow)))

    nxt = _bounce(scene, isect, c["throughput"], d_vc, d_vcm, d_vm, active,
                  c["state"], hit, mis_eta_vc, mis_eta_vm, adjoint=True,
                  algo=algo, last_bounce=(i + 1 >= max_len))
    for k in ("d_vc", "d_vcm", "d_vm"):
        nxt[k] = torch.where(dead, c[k], nxt[k])
    return dict(nxt, finite=c["finite"], path_id=c["path_id"]), shadow


def _connect_to_camera(scene, cam, isect, throughput, d_vc, d_vcm, valid,
                       mis_eta_vm, light_path_count, algo, pixel_area):
    """Light vertex -> camera connection up to its shadow ray: (contrib
    (R, 3), pixel id (R,), ShadowRay)."""
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
        dist_sqr * cos_cam * cos_cam * cos_cam, min=1e-12) / pixel_area
    w_light = (img_to_surf / light_path_count) * (
        mis_eta_vm + d_vcm + d_vc * pdf_rev)
    w = 1.0 if algo == "lt" else 1.0 / (w_light + 1.0)
    contrib = throughput * f * (w * img_to_surf / light_path_count)[..., None]
    valid = valid & torch.any(contrib > 0.0, dim=-1)

    offset = dist * 1e-3
    return contrib, pixel, sh.ShadowRay(isect.pos, dir_c, offset,
                                        dist - offset, valid)


def light_finish_plain(contrib, pixel, ok, occluded):
    """Keep the camera connections' rows where the shadow ray was cast and
    not occluded; zero contrib and pixel -1 elsewhere (in place)."""
    keep = ok & ~occluded
    contrib.copy_(torch.where(keep[..., None], contrib, 0.0))
    pixel.copy_(torch.where(keep, pixel, -1))


def _bounce(scene, isect, throughput, d_vc, d_vcm, d_vm, active, state, hit,
            mis_eta_vc, mis_eta_vm, *, adjoint, algo, last_bounce):
    """Shared camera / light bounce with the partial-weight updates: the
    next carry's org, d, tmin, throughput, active, d_vc, d_vcm, d_vm and
    state."""
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
    return dict(org=torch.where(a3, isect.pos, 0.0),
                d=torch.where(a3, wi, 0.0), tmin=hit.t * 1e-4,
                throughput=torch.where(a3, new_throughput, throughput),
                active=active, d_vc=torch.where(active, new_d_vc, d_vc),
                d_vcm=torch.where(active, new_d_vcm, d_vcm),
                d_vm=torch.where(active, new_d_vm, d_vm), state=state)


def camera_shade_plain(scene, c, hit, i, *, cache_count, cache_rec,
                       base_radius, mis_eta_vc, mis_eta_vm, algo, max_len,
                       light_path_count, num_connections, has_bump,
                       techniques, query=True):
    """Camera bounce `i` of the carry `c` after its closest hit `hit`,
    every live lane at bounce i: (next carry, ShadowSets or None,
    MergeQuery).  The next carry's radiance holds the env and emitter
    terms, its n_rays (with "n_rays" in c) the closest-hit rays;
    camera_finish adds the shadow sets and their rays, and the merge adds
    its term from the query.  A lane dead on entry casts no shadow ray:
    its rows hold DEAD_SHADOW.  `query` asks for the merge query (the
    plain version makes it either way)."""
    org, d, throughput, active, state = (c["org"], c["d"], c["throughput"],
                                         c["active"], c["state"])
    d_vc, d_vcm, d_vm, radiance = c["d_vc"], c["d_vcm"], c["d_vm"], \
        c["radiance"]
    num_lights = scene.lights.kind.shape[0]
    ppm = algo == "ppm"
    n_rays = c["n_rays"] + active.sum() if "n_rays" in c else None
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

    # --- NEE + vertex connections, up to their shadow rays ------------
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
    sets = None
    if shadow:
        dead = (~c["active"]).repeat(len(shadow))
        sets = ShadowSets(*(
            _dead_where(dead, x, v)
            for x, v in zip((torch.cat([s[k] for s in shadow])
                             for k in range(6)), DEAD_SHADOW)))
    q = MergeQuery(isect.pos, isect.normal, isect.gn, isect.w_out,
                   isect.params, d_vcm, d_vm, active & non_spec, throughput)

    nxt = _bounce(scene, isect, throughput, d_vc, d_vcm, d_vm, active, state,
                  hit, mis_eta_vc, mis_eta_vm, adjoint=False, algo=algo,
                  last_bounce=(i + 1 >= max_len))
    nxt["radiance"] = radiance
    if n_rays is not None:
        nxt["n_rays"] = n_rays
    return nxt, sets, q


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


def camera_finish_plain(radiance, contrib, ok, occluded, n_rays):
    """(radiance plus each shadow set's contrib where its ray was cast and
    not occluded, in set order; n_rays plus the cast rays, or None)."""
    n = radiance.shape[0]
    for k in range(ok.shape[0] // n):
        hit_ok = ok[k * n:(k + 1) * n] & ~occluded[k * n:(k + 1) * n]
        radiance = radiance + torch.where(hit_ok[..., None],
                                          contrib[k * n:(k + 1) * n], 0.0)
    return radiance, None if n_rays is None else n_rays + ok.sum()
