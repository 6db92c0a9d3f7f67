"""The reference VCM frame at chosen pixels, in plain PyTorch.

What the program's VCM frame (`render/integrators/vcm.py`) does, eagerly
and with the frozen plain shading (`vcm_shade.py`), merge
(`merge.py`) and caches (`light_cache.py`), the reference's own
traversal (`traverse.py`) in place of the program's:

  * the frame's constants: the progressive radius from the base radius
    (the mean primary hit distance of every 8th pixel over the image
    plane's distance, times the radius factor, as the program's engine
    estimates it once a run) and the MIS etas;
  * the whole light pass, in bands of light paths: a light start, then
    per bounce a closest hit, the light bounce with its camera
    connection and its shadow ray's any hit; every vertex appended to
    the collect cache, every camera connection splatted;
  * the selection of the shallowest vertices and the photon grid;
  * the camera pass over the chosen pixels only: per bounce a closest
    hit, env and emitter MIS, NEE and the vertex connections with their
    shadow rays, the merge, and the BSDF bounce.

A camera path depends only on its pixel's random stream and on the
frame's light pass, which runs whole, so the chosen pixels read as they
do inside the whole frame.  `lowp` is the check's control: the floats
that the camera and light bounces carry, and the hits, are stored in
bfloat16 between the steps.
"""

from __future__ import annotations

import torch

from . import light_cache as lc
from . import merge as merge_mod
from . import traverse
from . import vcm_shade as vs
from .camera import generate_ray
from .intersect import BIG
from .pt import camera_rays, round_lowp
from .sampling import PI
from .vecmath import dot

LIGHT_BAND = 1 << 18
LIGHT_FLOATS = ("org", "d", "tmin", "throughput", "d_vc", "d_vcm", "d_vm")
CAMERA_FLOATS = ("org", "d", "tmin", "throughput", "radiance", "d_vc",
                 "d_vcm", "d_vm")


def _lowp_carry(c, names):
    c.update({k: round_lowp(c[k]) for k in names if k in c})
    return c


def _lowp_hit(hit):
    return hit._replace(t=torch.where(hit.prim_id >= 0, round_lowp(hit.t),
                                      BIG),
                        u=round_lowp(hit.u), v=round_lowp(hit.v))


def base_radius(scene, cam, radius_factor: float) -> float:
    """The engine's estimate: the mean hit distance of every 8th pixel's
    primary ray (no alpha test) over the image-plane distance, times the
    radius factor."""
    dev = cam.pos.device
    w = max(cam.width // 8, 1)
    h = max(cam.height // 8, 1)
    i = torch.arange(w * h, device=dev)
    xs = (i % w).to(torch.float32) * 8.0 + 0.5
    ys = (i // w).to(torch.float32) * 8.0 + 0.5
    org, d = generate_ray(cam, xs, ys)
    hit = traverse.closest_hit(scene, org, d, torch.zeros_like(xs), BIG,
                               torch.ones_like(xs, dtype=torch.bool), False)
    ok = hit.prim_id >= 0
    mean_t = torch.sum(torch.where(ok, hit.t, 0.0)) / torch.clamp(
        torch.sum(ok.to(torch.float32)), min=1.0)
    return float(mean_t / cam.img_plane_dist) * radius_factor


def pixel_area(cam) -> float:
    return cam.width / cam.height


def auto_cache_capacity(light_path_count: int, max_len: int) -> int:
    return max(int(min(2, max(max_len - 1, 1)) * light_path_count), 1)


def _light_band(scene, cam, frame, eta_vc, eta_vm, collect, *, algo, start,
                lanes, light_path_count, max_len, has_masks, has_bump,
                lowp):
    """One band of light paths: its camera connections (contrib, pixel),
    its vertices appended to `collect`."""
    dev = cam.pos.device
    c = vs.light_start_plain(scene, frame, eta_vc, lanes=lanes,
                             light_path_count=light_path_count,
                             path_start=start)
    rows = vs.light_rows(lanes, max_len, True, algo != "ppm", dev)
    for i in range(max_len):
        if lowp:
            c = _lowp_carry(c, LIGHT_FLOATS)
        hit = traverse.closest_hit(scene, c["org"], c["d"], c["tmin"], BIG,
                                   c["active"], has_masks)
        if lowp:
            hit = _lowp_hit(hit)
        at = rows.at(i, lanes)
        c, shadow = vs.light_shade_plain(
            scene, cam, c, hit, i, at, mis_eta_vc=eta_vc, mis_eta_vm=eta_vm,
            algo=algo, light_path_count=light_path_count, max_len=max_len,
            has_bump=has_bump, pixel_area=pixel_area(cam))
        if shadow is not None:
            occluded = traverse.any_hit(scene, shadow.pos, shadow.dir,
                                        shadow.tmin, shadow.tmax, shadow.ok,
                                        has_masks)
            vs.light_finish_plain(at.cc, at.pixel, shadow.ok, occluded)
    collect.append(rows.store, rows.rec)
    return rows.cc, rows.pixel


def render_pixels(scene, cam, frame: int, pixel_id, radius0: float, *,
                  algo: str, width: int, height: int, spp: int, max_len: int,
                  light_path_count: int, num_connections: int,
                  has_masks: bool, has_bump: bool, lowp: bool = False):
    """(P, 3) radiance of the frame at `pixel_id`: its light splats
    (weighted by spp) and its camera samples."""
    dev = cam.pos.device
    num_pixels = width * height
    P = pixel_id.shape[0]
    frame_t = torch.as_tensor(frame, device=dev).to(torch.int64)
    radius0 = torch.as_tensor(radius0, dtype=torch.float32, device=dev)
    lpc = light_path_count if light_path_count > 0 else num_pixels // 2
    capacity = auto_cache_capacity(lpc, max_len)
    iteration = frame_t.to(torch.float32) + 1.0
    pm_radius = torch.clamp(radius0 / torch.pow(iteration, 0.5 * (1 - 0.75)),
                            min=1e-7)
    eta_vcm = PI * pm_radius * pm_radius * lpc
    eta_vc = 1.0 / eta_vcm
    eta_vm = torch.zeros_like(eta_vcm) if algo == "bpt" else eta_vcm

    # ---- the light pass, splatted to the chosen pixels only ------------
    where = torch.full((num_pixels + 1,), -1, dtype=torch.int64, device=dev)
    where[pixel_id] = torch.arange(P, device=dev)
    film = torch.zeros((P, 3), dtype=torch.float32, device=dev)
    collect = lc.empty_collect(lpc * max_len, dev)
    for start in range(0, lpc, LIGHT_BAND):
        lanes = min(LIGHT_BAND, lpc - start)
        cc, pixel = _light_band(
            scene, cam, frame_t, eta_vc, eta_vm, collect, algo=algo,
            start=start, lanes=lanes, light_path_count=lpc, max_len=max_len,
            has_masks=has_masks, has_bump=has_bump, lowp=lowp)
        if cc is not None:
            slot = where[torch.where(pixel >= 0, pixel.long(), num_pixels)]
            keep = slot >= 0
            band = torch.zeros((P, 3), dtype=torch.float32, device=dev)
            band.index_add_(0, slot[keep], cc[keep])
            film = film + band
    film = film * float(spp)
    count = collect.check()
    cache = lc.select_shallowest(collect.cache(), capacity, count=count,
                                 paths=lpc, lengths=max_len + 2)
    del collect
    grid = None
    if algo in ("vcm", "ppm"):
        grid = merge_mod.photon_grid(cache.rec, cache.count, pm_radius)
    mat_kinds = scene.mat_kinds

    # ---- the camera pass at the chosen pixels ---------------------------
    org, d, state = camera_rays(cam, width, spp, frame, pixel_id)
    cos_o = dot(d, cam.forward)
    a = cam.img_plane_dist / cos_o
    zero1 = torch.zeros_like(org[:, 0])
    c = dict(org=org, d=d, tmin=zero1, throughput=torch.ones_like(org),
             radiance=torch.zeros_like(org),
             active=torch.ones_like(zero1, dtype=torch.bool), d_vc=zero1,
             d_vcm=lpc / (a * a / cos_o / pixel_area(cam)), d_vm=zero1,
             state=state)
    merge = algo in ("vcm", "ppm")
    for i in range(max_len):
        if lowp:
            c = _lowp_carry(c, CAMERA_FLOATS)
        hit = traverse.closest_hit(scene, c["org"], c["d"], c["tmin"], BIG,
                                   c["active"], has_masks)
        if lowp:
            hit = _lowp_hit(hit)
        nxt, shadow, q = vs.camera_shade_plain(
            scene, c, hit, i, cache_count=cache.count,
            cache_rec=cache.packed(), base_radius=radius0,
            mis_eta_vc=eta_vc, mis_eta_vm=eta_vm, algo=algo,
            max_len=max_len, light_path_count=lpc,
            num_connections=num_connections, has_bump=has_bump,
            techniques=vs.TECHNIQUES, query=merge)
        if shadow is not None:
            occluded = traverse.any_hit(scene, shadow.pos, shadow.dir,
                                        shadow.tmin, shadow.tmax, shadow.ok,
                                        has_masks)
            nxt["radiance"], _ = vs.camera_finish_plain(
                nxt["radiance"], shadow.contrib, shadow.ok, occluded, None)
        if merge:
            radius_sqr = torch.clamp(pm_radius * pm_radius, min=1e-20)
            contrib = merge_mod.merge_contrib(
                grid, q.pos, q.normal, q.gn, q.w_out, q.params, q.d_vcm,
                q.d_vm, q.active, eta_vc, kinds=mat_kinds,
                ppm=(algo == "ppm"))
            norm = 2.0 / (PI * radius_sqr * lpc)
            nxt["radiance"] = nxt["radiance"] + torch.where(
                q.active[..., None], q.throughput * contrib * norm, 0.0)
        c = nxt
        if not bool(c["active"].any()):
            break
    return film + c["radiance"].reshape(spp, P, 3).sum(0)


def light_paths(render: dict) -> int:
    """The light paths a frame traces: the traffic's count, else the
    renderer's default, w*h/2 capped at 2^16 for BPT and LT and at 2^17
    for the merging algorithms."""
    if render.get("light_path_count", 0):
        return int(render["light_path_count"])
    cap = 1 << 16 if render["algorithm"] in ("bpt", "lt") else 1 << 17
    return min(render["width"] * render["height"] // 2, cap)


def renderer(render: dict, raw):
    """render(ref_scene, camera, frame, pixel_id, lowp=False) for the
    traffic's render settings; the base radius is estimated at the first
    call."""
    state = {}

    def fn(ref, cam, frame, pid, lowp=False):
        if "radius" not in state:
            state["radius"] = base_radius(ref, cam,
                                          render.get("radius_factor", 2.0))
        return render_pixels(
            ref, cam, frame, pid, state["radius"], algo=render["algorithm"],
            width=render["width"], height=render["height"],
            spp=render.get("spp", 1), max_len=render["max_path_len"],
            light_path_count=light_paths(render),
            num_connections=render.get("num_connections", 1),
            has_masks=raw.has_masks, has_bump=raw.has_bump, lowp=lowp)
    return fn
