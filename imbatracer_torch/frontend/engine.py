"""Algorithm dispatch: settings -> a frame-render function (torch twin
of imbatracer_tpu.frontend.engine.make_frame_fn, one device).

`pt` maps to the dedicated path tracer; `vcm` / `bpt` / `ppm` / `lt` /
`vcm_pt` map to the VCM template with the corresponding algorithm flag.
"""

from __future__ import annotations

import torch

from ..render.camera import Camera, generate_ray
from ..render.integrators.pt import render_pt_frame
from ..render.integrators.vcm import render_vcm_frame
from ..render.intersect import BIG
from ..render.traverse import closest_hit
from .renderer import RenderSettings, camera_for_scene

ALGO_MAP = {
    "pt": "pt-dedicated",
    "vcm": "vcm",
    "bpt": "bpt",
    "ppm": "ppm",
    "lt": "lt",
    "vcm_pt": "pt",
}
ALGORITHMS = tuple(ALGO_MAP)


def estimate_pixel_size(scene, cam: Camera, meta) -> float:
    """World-space footprint of one pixel (the photon-mapping base radius
    per unit radius factor): the mean hit distance of every 8th pixel's
    ray over the image-plane distance."""
    dev = cam.pos.device
    w = max(cam.width // 8, 1)
    h = max(cam.height // 8, 1)
    i = torch.arange(w * h, device=dev)
    xs = (i % w).to(torch.float32) * 8.0 + 0.5
    ys = (i // w).to(torch.float32) * 8.0 + 0.5
    org, d = generate_ray(cam, xs, ys)
    hit = closest_hit(scene.bvh, org, d, 0.0, BIG)
    ok = hit.prim_id >= 0
    mean_t = torch.sum(torch.where(ok, hit.t, 0.0)) / torch.clamp(
        torch.sum(ok.to(torch.float32)), min=1.0)
    return float(mean_t / cam.img_plane_dist)


def make_frame_fn(scene, meta, settings: RenderSettings):
    """Returns (frame_fn, camera); frame_fn(frame_index) -> (H*W, 3) film,
    rendered on the scene's device from the scene's camera.  The VCM
    family's frame_fn also takes `stats`, a dict that render_vcm_frame
    fills with the frame's vertex and photon counts."""
    core, cam = make_camera_frame_fn(scene, meta, settings)

    def frame_fn(frame, stats=None):
        return core(frame, cam, stats)

    return frame_fn, cam


def make_camera_frame_fn(scene, meta, settings: RenderSettings):
    """Returns (core_fn, default_camera) with core_fn(frame_index, camera,
    stats=None) -> (H*W, 3) film for that camera (the interactive preview
    moves it).  The VCM family's base radius is estimated once, from the
    default camera, as the JAX package does; `stats` as in
    make_frame_fn (the PT route fills none)."""
    algo = settings.algorithm
    if algo not in ALGO_MAP:
        raise ValueError(f"unknown algorithm {algo!r}")
    cam = camera_for_scene(meta, settings, scene.device)

    if algo == "pt":
        def core(frame, camera, stats=None):
            return render_pt_frame(
                scene, camera, frame, settings.width, settings.height,
                spp=settings.spp, max_len=settings.max_path_len,
                has_masks=meta.has_masks, has_bump=meta.has_bump)
        return core, cam

    vcm_algo = ALGO_MAP[algo]
    base_radius = 1.0
    if vcm_algo in ("vcm", "ppm"):
        base_radius = (estimate_pixel_size(scene, cam, meta)
                       * settings.radius_factor)
    lpc = settings.resolved_light_path_count()
    # The scene's material kinds: absent ones are skipped by the merge.
    mat_kinds = tuple(sorted(set(scene.materials.kind.tolist())))

    def core(frame, camera, stats=None):
        return render_vcm_frame(
            scene, camera, frame, base_radius, algo=vcm_algo,
            width=settings.width, height=settings.height, spp=settings.spp,
            max_len=settings.max_path_len, light_path_count=lpc,
            num_connections=settings.num_connections,
            has_masks=meta.has_masks, has_bump=meta.has_bump,
            mat_kinds=mat_kinds, stats=stats)

    return core, cam
