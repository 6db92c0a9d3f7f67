"""Algorithm dispatch: settings -> a frame-render function (torch twin
of imbatracer_tpu.frontend.engine.make_frame_fn).

`pt` maps to the dedicated path tracer; `vcm` / `bpt` / `ppm` / `lt` /
`vcm_pt` map to the VCM template with the corresponding algorithm flag.
Given a `comm` (parallel/comm.py), the frame functions render each frame
across its ranks (parallel/shard.py), as the JAX engine shards over its
mesh; without one, on the scene's one device.
"""

from __future__ import annotations

from functools import partial

import torch

from ..parallel import shard
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


def make_frame_fn(scene, meta, settings: RenderSettings, comm=None):
    """Returns (frame_fn, camera); frame_fn(frame_index) -> (H*W, 3) film,
    rendered on the scene's device from the scene's camera (across the
    ranks of `comm`, when given).  The VCM family's frame_fn also takes
    `stats`, a dict that render_vcm_frame fills with the frame's vertex
    and photon counts."""
    core, cam = make_camera_frame_fn(scene, meta, settings, comm)

    def frame_fn(frame, stats=None):
        return core(frame, cam, stats)

    return frame_fn, cam


def make_camera_frame_fn(scene, meta, settings: RenderSettings, comm=None):
    """Returns (core_fn, default_camera) with core_fn(frame_index, camera,
    stats=None) -> (H*W, 3) film for that camera (the interactive preview
    moves it).  The VCM family's base radius is estimated once, from the
    default camera, as the JAX package does; `stats` as in
    make_frame_fn (the PT route fills none).

    With `comm`, every rank must call it with the same scene and
    settings: it checks that the ranks' scenes are equal (one gather of
    their digests), rank 0 estimates the base radius and broadcasts it,
    and the light-path count is rounded up to a multiple of the ranks."""
    algo = settings.algorithm
    if algo not in ALGO_MAP:
        raise ValueError(f"unknown algorithm {algo!r}")
    cam = camera_for_scene(meta, settings, scene.device)
    if comm is not None:
        shard.check_replicated(comm, scene)

    if algo == "pt":
        def core(frame, camera, stats=None):
            kw = dict(spp=settings.spp, max_len=settings.max_path_len,
                      has_masks=meta.has_masks, has_bump=meta.has_bump)
            if comm is not None:
                return shard.render_pt_frame_sharded(
                    scene, camera, frame, settings.width, settings.height,
                    comm, **kw)
            return render_pt_frame(scene, camera, frame, settings.width,
                                   settings.height, **kw)
        return core, cam

    vcm_algo = ALGO_MAP[algo]
    base_radius = 1.0
    if vcm_algo in ("vcm", "ppm"):
        if comm is None or comm.rank == 0:
            base_radius = (estimate_pixel_size(scene, cam, meta)
                           * settings.radius_factor)
        if comm is not None:
            base_radius = float(comm.broadcast(torch.tensor(
                [base_radius], dtype=torch.float64, device=comm.device))[0])
    lpc = settings.resolved_light_path_count()
    if comm is not None:
        lpc = -(-lpc // comm.world) * comm.world
    # The scene's material kinds: absent ones are skipped by the merge.
    mat_kinds = tuple(sorted(set(scene.materials.kind.tolist())))
    render = (render_vcm_frame if comm is None else
              partial(shard.render_vcm_frame_sharded, comm=comm))

    def core(frame, camera, stats=None):
        return render(
            scene, camera, frame, base_radius, algo=vcm_algo,
            width=settings.width, height=settings.height, spp=settings.spp,
            max_len=settings.max_path_len, light_path_count=lpc,
            num_connections=settings.num_connections,
            has_masks=meta.has_masks, has_bump=meta.has_bump,
            mat_kinds=mat_kinds, stats=stats)

    return core, cam
