"""The reference path tracer: one progressive frame's radiance at chosen
pixels, in plain PyTorch.

Per lane it does what the program's PT frame does: a jittered camera
ray from the RNG stream keyed by (pixel, sample, frame), then `max_len`
bounces of closest hit, the frozen plain shading (`shade.py`: MIS on
environment misses and emitter hits, NEE with one uniformly picked
light, Russian roulette, BSDF sampling), the shadow ray's any hit and
the NEE add.  A lane's path depends only on its own stream, so a subset
of pixels renders exactly as it does inside the whole frame.

`lowp` is the control of the benchmark's check: every float the bounce
carries (ray origins and directions, the hit's t, u and v, throughput,
radiance, offsets and pdfs) is stored in bfloat16 between the steps,
the next precision below the float32 that the program states.
"""

from __future__ import annotations

import torch

from . import rng as rng_mod
from . import traverse
from .camera import generate_ray
from .intersect import BIG
from .shade import pt_shade_finish_plain, pt_shade_plain

LOWP = torch.bfloat16
CARRY_FLOATS = ("org", "d", "tmin", "throughput", "radiance", "last_pdf")


def round_lowp(x):
    return x.to(LOWP).to(torch.float32)


def camera_rays(cam, width: int, spp: int, frame: int, pixel_id):
    """The program's jittered primary rays for `pixel_id` (int64): lanes
    ordered sample-major, as the program orders a band's."""
    P = pixel_id.shape[0]
    pid = pixel_id.repeat(spp)
    sample_id = torch.arange(spp, device=pixel_id.device).repeat_interleave(P)
    state = rng_mod.seed(pid, sample_id, frame)
    state, (jx, jy) = rng_mod.next_floats(state, 2)
    px = (pid % width).to(torch.float32) + jx
    py = (pid // width).to(torch.float32) + jy
    org, d = generate_ray(cam, px, py)
    return org, d, state


def render_pixels(scene, cam, frame: int, pixel_id, *, width: int, spp: int,
                  max_len: int, has_masks: bool, has_bump: bool,
                  lowp: bool = False):
    """(P, 3) radiance summed over `spp` samples at each of `pixel_id`."""
    org, d, state = camera_rays(cam, width, spp, frame, pixel_id)
    zeros1 = torch.zeros_like(org[:, 0])
    c = dict(org=org, d=d, tmin=zeros1, throughput=torch.ones_like(org),
             radiance=torch.zeros_like(org),
             active=torch.ones_like(zeros1, dtype=torch.bool),
             depth=torch.zeros_like(zeros1, dtype=torch.int32),
             last_pdf=zeros1 + 1.0,
             last_specular=torch.ones_like(zeros1, dtype=torch.bool),
             state=state,
             n_rays=torch.zeros((), dtype=torch.int64, device=org.device))
    for _ in range(max_len):
        if lowp:
            c.update({k: round_lowp(c[k]) for k in CARRY_FLOATS})
        hit = traverse.closest_hit(scene, c["org"], c["d"], c["tmin"], BIG,
                                   c["active"], has_masks)
        if lowp:
            hit = hit._replace(t=torch.where(hit.prim_id >= 0,
                                             round_lowp(hit.t), BIG),
                               u=round_lowp(hit.u), v=round_lowp(hit.v))
        nxt, shadow, contrib = pt_shade_plain(scene, c, hit,
                                              has_bump=has_bump,
                                              max_len=max_len)
        occluded = traverse.any_hit(scene, shadow.pos, shadow.dir,
                                    shadow.tmin, shadow.tmax, shadow.ok,
                                    has_masks)
        nxt["radiance"], nxt["n_rays"] = pt_shade_finish_plain(
            nxt["radiance"], contrib, shadow.ok, occluded, nxt["n_rays"])
        c = nxt
        if not bool(c["active"].any()):
            break
    return c["radiance"].reshape(spp, -1, 3).sum(0)


def renderer(render: dict, raw):
    """render(ref_scene, camera, frame, pixel_id, lowp=False) for the
    traffic's render settings."""
    def fn(ref, cam, frame, pid, lowp=False):
        return render_pixels(ref, cam, frame, pid, width=render["width"],
                             spp=render.get("spp", 1),
                             max_len=render["max_path_len"],
                             has_masks=raw.has_masks, has_bump=raw.has_bump,
                             lowp=lowp)
    return fn
