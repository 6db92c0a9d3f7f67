"""Wavefront path tracer with NEE + MIS (torch twin of
imbatracer_tpu.render.integrators.pt, its banded frame renderer).

A frame is rendered in pixel bands of BAND_RAYS rays.  Each band is one
lockstep wavefront: a Python loop of `max_len` bounces, every bounce
traversing, shading and extending all lanes under an active mask
(environment-miss and emitter-hit MIS, one uniformly picked light for
NEE with an any-hit shadow ray, BSDF sampling with Russian roulette).
The shading runs in ops/shade.py: on the card two hand-written CUDA
kernels a bounce, one on each side of the shadow ray (the counterpart
of the XLA fusions of JAX's compiled band), on the CPU their plain
versions.  Scenes with alpha masks traverse through the masked route
(`alpha_fn_for`, render/traverse.py).  The per-ray RNG state rides in
the carry, so the estimator matches the JAX package's path for path.

Mid-frame lane compaction (the JAX module's compacted frame, after the
reference's RayQueue::compact): Russian roulette, misses and emitter hits
kill most lanes within a few bounces, yet a banded frame runs every band
for all `max_len` bounces.  The compacted frame runs the first
`compact_depth(max_len)` bounces of every band, stably sorts the merged
carry's lanes live-first (`_compact_carry`) and runs the remaining
bounces on ceil(alive / band lanes) bands only; one host sync a frame
reads the live count.  Each lane carries its RNG state and its lane id,
so a lane's path is the banded frame's, and the film is put back in lane
order before the per-band reshape-sums of the banded frame.  It is the
default on a CUDA device for frames of more than one band
(`use_compact`); the CPU keeps the banded frame unless asked.

CUDA graphs (the JAX module's compiled band programs, render/graphs.py):
on a CUDA device every band replays one captured bounce (`use_graphs`),
the camera rays, the compaction and the film staying eager.  The graphed
bounce traverses masked scenes through the graph-ready re-trace
(render/traverse.py), whose rounds past the first run in a WHILE
conditional node while a lane needs one; its overflow counter and the
device launch counts are read once, at the frame's end; a frame that
overflowed is rendered again on the eager route.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...core import rng as rng_mod
from ...ops import shade as shade_mod
from ...scene.textures import MaskTest
from ...utils import trace
from .. import graphs as graphs_mod
from .. import traverse as tt
from ..camera import Camera, generate_ray
from ..intersect import BIG
from ..traverse import any_hit, closest_hit

# Rays per band: the lockstep wavefront's width.
BAND_RAYS = 1 << 18
# Bounces every band of a compacted frame runs before its lanes are sorted.
COMPACT_DEPTH = 3


def alpha_fn_for(scene):
    """Transparency test for masked traversal: alpha_fn(prim, u, v) ->
    opaque, a textures.MaskTest over the narrow per-triangle mask record
    (TriAttrs.mask_rec), which the traversal kernels also run themselves.
    The JAX package's chained lookup through shade record and material
    row (IMBA_MASK_REC=0) is not ported; a masked scene always carries
    the record."""
    mask_rec = scene.attrs.mask_rec
    if mask_rec is None:
        raise NotImplementedError(
            "alpha masks need the scene's mask record (TriAttrs.mask_rec); "
            "the chained shade-record lookup is not ported")
    return MaskTest(mask_rec, scene.textures)


def _init_carry(org, d, state):
    zeros1 = torch.zeros_like(org[:, 0])
    return dict(
        org=org, d=d, tmin=zeros1, throughput=torch.ones_like(org),
        radiance=torch.zeros_like(org),
        active=torch.ones_like(zeros1, dtype=torch.bool),
        depth=torch.zeros_like(zeros1, dtype=torch.int32),
        last_pdf=zeros1 + 1.0,
        last_specular=torch.ones_like(zeros1, dtype=torch.bool),
        state=state,
        n_rays=torch.zeros((), dtype=torch.int64, device=org.device),
    )


def _pt_bounce(scene, c, *, alpha_fn, has_bump, max_len, overflow=None):
    """One PT bounce for every lane of the carry: the closest hit, the
    shading (ops/shade.py: the env and emitter MIS terms, NEE light
    sampling, Russian roulette, BSDF sampling), the shadow ray's any hit
    and the NEE add.  With `overflow`, a 0-d int32 device tensor, masked
    traversal takes the graph-ready re-trace (render/traverse.py) and
    the bounce reads nothing on the host."""
    hit = closest_hit(scene.bvh, c["org"], c["d"], c["tmin"], BIG,
                      alpha_fn=alpha_fn, active=c["active"], sort=True,
                      overflow=overflow)
    nxt, shadow, contrib = shade_mod.pt_shade(scene, c, hit,
                                              has_bump=has_bump,
                                              max_len=max_len)
    occluded = any_hit(scene.bvh, shadow.pos, shadow.dir, shadow.tmin,
                       shadow.tmax, alpha_fn=alpha_fn, active=shadow.ok,
                       sort=True, overflow=overflow)
    nxt["radiance"], nxt["n_rays"] = shade_mod.pt_shade_finish(
        nxt["radiance"], contrib, shadow.ok, occluded, nxt["n_rays"])
    return nxt


def _trace(scene, c, bounces, *, alpha_fn, has_bump, max_len):
    """`bounces` PT bounces of every lane of the carry.  The bounce is
    depth-per-lane, so lanes at mixed depths may share the carry."""
    for _ in range(bounces):
        c = _pt_bounce(scene, c, alpha_fn=alpha_fn, has_bump=has_bump,
                       max_len=max_len)
    return c


def compact_depth(max_len: int) -> int:
    """Phase-1 bounces of a compacted PT frame: COMPACT_DEPTH within
    [1, max_len - 1]."""
    return max(1, min(COMPACT_DEPTH, max_len - 1))


def use_compact(device, num_bands: int, max_len: int) -> bool:
    """Whether a frame of `num_bands` bands takes the compacted route by
    default: on a CUDA device, with more than one band and max_len >= 2.
    Every bounce of a band costs the card its launches whether or not
    its lanes live; on the CPU a dead lane costs only its arithmetic, so
    the banded frame stays."""
    return (torch.device(device).type == "cuda" and num_bands > 1
            and max_len >= 2)


def use_graphs(device, bvh) -> bool:
    """Whether a PT frame replays captured bounces by default: on a CUDA
    device, unless the BVH's pairs switch is on (the pair route reads
    its saturation count on the host each dispatch, so a bounce through
    it cannot be captured; it is off by default).  The CPU has no
    graphs."""
    return torch.device(device).type == "cuda" and not bvh.pairs


def _compact_carry(c, lane_id):
    """Stable partition of a lockstep carry's lanes, live lanes first: one
    stable sort of ~active and a gather of every column and of
    `lane_id`.  Returns (sorted carry, sorted lane ids, live count as a
    0-d tensor)."""
    _, order = torch.sort((~c["active"]).to(torch.uint8), stable=True)
    return ({k: v[order] for k, v in c.items()}, lane_id[order],
            c["active"].sum())


def compact_lanes(carries, band_lanes: int, phase2, stats=None):
    """Phase 2 of a compacted frame: merge the phase-1 carries (each a
    dict of per-lane columns), sort their lanes live-first, run
    `phase2(carry)` -> carry on the first ceil(alive / band_lanes)
    slices of `band_lanes` lanes, and return every lane's radiance in
    the carries' order (a scatter of unique lane ids, so the film sums
    as the banded frame's does).  The live count is the one host sync.
    Empties `carries`.  With `stats`, a dict, records "lanes", "alive"
    and "phase2_bands"."""
    with trace.span("compaction"):
        merged = {k: torch.cat([c[k] for c in carries])
                  for k in carries[0]}
        carries.clear()
        lanes = merged["active"].shape[0]
        lane_id = torch.arange(lanes, device=merged["active"].device)
        sc, lane_id, alive = _compact_carry(merged, lane_id)
        del merged
        with trace.span("wait:compact"):
            n_alive = int(alive)
    rad = sc["radiance"]
    n_bands2 = 0
    for done in range(0, n_alive, band_lanes):
        end = min(done + band_lanes, lanes)
        with trace.span("band"):
            rad[done:end] = phase2({k: v[done:end]
                                    for k, v in sc.items()})["radiance"]
        n_bands2 += 1
    if stats is not None:
        stats.update(lanes=lanes, alive=n_alive, phase2_bands=n_bands2)
    return torch.empty_like(rad).index_copy_(0, lane_id, rad)


def run_bands(bands, *, spp: int, width: int, max_len: int, depth0: int,
              compact: bool, phase1, phase2, stats=None):
    """A lockstep wavefront over `bands`, (start_pixel, pixels) runs of
    consecutive pixels: their films concatenated in order, (sum of
    pixels, 3).  `phase1(start, pixels)` returns a band's carry after
    `depth0` bounces (all `max_len` of them when not `compact`);
    `phase2(carry)` runs the remaining ones (compact_lanes).  With
    `stats`, a dict, also records "band_bounces", the bounces run summed
    over bands."""
    parts, carries = [], []
    for start, n in bands:
        with trace.span("band"):
            c = phase1(start, n)
        if compact:
            carries.append(c)
        else:
            parts.append(unswizzle_film(c["radiance"], spp, n, width))
        del c
    if compact:
        rad = compact_lanes(carries, max(n for _, n in bands) * spp, phase2,
                            stats)
        off = 0
        for _, n in bands:
            parts.append(unswizzle_film(rad[off:off + n * spp], spp, n,
                                        width))
            off += n * spp
    if stats is not None:
        stats["band_bounces"] = len(bands) * depth0 + (
            stats.get("phase2_bands", 0) * (max_len - depth0) if compact
            else 0)
    return parts[0] if len(parts) == 1 else torch.cat(parts)


@functools.lru_cache(maxsize=16)
def _tile_perm(num_pixels: int, width: int, device, tw: int = 32,
               th: int = 16):
    """Static permutation ordering a contiguous pixel band into (tw x th)
    image tiles and its inverse, int64 tensors on `device`; (None, None)
    when the band is not row-aligned.  Cached: it depends on the band's
    shape only, a sort of every band's pixels on each call would cost
    more than the frame's shading, and a copy to the card on each call
    would be a host-to-device copy a frame."""
    if num_pixels % width != 0 or num_pixels < width * th:
        return None, None
    i = np.arange(num_pixels)
    x, y = i % width, i // width
    perm = np.lexsort((x % tw, y % th, x // tw, y // th)).astype(np.int64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(num_pixels, dtype=np.int64)
    return (torch.tensor(perm, device=device),
            torch.tensor(inv, device=device))


def unswizzle_film(radiance, spp: int, num_pixels: int, width: int):
    """Undo the _tile_perm ordering and sum over spp: (spp*P, 3) -> (P, 3)."""
    _, inv = _tile_perm(num_pixels, width, radiance.device)
    r = radiance.reshape(spp, num_pixels, 3)
    if inv is not None:
        r = r[:, inv]
    return r.sum(dim=0)


def camera_rays(cam: Camera, width: int, height: int, spp: int, frame,
                start_pixel: int = 0, count: int = 0):
    """Jittered primary rays + per-ray RNG state + pixel ids for the band
    [start_pixel, start_pixel + count), emitted in image-tile order; RNG
    streams are keyed by global pixel ids, so banding never changes the
    image."""
    with trace.span("camera_rays"):
        dev = cam.pos.device
        num_pixels = count if count > 0 else width * height
        perm, _ = _tile_perm(num_pixels, width, dev)
        rel = (perm if perm is not None
               else torch.arange(num_pixels, device=dev))
        pixel_id = (start_pixel + rel).repeat(spp)
        sample_id = torch.arange(spp, device=dev).repeat_interleave(
            num_pixels)
        state = rng_mod.seed(pixel_id, sample_id, frame)
        state, (jx, jy) = rng_mod.next_floats(state, 2)
        px = (pixel_id % width).to(torch.float32) + jx
        py = (pixel_id // width).to(torch.float32) + jy
        org, d = generate_ray(cam, px, py)
    return org, d, state, pixel_id


def pt_bands(scene, cam: Camera, frame, bands, *, width: int, height: int,
             spp: int, max_len: int, has_masks: bool = False,
             has_bump: bool = False, compact: bool = None,
             graph: bool = None, stats: dict = None):
    """PT over `bands`, (start_pixel, pixels) runs of consecutive pixels:
    (their films concatenated in order, traced rays).  `compact`: the
    compacted route (None: `use_compact` on the camera's device).
    `graph`: every band replays one captured bounce (render/graphs.py)
    of the widest band's lanes, the others padded with dead lanes (None:
    `use_graphs`: on a CUDA device unless the BVH's pairs switch is on,
    whose route is eager by rule; True where graphs cannot run raises).
    A failed capture raises.  A graphed frame whose masked re-trace
    overflowed (render/traverse.py) is rendered again on the eager route,
    counted in graphs.GRAPH_STATS["reruns"] and logged."""
    dev = cam.pos.device
    if not bands:
        return (torch.zeros((0, 3), dtype=torch.float32, device=dev),
                torch.zeros((), dtype=torch.int64, device=dev))
    if compact is None:
        compact = use_compact(dev, len(bands), max_len)
    if graph is None:
        graph = use_graphs(dev, scene.bvh)
    elif graph and not use_graphs(dev, scene.bvh):
        raise ValueError("graph=True needs a CUDA device and the BVH's "
                         "pairs switch off")
    args = (scene, cam, frame, bands, width, height, spp, max_len,
            has_masks, has_bump, compact, stats)
    return graphs_mod.render_frame(scene, graph, lambda sg: _bands(*args, sg),
                                   "PT frame")


def _bands(scene, cam, frame, bands, width, height, spp, max_len, has_masks,
           has_bump, compact, stats, sg):
    """pt_bands' frame: eager, or with `sg` (the scene's SceneGraphs)
    through its captured bounce."""
    dev = cam.pos.device
    depth0 = compact_depth(max_len) if compact else max_len
    alpha_fn = alpha_fn_for(scene) if has_masks else None
    counts = []

    def carry0(start, n):
        org, d, state, _ = camera_rays(cam, width, height, spp, frame,
                                       start_pixel=start, count=n)
        return _init_carry(org, d, state)

    if sg is None:
        trace = functools.partial(_trace, scene, alpha_fn=alpha_fn,
                                  has_bump=has_bump, max_len=max_len)

        def phase1(start, n):
            c = trace(carry0(start, n), depth0)
            counts.append(c.pop("n_rays"))
            return c

        def phase2(c):
            c = trace(dict(c, n_rays=torch.zeros((), dtype=torch.int64,
                                                 device=dev)),
                      max_len - depth0)
            counts.append(c.pop("n_rays"))
            return c
    else:
        lanes = max(n for _, n in bands) * spp
        step = functools.partial(_pt_bounce, scene, alpha_fn=alpha_fn,
                                 has_bump=has_bump, max_len=max_len)
        key = (lanes, max_len, has_masks, has_bump,
               tt.graph_route(scene.bvh, has_masks))
        g = None

        def run(c, bounces):
            nonlocal g
            if g is None:
                g = sg.bounce(key, step, c, lanes)
            g.load(c)
            g.replay(bounces)
            counts.append(g.carry["n_rays"].clone())
            return g.carry

        def phase1(start, n):
            c = run(carry0(start, n), depth0)
            if not compact:
                return {"radiance": c["radiance"][:n * spp]}
            return {k: v[:n * spp].clone() for k, v in c.items()
                    if k != "n_rays"}

        def phase2(c):
            n = c["active"].shape[0]
            return {"radiance": run(c, max_len - depth0)["radiance"][:n]}

    film = run_bands(bands, spp=spp, width=width, max_len=max_len,
                     depth0=depth0, compact=compact, phase1=phase1,
                     phase2=phase2, stats=stats)
    n_rays = torch.zeros((), dtype=torch.int64, device=dev)
    for n in counts:
        n_rays = n_rays + n
    return film, n_rays


def render_pt_frame(scene, cam: Camera, frame, width: int, height: int,
                    spp: int = 1, max_len: int = 10, has_masks: bool = False,
                    has_bump: bool = False, with_stats: bool = False,
                    compact: bool = None, graph: bool = None,
                    stats: dict = None):
    """Render one progressive frame; returns an un-normalised (H*W, 3)
    radiance-sum film (divide by frames * spp for display), and with
    `with_stats` the traced-ray count.  `frame` is a 32-bit frame number
    (Python int or integer tensor).  `compact`: mid-frame lane
    compaction (None: `use_compact`, on for a CUDA device and more than
    one band).  `graph`: replay a captured bounce (None: `use_graphs`,
    on for a CUDA device; see pt_bands).  With `stats`, a dict, records
    the bands' "band_bounces" and, compacted, the lanes, the live lanes
    after the phase-1 bounces and the phase-2 bands (compact_lanes)."""
    num_pixels = width * height
    band = max(1, BAND_RAYS // max(spp, 1))
    bands = [(start, min(band, num_pixels - start))
             for start in range(0, num_pixels, band)]
    film, n_rays = pt_bands(scene, cam, frame, bands, width=width,
                            height=height, spp=spp, max_len=max_len,
                            has_masks=has_masks, has_bump=has_bump,
                            compact=compact, graph=graph, stats=stats)
    if with_stats:
        return film, n_rays
    return film
