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
band), the collect cache's overflow and count read once, then the
frame's middle, eager once a frame: `select_shallowest` down to the
working cache capacity and the photon grid (on the card hand-written
kernels around the library sorts, ops/select.py and ops/merge.py, the
counterparts of JAX's jitted select_shallowest, canonicalize and
build_merge_grid), then the camera pass in bands of BAND_RAYS rays,
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

The shading between a bounce's traversals is ops/vcm_shade.py's: on the
card four hand-written CUDA kernels (the light band's start, a light
bounce, a camera bounce, and the finish after the any hit), the
counterpart of the XLA fusions of JAX's compiled band programs; on the
CPU their plain versions, this module's torch code as it was.

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

from ...core.sampling import PI
from ...core.vecmath import dot
from ...ops import merge as merge_mod
from ...ops import vcm_shade as vs
from ...ops.vcm_shade import ALGOS, TECHNIQUES
from ...utils import trace
from .. import graphs as graphs_mod
from .. import traverse as tt
from ..camera import Camera
from ..film import splat
from ..intersect import BIG
from ..light_cache import CollectCache, empty_collect, select_shallowest
from ..traverse import any_hit, closest_hit
from . import pt as pt_mod
from .pt import (BAND_RAYS, alpha_fn_for, camera_rays, run_bands,
                 use_compact)

# Camera bounces every band of a compacted camera pass runs before its
# lanes are sorted.
VCM_COMPACT_DEPTH = 4


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
    on the host (render/graphs.py captures it).  The shading between the
    traversals runs in ops/vcm_shade.py (on the card, its kernels)."""
    dev = cam.pos.device
    L = band_paths if band_paths > 0 else light_path_count
    use_cc = algo != "ppm" and "cam_connect" in techniques
    use_cache = collect is not None
    c = vs.light_start(scene, frame, mis_eta_vc, lanes=L,
                       light_path_count=light_path_count,
                       path_start=path_start, path_end=path_end)
    # The band's vertex rows and camera connections, in (bounce, path)
    # order.
    rows = vs.light_rows(L, max_len, use_cache, use_cc, dev)
    for i in range(max_len):
        hit = closest_hit(scene.bvh, c["org"], c["d"], c["tmin"], BIG,
                          alpha_fn=alpha_fn, active=c["active"], sort=True,
                          overflow=overflow)
        at = rows.at(i, L)
        c, shadow = vs.light_shade(
            scene, cam, c, hit, i, at, mis_eta_vc=mis_eta_vc,
            mis_eta_vm=mis_eta_vm, algo=algo,
            light_path_count=light_path_count, max_len=max_len,
            has_bump=has_bump, pixel_area=pixel_area(cam))
        if shadow is not None:
            occluded = any_hit(scene.bvh, shadow.pos, shadow.dir,
                               shadow.tmin, shadow.tmax, alpha_fn=alpha_fn,
                               active=shadow.ok, sort=True, overflow=overflow)
            vs.light_finish(at.cc, at.pixel, shadow.ok, occluded)

    # One splat and one append per band, in (bounce, path) order.
    if use_cache:
        collect.append(rows.store, rows.rec)
    if use_cc:
        return splat(rows.cc, rows.pixel, num_pixels)
    return torch.zeros((num_pixels, 3), dtype=torch.float32, device=dev)


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
    The shading between the traversals runs in ops/vcm_shade.py (on the
    card, its kernels): env and emitter hits, NEE and the vertex
    connections up to one batched any-hit dispatch of their shadow rays,
    their add, then merging and BSDF sampling.  With `record`, a list,
    the arguments of the bounce's merge call are appended to it.  With
    "n_rays" in the carry, the bounce adds its traced rays (closest hit +
    shadow) to it.  `overflow` as in _light_pass."""
    hit = closest_hit(scene.bvh, c["org"], c["d"], c["tmin"], BIG,
                      alpha_fn=alpha_fn, active=c["active"], sort=True,
                      overflow=overflow)
    merge = algo in ("vcm", "ppm") and "merge" in techniques
    nxt, shadow, q = vs.camera_shade(
        scene, c, hit, i, cache_count=cache_count, cache_rec=cache_rec,
        base_radius=base_radius, mis_eta_vc=mis_eta_vc,
        mis_eta_vm=mis_eta_vm, algo=algo, max_len=max_len,
        light_path_count=light_path_count, num_connections=num_connections,
        has_bump=has_bump, techniques=techniques, query=merge)
    if shadow is not None:
        occluded = any_hit(scene.bvh, shadow.pos, shadow.dir, shadow.tmin,
                           shadow.tmax, alpha_fn=alpha_fn, active=shadow.ok,
                           sort=True, overflow=overflow)
        nxt["radiance"], n_rays = vs.camera_finish(
            nxt["radiance"], shadow.contrib, shadow.ok, occluded,
            nxt.get("n_rays"))
        if n_rays is not None:
            nxt["n_rays"] = n_rays
    if merge:
        nxt["radiance"] = _vertex_merging(
            grid, q, q.throughput, q.d_vcm, q.d_vm, q.active,
            nxt["radiance"], mis_eta_vc, pm_radius, light_path_count, algo,
            mat_kinds, record=record)
    return nxt


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
    # A host number's copy to the card waits for the queue to drain.
    with trace.span("wait:constants"):
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
    (the scene's SceneGraphs) the static one of `key`, emptied (its key
    columns left as they are: nothing reads one past the count)."""
    if sg is None:
        return empty_collect(capacity, device)
    ins = sg.inputs(key)
    if "collect_rec" not in ins:
        c = empty_collect(capacity, device)
        ins.update(collect_rec=c.rec, collect_count=c.count,
                   collect_lost=c.lost, collect_keys=c.keys)
    c = CollectCache(ins["collect_rec"], ins["collect_count"],
                     ins["collect_lost"], ins["collect_keys"])
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
        state.update(rec=collect.rec, count=collect.count, lost=collect.lost,
                     keys=collect.keys)

    def step(st, overflow):
        col = (CollectCache(st["rec"], st["count"], st["lost"], st["keys"])
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
            with trace.span("light_pass"):
                band = light_bands(
                    scene, fi, collect, sg=sg, key=key,
                    lanes=min(light_band, light_path_count), algo=algo,
                    num_pixels=num_pixels,
                    light_path_count=light_path_count, max_len=max_len,
                    alpha_fn=alpha_fn, has_bump=has_bump,
                    techniques=techniques)
                for start in range(0, light_path_count, light_band):
                    film = film + band(start, min(light_band,
                                                  light_path_count - start))
                film = film * float(spp)
            if collect is not None:
                with trace.span("select"):
                    count = collect.check()
                    # Canonical (path, bounce) layout of the shallowest
                    # vertices: the same set and order under any band
                    # schedule.
                    cache = select_shallowest(
                        collect.cache(), cache_capacity, count=count,
                        **key_bounds(light_path_count, max_len))
                if stats is not None:
                    stats["collected"] = collect.count.clone()
                    stats["cache"] = cache.count.clone()
                del collect
            if algo in ("vcm", "ppm"):
                with trace.span("photon_grid"):
                    grid = photon_grid(cache, pm_radius, stats)
            if cache is not None:
                # Only the grid's keys read the position column.
                cache = dataclasses.replace(cache, pos4=None)
        if algo == "lt":
            return film
        band = max(1, camera_band // max(spp, 1))
        bands = [(start, min(band, num_pixels - start))
                 for start in range(0, num_pixels, band)]
        with trace.span("camera_pass"):
            return film + camera_film(
                scene, working_cache(fi, cache, grid, sg, key), bands,
                stats=stats, algo=algo, width=width, height=height,
                spp=spp, max_len=max_len,
                light_path_count=light_path_count,
                num_connections=num_connections, has_bump=has_bump,
                alpha_fn=alpha_fn, techniques=techniques,
                mat_kinds=mat_kinds, compact=compact, sg=sg, key=key)

    return graphs_mod.render_frame(scene, graph, render, "VCM frame")


def photon_grid(cache, pm_radius, stats=None):
    """The merge kernel's photon grid over the cache's valid vertices (on
    the card from the box and the position column its selection wrote);
    records the photon count in `stats` ("photons")."""
    grid = merge_mod.photon_grid(cache.rec, cache.count, pm_radius,
                                 cache.box, cache.pos4)
    if stats is not None:
        stats["photons"] = cache.count.to(torch.int64)
    return grid


def key_bounds(light_path_count: int, max_len: int) -> dict:
    """The exclusive bounds of a frame's path ids and path lengths (a
    light vertex of bounce i has length i + 2, i < max_len), which let
    the selection's sort keys take 32 bits (ops/select.py key_bits)."""
    return dict(paths=light_path_count, lengths=max_len + 2)


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
