"""Frames rendered across ranks, one card each (torch twin of
imbatracer_tpu.parallel.shard, over torch.distributed).

The scene is replicated: every rank builds the same DeviceScene on its
own card.  Rays never move between ranks.

  * PT: rank r renders the whole image rows `row_range(height, r, N)`
    in its own bands of at most BAND_RAYS rays (whole rows, so each band
    keeps _tile_perm's image-tile order when it spans at least 16 rows),
    and one gather of the film slices gives every rank the full film.
  * The VCM family's light pass: for each step of bp * N paths, rank r
    traces paths [start + r bp, start + (r + 1) bp), and the ranks' light
    films are summed in rank order, which is the order in which the
    single-process render_vcm_frame(..., light_band=bp) adds its bands.
    Each rank appends its paths' vertices to its own collect cache;
    `gather_cache` merges them into the single-process working cache.
    Every rank then builds the photon grid from that cache.  The camera
    pass splits whole rows as PT does, with one gather at the end.

RNG streams are keyed by global pixel and path ids, so a rank's rays are
those of the single-process frame.  Collectives a frame: PT 1 (+1 for
the ray count of `with_stats`); the VCM family 1 per light step, 2 for
the cache (counts, rows), 1 for the camera film and, under CUDA graphs,
1 for the ranks' device counts (their overflow counters summed).

Mid-frame lane compaction (the PT frame and the VCM camera pass, see
render/integrators/pt.py) runs within each rank: a rank sorts its own
bands' lanes and picks its own phase-2 band count, with no collective,
by the single-process rule on its own band count (`compact=None`).
"""

from __future__ import annotations

import dataclasses
import hashlib

import torch

from ..render import graphs
from ..render.integrators import pt as pt_mod
from ..render.integrators import vcm as vcm_mod
from ..render.light_cache import from_rows, select_shallowest
from ..tensors import TensorData

_DIGEST_CHUNK = 1 << 26   # bytes copied to the host at a time


def row_range(height: int, rank: int, world: int):
    """Rank `rank`'s rows [y0, y1): height // world rows, one more for
    the first height % world ranks.  A rank may get none."""
    base, extra = divmod(height, world)
    y0 = rank * base + min(rank, extra)
    return y0, y0 + base + (1 if rank < extra else 0)


def row_bands(y0: int, y1: int, width: int, band_pixels: int):
    """(start_pixel, pixels) bands of whole rows covering rows [y0, y1),
    at most band_pixels each (at least one row).  A band of 16 rows or
    more runs in _tile_perm's image-tile order; at 1920 x 1080 the bands
    are 136 rows, eight a frame, as many as the unsharded frame's."""
    rows = max(1, band_pixels // width)
    return [(y * width, (min(y + rows, y1) - y) * width)
            for y in range(y0, y1, rows)]


def _pixel_counts(width: int, height: int, world: int):
    return [(y1 - y0) * width
            for y0, y1 in (row_range(height, r, world) for r in range(world))]


def render_pt_frame_sharded(scene, cam, frame, width: int, height: int,
                            comm, *, spp: int = 1, max_len: int = 10,
                            has_masks: bool = False, has_bump: bool = False,
                            with_stats: bool = False, compact: bool = None):
    """One PT frame across the ranks of `comm`: the full un-normalised
    (H*W, 3) film on every rank (and, with `with_stats`, the traced rays
    of all ranks), equal to render_pt_frame's film up to exact-t ties
    that a different block composition of the traversal resolves
    differently.  `compact` as in render_pt_frame, decided by each rank
    for its own bands."""
    y0, y1 = row_range(height, comm.rank, comm.world)
    local, n_rays = pt_mod.pt_bands(
        scene, cam, frame,
        row_bands(y0, y1, width, pt_mod.BAND_RAYS // max(spp, 1)),
        width=width, height=height, spp=spp, max_len=max_len,
        has_masks=has_masks, has_bump=has_bump, compact=compact)
    film = comm.all_gather_rows(
        local, counts=_pixel_counts(width, height, comm.world))
    if with_stats:
        return film, comm.sum_in_rank_order(n_rays.reshape(1))[0]
    return film


def gather_cache(comm, collect, capacity: int, stats: dict = None):
    """The working vertex cache of all ranks' collect caches: the
    `capacity` shallowest vertices by (path_length, path_id) in canonical
    order, as select_shallowest gives them from one collect cache of
    every rank's vertices.  The key is a total order, so the shallowest
    vertices of the union lie among each rank's own shallowest
    `capacity`: each rank selects those first, then one gather of the
    counts and one of the packed (C, 24) rows bring them together.
    With `stats`, records the collected and kept counts of all ranks."""
    local = select_shallowest(collect, capacity)
    counts = torch.stack(comm.all_gather(torch.stack([
        local.count.to(torch.int64), collect.count.to(torch.int64)])))
    kept = counts[:, 0].tolist()
    rows = comm.all_gather_rows(local.packed()[:kept[comm.rank]],
                                counts=kept)
    cache = select_shallowest(from_rows(rows, capacity), capacity)
    if stats is not None:
        stats["collected"] = counts[:, 1].sum().to(torch.int32)
        stats["cache"] = cache.count
    return cache


def render_vcm_frame_sharded(scene, cam, frame, base_radius, comm, *,
                             algo: str = "vcm", width: int = 512,
                             height: int = 512, spp: int = 1,
                             max_len: int = 10, light_path_count: int = 0,
                             num_connections: int = 1,
                             has_masks: bool = False, has_bump: bool = False,
                             techniques: tuple = vcm_mod.TECHNIQUES,
                             mat_kinds: tuple = None,
                             light_band: int = pt_mod.BAND_RAYS,
                             camera_band: int = pt_mod.BAND_RAYS,
                             stats: dict = None, compact: bool = None,
                             graph: bool = None):
    """One VCM-family frame across the ranks of `comm`, with
    render_vcm_frame's arguments; the full film on every rank.  On the
    CPU it equals render_vcm_frame(..., light_band=bp) bit for bit, bp =
    min(light_band, light_path_count // N) the paths a rank traces a
    step; on a card the light splat's atomics reorder its sums.
    `light_path_count` must divide by the number of ranks (ValueError):
    tracing more or fewer paths than it biases the light film, so the
    engine rounds it up.  `compact`: camera-pass compaction as in
    render_vcm_frame, decided by each rank for its own bands.  `graph`
    as in render_vcm_frame: each rank replays its own captured light
    bands (of bp lanes) and camera phases; the ranks' device counts are
    gathered (one more collective), their overflow counters summed, and
    if the sum is above 0 every rank renders the frame again eagerly."""
    dev = cam.pos.device
    num_pixels = width * height
    record = stats is not None and "merge_queries" in stats
    graph = vcm_mod.resolve_graph(graph, dev, scene.bvh, record)
    (frame, base_radius, light_path_count, cache_capacity, pm_radius,
     mis_eta_vc, mis_eta_vm) = vcm_mod.frame_constants(
        cam, frame, base_radius, algo=algo, num_pixels=num_pixels,
        light_path_count=light_path_count, max_len=max_len)
    alpha_fn = pt_mod.alpha_fn_for(scene) if has_masks else None
    world, rank = comm.world, comm.rank
    if algo != "pt" and light_path_count % world:
        raise ValueError(
            f"light_path_count ({light_path_count}) must be divisible by "
            f"the number of ranks ({world}); round it up as the engine "
            f"does")
    per_rank = light_path_count // world
    bp = min(light_band, per_rank)
    inputs = vcm_mod.FrameInputs(cam, frame, base_radius, pm_radius,
                                 mis_eta_vc, mis_eta_vm)
    key = vcm_mod.statics_key(width, height, light_path_count, max_len,
                               per_rank * max_len, cache_capacity)

    def render(sg):
        fi = inputs if sg is None else inputs.static(sg.inputs(key))
        film = torch.zeros((num_pixels, 3), dtype=torch.float32, device=dev)
        cache = grid = None
        if algo != "pt":
            collect = (vcm_mod.frame_collect(sg, key, per_rank * max_len, dev)
                       if algo != "lt" else None)
            band = vcm_mod.light_bands(
                scene, fi, collect, sg=sg, key=key, lanes=bp, algo=algo,
                num_pixels=num_pixels, light_path_count=light_path_count,
                max_len=max_len, alpha_fn=alpha_fn, has_bump=has_bump,
                techniques=techniques)
            for start in range(0, light_path_count, bp * world):
                # Both the count and the stride divide by the ranks, so the
                # last step splits evenly too.
                n = min(bp, (light_path_count - start) // world)
                film = comm.sum_in_rank_order(band(start + rank * n, n),
                                              init=film)
            film = film * float(spp)
            if collect is not None:
                collect.check()
                cache = gather_cache(comm, collect.cache(), cache_capacity,
                                     stats)
                del collect
            if algo in ("vcm", "ppm"):
                grid = vcm_mod.photon_grid(cache, pm_radius, stats)
        if algo == "lt":
            return film
        y0, y1 = row_range(height, rank, world)
        local = vcm_mod.camera_film(
            scene, vcm_mod.working_cache(fi, cache, grid, sg, key),
            row_bands(y0, y1, width, camera_band // max(spp, 1)),
            stats=stats, algo=algo, width=width, height=height, spp=spp,
            max_len=max_len, light_path_count=light_path_count,
            num_connections=num_connections, has_bump=has_bump,
            alpha_fn=alpha_fn, techniques=techniques, mat_kinds=mat_kinds,
            compact=compact, sg=sg, key=key)
        return film + comm.all_gather_rows(
            local, counts=_pixel_counts(width, height, world))

    def total(counts):
        # Every rank's device counts in one collective and one host read:
        # the overflow counters summed, this rank's own launch counts.
        rows = torch.stack(comm.all_gather(counts)).tolist()
        return [sum(r[0] for r in rows)] + rows[rank][1:]

    return graphs.render_frame(scene, graph, render,
                               f"VCM frame on rank {rank}", total)


def scene_digest(scene) -> bytes:
    """SHA-256 of every tensor of a DeviceScene (names, shapes, dtypes and
    bytes, copied to the host in chunks) and of its static fields."""
    h = hashlib.sha256()

    def walk(obj):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if isinstance(v, TensorData):
                walk(v)
            elif torch.is_tensor(v):
                h.update(f"{f.name}{tuple(v.shape)}{v.dtype}".encode())
                flat = v.detach().contiguous().reshape(-1).view(torch.uint8)
                for i in range(0, flat.numel(), _DIGEST_CHUNK):
                    h.update(flat[i:i + _DIGEST_CHUNK].cpu().numpy())
            else:
                h.update(f"{f.name}={v!r}".encode())

    walk(scene)
    return h.digest()


def check_replicated(comm, scene):
    """Raise unless every rank holds the same scene (one gather of the
    ranks' scene digests)."""
    mine = torch.frombuffer(bytearray(scene_digest(scene)),
                            dtype=torch.uint8).to(comm.device)
    for r, d in enumerate(comm.all_gather(mine)):
        if not torch.equal(d, mine):
            raise RuntimeError(f"rank {comm.rank}: rank {r} holds another "
                               f"scene; every rank must build the same one")
