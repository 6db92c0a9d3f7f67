#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (imbatracer_torch) on one GPU.

Run from the repository root: `python3 chip_smoke.py`.  Phases, in
order; any failure raises and the script exits non-zero:

1. Device: require CUDA; print the card's name and power limit.
2. Build: compile csrc/stream_traverse.cu and csrc/khit_traverse.cu with
   nvcc and csrc/bvh_builder.cpp with g++, all at once, into
   build/imbatracer_torch/; print each kernel entry's ptxas register and
   spill lines.
3. Stream kernel vs plain: 262,144 rays (camera rays, and bounce-like
   random rays with ~80% of lanes active) on the procedural cornell
   (S=1 super-chunk), make_big_scene(150) (S=3) and make_big_scene(4000)
   (S=68), closest hit and any hit, the CUDA kernel against its plain
   PyTorch version on the same tensors.  Tolerances: hit ids equal
   except where both hits have bit-equal t (ties); t/u/v within
   1e-5 * max(1, |x|) (both are built to round alike, so 0 is expected);
   any-hit flags may differ on at most 1e-4 of the rays.  Times both at
   the main-path shape (262,144 sorted bounce rays, S=68), and at S=3 (a
   scene the JAX package would send to its VMEM kernel): the kernel alone
   (candidate lists computed beforehand) and the wrapper with its lists;
   then runs the kernel's counting instantiation on the same rays, which
   must return the same rows, for the work behind the bound.
4. khit kernel vs plain: the same two ray sets, closest-hit bounds
   (tmin 1e-3, tmax 1e30), on make_leaf_scene(6000), make_still_life_like()
   (S=142) and the cornell (S=1).  The K=4 t vectors must agree to
   1e-5 * max(1, |t|) (0 expected) with the same hits present; ids equal
   except between hits of bit-equal t (including a tie between the K-th
   hit and the next one, which either version may keep).  Times both on
   the still-life bounce rays, and counts the kernel's work, as in 3.
5. Main paths, each with every launch counter set to 0 just before its
   timed frames and read just after them: (a) make_frame_fn +
   ProgressiveRenderer.step() for 3 frames of make_big_scene(4000) at
   1024^2, spp 1, max_len 6, and (b) of the cornell at 1024^2, max_len
   10 -- both stream-kernel entry points must have launched, no plain
   version may have run; (c) the
   still-life proxy (alpha masks + env map) at 1920x1080, spp 1,
   max_len 8: one warm-up frame, reset(), 8 frames, as the JAX package's
   curve (results/curves_r5/curve_still_life_pt_1080p.csv) was taken --
   the khit kernel must have launched and no plain version run, and the
   image's PSNR against goldens/still_life_1080p_len8.png must lie within
   0.5 dB of the JAX renderer's 17.16 dB at 8 frames; then one more
   still-life frame is traced with torch.profiler (device busy time, idle
   share, kernel count, the kernels and host ops that take longest).
   Films must be finite with a positive mean.
6. Film parity: the cornell and the masked scene at 64^2, spp 16,
   max_len 10, rendered on the card and on the CPU (plain versions); the
   films must agree to a mean relative difference <= 1% with >= 95% of
   pixels within 1e-3 relative (RR decisions flipped by last-ulp
   differences of transcendentals move a few paths).
7. The VCM family.  (a) Main path: the still-life at 1920x1080, spp 1,
   max_len 8, `vcm` with 2^20 light paths a frame and radius factor 2.0,
   through make_frame_fn + ProgressiveRenderer: one warm-up frame (which
   records, through render_vcm_frame's stats, the camera bounce-1 merge
   arguments of each band with the frame's photon grid), reset(), 2 timed
   frames with every
   launch counter set to 0 just before them and read just after -- the
   merge and khit kernels must have launched and no plain version run;
   the film must be finite and its mean within 5% of the PT film's mean
   over the same frames (PT is unbiased; the family agrees with it to
   ~2% in the JAX renderer); then one traced frame.  (b) Merge kernel vs
   plain on the kept queries of the band with the most active ones and
   the photons, and on random queries with
   kinds (0, 3, 4, 5), ppm both ways: per-query sums within 1e-4
   relative (of max(|plain|, 1e-6 max|plain|)), the counting launch's
   tallies equal to the plain version's; the kernel timed alone (queries
   prepared beforehand) and in merge_contrib, the plain version over 2
   calls.  (c) bpt, ppm and vcm_pt on the still life at 480x270,
   max_len 8, 2 frames each: finite, non-zero, mean within 5% of PT's.
   lt there too (finite, non-zero, reported); light tracing cannot see
   emitters directly nor through mirrors and glass, so it is held, over
   64 frames, against PT less the directly seen emission on the still
   life without the specular kinds.
   (d) Card vs CPU films of vcm and ppm on the cornell and vcm on the
   masked scene, 64^2, spp 4, max_len 8, held as in 6.
8. Output: the kernels' JSON line (`ms` the kernel alone; `bound_ms` the
   larger of its bytes over 3.35 TB/s and the float32 instructions its
   counting launch tallied over 33.5e12/s, see bound() and
   merge_bound()), the card's name and power limit, and last the
   {"ok": true, "device": ...} line.
"""

import json
import os
import subprocess
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

NUM_RAYS = 1 << 18
MAIN_FRAMES = 3
STILL_LIFE_FRAMES = 8
STILL_LIFE_PSNR = 17.16       # JAX renderer at 8 frames, spp 1
PSNR_TOL = 0.5
REPLACES = {
    "stream": "imbatracer_tpu/ops/pallas_stream.py:345 "
              "(+ imbatracer_tpu/ops/pallas_vmem.py:48)",
    "khit": "imbatracer_tpu/ops/pallas_khit.py:57 (via _khit_call :198)",
    "merge": "imbatracer_tpu/ops/pallas_merge.py:205 (via _merge_call :465)",
}
VCM_LPC = 1 << 20             # light paths a frame: BASELINE's 1M photons/iter
VCM_FRAMES = 2
FAMILY_SIZE = (480, 270)
MEAN_TOL = 0.05               # family film mean vs PT's
LT_FRAMES = 64
# Roofline of one H100 SXM (NVIDIA data sheet): HBM bytes/s, and float32
# instructions/s outside the tensor cores.  The sheet's 67 TFLOP/s counts
# an FMA as two operations; the kernels are built with --fmad=false, so
# each add, multiply, min, max or compare they issue is one instruction,
# at half that rate.
HBM_BYTES_PER_S = 3.35e12
FP32_INSTR_PER_S = 67e12 / 2
# Float instructions of one slab test (6 sub, 6 mul, 10 min/max, 3
# compares), and of one feature-dot Moller-Trumbore test up to the stage
# it ended at (stream_traverse.WORK_SLOTS[1:]): empty slot 1 (id test);
# |det| rejected 9 (+ det 5, |det| test, reciprocal counted as 1, zero
# test); t rejected 18 (+ t 7, 2 compares); u rejected 31 (+ u 12, 1
# compare); v rejected or hit 46 (+ v 12, u + v, 2 compares).  A khit hit
# adds K compares for its insertion.
SLAB_OPS = 25
MT_STAGE_OPS = (1, 9, 18, 31, 46, 46)
# Float instructions of the merge kernel per counted event (merge.
# WORK_SLOTS; division, sqrt and pow counted as one): a photon examined 9
# (3 sub, 3 mul, 2 add, the radius compare); within the radius 24 (the
# incoming direction in the query frame and the geometric side, 20, and
# 4 for the side tests); a BSDF evaluation 16 common (|li_z|, pdf_cos, f
# 9, 5 compares) plus diffuse 0, glossy 77 (half vector, Fresnel, Blinn D,
# G, both pdfs), phong 15, oren-nayar 36; an accepted pair 22 (MIS
# weight 9, kernel 3, weight 1, three accumulations 9).
MERGE_STAGE_OPS = (9, 24, 16, 16 + 77, 16 + 15, 16 + 36, 22)


def log(msg):
    print(msg, flush=True)


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps calls (CUDA events), after one
    warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def reset_counters():
    from imbatracer_torch.ops import khit as kh
    from imbatracer_torch.ops import merge as mg
    from imbatracer_torch.ops import stream_traverse as st
    from imbatracer_torch.render import traverse as tt

    st.reset_launches()
    kh.reset_launches()
    mg.reset_launches()
    for k in tt.MASK_STATS:
        tt.MASK_STATS[k] = 0


def counters():
    from imbatracer_torch.ops import khit as kh
    from imbatracer_torch.ops import merge as mg
    from imbatracer_torch.ops import stream_traverse as st
    from imbatracer_torch.render import traverse as tt

    return dict(closest_hit=st.LAUNCHES["closest_hit"],
                any_hit=st.LAUNCHES["any_hit"],
                stream_plain=st.LAUNCHES["plain"], khit=kh.LAUNCHES["khit"],
                khit_plain=kh.LAUNCHES["plain"], merge=mg.LAUNCHES["merge"],
                merge_plain=mg.LAUNCHES["plain"], **tt.MASK_STATS)


def plain_runs(got):
    return got["stream_plain"] + got["khit_plain"] + got["merge_plain"]


def bound(rays, sbox, tiles, out_cols, work, insert_ops=0):
    """(bound_ms, bound_by, detail): the least time one H100 could take
    for a traversal kernel's work on these rays -- the larger of the
    bytes (rays in, sbox and tiles read once, rows out) over the HBM rate
    and the float32 instructions the kernel issued over the float32
    instruction rate.  `work` holds the tallies of the kernel's counting
    launch on these rays (stream_traverse.WORK_SLOTS), costed with
    SLAB_OPS and MT_STAGE_OPS, plus `insert_ops` per hit."""
    from imbatracer_torch.ops import stream_traverse as st

    w = dict(zip(st.WORK_SLOTS, work.tolist()))
    ops = (w["slab"] * SLAB_OPS + w["mt_hit"] * insert_ops
           + sum(w[k] * c for k, c in zip(st.WORK_SLOTS[1:], MT_STAGE_OPS)))
    nbytes = 4 * (rays.numel() + sbox.numel() + tiles.numel()
                  + rays.shape[0] * out_cols)
    t_ops, t_bytes = ops / FP32_INSTR_PER_S, nbytes / HBM_BYTES_PER_S
    detail = dict(w, ops=ops, bytes=nbytes)
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", detail)


def time_kernel(launch, rays, sbox, tiles, out_cols, insert_ops=0):
    """Time a CUDA wrapper on these rays: (kernel ms with the candidate
    lists computed beforehand, wrapper ms with them computed per call,
    bound).  The counting launch behind the bound must return what the
    renderer's launch returns."""
    from imbatracer_torch.ops import stream_traverse as st

    lists = st.superchunk_candidates(rays, sbox)
    ms = cuda_ms(lambda: launch(lists=lists), 10)
    wrapper_ms = cuda_ms(launch, 10)
    work = torch.zeros(len(st.WORK_SLOTS), dtype=torch.int64,
                       device=rays.device)
    if not torch.equal(launch(lists=lists, work=work), launch(lists=lists)):
        raise AssertionError("the counting launch disagrees with the kernel")
    return ms, wrapper_ms, bound(rays, sbox, tiles, out_cols, work,
                                 insert_ops)


def ray_sets(scene, meta, dev, st):
    """(name, closest rays (R, 8), any-hit rays (R, 8)) for camera and
    bounce-like rays, sorted as the dispatch sorts them."""
    from imbatracer_torch.render.camera import make_camera
    from imbatracer_torch.render.integrators.pt import camera_rays

    rs = np.random.RandomState(7)
    side = int(round(NUM_RAYS ** 0.5))
    cam = make_camera(meta.cam_pos, meta.cam_dir, meta.cam_up, side, side,
                      60.0, device=dev)
    org, d, _, _ = camera_rays(cam, side, side, 1, 0)
    radius = float(scene.bsphere.radius)
    tmax_any = torch.as_tensor(rs.uniform(0.1, 3.0, NUM_RAYS) * radius,
                               dtype=torch.float32, device=dev)
    lo = scene.bsphere.center.cpu().numpy() - radius
    hi = scene.bsphere.center.cpu().numpy() + radius
    borg = torch.as_tensor(rs.uniform(lo, hi, (NUM_RAYS, 3)),
                           dtype=torch.float32, device=dev)
    bd = torch.as_tensor(rs.randn(NUM_RAYS, 3), dtype=torch.float32,
                         device=dev)
    bd = bd / torch.linalg.norm(bd, dim=1, keepdim=True)
    bact = torch.as_tensor(rs.rand(NUM_RAYS) < 0.8, device=dev)
    center = scene.bvh.center
    out = []
    for name, o, dd, act in (("camera", org, d, None),
                             ("bounce", borg, bd, bact)):
        o = o - center
        if act is None:
            act = torch.ones(NUM_RAYS, dtype=torch.bool, device=dev)
        lo_b, hi_b = st.scene_bounds(scene.bvh.sbox)
        perm = torch.sort(st.sort_keys(o, dd, act, lo_b, hi_b),
                          stable=True)[1]
        closest, _ = st.rays8(o[perm], dd[perm], 1e-3, st.BIG, act[perm])
        anyr, _ = st.rays8(o[perm], dd[perm], 1e-3, tmax_any, act[perm])
        out.append((name, closest.contiguous(), anyr.contiguous()))
    return out


def compare(scene, meta, label, dev, st, stats):
    for name, closest, anyr in ray_sets(scene, meta, dev, st):
        k = st.traverse_cuda(closest, scene.bvh.sbox, scene.bvh.tiles, False)
        p = st.traverse_plain(closest, scene.bvh.sbox, scene.bvh.tiles, False)
        torch.cuda.synchronize()
        kid, pid = k[:, 3], p[:, 3]
        tie = (kid != pid) & (k[:, 0] == p[:, 0]) & (kid >= 0) & (pid >= 0)
        bad_id = int(((kid != pid) & ~tie).sum())
        both = (kid == pid) & (kid >= 0)
        err = abs_err = 0.0
        if both.any():
            diff = (k[both, :3] - p[both, :3]).abs()
            scale = torch.clamp(p[both, :3].abs(), min=1.0)
            err = float((diff / scale).max())
            abs_err = float(diff.max())
        hits = int((kid >= 0).sum())
        ka = st.traverse_cuda(anyr, scene.bvh.sbox, scene.bvh.tiles, True)
        pa = st.traverse_plain(anyr, scene.bvh.sbox, scene.bvh.tiles, True)
        flips = int((ka[:, 0] != pa[:, 0]).sum())
        occ = float(ka[:, 0].mean())
        log(f"[parity] {label:<12} S={scene.bvh.sbox.shape[0]:<3} {name:<7} "
            f"closest: hits={hits} id_mismatch={bad_id} ties={int(tie.sum())}"
            f" max_rel_err(t,u,v)={err:.3e} | any: occluded={occ:.4f} "
            f"flag_mismatch={flips}")
        if bad_id or err > 1e-5 or flips > 1e-4 * NUM_RAYS:
            raise AssertionError(f"kernel disagrees with the plain version "
                                 f"on {label}/{name}")
        stats["closest_err"] = max(stats.get("closest_err", 0.0), abs_err)
        stats["any_err"] = max(stats.get("any_err", 0.0),
                               float((ka[:, 0] - pa[:, 0]).abs().max()))
        if label in ("big_150", "big_4000") and name == "bounce":
            for key, rays, occl in (("closest", closest, False),
                                    ("any", anyr, True)):
                args = (rays, scene.bvh.sbox, scene.bvh.tiles, occl)
                stats[label, key] = time_kernel(
                    partial(st.traverse_cuda, *args), *args[:3], 8)
                stats[label, f"{key}_plain_ms"] = cuda_ms(
                    lambda: st.traverse_plain(*args), 2)


def compare_khit(scene, meta, label, dev, st, kh, stats):
    sbox, tiles = scene.bvh.sbox, scene.bvh.tiles
    for name, rays, _ in ray_sets(scene, meta, dev, st):
        k = kh.khit_cuda(rays, sbox, tiles)
        # K + 1 nearest from the plain version: its first K are the plain
        # K-nearest, the extra one shows ties across the K-th place.
        p5 = kh.khit_plain(rays, sbox, tiles, k=kh.K + 1)
        p = p5[:, :8 * kh.K]
        torch.cuda.synchronize()
        kt, pt_ = k[:, 0::8], p[:, 0::8]
        kid, pid = k[:, 3::8], p[:, 3::8]
        present = pid >= 0
        if not torch.equal(kid >= 0, present):
            raise AssertionError(f"khit: present hits differ on "
                                 f"{label}/{name}")
        terr = float(((kt - pt_).abs() / torch.clamp(pt_.abs(), min=1.0))
                     [present].max()) if present.any() else 0.0
        # A slot is tied when another hit (returned or the next one) has
        # its bit-equal t: two triangles at one t, taken in either order.
        t5, present5 = p5[:, 0::8], p5[:, 3::8] >= 0
        tie = torch.zeros_like(present)
        for a in range(kh.K):
            for b in range(kh.K + 1):
                if a != b:
                    tie[:, a] |= (t5[:, a] == t5[:, b]) & present5[:, b]
        bad_id = int((present & (kid != pid) & ~tie).sum())
        same = present & (kid == pid)
        uv_err = 0.0
        if same.any():
            uv_err = max(float((k[:, f::8] - p[:, f::8]).abs()[same].max())
                         for f in (1, 2))
        per_slot = [int(present[:, s].sum()) for s in range(kh.K)]
        log(f"[khit] {label:<11} S={sbox.shape[0]:<3} {name:<7} hits per "
            f"slot {per_slot} id_mismatch={bad_id} "
            f"ties={int((present & (kid != pid)).sum())} "
            f"max_rel_err(t)={terr:.3e} max_abs_err(u,v)={uv_err:.3e}")
        if bad_id or terr > 1e-5 or uv_err > 1e-5:
            raise AssertionError(f"khit kernel disagrees with the plain "
                                 f"version on {label}/{name}")
        stats["khit_err"] = max(stats.get("khit_err", 0.0),
                                float((kt - pt_).abs()[present].max())
                                if present.any() else 0.0, uv_err)
        if label == "still_life" and name == "bounce":
            stats["khit"] = time_kernel(
                partial(kh.khit_cuda, rays, sbox, tiles), rays, sbox, tiles,
                8 * kh.K, insert_ops=kh.K)
            stats["khit_plain_ms"] = cuda_ms(
                lambda: kh.khit_plain(rays, sbox, tiles), 2)


def main_path(scene, meta, label, width, height, max_len, frames, card,
              warmup_reset=False):
    """Drive make_frame_fn + ProgressiveRenderer on the card: a warm-up
    frame (then reset() with `warmup_reset`), then `frames` timed frames,
    with every launch counter set to 0 just before them and read just
    after.  Returns the renderer, the counters, ms/frame and Mrays/s
    (traced rays counted afterwards by re-rendering the timed frames with
    `with_stats`; those launches are not in the counters)."""
    from imbatracer_torch.frontend.engine import make_frame_fn
    from imbatracer_torch.frontend.renderer import (ProgressiveRenderer,
                                                    RenderSettings)
    from imbatracer_torch.render.integrators.pt import render_pt_frame

    settings = RenderSettings(width=width, height=height, spp=1,
                              max_path_len=max_len)
    frame_fn, cam = make_frame_fn(scene, meta, settings)
    renderer = ProgressiveRenderer(frame_fn, settings, scene.device)
    renderer.step()                       # warm-up frame 0
    if warmup_reset:
        renderer.reset()
    torch.cuda.synchronize()
    first = renderer.frames
    reset_counters()
    t0 = time.time()
    for _ in range(frames):
        renderer.step()
    torch.cuda.synchronize()
    ms = (time.time() - t0) * 1000.0 / frames
    launches = counters()
    rays = 0
    for f in range(first, first + frames):
        _, n = render_pt_frame(scene, cam, f, width, height, spp=1,
                               max_len=max_len, has_masks=meta.has_masks,
                               with_stats=True)
        rays += int(n)
    film = renderer.accum
    mean = float(film.mean())
    if not bool(torch.isfinite(film).all()) or not mean > 0.0:
        raise AssertionError(f"{label}: film is not finite with a positive "
                             f"mean (mean {mean})")
    mrays = rays / (ms * frames / 1000.0) / 1e6
    log(f"[main] {label}: {width}x{height} spp 1 max_len {max_len}: "
        f"{ms:.1f} ms/frame over {frames} frames, {rays // frames} "
        f"rays/frame, {mrays:.2f} Mrays/s (film mean "
        f"{mean / renderer.frames:.4f}) [{card}]")
    return renderer, launches, ms, mrays


def profile_frame(renderer, label, card, top=8):
    """Trace one more frame of `renderer` with torch.profiler: wall time,
    device busy time (kernel time summed; the frame runs on one stream),
    the device's idle share, the kernel count, and the kernels with the
    most device time and the host ops with the most host time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.time()
        renderer.step()
        torch.cuda.synchronize()
        wall = 1e3 * (time.time() - t0)
    rows = prof.key_averages()
    dev = [e for e in rows
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e3
    log(f"[profile] {label}, one traced frame: wall {wall:.1f} ms, device "
        f"busy {busy:.1f} ms (idle {100.0 * (1.0 - busy / wall):.1f}%), "
        f"{sum(e.count for e in dev)} kernels [{card}]")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[profile]   device {e.self_device_time_total / 1e3:9.2f} ms "
            f"{e.count:7d}x  {e.key[:80]}")
    host = [e for e in rows if e.device_type == torch.autograd.DeviceType.CPU]
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:top]:
        log(f"[profile]   host   {e.self_cpu_time_total / 1e3:9.2f} ms "
            f"{e.count:7d}x  {e.key[:80]}")


def film_parity(dev, label, builder, has_masks):
    from imbatracer_torch.render.camera import make_camera
    from imbatracer_torch.render.integrators.pt import render_pt_frame

    films = {}
    for where in (dev, "cpu"):
        scene, meta = builder(device=where)
        cam = make_camera(meta.cam_pos, meta.cam_dir, meta.cam_up, 64, 64,
                          60.0, device=where)
        films[str(where)] = render_pt_frame(
            scene, cam, 5, 64, 64, spp=16, max_len=10,
            has_masks=has_masks).cpu().numpy()
    g, c = films[str(dev)], films["cpu"]
    mean_rel = abs(float(g.mean()) - float(c.mean())) / float(c.mean())
    rel = np.abs(g - c) / np.maximum(np.abs(c), 1e-3)
    within = float((rel.max(axis=-1) <= 1e-3).mean())
    log(f"[film] {label} 64x64 spp 16 max_len 10, card vs CPU: mean rel "
        f"diff {mean_rel:.3e}, pixels within 1e-3: {within:.4f}, exact "
        f"pixels: {float((g == c).all(axis=-1).mean()):.4f}")
    if not (mean_rel <= 0.01 and within >= 0.95):
        raise AssertionError(f"{label}: card and CPU films disagree")


def search_reads(keys, targets):
    """(N,) bool: the key slots that the merge kernel's lower_bound reads
    while it searches for each of `targets`, step by step as it does."""
    n = keys.shape[0]
    lo = torch.zeros_like(targets, dtype=torch.int64)
    hi = torch.full_like(lo, n)
    read = torch.zeros(n, dtype=torch.bool, device=keys.device)
    while True:
        go = lo < hi
        if not bool(go.any()):
            return read
        mid = (lo + hi) >> 1
        read[mid[go]] = True
        less = keys[torch.clamp(mid, max=n - 1)] < targets
        lo = torch.where(go & less, mid + 1, lo)
        hi = torch.where(go & ~less, mid, hi)


def merge_bytes(qrec, grid, scal, kinds, ppm):
    """(bytes, detail): what the merge function must move on these
    queries, each word read once: columns 0:34 of a live query row and the
    kind and active columns of another; the key slots of its binary
    searches; photon rows 0:3 (position) of every photon in a live
    query's combo ranges, rows 4:7 (w_in) of those within some query's
    radius, rows 7:10 (throughput) and, unless ppm, 10:12 (d_vcm, d_vm)
    of those accepted into some sum; the 2 scalars; the (Q, 8) rows
    out."""
    from imbatracer_torch.ops import merge as mg

    mask = mg.kind_mask(kinds)
    live = mg.live_rows(qrec, mask)
    k = qrec[:, 29:33].to(torch.int32)
    k = k[(k >= 0) & live[:, None]]
    keys_read = int(search_reads(grid.keys, torch.cat([k, k + 2])).sum())
    photons = mg.photon_rows(grid)
    seen, near, used = (torch.zeros(photons.shape[0], dtype=torch.bool,
                                    device=qrec.device) for _ in range(3))
    for qi, pidx in mg.pair_chunks(qrec, grid.keys, mask):
        _, in_r, _, ok = mg.pair_terms(qrec[qi], photons[pidx], scal[0],
                                       scal[1], mask, ppm)
        seen[pidx] = True
        near[pidx[in_r]] = True
        used[pidx[ok]] = True
    n_q, n_live = qrec.shape[0], int(live.sum())
    detail = dict(live=n_live, keys_read=keys_read, photons=int(seen.sum()),
                  near=int(near.sum()), used=int(used.sum()))
    words = (34 * n_live + 2 * (n_q - n_live) + keys_read
             + 3 * detail["photons"] + 3 * detail["near"]
             + (3 if ppm else 5) * detail["used"] + 2 + 8 * n_q)
    return 4 * words, detail


def merge_bound(qrec, grid, scal, kinds, ppm, work):
    """(bound_ms, bound_by, detail) of the merge kernel on these queries:
    the larger of the bytes the function must move (merge_bytes) over the
    HBM rate and the float32 instructions of its counting launch
    (MERGE_STAGE_OPS) over the float32 instruction rate."""
    from imbatracer_torch.ops import merge as mg

    w = dict(zip(mg.WORK_SLOTS, work.tolist()))
    ops = sum(w[k] * c for k, c in zip(mg.WORK_SLOTS, MERGE_STAGE_OPS))
    nbytes, read = merge_bytes(qrec, grid, scal, kinds, ppm)
    t_ops, t_bytes = ops / FP32_INSTR_PER_S, nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes",
            dict(w, ops=ops, bytes=nbytes, **read))


def compare_merge(label, qrec, grid, scal, kinds, ppm, stats):
    """Kernel vs plain on sorted query rows: per-query sums within 1e-4
    relative (of max(|plain|, 1e-6 max|plain|)), rows 3:8 zero, and the
    counting launch returns the kernel's rows with the plain version's
    tallies.  Returns the counted work."""
    from imbatracer_torch.ops import merge as mg

    k = mg.merge_cuda(qrec, grid, scal, kinds, ppm)
    work = torch.zeros(len(mg.WORK_SLOTS), dtype=torch.int64,
                       device=qrec.device)
    kc = mg.merge_cuda(qrec, grid, scal, kinds, ppm, work=work)
    pwork = torch.zeros_like(work)
    p = mg.merge_plain(qrec, grid, scal, kinds, ppm, work=pwork)
    torch.cuda.synchronize()
    ref = p[:, :3].abs()
    floor = 1e-6 * float(ref.max())
    diff = (k[:, :3] - p[:, :3]).abs()
    rel = float((diff / torch.clamp(ref, min=max(floor, 1e-30))).max())
    live = int((qrec[:, 33] > 0.5).sum())
    tallies = dict(zip(mg.WORK_SLOTS, work.tolist()))
    log(f"[merge] {label}: {qrec.shape[0]} queries ({live} active), "
        f"{grid.keys.shape[0]} photon slots, kinds {kinds} ppm {ppm}: "
        f"max rel err {rel:.3e}, max abs err {float(diff.max()):.3e}; "
        f"tallies {tallies}")
    if (rel > 1e-4 or not torch.equal(kc, k) or not torch.equal(work, pwork)
            or bool((k[:, 3:] != 0).any()) or not float(ref.sum()) > 0.0):
        raise AssertionError(f"merge kernel disagrees with the plain version "
                             f"on {label}")
    stats["merge_err"] = max(stats.get("merge_err", 0.0),
                             float(diff.max()))
    return work


def random_merge_case(dev, seed, num_p=1 << 17, num_q=1 << 16):
    """A photon grid and sorted query rows from a numpy seed (kinds
    0/3/4/5 mixed)."""
    from imbatracer_torch.ops import merge as mg

    rs = np.random.RandomState(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def unit(n):
        v = rs.randn(n, 3)
        return t(v / np.linalg.norm(v, axis=1, keepdims=True))

    grid = mg.build_merge_grid(
        t(rs.rand(num_p, 3)), torch.as_tensor(rs.rand(num_p) > 0.1,
                                              device=dev),
        0.01, unit(num_p), t(rs.rand(num_p, 3)), t(rs.rand(num_p)),
        t(rs.rand(num_p)))
    n = unit(num_q)
    gn = torch.nn.functional.normalize(n + 0.1 * unit(num_q), dim=1)
    params = dict(kind=torch.as_tensor(rs.choice((0, 3, 4, 5), num_q),
                                       dtype=torch.int32, device=dev),
                  kd=t(rs.rand(num_q, 3)), ks=t(rs.rand(num_q, 3)),
                  ns=t(1.0 + rs.rand(num_q) * 30.0))
    qrec, _ = mg.prepare_queries(
        grid, t(rs.rand(num_q, 3)), n, gn, unit(num_q), params,
        t(rs.rand(num_q) * 2), t(rs.rand(num_q) * 2),
        torch.as_tensor(rs.rand(num_q) > 0.15, device=dev))
    return qrec, grid, mg.scalars(grid, 0.3)


def time_merge(label, q, stats):
    """The merge kernel on recorded still-life queries (`q`, merge_contrib's
    arguments by name): parity, then the kernel alone (queries prepared
    beforehand), the wrapper (merge_contrib: preparation, kernel,
    un-permutation), the plain version over 2 calls, and the bound from
    the counting launch."""
    from imbatracer_torch.ops import merge as mg

    stats["merge_label"] = label
    grid, kinds, ppm = q["grid"], q["kinds"], q["ppm"]
    qrec, _ = mg.prepare_queries(grid, q["qpos"], q["normal"], q["gn"],
                                 q["w_out"], q["params"], q["d_vcm"],
                                 q["d_vm"], q["active"])
    scal = mg.scalars(grid, q["mis_eta_vc"])
    work = compare_merge(label, qrec, grid, scal, kinds, ppm, stats)
    ms = cuda_ms(lambda: mg.merge_cuda(qrec, grid, scal, kinds, ppm), 10)
    wrapper_ms = cuda_ms(lambda: mg.merge_contrib(**q), 10)
    plain_ms = cuda_ms(lambda: mg.merge_plain(qrec, grid, scal, kinds, ppm),
                       2)
    stats["merge"] = (ms, wrapper_ms,
                      merge_bound(qrec, grid, scal, kinds, ppm, work))
    stats["merge_plain_ms"] = plain_ms


def family_frames(scene, meta, algo, width, height, max_len, frames,
                  queries=None):
    """make_frame_fn + ProgressiveRenderer: a warm-up frame, reset(), then
    `frames` timed frames with the launch counters set to 0 just before
    them and read just after.  Returns (renderer, counters, ms/frame,
    stats of the warm-up frame).  With `queries`, a list, the warm-up
    frame appends each camera band's bounce-1 merge arguments to it."""
    from imbatracer_torch.frontend.engine import make_frame_fn
    from imbatracer_torch.frontend.renderer import (ProgressiveRenderer,
                                                    RenderSettings)

    settings = RenderSettings(width=width, height=height, spp=1,
                              max_path_len=max_len, algorithm=algo)
    if algo == "vcm" and (width, height) == (1920, 1080):
        settings.light_path_count = VCM_LPC
    frame_fn, _ = make_frame_fn(scene, meta, settings)
    renderer = ProgressiveRenderer(frame_fn, settings, scene.device)
    fstats = {} if queries is None else {"merge_queries": queries}
    if algo == "pt":
        renderer.step()
    else:
        renderer.accum = renderer.accum + frame_fn(0, stats=fstats)
    fstats.pop("merge_queries", None)
    renderer.reset()
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.time()
    for _ in range(frames):
        renderer.step()
    torch.cuda.synchronize()
    ms = (time.time() - t0) * 1000.0 / frames
    return renderer, counters(), ms, {k: int(v) for k, v in fstats.items()}


def film_mean(renderer, label):
    film = renderer.accum
    mean = float(film.mean()) / renderer.frames
    if not bool(torch.isfinite(film).all()) or not mean > 0.0:
        raise AssertionError(f"{label}: film is not finite with a positive "
                             f"mean (mean {mean})")
    return mean


def check_mean(label, mean, pt_mean, card):
    rel = (mean - pt_mean) / pt_mean
    log(f"[family] {label}: film mean {mean:.6f} a frame, PT {pt_mean:.6f}: "
        f"{100.0 * rel:+.2f}% [{card}]")
    if not abs(rel) <= MEAN_TOL:
        raise AssertionError(f"{label}: film mean is {100.0 * rel:+.2f}% off "
                             f"PT's, beyond {100.0 * MEAN_TOL:.0f}%")


def vcm_main_path(scene, meta, card, stats):
    """The slice's main path (phase 7a); returns the renderer for the
    traced frame and the merge launches of the timed frames."""
    from imbatracer_torch.utils.metrics import load_reference_png, psnr

    queries = []
    renderer, got, ms, fstats = family_frames(
        scene, meta, "vcm", 1920, 1080, 8, VCM_FRAMES, queries=queries)
    log(f"[vcm] still_life 1920x1080 spp 1 max_len 8, {VCM_LPC} light paths,"
        f" radius factor 2.0: {ms:.1f} ms/frame over {VCM_FRAMES} frames "
        f"[{card}]")
    log(f"[vcm] warm-up frame: {fstats['collected']} vertices collected, "
        f"cache {fstats['cache']}, photons {fstats['photons']}; launches "
        f"over the timed frames: {got}")
    if got["merge"] == 0 or got["khit"] == 0 or plain_runs(got):
        raise AssertionError("still_life vcm: the main path did not run "
                             "through the merge and khit kernels")
    mean = film_mean(renderer, "still_life vcm")
    pt, _, pt_ms, _ = family_frames(scene, meta, "pt", 1920, 1080, 8,
                                    VCM_FRAMES)
    check_mean("still_life 1920x1080 vcm", mean,
               film_mean(pt, "still_life pt"), card)
    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "goldens", "still_life_1080p_len8.png")
    log(f"[vcm] PSNR after {renderer.frames} frames vs "
        f"{os.path.basename(golden)}: "
        f"{psnr(renderer.image(), load_reference_png(golden)):.3f} dB (PT "
        f"{psnr(pt.image(), load_reference_png(golden)):.3f} dB at "
        f"{pt_ms:.1f} ms/frame) [{card}]")
    band = max(range(len(queries)),
               key=lambda b: int(queries[b]["active"].sum()))
    time_merge(f"still_life band {band}, camera bounce 1", queries[band],
               stats)
    del queries
    return renderer, got["merge"]


def direct_emission_mean(scene, meta, width, height, frames):
    """Mean a frame of what the camera sees of the emitters directly (the
    env and lamps at the first vertex, full weight): the template's PT
    with only the light-hit technique, one bounce, over frames 0.."""
    from imbatracer_torch.frontend.renderer import (RenderSettings,
                                                    camera_for_scene)
    from imbatracer_torch.render.integrators.vcm import render_vcm_frame

    cam = camera_for_scene(meta, RenderSettings(width=width, height=height),
                           scene.device)
    return sum(float(render_vcm_frame(
        scene, cam, f, 1.0, algo="pt", width=width, height=height, max_len=1,
        techniques=("light_hit",), has_masks=meta.has_masks).mean())
        for f in range(frames)) / frames


def run_family(scene, meta, label, algo, frames=VCM_FRAMES):
    w, h = FAMILY_SIZE
    r, got, ms, _ = family_frames(scene, meta, algo, w, h, 8, frames)
    log(f"[family] {label} {w}x{h} {algo}: {ms:.1f} ms/frame over "
        f"{frames} frames; launches {got}")
    if plain_runs(got) or (algo == "ppm" and got["merge"] == 0):
        raise AssertionError(f"{label} {algo}: a plain version ran or the "
                             f"merge kernel did not")
    return film_mean(r, f"{label} {algo}")


def other_algorithms(scene, meta, card):
    """bpt, ppm, lt and vcm_pt on the card (phase 7c), each held against
    PT's mean.  Light tracing has no camera paths, so it cannot render
    what the camera sees of an emitter directly, nor anything seen through
    a mirror or glass (a pinhole camera is never hit): on the still life
    it runs and is reported, and it is held against PT less the directly
    seen emission on the still life without the specular kinds, over
    LT_FRAMES frames (its sun-lit light paths are noisy: ~18% standard
    error on a mean of 32k paths, measured on the CPU)."""
    from imbatracer_torch.scene.procedural import make_still_life_like

    w, h = FAMILY_SIZE
    pt_mean = run_family(scene, meta, "still_life", "pt")
    for algo in ("bpt", "ppm", "vcm_pt"):
        check_mean(f"still_life {w}x{h} {algo}",
                   run_family(scene, meta, "still_life", algo), pt_mean,
                   card)
    lt = run_family(scene, meta, "still_life", "lt")
    direct = direct_emission_mean(scene, meta, w, h, VCM_FRAMES)
    log(f"[family] still_life {w}x{h} lt: film mean {lt:.6f} a frame, PT "
        f"less the directly seen emission {pt_mean - direct:.6f}: "
        f"{100.0 * (lt / (pt_mean - direct) - 1):+.2f}% (no paths through "
        f"mirrors and glass) [{card}]")
    diffuse, dmeta = make_still_life_like(specular_share=False,
                                          device=scene.device)
    label = "still_life (diffuse)"
    direct = direct_emission_mean(diffuse, dmeta, w, h, LT_FRAMES)
    check_mean(f"{label} {w}x{h} lt (PT less the directly seen emission)",
               run_family(diffuse, dmeta, label, "lt", LT_FRAMES),
               run_family(diffuse, dmeta, label, "pt", LT_FRAMES) - direct,
               card)


def vcm_film_parity(dev, label, builder, algo):
    from imbatracer_torch.frontend.engine import make_frame_fn
    from imbatracer_torch.frontend.renderer import RenderSettings

    films = {}
    for where in (dev, "cpu"):
        scene, meta = builder(device=where)
        settings = RenderSettings(width=64, height=64, spp=4, max_path_len=8,
                                  algorithm=algo)
        films[str(where)] = make_frame_fn(scene, meta, settings)[0](5) \
            .cpu().numpy()
    g, c = films[str(dev)], films["cpu"]
    mean_rel = abs(float(g.mean()) - float(c.mean())) / float(c.mean())
    rel = np.abs(g - c) / np.maximum(np.abs(c), 1e-3)
    within = float((rel.max(axis=-1) <= 1e-3).mean())
    log(f"[film] {label} {algo} 64x64 spp 4 max_len 8, card vs CPU: mean "
        f"rel diff {mean_rel:.3e}, pixels within 1e-3: {within:.4f}, exact "
        f"pixels: {float((g == c).all(axis=-1).mean()):.4f}")
    if not (mean_rel <= 0.01 and within >= 0.95):
        raise AssertionError(f"{label} {algo}: card and CPU films disagree")


def log_time(what, timed, plain_ms, card):
    ms, wrapper_ms, (bound_ms, bound_by, detail) = timed
    log(f"[time] {what} [{card}]: kernel {ms:.3f} ms (wrapper with its "
        f"candidate lists {wrapper_ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.4f} ms by {bound_by}, {detail})")


def kernel_entry(name, source, replaces, launches, err, timed, plain_ms):
    ms, _, (bound_ms, bound_by, _) = timed
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    from imbatracer_torch import libbuild
    from imbatracer_torch.accel import native
    from imbatracer_torch.device import get_device
    from imbatracer_torch.ops import khit as kh
    from imbatracer_torch.ops import merge as mg
    from imbatracer_torch.ops import stream_traverse as st
    from imbatracer_torch.scene.procedural import (make_big_scene,
                                                   make_cornell_scene,
                                                   make_leaf_scene,
                                                   make_masked_scene,
                                                   make_still_life_like)
    from imbatracer_torch.utils.metrics import load_reference_png, psnr

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = get_device("cuda")
    card = card_line()
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    t_start = time.time()

    t0 = time.time()
    libs = (st.LIB, kh.LIB, mg.LIB, native.LIB)
    paths = libbuild.build_all(libs)
    st._library()
    kh._library()
    mg._library()
    log(f"[build] {len(paths)} libraries in {time.time() - t0:.1f} s: "
        + ", ".join(os.path.relpath(p) for p in paths))
    for lib in libs:
        info = libbuild.BUILD_INFO.get(lib.name, {})
        log(f"[build] {lib.source}: {info.get('seconds', 0.0):.1f} s")
        for line in libbuild.ptxas_lines(lib.name):
            log(f"[build]   {line}")

    t0 = time.time()
    scenes = {
        "cornell": make_cornell_scene(device=dev),
        "big_150": make_big_scene(150, device=dev),
        "big_4000": make_big_scene(4000, device=dev),
        "leaf_6000": make_leaf_scene(6000, device=dev),
        "still_life": make_still_life_like(device=dev),
    }
    log(f"[scenes] built in {time.time() - t0:.1f} s: " + ", ".join(
        f"{k} {m.num_tris} tris S={s.bvh.sbox.shape[0]}"
        for k, (s, m) in scenes.items()))

    stats = {}
    for label in ("cornell", "big_150", "big_4000"):
        compare(*scenes[label], label, dev, st, stats)
    for label in ("big_150", "big_4000"):
        num_s = scenes[label][0].bvh.sbox.shape[0]
        for key in ("closest", "any"):
            log_time(f"stream kernel {key}, {label} (S={num_s}), {NUM_RAYS} "
                     f"sorted bounce rays", stats[label, key],
                     stats[label, f"{key}_plain_ms"], card)
    for label in ("leaf_6000", "still_life", "cornell"):
        compare_khit(*scenes[label], label, dev, st, kh, stats)
    log_time(f"khit kernel, S={scenes['still_life'][0].bvh.sbox.shape[0]}, "
             f"{NUM_RAYS} sorted still-life bounce rays", stats["khit"],
             stats["khit_plain_ms"], card)

    stream_launches = {"closest_hit": 0, "any_hit": 0}
    for label, max_len in (("big_4000", 6), ("cornell", 10)):
        _, got, _, _ = main_path(*scenes[label], label, 1024, 1024, max_len,
                                 MAIN_FRAMES, card)
        log(f"[main] {label} launches over the timed frames: {got}")
        if (got["closest_hit"] == 0 or got["any_hit"] == 0
                or got["stream_plain"] or got["khit_plain"]):
            raise AssertionError(f"{label}: the main path did not run "
                                 f"through the stream kernel")
        for k in stream_launches:
            stream_launches[k] += got[k]

    renderer, sl_got, sl_ms, sl_mrays = main_path(
        *scenes["still_life"], "still_life", 1920, 1080, 8,
        STILL_LIFE_FRAMES, card, warmup_reset=True)
    busy = max(sl_got["dispatches"] - sl_got["empty"], 1)
    log(f"[main] still_life launches over the timed frames: {sl_got}; khit "
        f"rounds per non-empty masked dispatch: "
        f"{sl_got['rounds'] / busy:.4f}")
    if sl_got["khit"] == 0 or sl_got["stream_plain"] or sl_got["khit_plain"]:
        raise AssertionError("still_life: the main path did not run through "
                             "the khit kernel")
    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "goldens", "still_life_1080p_len8.png")
    p = psnr(renderer.image(), load_reference_png(golden))
    log(f"[main] still_life PSNR after {renderer.frames} frames vs "
        f"{os.path.basename(golden)}: {p:.3f} dB (JAX renderer "
        f"{STILL_LIFE_PSNR} dB; {sl_ms:.1f} ms/frame, {sl_mrays:.2f} "
        f"Mrays/s) [{card}]")
    if not abs(p - STILL_LIFE_PSNR) <= PSNR_TOL:
        raise AssertionError(f"still_life PSNR {p:.3f} dB is not within "
                             f"{PSNR_TOL} dB of {STILL_LIFE_PSNR} dB")
    profile_frame(renderer, "still_life 1920x1080 max_len 8", card)

    film_parity(dev, "cornell", make_cornell_scene, False)
    film_parity(dev, "masked", make_masked_scene, True)

    # The VCM family (phase 7).
    for ppm in (False, True):
        compare_merge("random", *random_merge_case(dev, 11), (0, 3, 4, 5),
                      ppm, stats)
    vcm_renderer, merge_launches = vcm_main_path(*scenes["still_life"],
                                                 card, stats)
    ms, wrapper_ms, (bound_ms, bound_by, detail) = stats["merge"]
    log(f"[time] merge kernel, {stats['merge_label']} queries "
        f"[{card}]: kernel {ms:.3f} ms (merge_contrib with the query "
        f"preparation {wrapper_ms:.3f} ms, plain {stats['merge_plain_ms']:.3f}"
        f" ms, bound {bound_ms:.4f} ms by {bound_by}, {detail})")
    profile_frame(vcm_renderer, "still_life vcm 1920x1080 max_len 8", card)
    del vcm_renderer
    other_algorithms(*scenes["still_life"], card)
    vcm_film_parity(dev, "cornell", make_cornell_scene, "vcm")
    vcm_film_parity(dev, "cornell", make_cornell_scene, "ppm")
    vcm_film_parity(dev, "masked", make_masked_scene, "vcm")

    src = "imbatracer_torch/csrc/"
    kernels = [
        kernel_entry("stream_traverse_closest_hit",
                     src + "stream_traverse.cu", REPLACES["stream"],
                     stream_launches["closest_hit"], stats["closest_err"],
                     stats["big_4000", "closest"],
                     stats["big_4000", "closest_plain_ms"]),
        kernel_entry("stream_traverse_any_hit", src + "stream_traverse.cu",
                     REPLACES["stream"], stream_launches["any_hit"],
                     stats["any_err"], stats["big_4000", "any"],
                     stats["big_4000", "any_plain_ms"]),
        kernel_entry("khit_closest_k4", src + "khit_traverse.cu",
                     REPLACES["khit"], sl_got["khit"], stats["khit_err"],
                     stats["khit"], stats["khit_plain_ms"]),
        kernel_entry("merge_contrib", src + "merge_kernel.cu",
                     REPLACES["merge"], merge_launches, stats["merge_err"],
                     stats["merge"], stats["merge_plain_ms"]),
    ]
    log(f"[done] {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
