#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (imbatracer_torch) on one GPU.

Run from the repository root: `python3 chip_smoke.py`.  Phases, in
order, each logging its start as `[phase] <name> at <seconds> s`; any
failure raises and the script exits non-zero:

1. Device: require CUDA; print the card's name and power limit.
2. Build: compile csrc/stream_traverse.cu, csrc/khit_traverse.cu,
   csrc/merge_kernel.cu, csrc/pairs_kernel.cu (the pair route's
   candidates, queue, pair and resolve kernels) and csrc/graph_cond.cu
   (the WHILE conditional nodes of render/graphs.py) with nvcc and
   csrc/bvh_builder.cpp with g++, all at once, into
   build/imbatracer_torch/; print each kernel entry's ptxas register,
   static shared-memory and spill lines.
3. Stream kernel vs plain: 262,144 rays (camera rays, and bounce-like
   random rays with ~80% of lanes active) on the procedural cornell
   (S=1 super-chunk), make_big_scene(150) (S=3) and make_big_scene(4000)
   (S=68), closest hit and any hit, the CUDA kernel against its plain
   PyTorch version on the same tensors.  Tolerances: hit ids equal
   except where both hits have bit-equal t (ties); t/u/v within
   1e-5 * max(1, |x|) (both are built to round alike, so 0 is expected);
   any-hit flags may differ on at most 1e-4 of the rays.  Times both at
   the main-path shape (262,144 sorted bounce rays, S=68), and at S=3 (a
   scene the JAX package would send to its VMEM kernel): `ms` is the one
   launch a dispatch makes, its candidate stage included (each 128-ray
   block builds its list on the card), and the stage is also timed alone
   (imba_block_candidates); then runs the kernel's counting instantiation
   on the same rays, which must return the same rows, for the work behind
   the bound, and prints the kernel's registers, shared memory, spills
   and resident blocks an SM.  Before the timings, `[cand]` lines hold
   the card's candidate stage against its plain version
   (superchunk_candidates) on big_4000, the still life and (phase 8a) the
   instanced scene, camera and bounce rays, closest- and any-hit bounds:
   counts, lists and keys up to each count must be equal bit for bit (a
   -0 key counts as +0), with 0 mismatches.  `[cap]` lines: card_grid's
   17,161 super-chunks, above the 16,384 a block's shared-memory list
   holds, so each launch is a list launch into a global buffer and the
   walk: the flat stream kernel (closest and any hit), the instanced one
   and khit, CAP_RAYS rays each, against their plain versions (the
   tolerances below), timed.
4. khit kernel vs plain: the same two ray sets, closest-hit bounds
   (tmin 1e-3, tmax 1e30), on make_leaf_scene(6000), make_still_life_like()
   (S=140) and the cornell (S=1).  The K=4 t vectors must agree to
   1e-5 * max(1, |t|) (0 expected) with the same hits present; ids equal
   except between hits of bit-equal t (including a tie between the K-th
   hit and the next one, which either version may keep).  Times both on
   the still-life bounce rays (`ms` the one launch with its candidate
   stage), and counts the kernel's work, as in 3.
5. Main paths, each with every launch counter set to 0 just before its
   timed frames and read just after them: (a) make_frame_fn +
   ProgressiveRenderer.step() for 3 frames of make_big_scene(4000) at
   1024^2, spp 1, max_len 6, and (b) of the cornell at 1024^2, max_len
   10 -- both stream-kernel entry points must have launched, no plain
   version (superchunk_candidates, the plain candidate stage, included;
   so in every phase below) may have run; (c) the
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
   tallies equal to the plain version's; on the recorded queries also the
   query preparation kernels against prepare_queries (rows and
   permutation bit for bit); the kernel timed alone (queries prepared
   beforehand), in merge_contrib (printed beside the same function with
   torch glue, TORCH_GLUE_MS) and the preparation alone, the plain
   versions over 2-3 calls.  (c) bpt, ppm and vcm_pt on the still life at 480x270,
   max_len 8, 2 frames each: finite, non-zero, mean within 5% of PT's.
   lt there too (finite, non-zero, reported); light tracing cannot see
   emitters directly nor through mirrors and glass, so it is held, over
   64 frames, against PT less the directly seen emission on the still
   life without the specular kinds.
   (d) Card vs CPU films of vcm and ppm on the cornell and vcm on the
   masked scene, 64^2, spp 4, max_len 8, held as in 6.
8. The `.scene` / OBJ slice with two-level instancing, on the scene
   scene/generate.CARD writes into a temporary directory (BASELINE
   config 5: ~940k flat triangles from ~38k unique in 341 instances of 6
   meshes, ~1,400 super-chunks, area panels and an RLE HDR sky, every MTL
   path).  (a) The instanced stream kernel against its plain version on
   the two ray sets of phase 3 (same tolerances), timed and counted; the
   pair route, flat (make_big_scene(4000), S = 68) and instanced, closest
   and any hit, on the card: `[pcand]` lines, the candidates kernel
   against ray_candidates (0 mismatches); the card's queue against
   build_queue and segment_table; the pair kernel against its plain
   version on that queue; the resolve kernel against resolve; and the
   route with its saturation fallback against the stream kernel (exact;
   the number of rays the fallback re-traced is printed, and must be
   positive on the instanced scene); timed alone, as a route (printed
   beside the route with torch glue and the stream kernel's launch) and
   plain, and counted; the candidates, queue and resolve kernels timed at
   the instanced scene's S.  (b) The main path: `python -m
   imbatracer_torch <scene> <out.png> -a vcm -w 1920 -h2 1080 -s 1` run
   in this process (the perf line and the PNG), then make_frame_fn +
   ProgressiveRenderer, vcm at 1920x1080 with the default light paths, a
   warm-up frame, reset(), 2 timed frames with the counters zeroed just
   before and read just after: both instanced stream kernels and the
   merge kernel must have launched, khit and every plain version not;
   film finite with its mean within 5% of PT's over the same frames; one
   traced frame.  (c) PT through the pair queue (the BVH's pairs switch
   on) on the instanced scene at 1920x1080 and on big_4000 at 1024^2,
   the same frames as the stream route, whose ms/frame is printed beside:
   the pair route's kernels must launch and the images agree to
   PSNR_MIN.  (d) PT at 512^2 on the two-level and the
   flattened build of the scene (the flattened one masked through khit):
   images within PSNR_MIN, no graphed frame rendered again.
10. Split BVH, cache and interactive (after phase 8, before the output).
   (a) make_still_life_like()'s arrays through assemble_device_scene(...,
   spatial=True) (the function itself is unchanged): the native split
   build's seconds beside the binned build's, references over triangles,
   S, tile MB and sah_cost against the binned build's; on phase 4's
   262,144 still-life bounce rays, the same rays on both builds: khit and
   the stream kernel (closest and any) against their plain versions at
   phase 3/4's tolerances, 0 repeated ids in any khit row (kernel and
   plain), and khit's rows equal to the binned build's (t, and u and v
   where the ids agree, bit for bit; ids only differing on bit-equal-t
   ties); each kernel timed at both builds (CUDA events, 10 launches).
   (b) The main path over the split build: PT at 1920x1080, spp 1,
   max_len 8, a warm-up frame, reset(), 8 frames (counters zeroed just
   before, read just after; khit must launch, no plain version run):
   PSNR against goldens/still_life_1080p_len8.png within PSNR_TOL of
   17.16 dB, and at least PSNR_MIN against phase 5's binned image of the
   same frames; ms/frame beside phase 5's.  (c) A flat scene written by
   scene/generate.write_instanced_scene at CARD's mesh sizes, one
   instance of each mesh (38,244 triangles, below the two-level rule):
   `python -m imbatracer_torch <scene> out.png --sbvh -a pt -s 2` twice
   in a fresh cache directory; the first run builds the split BVH and
   writes the cache, the second loads it; the two PNGs must be equal
   byte for byte (else held to phase 6's tolerance on the 8-bit images,
   and the line says which held); both runs' scene-build seconds.  (d)
   `python -m imbatracer_torch <scene> out.png --interactive -a pt -w 640
   -h2 360` with stdin, stdout and stderr on a pseudo-terminal, under a
   time limit: once it has redrawn, the keys w, j, p and x with pauses;
   it must exit 0 after drawing half-block rows, its spp count must fall
   back after the move, and out.png must exist and not be black.
11. Multi-rank (parallel/, after phase 10, before the output): two cells
   at 1920x1080, spp 1, max_len 8, each through make_frame_fn with a
   Comm and without one on the same card: the still-life PT, a warm-up
   frame then frames 0 and 1, and the instanced vcm of phase 8 (default
   light paths), a warm-up frame then frame 0; launch counters and the
   Comm's counts set to 0 just before the timed frames and read just
   after (khit must launch on the PT cell, both instanced stream kernels
   and the merge kernel on the vcm cell, no plain version on either).
   The sharded PT films must equal the unsharded ones bit for bit on at
   least 99.99% of pixels (a difference can only come from an exact-t
   tie that another block composition resolves otherwise), the vcm
   film's mean within 1e-6 relative and at least 99.9% of its pixels
   within 1e-5 relative (of max(|x|, 1e-3)): the light splat's
   index_add_ adds with atomics on the card.  (a) NCCL at world size 1
   in this process, with ms/frame for both routes and the collectives'
   count, bytes and ms a frame (CUDA events).  (b) Two ranks sharing the
   card over gloo, spawned through parallel/launch.py: the same checks
   on rank 0's films (rank 1's equal to rank 0's bit for bit), its
   ms/frame a correctness run, not a scaling number.  (c) One NCCL rank
   a card when the machine has two or more, with the speed-up over (a);
   with one card a line says that it did not run and why.  (d) The CLI's
   rank function (`python -m imbatracer_torch <instances.scene> out.png
   -a pt -w 512 -h2 512 -s 2`) on two ranks over gloo on the card,
   against the one-process CLI: the PNGs equal byte for byte, or else
   at least 99.99% of pixels equal in the 8-bit images (the line says
   which held).
12. Compaction (after phase 11, before the output): still_life PT at
   1920x1080 (max_len 8), cornell (max_len 10) and big_4000 (max_len 6)
   PT at 1024^2, still_life vcm (VCM_LPC light paths) and the instanced
   vcm of phase 8 (written and built again) at 1920x1080 (max_len 8),
   each through the integrators with make_frame_fn's arguments: the
   default route, which must have compacted, and the banded one
   (compact=False), a warm-up frame of each, then COMPACT_CELLS' frames
   of both interleaved at the same frame numbers, each with the launch
   counters and the peak memory set just before it and read just after.
   Per cell: the share of lanes alive after the phase-1 bounces, the
   phase-2 bands and the band-bounces a frame, the stream, 1b, khit and
   merge launches a frame, ms/frame of both routes, the peak memory,
   and the traced rays a frame (PT: closest hit + shadow; vcm: those of
   the camera pass); PT films must be bit-equal on >= 99.99% of pixels,
   vcm film means within 1e-6 relative, traced rays within 1e-4
   relative, no plain version run.  Every earlier phase runs the
   default route, compacted wherever a frame has more than one band.
13. CUDA graphs (after phase 12, before the output): still_life PT and
   still_life over the split build (phase 10's) at 1920x1080 (max_len
   8), cornell (max_len 10) and big_4000 (max_len 6) PT at 1024^2, and
   the instanced PT of phase 8 (written and built again) at 1920x1080
   (max_len 8), each through render_pt_frame with make_frame_fn's
   arguments: the default route, which must replay one captured bounce
   a band-bounce (render/graphs.py), and graph=False, a warm-up frame of
   each (the capture), then GRAPH_FRAMES frames of both interleaved at
   the same frame numbers, each with the launch counters and the peak
   memory set just before it and read just after.  Per cell: ms/frame
   of both routes; captures, replays and reruns a frame; the stream,
   1b and khit launches a frame; peak memory; then one traced frame of
   each route (torch.profiler: wall, device busy, idle share, kernels,
   and the host's cudaLaunchKernel and cudaGraphLaunch calls).  Films
   must be bit-equal on >= 99.99% of pixels, traced rays equal, no
   plain version run, no frame rendered again.  On the masked cells
   (hold_rounds): the rounds a non-empty masked dispatch ran, mean and
   most, graphed (from the device counts of render/graphs.py) and eager,
   against the cap (render/traverse.py's KHIT_MAX_ROUNDS or
   RETRACE_MAX_ROUNDS); the most lanes one dispatch carried past its
   first round (what the slot shares are chosen from); the traversal
   launches a frame of both routes, the graphed ones held to the eager
   ones plus at most one first round for each empty dispatch; lanes past
   the slots and at the cap (both must be 0); the warm-up frame's
   captures, their seconds and the graph pool's and the conditional
   bodies' pools' MiB.  On the flat and two-level masked cells, frame 1
   replayed with the cap at one round (every loop's body skipped) and as
   run, each from graphs of its own, timed over COST_FRAMES frames: the
   loops' cost a frame against the graphed frame's device busy time.
14. VCM graphs (after phase 13, before the output): still_life vcm
   (VCM_LPC light paths) and the instanced vcm of phase 8 (default light
   paths, written and built again) at 1920x1080, and bpt, ppm, lt and
   vcm_pt on the still life at 480x270, max_len 8, each through
   render_vcm_frame with make_frame_fn's arguments: the default route,
   which must replay captured light bands and camera phases
   (render/integrators/vcm.py over render/graphs.py), and graph=False, a
   warm-up frame of each (the captures), then GRAPH_FRAMES frames of
   both at 1080p, one at 480x270, interleaved at the same frame numbers,
   each with the launch counters and the peak memory set just before it
   and read just after.  Per cell: ms/frame of both routes; captures,
   replays and reruns a frame; the stream, 1b, khit, merge and
   preparation launches a frame; peak memory; on the 1080p cells one
   traced frame of each route (wall, device busy, idle share, kernels,
   cudaLaunchKernel and cudaGraphLaunch calls); the re-trace's rounds,
   launches and captures as in phase 13 (hold_rounds).  Film means must
   agree within 1e-6 relative and >= 99.9% of pixels within 1e-5
   relative (the light splat adds with atomics), traced rays equal, no
   rerun, no plain version run.
   Every earlier phase runs the default route, graphed wherever it is a
   frame on the card (the pairs switch's frames of phase 8c, and phase
   7a's warm-up frame that records merge queries, eager by rule; phase
   7a runs one more warm-up frame for the captures).
15. Entry points (after phase 14, before the output), each part with the
   launch counters and graph counts zeroed just before it and read just
   after, its files under results/phase15/.  (a) imbatracer_torch.
   bench.main() in this process, stdout captured: its last line must be
   {"metric": "pt_megastep_throughput_cornell_1024", "value" > 0, "unit":
   "Mrays/s", "card"} with no vs_baseline, both secondaries (big_4000
   and the still life, ms/frame) written with values > 0, the stream and
   khit kernels launched, no plain version run and no frame rendered
   again; the headline printed beside phase 5b's cornell Mrays/s and the
   still life beside phase 5c's ms/frame, not compared.  (b)
   tools.run_bench.run_one on config 2 (still_life_pt_1080p) in curve
   mode, a sample every frame, CURVE_SECONDS: its PSNR against
   goldens/still_life_1080p_len8.png at frames 1-21 within PSNR_TOL of the
   JAX renderer's tracked curve (results/curves_r5/
   curve_still_life_pt_1080p.csv, its frame and PSNR columns).  (c)
   run_bench.main() with --proxies on configs 1, 3, 4 and 5 (config 5 on
   gen:card), PROXY_SECONDS each: every row without an error, config 4
   launching the merge kernel and config 5 the instanced stream and
   merge kernels, no plain version run, no frame rendered again (the
   counters' and the row's graph_reruns both 0).  (d)
   --selfcheck-instances at 512^2 on gen:card, PROXY_SECONDS: the gate
   must be PASS (PSNR >= 40 dB between the two-level and the flattened
   route), with no frame rendered again.  A frame rendered again fails
   its phase (8d, 13, 14, 15c, 15d) with its lanes past the gathered
   slots and past the cap of the rounds.
9. Output: the kernels' JSON line (`ms` the kernel alone: for the stream
   and khit kernels the one launch with its candidate stage; `bound_ms`
   the larger of its bytes over 3.35 TB/s and the float32 instructions
   its counting launch tallied over 33.5e12/s, the candidate stage's slab
   tests included and padding chunks, which the kernels skip, not, see
   bound(), pair_bound(), pair_candidates_bound() and merge_bound();
   `route_ms` on the pair and merge entries: the route, merge_contrib;
   `split_ms` and `split_launches` on the khit and stream entries: the
   kernel at the split build, phase 10a, and its launches on phase 10b's
   main path), the card's name and power limit, and last the {"ok":
   true, "device": ...} line.  Every kernel must have launched on a main
   path.

The script keeps its BVH disk cache (io/bvh_cache.py) in a temporary
directory of its own, removed at the end.
"""

import contextlib
import csv
import dataclasses
import faulthandler
import io
import json
import os
import pty
import re
import select
import shutil
import subprocess
import sys
import tempfile
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
    "stream_inst": "imbatracer_tpu/ops/pallas_stream.py:345 "
                   "(_make_kernel(occl, instanced=True), via _stream_call "
                   ":553)",
    "pairs": "imbatracer_tpu/ops/pallas_pairs.py:235 (_make_span_kernel, "
             "via _pairs_call :372)",
    "pair_candidates": "imbatracer_tpu/ops/pallas_pairs.py:98 (ray_candidates"
                       ", around pallas_call :397)",
    "pair_queue": "imbatracer_tpu/ops/pallas_pairs.py:200 (build_queue, "
                  "around pallas_call :397)",
    "pair_resolve": "imbatracer_tpu/ops/pallas_pairs.py:421 (_resolve_closest"
                    " and the fallback test, around pallas_call :397)",
    "merge_prep": "imbatracer_tpu/ops/pallas_merge.py:497 (merge_contrib's "
                  "query preparation, around pallas_call :469)",
}
# The same functions when their glue was torch ops (the route's candidates,
# queue and resolve; merge_contrib's query preparation and un-permutation),
# measured by this script on an NVIDIA H100 80GB HBM3 at 700 W on the same
# inputs: the route on 262,144 sorted bounce rays, merge_contrib on the
# still life's busiest band.
TORCH_GLUE_MS = {("big_4000", "closest"): 13.940, ("big_4000", "any"): 14.713,
                 ("instanced", "closest"): 65.831,
                 ("instanced", "any"): 74.949, "merge_contrib": 3.605}
VCM_LPC = 1 << 20             # light paths a frame: BASELINE's 1M photons/iter
VCM_FRAMES = 2
FAMILY_SIZE = (480, 270)
MEAN_TOL = 0.05               # family film mean vs PT's
LT_FRAMES = 64
INST_SIZE = (1920, 1080)      # the instanced slice's main path
INST_FRAMES = 2
FLAT_SIZE = (512, 512)        # two-level vs flattened
PSNR_MIN = 40.0               # pairs vs stream, two-level vs flattened
CLI_SAMPLES = 1
INTERACTIVE_SIZE = (640, 360)  # phase 10d
SUBPROCESS_LIMIT = 300         # seconds a CLI run of phase 10 may take
ROOT = os.path.dirname(os.path.abspath(__file__))
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


_START = time.time()

# Phase 3's `[cap]` line: a grid of CAP_SIDE^2 = 17,161 cards, one
# super-chunk each, above the 16,384 a block's shared-memory list holds.
CAP_SIDE = 131
CAP_RAYS = 1 << 14


def card_grid(side=CAP_SIDE):
    """(mesh, instances) for accel/instancing.build_two_level: side^2
    instances of one 2-triangle card (a 0.8-wide square in the xz plane)
    on a unit grid, each turned about y and lifted a little.  Each
    instance is one super-chunk."""
    from imbatracer_torch.core.math3d import instance_matrix

    v0 = np.asarray([[-0.4, 0, -0.4], [-0.4, 0, -0.4]], np.float32)
    v1 = np.asarray([[0.4, 0, -0.4], [0.4, 0, 0.4]], np.float32)
    v2 = np.asarray([[0.4, 0, 0.4], [-0.4, 0, 0.4]], np.float32)
    insts = []
    for i in range(side):
        for j in range(side):
            insts.append(dict(mesh_idx=0, face_base=2 * len(insts),
                              matrix=instance_matrix(
                                  (i - side / 2, 0.1 * ((7 * i + 3 * j) % 5),
                                   j - side / 2), (1.0, 1.0, 1.0),
                                  (0.0, float((13 * i + 7 * j) % 90), 0.0))))
    return (v0, v1, v2), insts


def wide_flat_bvh(mesh, insts, device):
    """(sbox (S, 8), tiles (S, 24, 1024)) of a flat BVH with one
    super-chunk per instance of `card_grid`: its two triangles in world
    space in slots 0-1 of chunk 0, the other 63 chunks padding (inverted
    boxes, id -1); the layout of stream_traverse.pack_stream_tiles, not
    recentred.  Built on `device` (1.7 GB at CAP_SIDE)."""
    m = np.stack([np.asarray(x["matrix"], np.float64) for x in insts])
    world = [torch.as_tensor(
        (np.einsum("sij,vj->svi", m[:, :3, :3], a.astype(np.float64))
         + m[:, None, :3, 3]).astype(np.float32), device=device)
        for a in mesh]                                     # (S, 2, 3) each
    v0, e1, e2 = world[0], world[1] - world[0], world[2] - world[0]
    num_s = v0.shape[0]
    tiles = torch.zeros((num_s, 24, 1024), dtype=torch.float32,
                        device=device)
    cols = lambda x: x.permute(0, 2, 1)                    # (S, 3, 2)
    n = torch.linalg.cross(e1, e2)
    tiles[:, 0:3, :2] = cols(n)
    tiles[:, 3, :2] = (v0 * n).sum(-1)
    tiles[:, 4:6, :] = -1.0
    tiles[:, 4, :2] = torch.arange(2 * num_s, device=device).view(
        num_s, 2).to(torch.float32)
    tiles[:, 8:11, :2] = cols(torch.linalg.cross(v0, e2))
    tiles[:, 11:14, :2] = cols(e2)
    tiles[:, 16:19, :2] = cols(torch.linalg.cross(e1, v0))
    tiles[:, 19:22, :2] = cols(-e1)
    lo = torch.minimum(torch.minimum(world[0], world[1]), world[2]).amin(1)
    hi = torch.maximum(torch.maximum(world[0], world[1]), world[2]).amax(1)
    for r, row in enumerate((6, 7, 14, 15, 22, 23)):
        tiles[:, row, 1:64] = 1e30 if r < 3 else -1e30
        tiles[:, row, 0] = (lo if r < 3 else hi)[:, r % 3]
    sbox = torch.cat([lo, hi, torch.zeros((num_s, 2), device=device)], 1)
    return sbox.contiguous(), tiles


def card_grid_rays(num, seed, side=CAP_SIDE, bounded=False):
    """(num, 8) ray rows from above `card_grid`'s cards, aimed down with a
    tilt: each enters a few card boxes.  `bounded`: tmax 0.5-6 (any hit),
    else 1e30."""
    from imbatracer_torch.ops import stream_traverse as st

    rs = np.random.RandomState(seed)
    half = side / 2 - 1
    org = np.stack([rs.uniform(-half, half, num), rs.uniform(1.0, 4.0, num),
                    rs.uniform(-half, half, num)], 1)
    d = np.stack([rs.uniform(-0.4, 0.4, num), -np.ones(num),
                  rs.uniform(-0.4, 0.4, num)], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = rs.uniform(0.5, 6.0, num) if bounded else st.BIG
    rays, _ = st.rays8(torch.as_tensor(org, dtype=torch.float32),
                       torch.as_tensor(d, dtype=torch.float32), 1e-3,
                       torch.as_tensor(tmax, dtype=torch.float32),
                       torch.as_tensor(rs.rand(num) < 0.9))
    return rays


def log(msg):
    print(msg, flush=True)


def phase(what):
    """Log the start of a phase with the seconds since the script began."""
    log(f"[phase] {what} at {time.time() - _START:.1f} s")


def cuda_ms(fn, reps, warm=True):
    """Mean device time of fn() over reps calls (CUDA events), after one
    warm-up call unless `warm` is False (fn ran just before)."""
    if warm:
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
    from imbatracer_torch.ops import pairs as pm
    from imbatracer_torch.ops import stream_traverse as st
    from imbatracer_torch.render import graphs
    from imbatracer_torch.render import traverse as tt

    st.reset_launches()
    kh.reset_launches()
    mg.reset_launches()
    pm.reset_launches()
    graphs.reset_stats()
    for k in tt.MASK_STATS:
        tt.MASK_STATS[k] = 0


def counters():
    from imbatracer_torch.ops import khit as kh
    from imbatracer_torch.ops import merge as mg
    from imbatracer_torch.ops import pairs as pm
    from imbatracer_torch.ops import stream_traverse as st
    from imbatracer_torch.render import graphs
    from imbatracer_torch.render import traverse as tt

    got = {k: v for k, v in st.LAUNCHES.items() if k not in st.PLAIN_KEYS}
    got.update({f"pairs_{k}": v for k, v in pm.LAUNCHES.items()
                if k not in pm.PLAIN_KEYS})
    return dict(got, stream_plain=st.LAUNCHES["plain"],
                candidates_plain=st.LAUNCHES["candidates_plain"],
                khit=kh.LAUNCHES["khit"], khit_plain=kh.LAUNCHES["plain"],
                merge=mg.LAUNCHES["merge"], merge_prep=mg.LAUNCHES["prep"],
                merge_plain=sum(mg.LAUNCHES[k] for k in mg.PLAIN_KEYS),
                pairs_plain=sum(pm.LAUNCHES[k] for k in pm.PLAIN_KEYS),
                fallback_dispatches=pm.FALLBACK["dispatches"],
                fallback_rays=pm.FALLBACK["rays"], **tt.MASK_STATS,
                **{f"graph_{k}": v for k, v in graphs.GRAPH_STATS.items()})


def plain_runs(got):
    """Calls of any plain version (stream, candidate stage, khit, the
    merge and its preparation, every step of the pair route)."""
    return (got["stream_plain"] + got["candidates_plain"] + got["khit_plain"]
            + got["merge_plain"] + got["pairs_plain"])


def bound(rays, sbox, tiles, out_cols, work, insert_ops=0, inst=None):
    """(bound_ms, bound_by, detail): the least time one H100 could take
    for a traversal kernel's work on these rays -- the larger of the
    bytes (the row of each active ray and the tmax word that marks each
    inactive one, sbox and tiles read once, the instancing metadata
    `inst` read once, rows out) over the HBM rate and the float32
    instructions the kernel issued over the float32 instruction rate.
    `work` holds the tallies of the kernel's counting launch on these
    rays (stream_traverse.WORK_SLOTS): the candidate stage's slab tests
    and the walk's (super-chunk and non-padding chunk boxes; padding
    chunks, which the kernels skip, are work these inputs do not need)
    costed with SLAB_OPS, the first-pass Moller-Trumbore stages with
    MT_STAGE_OPS, plus `insert_ops` per hit.  The walk's second looks
    (the design's own: each repeats a test counted above) and an
    instanced kernel's ray transforms (~54 instructions per super-chunk
    entered, before its chunk tests of 25 each) are not counted."""
    from imbatracer_torch.ops import stream_traverse as st

    w = dict(zip(st.WORK_SLOTS, work.tolist()))
    ops = ((w["slab"] + w["cand_slab"]) * SLAB_OPS
           + w["mt_hit"] * insert_ops
           + sum(w[k] * c for k, c in zip(st.WORK_SLOTS[1:], MT_STAGE_OPS)))
    meta = 0 if inst is None else sum(x.numel() for x in inst)
    active = int((rays[:, 7] >= 0.0).sum())
    ray_words = 8 * active + (rays.shape[0] - active)
    nbytes = 4 * (ray_words + sbox.numel() + tiles.numel() + meta
                  + rays.shape[0] * out_cols)
    t_ops, t_bytes = ops / FP32_INSTR_PER_S, nbytes / HBM_BYTES_PER_S
    detail = dict(w, ops=ops, bytes=nbytes)
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", detail)


def time_kernel(launch, rays, sbox, tiles, out_cols, insert_ops=0,
                inst=None):
    """Time a CUDA wrapper on these rays: (ms of its one launch, the
    candidate stage included; ms of the candidate stage launched alone;
    bound).  The counting launch behind the bound must return what the
    renderer's launch returns."""
    from imbatracer_torch.ops import stream_traverse as st

    ms = cuda_ms(launch, 10)
    stage_ms = cuda_ms(lambda: st.candidates_cuda(rays, sbox), 10)
    work = torch.zeros(len(st.WORK_SLOTS), dtype=torch.int64,
                       device=rays.device)
    if not torch.equal(launch(work=work), launch()):
        raise AssertionError("the counting launch disagrees with the kernel")
    return ms, stage_ms, bound(rays, sbox, tiles, out_cols, work,
                               insert_ops, inst)


def compare_candidates(scene, meta, label, dev, st):
    """`[cand]`: the kernels' candidate stage (launched alone) against its
    plain version, superchunk_candidates, on the camera and bounce rays
    with closest-hit (tmax 1e30) and any-hit bounds: the number of blocks
    whose counts differ, and of list entries and keys (as bits, -0 as +0)
    that differ up to each block's count.  All must be 0."""
    sbox = scene.bvh.sbox
    for name, closest, anyr in ray_sets(scene, meta, dev, st):
        for key, rays in (("closest", closest), ("any", anyr)):
            ref = st.superchunk_candidates(rays, sbox)
            bad = st.candidate_mismatches(st.candidates_cuda(rays, sbox), ref)
            rc = ref[2]
            log(f"[cand] {label:<10} S={sbox.shape[0]:<5} {name:<7} {key:<7}"
                f" blocks={rc.shape[0]} candidates={int(rc.sum())} (mean "
                f"{float(rc.float().mean()):.2f}, max {int(rc.max())}) "
                f"count_mismatch={bad[0]} list_mismatch={bad[1]} "
                f"key_mismatch={bad[2]}")
            if any(bad):
                raise AssertionError(f"the card's candidate stage disagrees "
                                     f"with superchunk_candidates on "
                                     f"{label}/{name}/{key}")


def log_resources(what, res, card):
    log(f"[res] {what} [{card}]: {res['registers']} registers, "
        f"{res['static_smem']} B static + {res['dynamic_smem']} B dynamic "
        f"shared memory, {res['local_bytes']} B local (spills), "
        f"{res['blocks_per_sm']} resident blocks an SM")


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
    inst = scene.bvh.inst
    for name, closest, anyr in ray_sets(scene, meta, dev, st):
        k = st.traverse_cuda(closest, scene.bvh.sbox, scene.bvh.tiles, False,
                             inst=inst)
        p = st.traverse_plain(closest, scene.bvh.sbox, scene.bvh.tiles, False,
                              inst=inst)
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
        ka = st.traverse_cuda(anyr, scene.bvh.sbox, scene.bvh.tiles, True,
                              inst=inst)
        pa = st.traverse_plain(anyr, scene.bvh.sbox, scene.bvh.tiles, True,
                               inst=inst)
        flips = int((ka[:, 0] != pa[:, 0]).sum())
        occ = float(ka[:, 0].mean())
        log(f"[parity] {label:<12} S={scene.bvh.sbox.shape[0]:<3} {name:<7} "
            f"closest: hits={hits} id_mismatch={bad_id} ties={int(tie.sum())}"
            f" max_rel_err(t,u,v)={err:.3e} | any: occluded={occ:.4f} "
            f"flag_mismatch={flips}")
        if bad_id or err > 1e-5 or flips > 1e-4 * NUM_RAYS:
            raise AssertionError(f"kernel disagrees with the plain version "
                                 f"on {label}/{name}")
        tag = "" if inst is None else "_instanced"
        stats["closest_err" + tag] = max(stats.get("closest_err" + tag, 0.0),
                                         abs_err)
        stats["any_err" + tag] = max(stats.get("any_err" + tag, 0.0),
                                     float((ka[:, 0] - pa[:, 0]).abs().max()))
        if label in ("big_150", "big_4000", "instanced") and name == "bounce":
            for key, rays, occl in (("closest", closest, False),
                                    ("any", anyr, True)):
                args = (rays, scene.bvh.sbox, scene.bvh.tiles, occl)
                stats[label, key] = time_kernel(
                    partial(st.traverse_cuda, *args, inst=inst), *args[:3], 8,
                    inst=inst)
                reps = 1 if inst is not None else 2
                stats[label, f"{key}_plain_ms"] = cuda_ms(
                    lambda: st.traverse_plain(*args, inst=inst), reps,
                    warm=inst is None)


def hold_khit(k, p5, K):
    """K-nearest kernel rows `k` against the plain version's K + 1 nearest
    `p5`: (log text, max abs error of t/u/v, disagrees).  They agree when
    the same hits are present, t within 1e-5 relative (0 expected), ids
    equal except between hits of bit-equal t (two triangles at one t,
    taken in either order, including a tie between the K-th hit and the
    next one, which either version may keep), and u/v within 1e-5 where
    the ids agree."""
    p = p5[:, :8 * K]
    kt, pt_ = k[:, 0::8], p[:, 0::8]
    kid, pid = k[:, 3::8], p[:, 3::8]
    present = pid >= 0
    t5, present5 = p5[:, 0::8], p5[:, 3::8] >= 0
    tie = torch.zeros_like(present)
    for a in range(K):
        for b in range(K + 1):
            if a != b:
                tie[:, a] |= (t5[:, a] == t5[:, b]) & present5[:, b]
    bad_id = int((present & (kid != pid) & ~tie).sum())
    terr = t_abs = uv_err = 0.0
    if present.any():
        terr = float(((kt - pt_).abs() / torch.clamp(pt_.abs(), min=1.0))
                     [present].max())
        t_abs = float((kt - pt_).abs()[present].max())
    same = present & (kid == pid)
    if same.any():
        uv_err = max(float((k[:, f::8] - p[:, f::8]).abs()[same].max())
                     for f in (1, 2))
    per_slot = [int(present[:, s].sum()) for s in range(K)]
    text = (f"hits per slot {per_slot} id_mismatch={bad_id} ties="
            f"{int((present & (kid != pid)).sum())} max_rel_err(t)="
            f"{terr:.3e} max_abs_err(u,v)={uv_err:.3e}")
    bad = (not torch.equal(kid >= 0, present) or bad_id > 0 or terr > 1e-5
           or uv_err > 1e-5)
    return text, max(t_abs, uv_err), bad


def compare_cap(dev, st, kh, card):
    """Phase 3's `[cap]` lines: card_grid's 17,161 super-chunks, above the
    16,384 a block's shared-memory list holds, so each launch is a list
    launch into a global buffer and the walk: the flat stream kernel
    (closest and any hit) and khit on one super-chunk a card, and the
    instanced stream kernel on the two-level build, CAP_RAYS rays each,
    against their plain versions run on the card's tensors."""
    from imbatracer_torch.accel.device import DeviceBvh
    from imbatracer_torch.accel.instancing import build_two_level

    t0 = time.time()
    mesh, insts = card_grid()
    sbox, tiles = wide_flat_bvh(mesh, insts, dev)
    tl = build_two_level([mesh], insts)
    two = DeviceBvh.from_two_level(tl.sbox, tl.tiles, tl.tile_idx, tl.inst_of,
                                   tl.itab, device=dev)
    closest = card_grid_rays(CAP_RAYS, 3).to(dev)
    anyr = card_grid_rays(CAP_RAYS, 3, bounded=True).to(dev)
    num_s = sbox.shape[0]
    scratch = st.list_scratch_bytes(CAP_RAYS, num_s)
    log(f"[cap] S={num_s} (cap {st.MAX_SUPER}) built in "
        f"{time.time() - t0:.1f} s: flat tiles "
        f"{tiles.numel() * 4 / 2**20:.1f} MB; lists of {CAP_RAYS} rays in a "
        f"global buffer of {scratch} B")
    for what, rays, occl, inst in (
            ("stream closest", closest, False, None),
            ("stream any", anyr, True, None),
            ("stream closest instanced", closest, False, two.inst),
            ("stream any instanced", anyr, True, two.inst)):
        sb, tb = (sbox, tiles) if inst is None else (two.sbox, two.tiles)
        launch = partial(st.traverse_cuda, rays, sb, tb, occl, inst=inst)
        k = launch()
        p = st.traverse_plain(rays, sb, tb, occl, inst=inst)
        bad, rel, _ = hold_rows(k, p, occl)
        hits = int((p[:, 0] > 0.0).sum() if occl else (p[:, 3] >= 0.0).sum())
        ms = cuda_ms(launch, 3)
        log(f"[cap] S={num_s} {what:<24}: hits {hits}, mismatch={bad} "
            f"max_rel_err(t,u,v)={rel:.3e}; list launch + walk {ms:.3f} ms "
            f"[{card}]")
        if bad > (1e-4 * CAP_RAYS if occl else 0) or rel > 1e-5:
            raise AssertionError(f"[cap] {what}: the kernel disagrees with "
                                 f"the plain version")
    text, _, bad = hold_khit(kh.khit_cuda(closest, sbox, tiles),
                             kh.khit_plain(closest, sbox, tiles, k=kh.K + 1),
                             kh.K)
    ms = cuda_ms(partial(kh.khit_cuda, closest, sbox, tiles), 3)
    log(f"[cap] S={num_s} khit                    : {text}; list launch + "
        f"walk {ms:.3f} ms [{card}]")
    if bad:
        raise AssertionError("[cap] khit: the kernel disagrees with the "
                             "plain version")
    del sbox, tiles, two
    torch.cuda.empty_cache()


def compare_khit(scene, meta, label, dev, st, kh, stats):
    sbox, tiles = scene.bvh.sbox, scene.bvh.tiles
    for name, rays, _ in ray_sets(scene, meta, dev, st):
        k = kh.khit_cuda(rays, sbox, tiles)
        # K + 1 nearest from the plain version: its first K are the plain
        # K-nearest, the extra one shows ties across the K-th place.
        p5 = kh.khit_plain(rays, sbox, tiles, k=kh.K + 1)
        torch.cuda.synchronize()
        text, err, bad = hold_khit(k, p5, kh.K)
        log(f"[khit] {label:<11} S={sbox.shape[0]:<3} {name:<7} {text}")
        if bad:
            raise AssertionError(f"khit kernel disagrees with the plain "
                                 f"version on {label}/{name}")
        stats["khit_err"] = max(stats.get("khit_err", 0.0), err)
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


def trace_totals(events):
    """({name: [ns, count]} of the device events, the same of the host
    events by self time) of a torch.profiler trace's raw events: what
    key_averages() reports as self device and self CPU time, summed
    straight from the events.  key_averages() first builds an event tree
    in Python, which takes minutes for the ~2M events of one instanced
    1080p frame.  A host event's self time is its duration less that of
    the events nested directly in it on its thread; as there, an event
    whose only child has its name counts once with that child."""
    dev, host, threads = {}, {}, {}

    def add(rows, name, ns, n=1):
        row = rows.setdefault(name, [0, 0])
        row[0] += ns
        row[1] += n

    def close(frame):                   # [end, name, self, children, last]
        _, name, ns, children, last = frame
        add(host, name, ns, 0 if children == 1 and last == name else 1)

    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            add(dev, e.name(), e.duration_ns())
        elif e.is_async():
            add(host, e.name(), e.duration_ns())
        else:
            threads.setdefault(e.start_thread_id(), []).append(
                (e.start_ns(), -e.duration_ns(), e.name()))
    for evs in threads.values():
        evs.sort()                      # parents before their children
        stack = []                      # the open events, outermost first
        for start, neg_ns, name in evs:
            while stack and stack[-1][0] <= start:
                close(stack.pop())
            if stack:
                stack[-1][2] += neg_ns
                stack[-1][3] += 1
                stack[-1][4] = name
            stack.append([start - neg_ns, name, -neg_ns, 0, None])
        while stack:
            close(stack.pop())
    return dev, host


def profile_frame(renderer, label, card, top=8):
    """Trace one more frame of `renderer` with torch.profiler: wall time,
    device busy time (kernel time summed; the frame runs on one stream),
    the device's idle share, the kernel count, and the kernels with the
    most device time and the host ops with the most host (self) time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.time()
        renderer.step()
        torch.cuda.synchronize()
        wall = 1e3 * (time.time() - t0)
    dev, host = trace_totals(prof.profiler.kineto_results.events())
    busy = sum(ns for ns, _ in dev.values()) / 1e6
    log(f"[profile] {label}, one traced frame: wall {wall:.1f} ms, device "
        f"busy {busy:.1f} ms (idle {100.0 * (1.0 - busy / wall):.1f}%), "
        f"{sum(n for _, n in dev.values())} kernels [{card}]")
    for where, rows in (("device", dev), ("host  ", host)):
        for name, (ns, n) in sorted(rows.items(),
                                    key=lambda kv: -kv[1][0])[:top]:
            log(f"[profile]   {where} {ns / 1e6:9.2f} ms {n:7d}x  "
                f"{name[:80]}")


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


def time_merge(label, q, stats, card):
    """The merge kernels on recorded still-life queries (`q`,
    merge_contrib's arguments by name): the preparation kernels against
    prepare_queries (rows and permutation bit for bit), the gather's
    parity, then the gather alone (queries prepared beforehand), the
    wrapper (merge_contrib: preparation, gather into the caller's rows),
    the preparation alone, the plain versions, and the bounds."""
    from imbatracer_torch.ops import merge as mg

    stats["merge_label"] = label
    grid, kinds, ppm = q["grid"], q["kinds"], q["ppm"]
    args = [q[k] for k in ("qpos", "normal", "gn", "w_out", "params",
                           "d_vcm", "d_vm", "active")]
    qrec, perm = mg.prepare_queries(grid, *args)
    gq, gperm = mg.prepare_cuda(grid, *args)
    torch.cuda.synchronize()
    row_bad = int((gq.view(torch.int32) != qrec.view(torch.int32)).any(
        dim=1).sum())
    perm_bad = int((gperm != perm).sum())
    log(f"[merge] {label}: query preparation kernels vs prepare_queries: "
        f"{qrec.shape[0]} rows, {row_bad} rows and {perm_bad} permutation "
        f"entries not bit-equal")
    if row_bad or perm_bad:
        raise AssertionError("the merge preparation kernels disagree with "
                             "prepare_queries")
    scal = mg.scalars(grid, q["mis_eta_vc"])
    work = compare_merge(label, qrec, grid, scal, kinds, ppm, stats)
    ms = cuda_ms(lambda: mg.merge_cuda(qrec, grid, scal, kinds, ppm), 10)
    wrapper_ms = cuda_ms(lambda: mg.merge_contrib(**q), 10)
    plain_ms = cuda_ms(lambda: mg.merge_plain(qrec, grid, scal, kinds, ppm),
                       2)
    stats["merge"] = (ms, wrapper_ms,
                      merge_bound(qrec, grid, scal, kinds, ppm, work))
    stats["merge_plain_ms"] = plain_ms
    num_q = qrec.shape[0]
    # In: 3 position, 3 normal, 3 geometric normal, 3 w_out, kind, 3 kd,
    # 3 ks, ns, d_vcm, d_vm words and the active byte a query; out: its
    # 40-word row and 8-byte permutation entry.
    stats["merge_prep"] = (
        cuda_ms(lambda: mg.prepare_cuda(grid, *args), 10), None,
        bytes_bound(num_q * (4 * 22 + 1 + 4 * mg.QREC_W + 8), queries=num_q))
    stats["merge_prep_plain_ms"] = cuda_ms(
        lambda: mg.prepare_queries(grid, *args), 3)
    stats["merge_prep_err"] = float((gq - qrec).abs().max())
    log_time(f"merge preparation kernels, {label} queries", stats["merge_prep"],
             stats["merge_prep_plain_ms"], card, second=None)


def family_frames(scene, meta, algo, width, height, max_len, frames,
                  queries=None, lpc=None, warmup=True):
    """make_frame_fn + ProgressiveRenderer: a warm-up frame (unless not
    `warmup`), reset(), then `frames` timed frames with the launch
    counters set to 0 just before them and read just after.  Returns
    (renderer, counters, ms/frame, stats of the warm-up frame).  With
    `queries`, a list, the warm-up frame appends each camera band's
    bounce-1 merge arguments to it (an eager frame) and one more warm-up
    frame captures the graphs.  `lpc`: light paths a frame (0: the
    default, capped count; None: VCM_LPC for vcm at 1920x1080, else the
    default)."""
    from imbatracer_torch.frontend.engine import make_frame_fn
    from imbatracer_torch.frontend.renderer import (ProgressiveRenderer,
                                                    RenderSettings)

    settings = RenderSettings(width=width, height=height, spp=1,
                              max_path_len=max_len, algorithm=algo)
    if lpc is None and algo == "vcm" and (width, height) == (1920, 1080):
        lpc = VCM_LPC
    settings.light_path_count = lpc or 0
    frame_fn, _ = make_frame_fn(scene, meta, settings)
    renderer = ProgressiveRenderer(frame_fn, settings, scene.device)
    fstats = {} if queries is None else {"merge_queries": queries}
    if warmup and algo == "pt":
        renderer.step()
    elif warmup:
        renderer.accum = renderer.accum + frame_fn(0, stats=fstats)
        if queries is not None:
            # A frame that records is eager by rule: capture the graphs
            # outside the timed frames.
            frame_fn(0)
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
    traced frame and the launch counters of the timed frames."""
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
    if (got["merge"] == 0 or got["merge_prep"] == 0 or got["khit"] == 0
            or plain_runs(got)):
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
               stats, card)
    del queries
    return renderer, got


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


def hold_rows(k, p, occl):
    """(mismatches, max relative t/u/v error, max abs error) of kernel
    rows against reference rows: any-hit flags that differ, or closest-hit
    ids that differ where the two t are not bit-equal; the errors over
    rows with equal ids."""
    if occl:
        return int((k[:, 0] != p[:, 0]).sum()), 0.0, float(
            (k[:, 0] - p[:, 0]).abs().max())
    kid, pid = k[:, 3], p[:, 3]
    tie = (kid != pid) & (k[:, 0] == p[:, 0])
    bad = int(((kid != pid) & ~tie).sum())
    both = (kid == pid) & (kid >= 0)
    if not bool(both.any()):
        return bad, 0.0, 0.0
    diff = (k[both, :3] - p[both, :3]).abs()
    rel = float((diff / torch.clamp(p[both, :3].abs(), min=1.0)).max())
    return bad, rel, float(diff.max())


def pair_bound(rows, sc, tiles, inst, work):
    """(bound_ms, bound_by, detail) of the pair kernel on one queue: the
    bytes it must move (each lane's super-chunk, the ray row of each live
    lane -- a lane with sc = -1 needs none --, each tile a live lane
    reads, the instancing metadata, the rows out) over the HBM rate, and
    the float32 instructions of its counting launch over the float32
    instruction rate (ray transforms not counted, as in bound())."""
    from imbatracer_torch.ops import stream_traverse as st

    w = dict(zip(st.WORK_SLOTS, work.tolist()))
    ops = w["slab"] * SLAB_OPS + sum(
        w[k] * c for k, c in zip(st.WORK_SLOTS[1:], MT_STAGE_OPS))
    live = (sc >= 0) & (rows[:, 7] >= 0.0)
    n_live = int(live.sum())
    tiles_read = int(torch.unique(st.tile_of(sc[live].long(), inst)).numel())
    meta = 0 if inst is None else sum(x.numel() for x in inst)
    nbytes = 4 * (8 * n_live + sc.numel() + meta + 8 * rows.shape[0]
                  + tiles_read * st.TILE_ROWS * st.TRI_ROWS)
    t_ops, t_bytes = ops / FP32_INSTR_PER_S, nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes",
            dict(w, ops=ops, bytes=nbytes, lanes=n_live,
                 tiles_read=tiles_read))


def bytes_bound(nbytes, **detail):
    """(bound_ms, "bytes", detail) of a function that moves `nbytes` and
    does little arithmetic on them."""
    return 1e3 * nbytes / HBM_BYTES_PER_S, "bytes", dict(detail, bytes=nbytes)


def pair_candidates_bound(rays, sbox, k):
    """(bound_ms, bound_by, detail) of the candidates kernel: the bytes of
    the rays and boxes in and of idx, ent, rank, count, mindrop and the
    histogram out, and the slab tests its group boxes leave (one per ray
    and group of 8 boxes, and one per ray and box of each group it
    enters, inactive lanes included, as the kernel tests them)."""
    from imbatracer_torch.ops import stream_traverse as st

    num_r, num_s = rays.shape[0], sbox.shape[0]
    groups = -(-num_s // 8)
    box = torch.cat([sbox[:, 0:6], sbox.new_zeros((groups * 8 - num_s, 6))])
    box = box.view(groups, 8, 6)
    real = (torch.arange(groups * 8, device=sbox.device) < num_s).view(
        groups, 8)
    lo = torch.where(real[..., None], box[..., 0:3], st.BIG).amin(1)
    hi = torch.where(real[..., None], box[..., 3:6], -st.BIG).amax(1)
    inverted = ((box[..., 0] > box[..., 3]) & real).any(1)
    lo = torch.where(inverted[:, None], -st.BIG, lo)
    hi = torch.where(inverted[:, None], st.BIG, hi)
    size = real.sum(1)
    tests = num_r * groups
    for r0 in range(0, num_r, 1 << 15):
        r = rays[r0:r0 + (1 << 15)]
        tn, tf = st._slab(lo[None], hi[None], r[:, None, 0:3],
                          st._safe_inv(r[:, None, 4:7]))
        enter = (tn <= tf) & (tf >= r[:, 3, None]) & (tn <= r[:, 7, None])
        tests += int((enter * size[None]).sum())
    ops = tests * SLAB_OPS
    nbytes = 4 * (num_r * 8 + num_s * 6 + num_r * (3 * k + 2) + num_s)
    t_ops, t_bytes = ops / FP32_INSTR_PER_S, nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes",
            dict(slab_tests=tests, ops=ops, bytes=nbytes))


def queue_slots(rays, idx, order, hist):
    """(slots, rows, sc) of the card queue's lanes: the pair slots in
    queue order, their ray rows and their super-chunks, as pairs_plain
    takes a queue."""
    slots = order[:int(hist.sum())].long()
    k = idx.shape[1]
    return (slots, rays[slots // k].contiguous(),
            idx.view(-1)[slots].contiguous())


def compare_pair_candidates(label, name, key, rays, sbox, pm):
    """`[pcand]`: the candidates kernel against ray_candidates: idx, count
    and mindrop that differ, and entry t that differ as bits (-0 read as
    +0).  All must be 0."""
    got = pm.candidates_cuda(rays, sbox)[:4]
    ref = pm.ray_candidates(rays, sbox)
    bits = lambda x: (x + 0.0).view(torch.int32)
    bad = dict(idx=int((got[0] != ref[0]).sum()),
               ent=int((bits(got[1]) != bits(ref[1])).sum()),
               count=int((got[2] != ref[2]).sum()),
               mindrop=int((got[3] != ref[3]).sum()))
    k = ref[0].shape[1]
    log(f"[pcand] {label:<9} S={sbox.shape[0]:<5} {name:<7} {key:<7} rays "
        f"{rays.shape[0]}, candidates {int(ref[2].sum())} (> {k}: "
        f"{int((ref[2] > k).sum())} rays); mismatches {bad}")
    if any(bad.values()):
        raise AssertionError(f"the pair candidates kernel disagrees with "
                             f"ray_candidates on {label}/{name}/{key}")


def compare_pairs(scene, meta, label, dev, st, pm, stats, card):
    """Phase 8a, the pair route on the card: on each ray set and query
    kind, the candidates kernel against ray_candidates (`[pcand]`), the
    card's queue against build_queue (the same lanes in each super-chunk's
    run) and segment_table, the pair kernel against its plain version on
    that queue, the resolve kernel against resolve on the kernel's lanes,
    and the whole route (pair_rows: candidates, queue, kernel, resolve,
    saturation fallback) against the stream kernel; on the bounce rays the
    kernels timed alone, the route, the plain versions, and the pair
    kernel counted."""
    sbox, tiles, inst = scene.bvh.sbox, scene.bvh.tiles, scene.bvh.inst
    num_s = sbox.shape[0]
    tag = "" if inst is None else "_instanced"
    for name, closest, anyr in ray_sets(scene, meta, dev, st):
        for key, rays, occl in (("closest", closest, False),
                                ("any", anyr, True)):
            compare_pair_candidates(label, name, key, rays, sbox, pm)
            idx, _, count, mindrop, hist, rank = pm.candidates_cuda(rays,
                                                                    sbox)
            k = idx.shape[1]
            order, seg, nseg = pm.queue_cuda(idx, rank, hist)
            lanes = pm.pairs_cuda(rays, sbox, tiles, order, seg, nseg, k,
                                  occl, inst)
            slots, rows, sc = queue_slots(rays, idx, order, hist)
            # The same lanes in each run: build_queue's (stable) order is
            # the card's sorted by (super-chunk, pair slot).
            _, rsc, rorder = pm.build_queue(idx, rays, num_s)
            total, num_p = slots.shape[0], idx.numel()
            by_run = torch.sort(sc.long() * num_p + slots)[0] % num_p
            queue_bad = int((sc != rsc[:total]).sum()) + int(
                (by_run != rorder[:total]).sum())
            table = pm.segment_table(hist)
            queue_bad += int(int(nseg) != table.shape[0]) + int(
                (seg[:table.shape[0]] != table).any())
            p = pm.pairs_plain(rows, sc, tiles, occl, inst)
            out, _, sat, nsat = pm.resolve_cuda(rays, lanes, count, mindrop,
                                                k, occl)
            want, want_sat = pm.resolve(rays, lanes, count, mindrop, k, occl)
            before = pm.FALLBACK["rays"]
            route = pm.pair_rows(rays, sbox, tiles, occl, inst)
            fallback = pm.FALLBACK["rays"] - before
            ref = st.traverse_cuda(rays, sbox, tiles, occl, inst=inst)
            torch.cuda.synchronize()
            bad, rel, abs_err = hold_rows(lanes[slots], p, occl)
            rbad, rrel, _ = hold_rows(route, ref, occl)
            resolve_bad = int((out != want).any(dim=1).sum()) + int(
                (sat != want_sat).sum()) + abs(int(nsat) - int(want_sat.sum()))
            log(f"[pairs] {label:<9} S={num_s:<5} {name:<7} {key:<7} lanes="
                f"{slots.shape[0]} in {int(nseg)} segments; queue mismatch="
                f"{queue_bad}; kernel vs plain: mismatch={bad} "
                f"max_rel_err(t,u,v)={rel:.3e}; resolve mismatch="
                f"{resolve_bad}; route vs stream kernel: mismatch={rbad} "
                f"max_rel_err={rrel:.3e}; rays with > {k} candidates "
                f"{int((count > k).sum())}, re-traced by the fallback "
                f"{fallback}")
            allow = 1e-4 * rays.shape[0] if occl else 0
            if (queue_bad or resolve_bad or bad > allow or rel > 1e-5
                    or rbad > allow or rrel > 1e-5):
                raise AssertionError(f"the pair route disagrees on "
                                     f"{label}/{name}/{key}")
            err_key = f"pairs_{key}{tag}_err"
            stats[err_key] = max(stats.get(err_key, 0.0), abs_err)
            stats[f"fallback {label} {name} {key}"] = fallback
            if name != "bounce":
                continue
            ms = cuda_ms(lambda: pm.pairs_cuda(rays, sbox, tiles, order, seg,
                                               nseg, k, occl, inst), 10)
            route_ms = cuda_ms(
                lambda: pm.pair_rows(rays, sbox, tiles, occl, inst), 10)
            plain_ms = cuda_ms(
                lambda: pm.pairs_plain(rows, sc, tiles, occl, inst), 1,
                warm=False)
            work = torch.zeros(len(st.WORK_SLOTS), dtype=torch.int64,
                               device=dev)
            counted = pm.pairs_cuda(rays, sbox, tiles, order, seg, nseg, k,
                                    occl, inst, work=work)
            if not torch.equal(counted[slots], lanes[slots]):
                raise AssertionError("the pairs counting launch disagrees "
                                     "with the kernel")
            stats[f"pairs_{key}{tag}"] = (ms, route_ms, pair_bound(
                rows, sc, tiles, inst, work))
            stats[f"pairs_{key}{tag}_plain_ms"] = plain_ms
            stream_ms = stats[label, key][0]
            log(f"[time] pair route {label} S={num_s} {key}, {rays.shape[0]} "
                f"sorted bounce rays [{card}]: {route_ms:.3f} ms (with torch "
                f"glue {TORCH_GLUE_MS[label, key]:.3f} ms; the stream "
                f"kernel's launch {stream_ms:.3f} ms)")
            if label != "instanced" or key != "closest":
                continue
            # The route's other kernels, at the instanced scene's S.
            prep = (idx, rank, hist)
            stats["pair_candidates"] = (
                cuda_ms(lambda: pm.candidates_cuda(rays, sbox), 10), None,
                pair_candidates_bound(rays, sbox, k))
            stats["pair_candidates_plain_ms"] = cuda_ms(
                lambda: pm.ray_candidates(rays, sbox), 2)
            stats["pair_queue"] = (
                cuda_ms(lambda: pm.queue_cuda(*prep), 10), None,
                bytes_bound(4 * (2 * num_p + num_s + total + num_s
                                 + 4 * int(nseg)), lanes=total))
            stats["pair_queue_plain_ms"] = cuda_ms(
                lambda: pm.build_queue(idx, rays, num_s), 3)
            stats["pair_queue_library_ms"] = cuda_ms(
                lambda: torch.sort(idx.view(-1), stable=True), 10)
            stats["pair_resolve"] = (
                cuda_ms(lambda: pm.resolve_cuda(rays, lanes, count, mindrop,
                                                k, occl), 10), None,
                bytes_bound(4 * (8 * rays.shape[0] + 8 * total
                                 + 2 * rays.shape[0] + 16 * rays.shape[0])
                            + rays.shape[0], lanes=total))
            stats["pair_resolve_plain_ms"] = cuda_ms(
                lambda: pm.resolve(rays, lanes, count, mindrop, k, occl), 3)
            stats["pair_resolve_err"] = float((out - want).abs().max())
            for what, second in (("pair_candidates", "ray_candidates"),
                                 ("pair_queue", "build_queue"),
                                 ("pair_resolve", "resolve")):
                log_time(f"{what} kernel, {label} S={num_s}, {rays.shape[0]} "
                         f"sorted bounce rays", stats[what],
                         stats[f"{what}_plain_ms"], card, second=None)
            log_resources(f"pairs kernel {key}{tag}",
                          pm.resources(occl, inst is not None), card)


def with_pairs(scene):
    """The scene with its BVH's pairs switch on (accel/device.py)."""
    return dataclasses.replace(
        scene, bvh=dataclasses.replace(scene.bvh, pairs=True))


def pairs_main_path(scene, meta, label, width, height, max_len, ref, ref_ms,
                    card):
    """Phase 8c: PT through the pair queue (the switch on), the frames
    `ref` took through the stream kernel in `ref_ms` a frame (no warm-up:
    nothing is compiled and the frame indices match); the pair route's
    kernels must launch, no plain version may run, and the image must
    agree with `ref`'s to PSNR_MIN.  Returns the launch counters."""
    from imbatracer_torch.utils.metrics import psnr

    r, got, ms, _ = family_frames(with_pairs(scene), meta, "pt", width,
                                  height, max_len, INST_FRAMES, warmup=False)
    p = psnr(r.image(), ref.image())
    log(f"[pairs] {label} {width}x{height} PT with the pairs switch on: "
        f"{ms:.1f} ms/frame over {INST_FRAMES} frames (the stream route "
        f"{ref_ms:.1f} ms/frame), PSNR {p:.2f} dB against the stream "
        f"route's frames; launches {got} [{card}]")
    tag = "_instanced" if scene.bvh.two_level else ""
    route = ("pairs_candidates", "pairs_queue", "pairs_resolve")
    if (not got[f"pairs_closest_hit{tag}"] or not got[f"pairs_any_hit{tag}"]
            or not all(got[k] for k in route)
            or plain_runs(got) or not p >= PSNR_MIN):
        raise AssertionError(f"{label}: the pairs route did not run through "
                             f"the pair kernels or disagrees with the "
                             f"stream route")
    return got


def run_cli(path, out_png, card):
    """Phase 8b: `python -m imbatracer_torch` as a user types it, run in
    this process: vcm at INST_SIZE, the default light-path count,
    CLI_SAMPLES samples a pixel.  It must print the perf line and write
    the PNG."""
    from imbatracer_torch.frontend import cli

    w, h = INST_SIZE
    argv = [path, out_png, "-a", "vcm", "-w", str(w), "-h2", str(h), "-s",
            str(CLI_SAMPLES), "-q"]
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    text = buf.getvalue().strip()
    log(f"[cli] python -m imbatracer_torch {' '.join(argv[2:])} "
        f"<instances.scene> <out.png>: rc {rc} in {time.time() - t0:.1f} s "
        f"(scene build included): {text} [{card}]")
    with open(out_png, "rb") as f:
        ok_png = f.read(8) == b"\x89PNG\r\n\x1a\n"
    if rc != 0 or "Done after" not in text or not ok_png:
        raise AssertionError("the CLI did not render the instanced scene")


def instanced_phase(dev, card, big, stats):
    """Phase 8: the `.scene` / OBJ slice on the generated instanced scene
    (scene/generate.CARD, written to a temporary directory).  Returns the
    launch counts of its main paths."""
    from imbatracer_torch.ops import pairs as pm
    from imbatracer_torch.ops import stream_traverse as st
    from imbatracer_torch.scene.build import build_scene
    from imbatracer_torch.scene.generate import CARD, write_instanced_scene
    from imbatracer_torch.utils.metrics import psnr

    phase("8 the instanced scene: write and build")
    tmp = tempfile.mkdtemp(prefix="imba_instanced_")
    try:
        t0 = time.time()
        path = write_instanced_scene(tmp, **CARD)
        t_write = time.time() - t0
        t0 = time.time()
        scene, meta = build_scene(path, quiet=True, device=dev)
        torch.cuda.synchronize()
        bvh = scene.bvh
        shade = sum(x.numel() * x.element_size() for x in
                    (scene.attrs.rec, scene.attrs.shade_rec, scene.attrs.gn,
                     scene.attrs.n0, scene.attrs.n1, scene.attrs.n2,
                     scene.attrs.uv0, scene.attrs.uv1, scene.attrs.uv2,
                     scene.attrs.mask_rec))
        log(f"[inst] scene written in {t_write:.1f} s, built in "
            f"{time.time() - t0:.1f} s: {meta.num_tris} flat triangles, "
            f"{meta.bvh_stats}, {meta.num_lights} lights, "
            f"{meta.num_textures} textures, masks {meta.has_masks}, bump "
            f"{meta.has_bump}, env {meta.has_env}; tiles "
            f"{bvh.tiles.numel() * 4 / 2**20:.1f} MB, flat shading records "
            f"{shade / 2**20:.1f} MB")
        if not bvh.two_level:
            raise AssertionError("the instanced scene was not built two-level")

        # (a) Kernel parity, timing and counted work.
        phase("8a instanced stream and pair kernels vs plain")
        compare(scene, meta, "instanced", dev, st, stats)
        compare_candidates(scene, meta, "instanced", dev, st)
        num_s = bvh.sbox.shape[0]
        for key in ("closest", "any"):
            log_time(f"instanced stream kernel {key}, S={num_s}, "
                     f"{bvh.tiles.shape[0]} tiles, {NUM_RAYS} sorted bounce "
                     f"rays", stats["instanced", key],
                     stats["instanced", f"{key}_plain_ms"], card)
            log_resources(f"instanced stream kernel {key}, S={num_s}",
                          st.resources(key == "any", True, num_s), card)
        for label, sc in (("instanced", (scene, meta)), ("big_4000", big)):
            compare_pairs(sc[0], sc[1], label, dev, st, pm, stats, card)
            tag = "_instanced" if sc[0].bvh.two_level else ""
            for key in ("closest", "any"):
                log_time(f"pairs kernel {key}{tag}, S={sc[0].bvh.sbox.shape[0]}"
                         f", {NUM_RAYS} sorted bounce rays (kernel on the "
                         f"card's queue)",
                         stats[f"pairs_{key}{tag}"],
                         stats[f"pairs_{key}{tag}_plain_ms"], card,
                         second="the route")
        if not any(v for k, v in stats.items() if isinstance(k, str)
                   and k.startswith("fallback instanced")):
            raise AssertionError("the saturation fallback re-traced no ray "
                                 "on the instanced scene")

        # (b) The main path: the CLI, then make_frame_fn + the renderer.
        phase("8b the CLI and the instanced vcm main path")
        run_cli(path, os.path.join(tmp, "cli_vcm.png"), card)
        w, h = INST_SIZE
        vr, got, ms, fstats = family_frames(scene, meta, "vcm", w, h, 8,
                                            INST_FRAMES, lpc=0)
        log(f"[inst] vcm {w}x{h} spp 1 max_len 8, default light paths: "
            f"{ms:.1f} ms/frame over {INST_FRAMES} frames; warm-up frame "
            f"{fstats}; launches over the timed frames {got} [{card}]")
        if (not got["closest_hit_instanced"] or not got["any_hit_instanced"]
                or not got["merge"] or got["khit"] or plain_runs(got)):
            raise AssertionError("instanced vcm: the main path did not run "
                                 "through the instanced and merge kernels "
                                 "alone")
        mean = film_mean(vr, "instanced vcm")
        pt, pt_got, pt_ms, _ = family_frames(scene, meta, "pt", w, h, 8,
                                             INST_FRAMES)
        log(f"[inst] pt {w}x{h} spp 1 max_len 8: {pt_ms:.1f} ms/frame over "
            f"{INST_FRAMES} frames; launches {pt_got} [{card}]")
        check_mean(f"instanced {w}x{h} vcm", mean, film_mean(pt, "instanced"
                                                             " pt"), card)
        profile_frame(vr, f"instanced vcm {w}x{h} max_len 8", card)
        del vr

        # (c) The pairs route, instanced and flat.
        phase("8c the pairs route")
        pairs_got = pairs_main_path(scene, meta, "instanced", w, h, 8, pt,
                                    pt_ms, card)
        del pt
        big_ref, _, big_ms, _ = family_frames(*big, "pt", 1024, 1024, 6,
                                              INST_FRAMES)
        big_got = pairs_main_path(*big, "big_4000", 1024, 1024, 6, big_ref,
                                  big_ms, card)
        for k in ("pairs_closest_hit", "pairs_any_hit"):
            pairs_got[k] = big_got[k]
        for k in ("pairs_candidates", "pairs_queue", "pairs_resolve"):
            pairs_got[k] += big_got[k]

        # (d) Two-level against flattened.
        phase("8d two-level vs flattened")
        flat, fmeta = build_scene(path, quiet=True, device=dev,
                                  force_flatten=True)
        fw, fh = FLAT_SIZE
        tr, tgot, tms, _ = family_frames(scene, meta, "pt", fw, fh, 8,
                                         INST_FRAMES)
        fr, fgot, fms, _ = family_frames(flat, fmeta, "pt", fw, fh, 8,
                                         INST_FRAMES)
        p = psnr(tr.image(), fr.image())
        log(f"[inst] two-level vs flattened (S={flat.bvh.sbox.shape[0]}, "
            f"{flat.bvh.tiles.numel() * 4 / 2**20:.1f} MB of tiles), PT "
            f"{fw}x{fh}, {INST_FRAMES} frames: PSNR {p:.2f} dB; two-level "
            f"{tms:.1f} ms/frame, masked rounds {tgot['rounds']}, most "
            f"{tgot['max_rounds']} a dispatch; flattened {fms:.1f} ms/frame, "
            f"khit {fgot['khit']}; frames rendered again two-level "
            f"{tgot['graph_reruns']}, flattened {fgot['graph_reruns']} "
            f"(lanes past the slots {tgot['dropped'] + fgot['dropped']}, at "
            f"the cap {tgot['capped'] + fgot['capped']}) [{card}]")
        if (not p >= PSNR_MIN or tgot["khit"] or not fgot["khit"]
                or plain_runs(tgot) or plain_runs(fgot)):
            raise AssertionError("two-level and flattened renders disagree "
                                 "or took the wrong routes")
        if tgot["graph_reruns"] or fgot["graph_reruns"]:
            raise AssertionError("two-level vs flattened: a graphed frame "
                                 "was rendered again on the eager route")
        return dict(got, **{k: v for k, v in pairs_got.items()
                            if k.startswith("pairs_")})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def repeated_ids(rows, k):
    """Slots of khit rows (R, 8k) whose id repeats an earlier slot's."""
    ids = rows[:, 3::8]
    return sum(int(((ids[:, a] >= 0) & (ids[:, a] == ids[:, b])).sum())
               for a in range(k) for b in range(a))


def split_still_life(dev):
    """make_still_life_like() with its arrays passed on to
    assemble_device_scene(..., spatial=True): (scene, meta, (v0, v1,
    v2)).  The function and its default are left as they are."""
    from imbatracer_torch.scene import procedural

    real = procedural.assemble_device_scene
    seen = {}

    def spatial(*args, **kw):
        seen["tris"] = args[:3]
        return real(*args, **dict(kw, spatial=True))

    procedural.assemble_device_scene = spatial
    try:
        scene, meta = procedural.make_still_life_like(device=dev)
    finally:
        procedural.assemble_device_scene = real
    return scene, meta, seen["tris"]


def chunk_stats(scene):
    """What the chunk packing of a flat scene makes of its references:
    (reference counts of the two most-referenced triangles, chunks that
    hold either, chunks, mean surface area of the chunk boxes).  A chunk
    box spans its triangles whole, however the builder clipped them."""
    from imbatracer_torch.ops import stream_traverse as st

    ids = scene.bvh.tri_id.long()
    top = torch.topk(torch.bincount(ids[ids >= 0]), 2)
    pad = scene.bvh.sbox.shape[0] * st.TRI_ROWS - ids.shape[0]
    chunks = torch.nn.functional.pad(ids, (0, pad), value=-1).view(
        -1, st.CHUNK)
    holding = int(torch.isin(chunks, top.indices).any(1).sum())
    box = st.cbox_rows(scene.bvh.tiles).reshape(-1, 6).double()
    ext = box[:, 3:] - box[:, :3]
    e = ext[(ext >= 0).all(1)]
    area = 2.0 * (e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2] + e[:, 0] * e[:, 2])
    return top.values.tolist(), holding, e.shape[0], float(area.mean())


def split_kernels(binned, split, tris, dev, card, stats):
    """Phase 10a: the split build's numbers, and khit and the stream
    kernel over it, held against their plain versions and against the
    binned build's khit rows, each timed at both builds."""
    from imbatracer_torch.accel.builder import triangle_bboxes
    from imbatracer_torch.accel.native import (build_bvh_native,
                                               build_sbvh_native)
    from imbatracer_torch.accel.sbvh import sah_cost
    from imbatracer_torch.ops import khit as kh
    from imbatracer_torch.ops import stream_traverse as st

    v0, v1, v2 = tris
    t0 = time.time()
    nodes_b = build_bvh_native(*triangle_bboxes(v0, v1, v2))
    t_b = time.time() - t0
    t0 = time.time()
    nodes_s = build_sbvh_native(np.stack([v0, v1, v2], axis=1))
    t_s = time.time() - t0
    (sb, mb), (ss, _) = binned, split
    refs = int((ss.bvh.tri_id >= 0).sum())
    mbytes = lambda sc: sc.bvh.tiles.numel() * 4 / 2**20
    log(f"[sbvh] still life, {mb.num_tris} triangles: native split build "
        f"{t_s:.2f} s (binned {t_b:.2f} s); {refs} references = "
        f"{refs / mb.num_tris:.4f} x the triangles; S={ss.bvh.sbox.shape[0]}"
        f" (binned {sb.bvh.sbox.shape[0]}); tiles {mbytes(ss):.1f} MB "
        f"(binned {mbytes(sb):.1f} MB); sah_cost {sah_cost(nodes_s):.2f} "
        f"(binned {sah_cost(nodes_b):.2f}, ratio "
        f"{sah_cost(nodes_s) / sah_cost(nodes_b):.4f})")
    (refs_s, hold_s, n_s, area_s), (refs_b, hold_b, n_b, area_b) = (
        chunk_stats(sc) for sc in (ss, sb))
    log(f"[sbvh] chunk packing: the two most-referenced triangles have "
        f"{refs_s} references (binned {refs_b}); {hold_s} of {n_s} chunks "
        f"hold one (binned {hold_b} of {n_b}); mean chunk box surface area "
        f"{area_s:.1f} (binned {area_b:.1f})")

    rays = {}
    for name, (scene, meta) in (("binned", binned), ("split", split)):
        rays[name] = {n: (c, a) for n, c, a in
                      ray_sets(scene, meta, dev, st)}["bounce"]
    if not all(torch.equal(x, y) for x, y in zip(rays["binned"],
                                                 rays["split"])):
        raise AssertionError("[sbvh] the two builds' ray sets differ")
    closest, anyr = rays["split"]
    sbox, tiles = ss.bvh.sbox, ss.bvh.tiles
    k = kh.khit_cuda(closest, sbox, tiles)
    p5 = kh.khit_plain(closest, sbox, tiles, k=kh.K + 1)
    kb = kh.khit_cuda(closest, sb.bvh.sbox, sb.bvh.tiles)
    torch.cuda.synchronize()
    text, err, bad = hold_khit(k, p5, kh.K)
    rep_k, rep_p = repeated_ids(k, kh.K), repeated_ids(p5, kh.K + 1)
    bits = lambda x: x.contiguous().view(torch.int32)
    t5, present5 = p5[:, 0::8], p5[:, 3::8] >= 0
    tie = torch.zeros_like(k[:, 3::8], dtype=torch.bool)
    for a in range(kh.K):
        for b in range(kh.K + 1):
            if a != b:
                tie[:, a] |= (t5[:, a] == t5[:, b]) & present5[:, b]
    kid, bid = k[:, 3::8], kb[:, 3::8]
    same = kid == bid
    t_bits = int((bits(k[:, 0::8]) != bits(kb[:, 0::8])).sum())
    id_off = int((~same & ~tie).sum())
    uv_bits = sum(int(((bits(k[:, f::8]) != bits(kb[:, f::8])) & same).sum())
                  for f in (1, 2))
    log(f"[sbvh] khit, split build, {NUM_RAYS} sorted bounce rays: {text};"
        f" repeated ids: kernel {rep_k}, plain {rep_p}; against the binned "
        f"build's rows: t not bit-equal {t_bits}, ids differing off a "
        f"bit-equal-t tie {id_off} (on ties {int((~same).sum())}), u/v not "
        f"bit-equal where the ids agree {uv_bits}")
    if bad or rep_k or rep_p or t_bits or id_off or uv_bits:
        raise AssertionError("[sbvh] khit over the split build disagrees")
    stats["khit_err"] = max(stats["khit_err"], err)
    for key, rays_, occl in (("closest", closest, False), ("any", anyr,
                                                            True)):
        bad, rel, abs_err = hold_rows(st.traverse_cuda(rays_, sbox, tiles,
                                                       occl),
                                      st.traverse_plain(rays_, sbox, tiles,
                                                        occl), occl)
        log(f"[sbvh] stream {key}, split build: mismatch={bad} "
            f"max_rel_err(t,u,v)={rel:.3e}")
        if bad > (1e-4 * NUM_RAYS if occl else 0) or rel > 1e-5:
            raise AssertionError(f"[sbvh] stream {key} over the split build "
                                 f"disagrees with the plain version")
        stats[f"{key}_err"] = max(stats[f"{key}_err"], abs_err)

    for name, (scene, _) in (("binned", binned), ("split", split)):
        c, a = rays[name]
        sb_, tb_ = scene.bvh.sbox, scene.bvh.tiles
        stats["sbvh", name, "khit"] = time_kernel(
            partial(kh.khit_cuda, c, sb_, tb_), c, sb_, tb_, 8 * kh.K,
            insert_ops=kh.K)
        for key, rays_, occl in (("closest", c, False), ("any", a, True)):
            stats["sbvh", name, key] = time_kernel(
                partial(st.traverse_cuda, rays_, sb_, tb_, occl), rays_, sb_,
                tb_, 8)
    for kind in ("khit", "closest", "any"):
        (b_ms, _, b_bound), (s_ms, _, s_bound) = (
            stats["sbvh", n, kind] for n in ("binned", "split"))
        log(f"[sbvh] {kind} at both builds, {NUM_RAYS} sorted still-life "
            f"bounce rays [{card}]: binned (S={sb.bvh.sbox.shape[0]}) "
            f"{b_ms:.3f} ms, bound {b_bound[0]:.4f} ms; split "
            f"(S={ss.bvh.sbox.shape[0]}) {s_ms:.3f} ms, bound "
            f"{s_bound[0]:.4f} ms")


def run_sbvh_cli(path, tmp, card):
    """Phase 10c: `python -m imbatracer_torch <scene> <png> --sbvh -a pt
    -s 2` twice in a fresh cache directory: the first builds and caches
    the split BVH, the second loads it; the PNGs must be equal byte for
    byte, or else equal to phase 6's tolerance on the 8-bit images."""
    from imbatracer_torch.io.image import load_png

    env = dict(os.environ, IMBATRACER_CACHE_DIR=os.path.join(tmp, "accel"),
               PYTHONPATH=ROOT)
    pngs, built = [], []
    for run, says in enumerate(("wrote BVH cache", "BVH loaded from cache")):
        out = os.path.join(tmp, f"sbvh{run}.png")
        t0 = time.time()
        res = subprocess.run(
            [sys.executable, "-m", "imbatracer_torch", path, out, "--sbvh",
             "-a", "pt", "-s", "2"], capture_output=True, text=True,
            cwd=ROOT, env=env, timeout=SUBPROCESS_LIMIT)
        m = re.search(r"scene built in ([0-9.]+)s", res.stderr)
        built.append(float(m.group(1)) if m else float("nan"))
        perf = [ln for ln in res.stdout.splitlines() if "Done after" in ln]
        log(f"[cli] --sbvh run {run + 1}: rc {res.returncode} in "
            f"{time.time() - t0:.1f} s, scene built in {built[-1]:.2f} s, "
            f"{'; '.join(ln.split('] ', 1)[-1] for ln in res.stderr.splitlines() if 'BVH' in ln)}"
            f"; {perf[0] if perf else 'no perf line'} [{card}]")
        if (res.returncode != 0 or not perf or says not in res.stderr
                or (run == 0 and "BVH (sbvh)" not in res.stderr)):
            raise AssertionError(f"--sbvh run {run + 1} failed:\n"
                                 f"{res.stderr[-3000:]}")
        with open(out, "rb") as f:
            pngs.append(f.read())
    if pngs[0] == pngs[1]:
        held = "equal byte for byte"
    else:
        a, b = (load_png(os.path.join(tmp, f"sbvh{r}.png")).astype(np.float64)
                for r in range(2))
        mean_rel = abs(a.mean() - b.mean()) / max(b.mean(), 1e-9)
        within = float((np.abs(a - b).max(axis=-1) <= 1.0).mean())
        held = (f"not byte-equal; held to phase 6's tolerance: mean rel diff "
                f"{mean_rel:.3e}, pixels within a level {within:.4f}")
        if not (mean_rel <= 0.01 and within >= 0.95):
            raise AssertionError(f"--sbvh: the two runs' images differ "
                                 f"({held})")
    log(f"[cli] --sbvh: the second run loaded the cached split BVH; scene "
        f"build {built[0]:.2f} s, then {built[1]:.2f} s; images {held} "
        f"[{card}]")


def run_interactive_pty(path, tmp, card):
    """Phase 10d: `--interactive` on a pseudo-terminal: after it has
    redrawn a few times, w (a move), j (a turn), p (save) and x (quit),
    with pauses.  It must exit 0 within SUBPROCESS_LIMIT after drawing
    half-block rows, restart its spp count after the move and leave a
    PNG that is not black."""
    from imbatracer_torch.io.image import load_png

    out = os.path.join(tmp, "interactive.png")
    w, h = INTERACTIVE_SIZE
    master, slave = pty.openpty()
    env = dict(os.environ, PYTHONPATH=ROOT, COLUMNS="100", LINES="30")
    t0 = time.time()
    proc = subprocess.Popen(
        [sys.executable, "-m", "imbatracer_torch", path, out,
         "--interactive", "-a", "pt", "-w", str(w), "-h2", str(h)],
        stdin=slave, stdout=slave, stderr=slave, cwd=ROOT, env=env,
        close_fds=True)
    os.close(slave)
    buf = bytearray()

    def read_until(pred, limit):
        t_end = min(time.time() + limit, t0 + SUBPROCESS_LIMIT)
        while time.time() < t_end and not pred():
            ready, _, _ = select.select([master], [], [], 0.2)
            if ready:
                try:
                    buf.extend(os.read(master, 1 << 16))
                except OSError:
                    break
        return pred()

    spp = lambda: [int(x) for x in re.findall(rb"(\d+) spp", bytes(buf))]
    try:
        if not read_until(lambda: max(spp(), default=0) >= 3, 200):
            raise AssertionError("--interactive: no redraw")
        seen = len(spp())
        os.write(master, b"w")
        fell = read_until(lambda: any(
            b < a for a, b in zip(spp()[seen - 1:], spp()[seen:])), 60)
        time.sleep(0.5)
        os.write(master, b"j")
        time.sleep(0.5)
        os.write(master, b"p")
        saved = read_until(lambda: os.path.exists(out), 60)
        time.sleep(0.5)
        os.write(master, b"x")
        read_until(lambda: proc.poll() is not None, 60)
        rc = proc.wait(timeout=10)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        os.close(master)
    counts = spp()
    blocks = bytes(buf).count("▀".encode())
    mean = float(load_png(out).mean()) if os.path.exists(out) else 0.0
    log(f"[interactive] {w}x{h} PT on a pseudo-terminal: rc {rc} after "
        f"{time.time() - t0:.1f} s, {len(counts)} redraws (spp "
        f"{counts[:6]}...{counts[-3:]}), spp restarted after the move "
        f"{fell}, saved on p {saved}, half-blocks drawn {blocks}, final PNG "
        f"mean {mean:.2f} of 255 [{card}]")
    if rc != 0 or not fell or not saved or not blocks or not mean > 0.0:
        raise AssertionError(f"--interactive failed:\n"
                             f"{bytes(buf)[-3000:].decode(errors='replace')}")


def split_phase(dev, card, still_life, binned_image, binned_ms, stats):
    """Phase 10: the split BVH on the still life (kernels and main path),
    the CLI's --sbvh with the cache, and --interactive.  Returns the main
    path's launch counters."""
    from imbatracer_torch.scene.generate import CARD, write_instanced_scene
    from imbatracer_torch.utils.metrics import load_reference_png, psnr

    phase("10a split BVH: the still life's build and kernels")
    t0 = time.time()
    scene, meta, tris = split_still_life(dev)
    log(f"[sbvh] the split still life assembled in {time.time() - t0:.1f} s")
    split_kernels(still_life, (scene, meta), tris, dev, card, stats)

    phase("10b split BVH: the still-life main path")
    w, h = 1920, 1080
    r, got, ms, _ = family_frames(scene, meta, "pt", w, h, 8,
                                  STILL_LIFE_FRAMES)
    golden = os.path.join(ROOT, "goldens", "still_life_1080p_len8.png")
    p_gold = psnr(r.image(), load_reference_png(golden))
    p_route = psnr(r.image(), binned_image)
    log(f"[sbvh] still life {w}x{h} PT over the split build, "
        f"{STILL_LIFE_FRAMES} frames: PSNR {p_gold:.3f} dB vs "
        f"{os.path.basename(golden)} (JAX renderer {STILL_LIFE_PSNR} dB), "
        f"{p_route:.2f} dB vs the binned build's image of the same frames; "
        f"{ms:.1f} ms/frame (binned {binned_ms:.1f} ms/frame, phase 5); "
        f"launches {got} [{card}]")
    if (not got["khit"] or plain_runs(got)
            or not abs(p_gold - STILL_LIFE_PSNR) <= PSNR_TOL
            or not p_route >= PSNR_MIN):
        raise AssertionError("the still life over the split build did not "
                             "run through khit alone or disagrees")
    del r, scene

    phase("10c the CLI with --sbvh and the BVH cache")
    tmp = tempfile.mkdtemp(prefix="imba_sbvh_")
    try:
        sizes = {k: v for k, v in CARD.items() if k != "counts"}
        path = write_instanced_scene(
            tmp, **dict(sizes, counts={m: 1 for m in CARD["counts"]}))
        run_sbvh_cli(path, tmp, card)
        phase("10d --interactive on a pseudo-terminal")
        run_interactive_pty(path, tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return got


DIST_SIZE = (1920, 1080)        # phase 11's cells
DIST_CELLS = (("still_life pt", "pt", 2), ("instanced vcm", "vcm", 1))
DIST_PT_EQUAL = 0.9999            # PT pixels bit-equal to the unsharded film
DIST_VCM_MEAN = 1e-6              # vcm film mean, relative
DIST_VCM_PIXELS = 0.999           # vcm pixels within DIST_VCM_REL
DIST_VCM_REL = 1e-5
DIST_CLI_SIZE = 512
DIST_TIMEOUT = 600                # seconds a rank may wait in a collective


def dist_cells(dev, comm, inst_path):
    """Phase 11's cells on `dev`, across `comm`'s ranks (or unsharded
    without one): {cell: dict(films, ms, launches, collectives)}, the
    films of the timed frames on the host."""
    from imbatracer_torch.frontend.engine import make_frame_fn
    from imbatracer_torch.frontend.renderer import RenderSettings
    from imbatracer_torch.scene.build import build_scene
    from imbatracer_torch.scene.procedural import make_still_life_like

    out = {}
    w, h = DIST_SIZE
    for cell, algo, frames in DIST_CELLS:
        scene, meta = (make_still_life_like(device=dev) if algo == "pt" else
                       build_scene(inst_path, quiet=True, device=dev))
        settings = RenderSettings(width=w, height=h, spp=1, max_path_len=8,
                                  algorithm=algo)
        frame_fn, _ = make_frame_fn(scene, meta, settings, comm=comm)
        frame_fn(0)                       # warm-up
        torch.cuda.synchronize()
        reset_counters()
        if comm is not None:
            comm.reset_counts()
            comm.timed = True
        t0 = time.time()
        films = [frame_fn(f) for f in range(frames)]
        torch.cuda.synchronize()
        ms = (time.time() - t0) * 1000.0 / frames
        got = dict(films=[f.cpu() for f in films], ms=ms,
                   launches=counters())
        if comm is not None:
            got["collectives"] = dict(
                calls=comm.calls / frames, bytes=comm.bytes / frames,
                ms=comm.collective_ms() / frames,
                kinds={k: v / frames for k, v in comm.kinds.items()})
            comm.timed = False
        out[cell] = got
        del scene, frame_fn, films
        torch.cuda.empty_cache()
    return out


def dist_rank(comm, inst_path, out_dir):
    """A spawned rank of phase 11b / 11c: dist_cells across the ranks;
    every rank saves its results to out_dir/rank<r>.pt."""
    got = dist_cells(comm.device, comm, inst_path)
    torch.save(got, os.path.join(out_dir, f"rank{comm.rank}.pt"))


def vcm_parity(a, b):
    """(film mean rel diff, share of pixels within DIST_VCM_REL, max rel)
    of film `a` against `b`: the rule for VCM films of two exact routes
    (the light splat adds with atomics on the card)."""
    a, b = a.double(), b.double()
    mean = abs(float(a.mean() - b.mean())) / max(abs(float(b.mean())), 1e-30)
    rel = ((a - b).abs() / b.abs().clamp(min=1e-3)).amax(dim=1)
    return mean, float((rel <= DIST_VCM_REL).double().mean()), float(
        rel.max())


def hold_dist(label, got, ref, card):
    """Hold one route's cells against the unsharded ones; log and return
    the per-cell parity."""
    for cell, algo, _ in DIST_CELLS:
        g, r = got[cell], ref[cell]
        la = g["launches"]
        need = (("khit",) if algo == "pt" else
                ("closest_hit_instanced", "any_hit_instanced", "merge"))
        if not all(la[k] for k in need) or plain_runs(la):
            raise AssertionError(f"{label} {cell}: the sharded frames did not "
                                 f"run through {need} alone: {la}")
        if algo == "pt":
            same = [float((a == b).all(dim=1).double().mean())
                    for a, b in zip(g["films"], r["films"])]
            ok = min(same) >= DIST_PT_EQUAL
            parity = (f"pixels bit-equal {', '.join(f'{x:.6f}' for x in same)}"
                      f" (need >= {DIST_PT_EQUAL})")
        else:
            mean, within, worst = vcm_parity(g["films"][0], r["films"][0])
            ok = mean <= DIST_VCM_MEAN and within >= DIST_VCM_PIXELS
            parity = (f"mean rel diff {mean:.3e} (need <= {DIST_VCM_MEAN}), "
                      f"pixels within {DIST_VCM_REL} rel {within:.6f} (need "
                      f">= {DIST_VCM_PIXELS}), max rel {worst:.3e}")
        c = g.get("collectives", {})
        log(f"[dist] {label} {cell} {DIST_SIZE[0]}x{DIST_SIZE[1]}: {parity}; "
            f"{g['ms']:.1f} ms/frame sharded, {r['ms']:.1f} unsharded; "
            f"collectives a frame {c.get('calls')} ({c.get('kinds')}), "
            f"{c.get('bytes', 0) / 1e6:.3f} MB, {c.get('ms', 0.0):.3f} ms; "
            f"launches a frame a rank {per_frame(la, cell)} [{card}]")
        if not ok:
            raise AssertionError(f"{label} {cell}: the sharded film disagrees "
                                 f"with the unsharded one")


def per_frame(launches, cell):
    frames = dict((c, f) for c, _, f in DIST_CELLS)[cell]
    keys = ("closest_hit", "any_hit", "closest_hit_instanced",
            "any_hit_instanced", "khit", "merge", "merge_prep")
    return {k: launches[k] / frames for k in keys if launches.get(k)}


def spawn_dist(label, world, backend, inst_path, ref, card):
    """Phase 11b / 11c: dist_rank on `world` spawned ranks; holds rank 0's
    cells against `ref` and every rank's films against rank 0's."""
    from imbatracer_torch.parallel import launch

    out_dir = tempfile.mkdtemp(prefix="imba_dist_")
    try:
        t0 = time.time()
        launch.spawn(dist_rank, world, "cuda", backend,
                     args=(inst_path, out_dir), timeout=DIST_TIMEOUT)
        took = time.time() - t0
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"))
                 for r in range(world)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    for r, got in enumerate(ranks[1:], 1):
        for cell, _, _ in DIST_CELLS:
            if not all(torch.equal(a, b) for a, b in
                       zip(got[cell]["films"], ranks[0][cell]["films"])):
                raise AssertionError(f"{label}: rank {r}'s {cell} film is not "
                                     f"rank 0's")
    log(f"[dist] {label}: backend {backend}, world {world}, cards "
        f"{torch.cuda.device_count()}, spawned and joined in {took:.1f} s; "
        f"every rank's films equal rank 0's")
    hold_dist(label, ranks[0], ref, card)
    return ranks[0]


def dist_cli(inst_path, tmp, card):
    """Phase 11d: the CLI on two ranks over gloo against one process."""
    from imbatracer_torch.frontend import cli
    from imbatracer_torch.io.image import load_png
    from imbatracer_torch.parallel import launch

    n = str(DIST_CLI_SIZE)
    argv = ["-a", "pt", "-w", n, "-h2", n, "-s", "2", "-q"]
    one, two = os.path.join(tmp, "one.png"), os.path.join(tmp, "two.png")
    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main([inst_path, one] + argv)
    t_one = time.time() - t0
    t0 = time.time()
    launch.spawn(cli.render_rank, 2, "cuda", "gloo",
                 args=([inst_path, two] + argv,), timeout=DIST_TIMEOUT)
    t_two = time.time() - t0
    with open(one, "rb") as f1, open(two, "rb") as f2:
        same_bytes = f1.read() == f2.read()
    equal = float((load_png(one) == load_png(two)).all(axis=-1).mean())
    log(f"[dist] 11d the CLI {' '.join(argv)} <instances.scene>: one process "
        f"{t_one:.1f} s, two ranks over gloo on the card {t_two:.1f} s "
        f"(scene builds included); PNGs equal byte for byte: {same_bytes}; "
        f"8-bit pixels equal {equal:.6f} (need byte equality or >= "
        f"{DIST_PT_EQUAL}) [{card}]")
    if not (same_bytes or equal >= DIST_PT_EQUAL):
        raise AssertionError("11d: the CLI's PNG across two ranks differs "
                             "from the one-process PNG")


def multi_rank_phase(dev, card):
    """Phase 11: the sharded frames (parallel/) on the card."""
    from imbatracer_torch.parallel import launch
    from imbatracer_torch.parallel.comm import Comm
    from imbatracer_torch.scene.generate import CARD, write_instanced_scene

    phase("11a multi-rank: NCCL at world size 1")
    tmp = tempfile.mkdtemp(prefix="imba_dist_scene_")
    try:
        inst_path = write_instanced_scene(tmp, **CARD)
        ref = dist_cells(dev, None, inst_path)
        comm = Comm.init("nccl", launch.ADDR, launch.free_port(), 0, 1, dev,
                         timeout=DIST_TIMEOUT)
        try:
            world1 = dist_cells(dev, comm, inst_path)
        finally:
            comm.close()
        log(f"[dist] 11a: backend nccl, world 1, cards "
            f"{torch.cuda.device_count()}")
        hold_dist("11a nccl world 1", world1, ref, card)
        torch.cuda.empty_cache()

        phase("11b multi-rank: two ranks sharing the card over gloo")
        spawn_dist("11b gloo world 2 (one card, a correctness run)", 2,
                   "gloo", inst_path, ref, card)

        phase("11c multi-rank: one NCCL rank a card")
        cards = torch.cuda.device_count()
        if cards >= 2:
            got = spawn_dist(f"11c nccl world {cards}", cards, "nccl",
                             inst_path, ref, card)
            for cell, _, _ in DIST_CELLS:
                log(f"[dist] 11c {cell}: {got[cell]['ms']:.1f} ms/frame on "
                    f"{cards} cards, {world1[cell]['ms']:.1f} at world 1: "
                    f"speed-up {world1[cell]['ms'] / got[cell]['ms']:.3f}x "
                    f"[{card}]")
        else:
            log(f"[dist] 11c did not run: the machine has {cards} card, and "
                f"NCCL takes one card a rank")

        phase("11d multi-rank: the CLI on two ranks")
        dist_cli(inst_path, tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# Phase 12's cells: (cell, scene, algorithm, width, height, max_len, timed
# frames a route).
COMPACT_CELLS = (
    ("still_life pt", "still_life", "pt", 1920, 1080, 8, 3),
    ("cornell pt", "cornell", "pt", 1024, 1024, 10, 3),
    ("big_4000 pt", "big_4000", "pt", 1024, 1024, 6, 3),
    ("still_life vcm", "still_life", "vcm", 1920, 1080, 8, 2),
    ("instanced vcm", "instanced", "vcm", 1920, 1080, 8, 2),
)
COMPACT_PT_EQUAL = 0.9999     # PT pixels bit-equal across the two routes
COMPACT_VCM_MEAN = 1e-6       # vcm film means, relative
COMPACT_RAYS_REL = 1e-4       # traced rays a frame, relative
ROUTE_KEYS = ("closest_hit", "any_hit", "closest_hit_instanced",
              "any_hit_instanced", "khit", "merge")


def pt_route_fn(scene, meta, width, height, max_len, route):
    """f(frame, x) -> (film, traced rays, route stats) of one PT frame at
    spp 1 through render_pt_frame with `route`=x ("compact" or "graph";
    None: the default), and the arguments make_frame_fn gives it; the
    camera is f.cam."""
    from imbatracer_torch.frontend.renderer import (RenderSettings,
                                                    camera_for_scene)
    from imbatracer_torch.render.integrators.pt import render_pt_frame

    settings = RenderSettings(width=width, height=height, spp=1,
                              max_path_len=max_len)
    cam = camera_for_scene(meta, settings, scene.device)

    def fn(frame, x):
        stats = {}
        film, rays = render_pt_frame(
            scene, cam, frame, width, height, max_len=max_len,
            has_masks=meta.has_masks, has_bump=meta.has_bump,
            with_stats=True, stats=stats, **{route: x})
        return film, rays, stats
    fn.cam = cam
    return fn


def route_fn(scene, meta, algo, width, height, max_len, switch="compact"):
    """f(frame, x) -> (film, traced rays, route counts) of one frame of a
    phase-12 or phase-14 cell through the integrators with `switch`=x
    ("compact" or "graph"; None: the default), with the arguments
    make_frame_fn gives them (vcm: VCM_LPC light paths on the still life
    at 1080p, else the default count; `algo` a CLI name, vcm_pt the
    template's PT).  PT's rays are the frame's closest-hit and shadow
    rays, the family's those of its camera pass (none for lt)."""
    from imbatracer_torch.frontend.engine import (ALGO_MAP,
                                                  estimate_pixel_size)
    from imbatracer_torch.frontend.renderer import (RenderSettings,
                                                    camera_for_scene)
    from imbatracer_torch.render.integrators.vcm import render_vcm_frame

    if algo == "pt":
        return pt_route_fn(scene, meta, width, height, max_len, switch)
    settings = RenderSettings(width=width, height=height, spp=1,
                              max_path_len=max_len, algorithm=algo)
    cam = camera_for_scene(meta, settings, scene.device)
    lpc = (VCM_LPC if (width, height) == (1920, 1080)
           and not scene.bvh.two_level
           else settings.resolved_light_path_count())
    radius = estimate_pixel_size(scene, cam, meta) * settings.radius_factor
    kinds = tuple(sorted(set(scene.materials.kind.tolist())))

    def fn(frame, x):
        route = {}
        film = render_vcm_frame(
            scene, cam, frame, radius, algo=ALGO_MAP[algo], width=width,
            height=height, max_len=max_len, light_path_count=lpc,
            has_masks=meta.has_masks, has_bump=meta.has_bump,
            mat_kinds=kinds, stats={"route": route}, **{switch: x})
        return film, route.get("camera_rays", 0), route
    return fn


def run_route(fn, frame, compact):
    """One frame of one route (`compact`: fn's second argument), the
    launch counters and the peak memory set just before it and read just
    after."""
    torch.cuda.synchronize()
    reset_counters()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.time()
    film, rays, route = fn(frame, compact)
    torch.cuda.synchronize()
    ms = (time.time() - t0) * 1000.0
    return dict(film=film, rays=int(rays), route=route, ms=ms,
                launches=counters(), held=held,
                peak=torch.cuda.max_memory_allocated())


def hold_routes(cell, algo, compacted, banded, card):
    """Log one phase-12 cell's two routes over the same frames and hold
    them against each other: the default must have compacted, PT films
    bit-equal on COMPACT_PT_EQUAL of the pixels, vcm film means within
    COMPACT_VCM_MEAN (the light splat adds with atomics), traced rays
    within COMPACT_RAYS_REL, no plain version run."""
    n = len(compacted)
    cr = [r["route"] for r in compacted]
    if any("alive" not in r for r in cr):
        raise AssertionError(f"{cell}: the default route did not compact")
    for r in compacted + banded:
        if not bool(torch.isfinite(r["film"]).all()) or not float(
                r["film"].mean()) > 0.0 or plain_runs(r["launches"]):
            raise AssertionError(f"{cell}: a film is not finite with a "
                                 f"positive mean, or a plain version ran")
    parity, ok = [], True
    for c, b in zip(compacted, banded):
        if algo == "pt":
            x = float((c["film"] == b["film"]).all(dim=1).double().mean())
            ok = ok and x >= COMPACT_PT_EQUAL
        else:
            x = abs(float(c["film"].double().mean()
                          - b["film"].double().mean())) / float(
                b["film"].double().mean())
            ok = ok and x <= COMPACT_VCM_MEAN
        parity.append(f"{x:.6g}")
        ok = ok and abs(c["rays"] - b["rays"]) <= COMPACT_RAYS_REL * b["rays"]
    ms = lambda runs: ", ".join(f"{r['ms']:.1f}" for r in runs)
    mean_ms = lambda runs: sum(r["ms"] for r in runs) / n
    launches = lambda runs: {k: sum(r["launches"][k] for r in runs) / n
                             for k in ROUTE_KEYS}
    peak = lambda runs: max(r["peak"] for r in runs) / 2**20
    alive = ", ".join(f"{r['alive'] / r['lanes']:.4f}" for r in cr)
    log(f"[compact] {cell}: alive after the phase-1 bounces {alive} of "
        f"{cr[0]['lanes']} lanes; phase-2 bands "
        f"{[r['phase2_bands'] for r in cr]}; band-bounces a frame compacted "
        f"{[r['band_bounces'] for r in cr]}, banded "
        f"{[r['route']['band_bounces'] for r in banded]} [{card}]")
    log(f"[compact] {cell}: ms/frame compacted {mean_ms(compacted):.1f} "
        f"({ms(compacted)}), banded {mean_ms(banded):.1f} ({ms(banded)}), "
        f"{n} frames each, interleaved [{card}]")
    log(f"[compact] {cell}: launches a frame compacted "
        f"{launches(compacted)}, banded {launches(banded)}; traced rays a "
        f"frame compacted {[r['rays'] for r in compacted]}, banded "
        f"{[r['rays'] for r in banded]}")
    log(f"[compact] {cell}: peak memory compacted {peak(compacted):.1f} "
        f"MiB, banded {peak(banded):.1f} MiB, of which "
        f"{compacted[0]['held'] / 2**20:.1f} MiB was held before the frame;"
        f" film parity "
        + (f"pixels bit-equal {', '.join(parity)} (need >= "
           f"{COMPACT_PT_EQUAL})" if algo == "pt" else
           f"mean rel diff {', '.join(parity)} (need <= "
           f"{COMPACT_VCM_MEAN})")
        + f", rays within {COMPACT_RAYS_REL} rel [{card}]")
    if not ok:
        raise AssertionError(f"{cell}: the compacted and banded routes "
                             f"disagree")


def compaction_phase(dev, card, scenes):
    """Phase 12: each cell of COMPACT_CELLS through the default route
    (compacted on the card) and the banded one, a warm-up frame of each
    (the captures of their graphs), then the same frame numbers
    interleaved."""
    from imbatracer_torch.scene.build import build_scene
    from imbatracer_torch.scene.generate import CARD, write_instanced_scene

    phase("12 compaction: the compacted and banded routes")
    tmp = tempfile.mkdtemp(prefix="imba_compact_")
    try:
        scenes = dict(scenes, instanced=build_scene(
            write_instanced_scene(tmp, **CARD), quiet=True, device=dev))
        for cell, key, algo, w, h, max_len, frames in COMPACT_CELLS:
            fn = route_fn(*scenes[key], algo, w, h, max_len)
            fn(0, None)
            fn(0, False)
            runs = {None: [], False: []}
            for f in range(1, frames + 1):
                for compact in ((None, False) if f % 2 else (False, None)):
                    runs[compact].append(run_route(fn, f, compact))
            hold_routes(f"{cell} {w}x{h} max_len {max_len}", algo,
                        runs[None], runs[False], card)
            del fn, runs
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


GRAPH_CELLS = (
    ("still_life pt", "still_life", 1920, 1080, 8),
    ("still_life sbvh pt", "still_life_sbvh", 1920, 1080, 8),
    ("cornell pt", "cornell", 1024, 1024, 10),
    ("big_4000 pt", "big_4000", 1024, 1024, 6),
    ("instanced pt", "instanced", 1920, 1080, 8),
)
GRAPH_FRAMES = 2              # timed frames of each route, interleaved
GRAPH_PT_EQUAL = 0.9999       # pixels bit-equal across the two routes
COST_FRAMES = 3               # replayed frames timed a re-trace variant


def trace_route(fn, frame, graph):
    """One frame of fn traced with torch.profiler: (wall ms, device busy
    ms, kernels, cudaLaunchKernel calls, cudaGraphLaunch calls)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.time()
        fn(frame, graph)
        torch.cuda.synchronize()
        wall = 1e3 * (time.time() - t0)
    dev, host = trace_totals(prof.profiler.kineto_results.events())
    calls = lambda pre: sum(n for name, (_, n) in host.items()
                            if name.startswith(pre))
    return dict(wall=wall, busy=sum(ns for ns, _ in dev.values()) / 1e6,
                kernels=sum(n for _, n in dev.values()),
                launch_kernel=calls("cudaLaunchKernel"),
                graph_launch=calls("cudaGraphLaunch"))


def loop_cost(cell, scene, meta, fn, size, max_len, frame, busy_ms, card):
    """What the masked re-trace's while loops cost a graphed frame: frame
    `frame` through the captured bounce with the cap on the rounds at 1,
    so that every loop's body is skipped (its WHILE node and the kernel
    that sets its flag still run; the lanes that needed more rounds stay
    unresolved and the film is not used), and as the route runs it, each
    from a SceneGraphs of its own captured in a warm-up frame and timed
    over COST_FRAMES replayed frames (CUDA events, no rerun).  The
    difference is printed against the graphed frame's device busy
    time."""
    from imbatracer_torch.render import graphs
    from imbatracer_torch.render import traverse as tt
    from imbatracer_torch.render.integrators import pt

    w, h = size
    band = pt.BAND_RAYS
    bands = [(s0, min(band, w * h - s0)) for s0 in range(0, w * h, band)]
    compact = pt.use_compact(scene.device, len(bands), max_len)
    name = ("RETRACE_MAX_ROUNDS" if scene.bvh.two_level
            else "KHIT_MAX_ROUNDS")
    cap = getattr(tt, name)
    slot = graphs._slot(tt.MASK_STATS, "rounds")
    ms, passes = {}, {}
    for label, rounds in (("rounds skipped", 1), ("as run", cap)):
        setattr(tt, name, rounds)
        try:
            sg = graphs.SceneGraphs(scene.device)
            run = partial(pt._bands, scene, fn.cam, frame, bands, w, h, 1,
                          max_len, meta.has_masks, meta.has_bump, compact,
                          None, sg)
            run()
            sg.counts.zero_()
            ms[label] = cuda_ms(run, COST_FRAMES, warm=False)
            passes[label] = sg.counts.tolist()[slot] / COST_FRAMES
        finally:
            setattr(tt, name, cap)
        del run, sg
        torch.cuda.empty_cache()
    extra = ms["as run"] - ms["rounds skipped"]
    log(f"[graphs] {cell}: graphed frame {frame} (CUDA events, "
        f"{COST_FRAMES} frames): rounds past the first skipped "
        f"{ms['rounds skipped']:.1f} ms, as run {ms['as run']:.1f} ms "
        f"({passes['as run']:.1f} loop passes a frame, cap {cap}); the "
        f"loops' rounds {extra:.1f} ms a frame, {100.0 * extra / busy_ms:.1f}"
        f"% of the graphed frame's device busy {busy_ms:.1f} ms [{card}]")


TRAVERSAL_KEYS = ROUTE_KEYS[:5]


def pool_mib(scene):
    """(MiB, MiB) of card memory the scene's graphs hold: their pool, and
    the pools of their conditional bodies (None where the allocator's
    snapshot names no pools)."""
    from imbatracer_torch.render import graphs

    sg = graphs.for_scene(scene)
    segs = torch.cuda.memory_snapshot()
    if not segs or "segment_pool_id" not in segs[0]:
        return None, None
    mib = lambda ids: sum(s["total_size"] for s in segs
                          if tuple(s["segment_pool_id"]) in ids) / 2**20
    return (mib({tuple(sg.pool)}),
            mib({tuple(p) for _, p in sg.bodies}))


def warm_captures(fn, scene):
    """The warm-up frame of the default route (its captures) with the
    counters set to 0 just before it and read just after: (captures,
    seconds they took, pool MiB, body pools MiB)."""
    torch.cuda.synchronize()
    reset_counters()
    fn(0, None)
    torch.cuda.synchronize()
    got = counters()
    return dict(captures=got["graph_captures"],
                seconds=got["graph_capture_s"], pools=pool_mib(scene))


def hold_rounds(tag, cell, runs, two_level, warm, card):
    """Log a masked cell's re-trace, graphed against eager over the same
    frames: rounds a non-empty masked dispatch (mean and most; the
    graphed route's from the device counts) against the cap, the
    traversal launches a frame, the lanes past the slots and the cap,
    and the warm-up frame's captures, their seconds and pool memory.
    Holds the graphed launches to the eager ones plus at most one first
    round for each empty dispatch, with no lane past the slots or the
    cap and no frame rendered again."""
    from imbatracer_torch.render import traverse as tt

    g, e = runs[None], runs[False]
    tot = lambda rs, k: sum(r["launches"][k] for r in rs)
    n = len(g)
    if not tot(e, "dispatches"):
        return
    cap, div = tt.retrace_plan(two_level)
    mean_g = (tot(g, "rounds") - tot(g, "empty")) / max(
        tot(g, "dispatches") - tot(g, "empty"), 1)
    mean_e = tot(e, "rounds") / max(tot(e, "dispatches") - tot(e, "empty"),
                                    1)
    most = lambda rs, k: max(r["launches"][k] for r in rs)
    delta = {k: (tot(g, k) - tot(e, k)) / n for k in TRAVERSAL_KEYS}
    empty = tot(g, "empty") / n
    pools = warm["pools"]
    log(f"[{tag}] {cell}: rounds a non-empty masked dispatch graphed mean "
        f"{mean_g:.6f}, most {most(g, 'max_rounds')} (device counts), "
        f"eager mean {mean_e:.6f}, most {most(e, 'max_rounds')}; cap "
        f"{cap}, slot share 1/{div}, lanes carried past the first at most "
        f"{most(e, 'max_lanes')}; lanes past the slots "
        f"{tot(g, 'dropped')}, at the cap {tot(g, 'capped')}")
    log(f"[{tag}] {cell}: traversal launches a frame graphed "
        f"{ {k: tot(g, k) / n for k in TRAVERSAL_KEYS} }, eager "
        f"{ {k: tot(e, k) / n for k in TRAVERSAL_KEYS} }; graphed - eager "
        f"{delta}, empty masked dispatches {empty} a frame; masked "
        f"dispatches {tot(g, 'dispatches') / n} a frame [{card}]")
    took = (f"{warm['captures']} captures in {warm['seconds']:.3f} s "
            f"(warm-up runs included)" if warm["captures"] else
            "no capture (the scene's graphs were captured in an earlier "
            "phase)")
    log(f"[{tag}] {cell}: warm-up frame: {took}; the scene's graph pool "
        + ("not measured" if pools[0] is None else
           f"{pools[0]:.1f} MiB, conditional bodies' pools "
           f"{pools[1]:.1f} MiB") + f" [{card}]")
    if (any(v < 0 for v in delta.values()) or sum(delta.values()) > empty
            or tot(g, "dropped") or tot(g, "capped")
            or tot(g, "graph_reruns")):
        raise AssertionError(
            f"{cell}: the graphed re-trace ran other rounds than the eager "
            f"one, or {tot(g, 'graph_reruns')} frames were rendered again "
            f"({tot(g, 'dropped')} lanes past the slots, "
            f"{tot(g, 'capped')} at the cap of {cap} rounds)")


def hold_graph_cell(cell, runs, traced, card):
    """Log one phase-13 cell's two routes over the same frames and hold
    them against each other: the default must have replayed captured
    bounces (no capture and no rerun in the timed frames), films
    bit-equal on GRAPH_PT_EQUAL of the pixels, traced rays equal, no
    plain version run.  The masked re-trace's rounds: hold_rounds."""
    g, e = runs[None], runs[False]
    ok = all(r["launches"]["graph_replays"] > 0
             and r["launches"]["graph_captures"] == 0
             and r["launches"]["graph_reruns"] == 0 for r in g)
    ok = ok and not any(r["launches"]["graph_replays"] for r in e)
    parity = []
    for a, b in zip(g, e):
        x = float((a["film"] == b["film"]).all(dim=1).double().mean())
        parity.append(f"{x:.6g}")
        ok = ok and x >= GRAPH_PT_EQUAL and a["rays"] == b["rays"]
    for r in g + e:
        ok = ok and bool(torch.isfinite(r["film"]).all()) and not plain_runs(
            r["launches"])
    n = len(g)
    mean_ms = lambda rs: sum(r["ms"] for r in rs) / n
    each = lambda rs: ", ".join(f"{r['ms']:.1f}" for r in rs)
    keys = ROUTE_KEYS[:5] + ("graph_captures", "graph_replays",
                             "graph_reruns")
    per = lambda rs: {k: sum(r["launches"][k] for r in rs) / n
                      for k in keys}
    peak = lambda rs: max(r["peak"] for r in rs) / 2**20
    log(f"[graphs] {cell}: ms/frame graphed {mean_ms(g):.1f} ({each(g)}), "
        f"eager {mean_ms(e):.1f} ({each(e)}), {n} frames each, "
        f"interleaved; band-bounces a frame "
        f"{[r['route']['band_bounces'] for r in g]} [{card}]")
    log(f"[graphs] {cell}: a frame graphed {per(g)}, eager {per(e)}")
    log(f"[graphs] {cell}: peak memory graphed {peak(g):.1f} MiB, eager "
        f"{peak(e):.1f} MiB, of which {g[0]['held'] / 2**20:.1f} MiB was "
        f"held before the frame; pixels bit-equal {', '.join(parity)} (need "
        f">= {GRAPH_PT_EQUAL}), traced rays graphed "
        f"{[r['rays'] for r in g]}, eager {[r['rays'] for r in e]} [{card}]")
    for name, t in (("graphed", traced[None]), ("eager", traced[False])):
        log(f"[graphs] {cell}: one traced frame {name}: wall "
            f"{t['wall']:.1f} ms, device busy {t['busy']:.1f} ms (idle "
            f"{100.0 * (1.0 - t['busy'] / t['wall']):.1f}%), "
            f"{t['kernels']} kernels, {t['launch_kernel']} cudaLaunchKernel"
            f", {t['graph_launch']} cudaGraphLaunch [{card}]")
    if not ok:
        raise AssertionError(f"{cell}: the graphed and eager routes "
                             f"disagree, or the default did not replay")


def graph_phase(dev, card, scenes):
    """Phase 13: each cell of GRAPH_CELLS through the default route
    (CUDA graphs on the card) and graph=False, a warm-up frame of each,
    then the same frame numbers interleaved, then one traced frame of
    each; the re-trace's rounds held (hold_rounds) and its loops costed
    on the masked cells."""
    from imbatracer_torch.scene.build import build_scene
    from imbatracer_torch.scene.generate import CARD, write_instanced_scene

    phase("13 CUDA graphs: the graphed and eager PT routes")
    tmp = tempfile.mkdtemp(prefix="imba_graphs_")
    try:
        split, split_meta, _ = split_still_life(dev)
        scenes = dict(scenes, still_life_sbvh=(split, split_meta),
                      instanced=build_scene(write_instanced_scene(tmp, **CARD),
                                            quiet=True, device=dev))
        for cell, key, w, h, max_len in GRAPH_CELLS:
            scene, meta = scenes[key]
            label = f"{cell} {w}x{h} max_len {max_len}"
            fn = pt_route_fn(scene, meta, w, h, max_len, "graph")
            warm = warm_captures(fn, scene)
            fn(0, False)
            runs = {None: [], False: []}
            for f in range(1, GRAPH_FRAMES + 1):
                for graph in ((None, False) if f % 2 else (False, None)):
                    runs[graph].append(run_route(fn, f, graph))
            traced = {g: trace_route(fn, GRAPH_FRAMES + 1, g)
                      for g in (None, False)}
            hold_graph_cell(label, runs, traced, card)
            hold_rounds("graphs", label, runs, scene.bvh.two_level, warm,
                        card)
            if meta.has_masks and key != "still_life_sbvh":
                loop_cost(label, scene, meta, fn, (w, h), max_len, 1,
                          traced[None]["busy"], card)
            del fn, runs
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# Phase 14's cells: (cell, scene, algorithm, width, height, max_len, timed
# frames a route, traced).
VCM_GRAPH_CELLS = (
    ("still_life vcm", "still_life", "vcm", 1920, 1080, 8, GRAPH_FRAMES,
     True),
    ("instanced vcm", "instanced", "vcm", 1920, 1080, 8, GRAPH_FRAMES, True),
    ("still_life bpt", "still_life", "bpt", *FAMILY_SIZE, 8, 1, False),
    ("still_life ppm", "still_life", "ppm", *FAMILY_SIZE, 8, 1, False),
    ("still_life lt", "still_life", "lt", *FAMILY_SIZE, 8, 1, False),
    ("still_life vcm_pt", "still_life", "vcm_pt", *FAMILY_SIZE, 8, 1,
     False),
)
VCM_LAUNCH_KEYS = ("closest_hit", "any_hit", "closest_hit_instanced",
                   "any_hit_instanced", "khit", "merge", "merge_prep",
                   "graph_captures", "graph_replays", "graph_reruns")


def hold_vcm_graph_cell(cell, runs, traced, card):
    """Log one phase-14 cell's two routes over the same frames and hold
    them against each other: the default must have replayed captured
    graphs with no capture and no rerun in the timed frames, film means
    within DIST_VCM_MEAN and DIST_VCM_PIXELS of the pixels within
    DIST_VCM_REL, traced rays equal, no plain version run."""
    g, e = runs[None], runs[False]
    ok = all(r["launches"]["graph_replays"] > 0
             and r["launches"]["graph_captures"] == 0
             and r["launches"]["graph_reruns"] == 0 for r in g)
    ok = ok and not any(r["launches"]["graph_replays"] for r in e)
    parity = []
    for a, b in zip(g, e):
        mean, within, worst = vcm_parity(a["film"], b["film"])
        parity.append(f"mean rel {mean:.3e}, pixels within {DIST_VCM_REL} "
                      f"{within:.6f}, max rel {worst:.3e}")
        ok = (ok and mean <= DIST_VCM_MEAN and within >= DIST_VCM_PIXELS
              and a["rays"] == b["rays"])
    for r in g + e:
        ok = (ok and bool(torch.isfinite(r["film"]).all())
              and float(r["film"].mean()) > 0.0
              and not plain_runs(r["launches"]))
    n = len(g)
    mean_ms = lambda rs: sum(r["ms"] for r in rs) / n
    each = lambda rs: ", ".join(f"{r['ms']:.1f}" for r in rs)
    per = lambda rs: {k: sum(r["launches"][k] for r in rs) / n
                      for k in VCM_LAUNCH_KEYS}
    peak = lambda rs: max(r["peak"] for r in rs) / 2**20
    log(f"[vcmgraphs] {cell}: ms/frame graphed {mean_ms(g):.1f} "
        f"({each(g)}), eager {mean_ms(e):.1f} ({each(e)}), {n} frames "
        f"each, interleaved [{card}]")
    log(f"[vcmgraphs] {cell}: a frame graphed {per(g)}, eager {per(e)}")
    log(f"[vcmgraphs] {cell}: peak memory graphed {peak(g):.1f} MiB, eager "
        f"{peak(e):.1f} MiB, of which {g[0]['held'] / 2**20:.1f} MiB was "
        f"held before the frame; films {'; '.join(parity)} (need mean <= "
        f"{DIST_VCM_MEAN}, pixels >= {DIST_VCM_PIXELS}); traced rays "
        f"graphed {[r['rays'] for r in g]}, eager {[r['rays'] for r in e]} "
        f"[{card}]")
    for name, t in (("graphed", traced.get(None)), ("eager",
                                                    traced.get(False))):
        if t is not None:
            log(f"[vcmgraphs] {cell}: one traced frame {name}: wall "
                f"{t['wall']:.1f} ms, device busy {t['busy']:.1f} ms (idle "
                f"{100.0 * (1.0 - t['busy'] / t['wall']):.1f}%), "
                f"{t['kernels']} kernels, {t['launch_kernel']} "
                f"cudaLaunchKernel, {t['graph_launch']} cudaGraphLaunch "
                f"[{card}]")
    if not ok:
        raise AssertionError(f"{cell}: the graphed and eager routes "
                             f"disagree, or the default did not replay")


def vcm_graph_phase(dev, card, scenes):
    """Phase 14: each cell of VCM_GRAPH_CELLS through render_vcm_frame on
    the default route (CUDA graphs on the card) and graph=False, a
    warm-up frame of each (the captures), then the same frame numbers
    interleaved, then, on the 1080p cells, one traced frame of each; the
    re-trace's rounds held (hold_rounds)."""
    from imbatracer_torch.scene.build import build_scene
    from imbatracer_torch.scene.generate import CARD, write_instanced_scene
    from imbatracer_torch.scene.procedural import make_still_life_like

    phase("14 VCM graphs: the graphed and eager VCM-family routes")
    tmp = tempfile.mkdtemp(prefix="imba_vcm_graphs_")
    try:
        # Both scenes built again, so that every graph traced here is
        # captured in this phase: tracing a graphed still-life vcm frame
        # whose graphs phase 7 had captured and traced crashed the
        # process inside the replay (PERF.md section 7).
        scenes = dict(scenes, still_life=make_still_life_like(device=dev),
                      instanced=build_scene(write_instanced_scene(tmp, **CARD),
                                            quiet=True, device=dev))
        for cell, key, algo, w, h, max_len, frames, trace in \
                VCM_GRAPH_CELLS:
            label = f"{cell} {w}x{h} max_len {max_len}"
            fn = route_fn(*scenes[key], algo, w, h, max_len, "graph")
            warm = warm_captures(fn, scenes[key][0])
            fn(0, False)
            log(f"[vcmgraphs] {label}: warm-up frames done")
            runs = {None: [], False: []}
            for f in range(1, frames + 1):
                for graph in ((None, False) if f % 2 else (False, None)):
                    runs[graph].append(run_route(fn, f, graph))
            log(f"[vcmgraphs] {label}: timed frames done")
            traced = ({g: trace_route(fn, frames + 1, g)
                       for g in (None, False)} if trace else {})
            hold_vcm_graph_cell(label, runs, traced, card)
            hold_rounds("vcmgraphs", label, runs,
                        scenes[key][0].bvh.two_level, warm, card)
            del fn, runs
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# Phase 15: the measuring entry points (imbatracer_torch.bench and
# imbatracer_torch.tools.run_bench).
ENTRY_OUT = os.path.join(ROOT, "results", "phase15")
CURVE_SECONDS = 20.0          # 15b: the still-life curve's budget
CURVE_FRAMES = 21             # JAX's tracked curve holds frames 1-21
CURVE_JAX = os.path.join(ROOT, "results", "curves_r5",
                         "curve_still_life_pt_1080p.csv")
PROXY_SECONDS = 10.0          # 15c and 15d: budget a run
PROXY_CONFIGS = (             # 15c: BASELINE configs 1, 3, 4 and 5
    ("still_life_pt_512_16spp", ()),
    ("still_life_bpt_1080p", ()),
    ("still_life_ppm_1M", ("merge",)),
    ("instances_vcm_1080p", ("closest_hit_instanced", "any_hit_instanced",
                             "merge")),
)


def nonzero(got):
    return {k: v for k, v in got.items() if v}


def read_csv(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def bench_entry(card, cornell_mrays, sl_ms):
    """15a: bench.main() in this process, stdout captured, the launch
    counters and graph counts zeroed just before and read just after;
    the card's clock, power and temperature sampled beside it."""
    from imbatracer_torch import bench
    from imbatracer_torch.device import smi_query

    def gpu_state():
        return smi_query("cuda", "clocks.sm,power.draw,temperature.gpu")

    buf = io.StringIO()
    state = gpu_state()
    reset_counters()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        rc = bench.main(["--out-dir", ENTRY_OUT])
    got = counters()
    log(f"[entry] card before / after the bench (SM clock, power, "
        f"temperature): {state} / {gpu_state()}")
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        log(f"[entry] bench | {line}")
    head = json.loads(lines[-1])
    res = {}
    for key in ("big", "1080p"):
        with open(os.path.join(ENTRY_OUT, f"torch_bench_{key}.json")) as f:
            res[key] = json.load(f)
    log(f"[entry] bench in {time.time() - t0:.1f} s, rc {rc}; launches "
        f"{nonzero(got)}")
    log(f"[entry] bench headline {head['value']} {head['unit']} (20 frames)"
        f" beside phase 5b's cornell 1024^2 {cornell_mrays:.2f} Mrays/s (3 "
        f"frames); still life {res['1080p']['value']} ms/frame (3 frames) "
        f"beside phase 5c's {sl_ms:.1f} ms/frame (8 frames); big_4000 "
        f"{res['big']['value']} ms/frame [{card}]")
    if (rc != 0 or head.get("metric") != "pt_megastep_throughput_cornell_1024"
            or not head.get("value", 0) > 0 or head.get("unit") != "Mrays/s"
            or "card" not in head or "vs_baseline" in head):
        raise AssertionError(f"bench: unexpected last line {lines[-1]!r}")
    if not all(r["value"] > 0 for r in res.values()):
        raise AssertionError(f"bench: a secondary is not positive: {res}")
    if (not got["closest_hit"] or not got["any_hit"] or not got["khit"]
            or plain_runs(got) or got["graph_reruns"]):
        raise AssertionError("bench: the stream and khit kernels did not "
                             "both launch, a plain version ran, or a frame "
                             "was rendered again")


def curve_entry(card):
    """15b: run_one's curve mode on config 2, a sample every frame, held
    frame by frame against the JAX renderer's tracked curve (its frame and
    PSNR columns only)."""
    from imbatracer_torch.tools import run_bench as rb

    run = {r[0]: r for r in rb.PROXY_RUNS}["still_life_pt_1080p"]
    path = os.path.join(ENTRY_OUT, "curve_still_life_pt_1080p.csv")
    reset_counters()
    row = rb.run_one(*run, seconds=CURVE_SECONDS, curve_path=path,
                     curve_every=0.0)
    got = counters()
    ours = {int(r["frames"]): float(r["psnr"]) for r in read_csv(path)}
    ref = {int(r["frames"]): float(r["psnr"]) for r in read_csv(CURVE_JAX)}
    diffs = {f: ours[f] - ref[f] for f in range(1, CURVE_FRAMES + 1)
             if f in ours}
    worst = max(abs(d) for d in diffs.values()) if diffs else float("nan")
    log(f"[entry] curve {run[0]}: {row}; launches {nonzero(got)}")
    log(f"[entry] curve PSNR port / JAX at frames 1-{CURVE_FRAMES}: "
        + ", ".join(f"{f}: {ours[f]:.2f}/{ref[f]:.2f}" for f in diffs)
        + f"; largest difference {worst:.3f} dB [{card}]")
    if len(diffs) < CURVE_FRAMES or not worst <= PSNR_TOL:
        raise AssertionError(f"curve: {len(diffs)} of frames 1-{CURVE_FRAMES}"
                             f" sampled, largest PSNR difference {worst} dB "
                             f"(bound {PSNR_TOL})")
    if not got["khit"] or plain_runs(got):
        raise AssertionError("curve: khit did not launch or a plain version "
                             "ran")


def proxy_entry(card):
    """15c: configs 1, 3, 4 and 5 through run_bench.main(), each with the
    counters zeroed just before and read just after; 15d: the instanced
    self-check."""
    from imbatracer_torch.tools import run_bench as rb

    for name, kernels in PROXY_CONFIGS:
        path = os.path.join(ENTRY_OUT, f"proxy_{name}.csv")
        reset_counters()
        rc = rb.main(["--proxies", "--only", f"{name}$", "-t",
                      str(PROXY_SECONDS), "-o", path])
        got = counters()
        rows = read_csv(path)
        log(f"[entry] proxy {name}: rc {rc}, rows {rows}; launches "
            f"{nonzero(got)} [{card}]")
        if (rc != 0 or [r["name"] for r in rows] != [name]
                or rows[0]["error"] or not int(rows[0]["samples"])):
            raise AssertionError(f"proxy {name}: no clean row")
        # A rerun frame mixes the eager route into the row's ms/frame.
        if got["graph_reruns"] or int(rows[0]["graph_reruns"]):
            raise AssertionError(f"proxy {name}: {got['graph_reruns']} frames"
                                 f" rendered again on the eager route "
                                 f"({got['dropped']} lanes past the slots, "
                                 f"{got['capped']} at the cap)")
        if not all(got[k] for k in kernels) or plain_runs(got):
            raise AssertionError(f"proxy {name}: {kernels} did not all "
                                 f"launch, or a plain version ran")

    phase("15d entry points: the instanced self-check")
    path = os.path.join(ENTRY_OUT, "selfcheck.csv")
    reset_counters()
    rc = rb.main(["--selfcheck-instances", "--only", "instances_selfcheck$",
                  "--size", "512", "-t", str(PROXY_SECONDS), "-o", path])
    got = counters()
    rows = read_csv(path)
    log(f"[entry] selfcheck: rc {rc}, rows {rows}; launches {nonzero(got)} "
        f"[{card}]")
    if rc != 0 or len(rows) != 1 or rows[0]["gate"] != "PASS":
        raise AssertionError("selfcheck: the two-level and flattened routes "
                             "did not PASS")
    if got["graph_reruns"]:
        raise AssertionError(
            f"selfcheck: {got['graph_reruns']} frames rendered again on the "
            f"eager route ({got['dropped']} lanes past the slots, "
            f"{got['capped']} at the cap)")


def entry_points_phase(card, cornell_mrays, sl_ms):
    """Phase 15: the port's measuring entry points on the card."""
    shutil.rmtree(ENTRY_OUT, ignore_errors=True)
    os.makedirs(ENTRY_OUT)
    phase("15a entry points: python -m imbatracer_torch.bench")
    bench_entry(card, cornell_mrays, sl_ms)
    phase("15b entry points: run_one curve parity with JAX")
    curve_entry(card)
    phase("15c entry points: run_bench --proxies, configs 1, 3, 4, 5")
    proxy_entry(card)


def log_time(what, timed, plain_ms, card, second="its candidate stage alone"):
    """`[time]`: (ms, the second time or None, bound) as timed."""
    ms, second_ms, (bound_ms, bound_by, detail) = timed
    also = "" if second is None else f"{second} {second_ms:.3f} ms, "
    log(f"[time] {what} [{card}]: kernel {ms:.3f} ms ({also}plain "
        f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms by {bound_by}, "
        f"{detail})")


def kernel_entry(name, source, replaces, launches, err, timed, plain_ms,
                 route_ms=False, library_ms=None, split=None):
    """One entry of the kernels line; with `route_ms` it also carries the
    second time of `timed`, its wrapper's: the pair route, or
    merge_contrib; with `split` = (timed, launches) the kernel's time at
    the split build (phase 10a) and its launches on phase 10b's main
    path."""
    ms, second_ms, (bound_ms, bound_by, _) = timed
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches, "max_abs_err": err,
             "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": library_ms}
    if route_ms:
        entry["route_ms"] = second_ms
    if split is not None:
        entry["split_ms"], entry["split_launches"] = split[0][0], split[1]
    return entry


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    faulthandler.enable()
    cache = tempfile.mkdtemp(prefix="imba_accel_")
    os.environ["IMBATRACER_CACHE_DIR"] = cache
    try:
        run()
    finally:
        shutil.rmtree(cache, ignore_errors=True)


def run():
    from imbatracer_torch import libbuild
    from imbatracer_torch.accel import native
    from imbatracer_torch.device import card_line, get_device
    from imbatracer_torch.ops import khit as kh
    from imbatracer_torch.ops import merge as mg
    from imbatracer_torch.ops import pairs as pm
    from imbatracer_torch.ops import stream_traverse as st
    from imbatracer_torch.render import graphs
    from imbatracer_torch.scene.procedural import (make_big_scene,
                                                   make_cornell_scene,
                                                   make_leaf_scene,
                                                   make_masked_scene,
                                                   make_still_life_like)
    from imbatracer_torch.utils.metrics import load_reference_png, psnr

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = get_device("cuda")
    card = card_line(dev)
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    phase("2 build")
    t0 = time.time()
    libs = (st.LIB, kh.LIB, mg.LIB, pm.LIB, graphs.COND_LIB, native.LIB)
    paths = libbuild.build_all(libs)
    st._library()
    kh._library()
    mg._library()
    pm._library()
    graphs._cond_library()
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
    phase("3 stream kernel vs plain")
    for label in ("cornell", "big_150", "big_4000"):
        compare(*scenes[label], label, dev, st, stats)
    compare_candidates(*scenes["big_4000"], "big_4000", dev, st)
    for label in ("big_150", "big_4000"):
        num_s = scenes[label][0].bvh.sbox.shape[0]
        for key in ("closest", "any"):
            log_time(f"stream kernel {key}, {label} (S={num_s}), {NUM_RAYS} "
                     f"sorted bounce rays", stats[label, key],
                     stats[label, f"{key}_plain_ms"], card)
            log_resources(f"stream kernel {key}, S={num_s}",
                          st.resources(key == "any", False, num_s), card)
    compare_cap(dev, st, kh, card)
    phase("4 khit kernel vs plain")
    for label in ("leaf_6000", "still_life", "cornell"):
        compare_khit(*scenes[label], label, dev, st, kh, stats)
    compare_candidates(*scenes["still_life"], "still_life", dev, st)
    num_s = scenes["still_life"][0].bvh.sbox.shape[0]
    log_time(f"khit kernel, S={num_s}, {NUM_RAYS} sorted still-life bounce "
             f"rays", stats["khit"], stats["khit_plain_ms"], card)
    log_resources(f"khit kernel, S={num_s}", kh.resources(num_s), card)

    phase("5 main paths")
    stream_launches = {"closest_hit": 0, "any_hit": 0}
    main_mrays = {}
    for label, max_len in (("big_4000", 6), ("cornell", 10)):
        _, got, _, main_mrays[label] = main_path(
            *scenes[label], label, 1024, 1024, max_len, MAIN_FRAMES, card)
        log(f"[main] {label} launches over the timed frames: {got}")
        if got["closest_hit"] == 0 or got["any_hit"] == 0 or plain_runs(got):
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
    if sl_got["khit"] == 0 or plain_runs(sl_got):
        raise AssertionError("still_life: the main path did not run through "
                             "the khit kernel")
    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "goldens", "still_life_1080p_len8.png")
    sl_image = renderer.image()       # phase 10b's yardstick
    p = psnr(sl_image, load_reference_png(golden))
    log(f"[main] still_life PSNR after {renderer.frames} frames vs "
        f"{os.path.basename(golden)}: {p:.3f} dB (JAX renderer "
        f"{STILL_LIFE_PSNR} dB; {sl_ms:.1f} ms/frame, {sl_mrays:.2f} "
        f"Mrays/s) [{card}]")
    if not abs(p - STILL_LIFE_PSNR) <= PSNR_TOL:
        raise AssertionError(f"still_life PSNR {p:.3f} dB is not within "
                             f"{PSNR_TOL} dB of {STILL_LIFE_PSNR} dB")
    profile_frame(renderer, "still_life 1920x1080 max_len 8", card)

    phase("6 film parity")
    film_parity(dev, "cornell", make_cornell_scene, False)
    film_parity(dev, "masked", make_masked_scene, True)

    # The VCM family (phase 7).
    phase("7 the VCM family: merge parity and the still-life vcm main path")
    for ppm in (False, True):
        compare_merge("random", *random_merge_case(dev, 11), (0, 3, 4, 5),
                      ppm, stats)
    vcm_renderer, vcm_got = vcm_main_path(*scenes["still_life"], card,
                                          stats)
    ms, wrapper_ms, (bound_ms, bound_by, detail) = stats["merge"]
    log(f"[time] merge kernel, {stats['merge_label']} queries "
        f"[{card}]: kernel {ms:.3f} ms (merge_contrib with the query "
        f"preparation {wrapper_ms:.3f} ms, with torch glue "
        f"{TORCH_GLUE_MS['merge_contrib']:.3f} ms; plain "
        f"{stats['merge_plain_ms']:.3f} ms, bound {bound_ms:.4f} ms by "
        f"{bound_by}, {detail})")
    profile_frame(vcm_renderer, "still_life vcm 1920x1080 max_len 8", card)
    del vcm_renderer
    phase("7c bpt, ppm, vcm_pt and lt at 480x270")
    other_algorithms(*scenes["still_life"], card)
    phase("7d vcm and ppm films, card vs CPU")
    vcm_film_parity(dev, "cornell", make_cornell_scene, "vcm")
    vcm_film_parity(dev, "cornell", make_cornell_scene, "ppm")
    vcm_film_parity(dev, "masked", make_masked_scene, "vcm")

    # The `.scene` / OBJ slice with two-level instancing (phase 8).
    inst_got = instanced_phase(dev, card, scenes["big_4000"], stats)

    # The split BVH, the BVH cache and the interactive preview (phase 10).
    split_got = split_phase(dev, card, scenes["still_life"], sl_image,
                            sl_ms, stats)

    # The sharded frames (phase 11).
    multi_rank_phase(dev, card)

    # The compacted and banded routes side by side (phase 12).
    compaction_phase(dev, card, scenes)

    # The graphed and eager PT routes side by side (phase 13).
    graph_phase(dev, card, scenes)

    # The graphed and eager VCM-family routes side by side (phase 14).
    vcm_graph_phase(dev, card, scenes)

    # The measuring entry points (phase 15).
    entry_points_phase(card, main_mrays["cornell"], sl_ms)

    phase("9 output")
    src = "imbatracer_torch/csrc/"
    kernels = [
        kernel_entry("stream_traverse_closest_hit",
                     src + "stream_traverse.cu", REPLACES["stream"],
                     stream_launches["closest_hit"], stats["closest_err"],
                     stats["big_4000", "closest"],
                     stats["big_4000", "closest_plain_ms"],
                     split=(stats["sbvh", "split", "closest"],
                            split_got["closest_hit"])),
        kernel_entry("stream_traverse_any_hit", src + "stream_traverse.cu",
                     REPLACES["stream"], stream_launches["any_hit"],
                     stats["any_err"], stats["big_4000", "any"],
                     stats["big_4000", "any_plain_ms"],
                     split=(stats["sbvh", "split", "any"],
                            split_got["any_hit"])),
        kernel_entry("khit_closest_k4", src + "khit_traverse.cu",
                     REPLACES["khit"], sl_got["khit"], stats["khit_err"],
                     stats["khit"], stats["khit_plain_ms"],
                     split=(stats["sbvh", "split", "khit"],
                            split_got["khit"])),
        kernel_entry("merge_contrib", src + "merge_kernel.cu",
                     REPLACES["merge"], vcm_got["merge"], stats["merge_err"],
                     stats["merge"], stats["merge_plain_ms"], route_ms=True),
        kernel_entry("merge_prep", src + "merge_kernel.cu",
                     REPLACES["merge_prep"], vcm_got["merge_prep"],
                     stats["merge_prep_err"], stats["merge_prep"],
                     stats["merge_prep_plain_ms"]),
    ]
    for key in ("closest", "any"):
        kernels.append(kernel_entry(
            f"stream_traverse_{key}_hit_instanced", src + "stream_traverse.cu",
            REPLACES["stream_inst"], inst_got[f"{key}_hit_instanced"],
            stats[f"{key}_err_instanced"], stats["instanced", key],
            stats["instanced", f"{key}_plain_ms"]))
    for tag in ("", "_instanced"):
        for key in ("closest", "any"):
            kernels.append(kernel_entry(
                f"pairs_{key}_hit{tag}", src + "pairs_kernel.cu",
                REPLACES["pairs"], inst_got[f"pairs_{key}_hit{tag}"],
                stats[f"pairs_{key}{tag}_err"], stats[f"pairs_{key}{tag}"],
                stats[f"pairs_{key}{tag}_plain_ms"], route_ms=True))
    for name, err in (("candidates", 0.0), ("queue", 0.0),
                      ("resolve", stats["pair_resolve_err"])):
        kernels.append(kernel_entry(
            f"pair_{name}", src + "pairs_kernel.cu",
            REPLACES[f"pair_{name}"], inst_got[f"pairs_{name}"], err,
            stats[f"pair_{name}"], stats[f"pair_{name}_plain_ms"],
            library_ms=stats.get(f"pair_{name}_library_ms")))
    for k in kernels:
        if not k["launches"]:
            raise AssertionError(f"{k['name']} was not launched on a main "
                                 f"path")
    log(f"[done] {time.time() - _START:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
