#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (imbatracer_torch) on one GPU.

Run from the repository root: `python3 chip_smoke.py`.  Phases, in
order, each logging its start as `[phase] <name> at <seconds> s`; any
failure raises and the script exits non-zero:

1. Device: require CUDA; print the card's name and power limit.
2. Build: compile csrc/stream_traverse.cu, csrc/khit_traverse.cu,
   csrc/merge_kernel.cu, csrc/pairs_kernel.cu (the pair route's
   candidates, queue, pair and resolve kernels), csrc/pt_shade.cu (the PT
   bounce's shading), csrc/vcm_shade.cu (the VCM bounces'),
   csrc/dispatch.cu (the traversal dispatch glue and the re-trace's
   slot kernels), csrc/light_tail.cu (the light band's collect append
   and splat) and csrc/graph_cond.cu
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
4b. Shade kernels vs plain: the PT bounce's shading kernels
   (ops/shade.py: pt_shade_kernel and pt_shade_finish_kernel of
   csrc/pt_shade.cu) against their plain versions on the same carry and
   closest hit, run on the card: the middle NUM_RAYS band (whole rows) of
   PT frame 1 of the still life at 1920x1080 at bounce 0 and after 3
   and LATE_BOUNCE bounces (4% of its lanes alive), of the cornell at
   1024^2 after 1 and of the bumped scene at
   1024^2 at bounce 0 (phase 8a: the instanced scene at 1920x1080 after
   1).  Per column of the next carry, the shadow ray, contrib and the
   finish: the bit-equal share of the lanes, the share within 1e-5 *
   max(1, |x|) and the max relative error; the RNG state and the counts
   must be equal on every lane, active, depth, last_specular and the
   shadow flag on >= 99.99% of the lanes, each float column within on >=
   99.9%.  The finish also on seeded ragged bands (FINISH_LANES, from an
   aligned base and one an element past it, a carried count near 2^40),
   its radiance and count bit-equal.  Each kernel timed alone as
   graph_ms (10 launches in one CUDA
   graph, the device's time) beside the plain composite (3 calls) and
   its bound (shade_bytes: the lanes' columns in and out, the distinct
   shade-record and light rows; or SHADE_LANE_OPS float instructions a
   lane, whichever is larger), with the cell's alive share, and the
   kernels' registers, spills and resident blocks.
4c. VCM shade kernels vs plain: the VCM family's bounce shading kernels
   (ops/vcm_shade.py: vcm_light_start_kernel, vcm_light_shade_kernel,
   vcm_camera_shade_kernel and both entries of vcm_finish_kernel in
   csrc/vcm_shade.cu) against their plain versions on the same inputs, run
   on the card: NUM_RAYS-lane bands of the still life at 1920x1080 with
   VCM_LPC light paths -- the light band's start (its padded form, the
   band end a pointer), light bounces 0, 3 and 6 (all, 42% and few of
   the lanes alive on entry, each share printed), camera bounces 0 and 3 with
   the working cache of a light pass and its photon grid -- and of the
   cornell with a point, a spot and a directional light beside its
   triangle light at 1024^2 (sample_emit of every finite and delta kind,
   the camera at bounce 1 with 3 connections; phase 8a: the instanced
   scene at 1920x1080, light and camera bounce 1).  `[vcmshade]` lines:
   per output column the bit-equal share, the share within 1e-5 * max(1,
   |x|) and the max relative error, at phase 4b's gates (the RNG state,
   the counts and the integer columns equal; the flags and pixel ids on
   >= 99.99% of the lanes; each float column within on >= 99.9%; the
   light bounce bit for bit on every column and lane).  Each
   kernel timed alone as graph_ms (10 launches in one CUDA graph) beside
   its plain composite
   and its bound (vcm_shade_bytes: the columns it reads and writes, the distinct
   shade-record, light, cache and material rows; or VCM_LANE_OPS float
   instructions a lane), with its registers, spills and resident blocks.
4d. Dispatch glue kernels vs plain: the four kernels of csrc/dispatch.cu
   (ops/dispatch.py: dispatch_keys_kernel, dispatch_rows_kernel,
   khit_resolve_kernel, stream_resolve_kernel) against their plain
   versions on the same CUDA tensors: NUM_RAYS-lane bands of bounce rays
   (PT frame 1 after one bounce) of the still life at 1920x1080 and the
   cornell at 1024^2 (phase 8a: the instanced scene at 1920x1080), in a
   first round over every lane and a re-trace round over a slot map
   (every third active lane, state by slot, tmin' past the slot's hit):
   keys, rows, the khit resolve of the khit kernel's rows (the still
   life), the stream resolve's closest, re-trace (masked scenes) and
   occlusion modes of the stream kernel's rows.  `[dispatch]` lines: the
   elements not bit-equal, which must be 0.  Each kernel timed alone as
   graph_ms beside its plain version and its bound
   (the bytes the function moves:
   the lane arrays in and out, the rows, the mask-record rows of the hits
   it tests), the library sort's time a dispatch, and the kernels'
   registers, spills and resident blocks.
4e. Light-band tail and slot kernels vs plain: csrc/light_tail.cu
   (ops/light_tail.py: collect_append_kernel with its one-thread tail,
   splat_kernel) on the 8 x NUM_RAYS staged rows of the middle light band
   of a still-life vcm frame at 1920x1080 with VCM_LPC light paths
   (`[tail]` lines): the append into an empty collect buffer of the
   frame's capacity, into one that overflows and into a full one, from a
   seeded buffer -- rec[:C], count and lost bit-equal to the plain
   version, lost the rows past the capacity, CollectCache.check raising
   exactly on an overflow; the splat's film within phase 14's rule (mean
   1e-6 relative, >= 99.9% of pixels within 1e-5: both add with
   atomics).  The slot kernels of csrc/dispatch.cu (ops/dispatch.py:
   slot_gather_kernel, slot_finish_kernel; `[slots]`
   lines; the merge of the slots' hits runs in slot_finish_kernel's
   launch) on the still life's bounce-1 rays as its graph-ready khit
   re-trace gathers them (phase 8a: the instanced scene's two-level
   re-trace) and on seeded need masks at both slot shares (no lane
   active; past the slots; within them): the slot state, the merged hit
   and the overflow and device counts, the loop body's per-run counts
   folded in, bit-equal.  Each kernel timed
   alone beside its plain version, its bound and, for the append and
   the splat, one library call (index_copy_, index_add_), and the
   kernels' registers, spills and resident blocks.
4f. The frame's middle vs plain: csrc/select.cu (ops/select.py:
   select_keys_kernel in both modes and widths, select_gather_kernel with
   its box) and csrc/grid_build.cu (ops/merge.py: grid_keys_kernel,
   grid_tiles_kernel) against their plain versions on the same CUDA
   tensors, on the still life's collect cache from a real light pass at
   1920x1080 with VCM_LPC light paths (`[middle]` lines): the admission
   keys of the valid rows (32- and 64-bit), the canonical keys of the
   kept rows through the first sort's order, the working cache's rows
   (zero past the kept ones), the photon grid's keys, bbox_min,
   inv_cell, tiles and padded keys -- elements not bit-equal, which must
   be 0 -- and the box against the kept rows' min and max; the same rows
   cut to half their count, a canonical order alone (no cut) and an
   empty cache too.  Each kernel timed alone
   (device time of graphed launches) beside its plain version, its bound
   (the bytes the function moves) and, for the gather, one library
   index_select of the composed order; the whole middle through the
   kernels and through the plain versions, and its peak memory; the
   kernels' registers, spills and resident blocks.
5. Main paths, each with every launch counter set to 0 just before its
   timed frames and read just after them: (a) make_frame_fn +
   ProgressiveRenderer.step() for 3 frames of make_big_scene(4000) at
   1024^2, spp 1, max_len 6, and (b) of the cornell at 1024^2, max_len
   10 -- both stream-kernel entry points must have launched, no plain
   version (superchunk_candidates, the plain candidate stage, included;
   so in every phase below, the plain shading too) may have run, and
   pt_shade and pt_shade_finish once each a band-bounce (a graph
   replay), and the dispatch keys, rows and stream resolve kernels (on
   every main path below too, with khit_resolve on the still life's PT
   and vcm paths and stream_resolve on the instanced ones, and the three
   slot kernels once each a masked dispatch on those graphed masked
   paths; no resolve may take opaque flags: the mask record's test runs
   in the kernel; the vcm paths launch the collect append and splat,
   and the frame's middle kernels: the selection's on every path with a
   collect cache, the grid's on vcm and ppm);
   (c) the
   still-life proxy (alpha masks + env map) at 1920x1080, spp 1,
   max_len 8: one warm-up frame, reset(), 8 frames, as the JAX package's
   curve (results/curves_r5/curve_still_life_pt_1080p.csv) was taken --
   the khit kernel must have launched and no plain version run, and the
   image's PSNR against goldens/still_life_1080p_len8.png must lie within
   0.5 dB of the JAX renderer's 17.16 dB at 8 frames; then one more
   still-life frame is traced with torch.profiler (device busy time, idle
   share, kernel count, the kernels and host ops that take longest, and
   the launches and time of the kernels TRACED_KERNELS names: the WHILE
   nodes' set_conditional, the dispatch kernels and the library sort).
   Films must be finite with a positive mean.
6. Film parity: the cornell, the masked scene, a small still life
   (make_still_life_like(num_objects=40, num_cards=16): the env map, masks
   and every material kind) and the bumped scene at 64^2, spp 16,
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
   merge and khit kernels must have launched, the VCM shade kernels too
   (each light band's start, light bounce and connection finish, each
   camera bounce and its shadow sets' finish), and no plain version run;
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
   plain version run, no frame rendered again, pt_shade and
   pt_shade_finish launched once a band-bounce on both routes.  On the masked cells
   (hold_rounds, hold_route_slots): the slot kernels launched once each
   a masked dispatch on the graphed route and never on the eager one;
   the rounds a non-empty masked dispatch ran, mean and
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
   replays and reruns a frame; the stream, 1b, khit, merge,
   preparation and VCM shade launches a frame; peak memory; on the 1080p cells one
   traced frame of each route (wall, device busy, idle share, kernels,
   cudaLaunchKernel and cudaGraphLaunch calls; `[lighttail]`: the light
   band's tail kernels' device time and launches in the traced graphed
   frame); the collect append and splat kernels launched (lt: the
   splat; ppm: the append), the slot kernels as in phase 13; the
   re-trace's rounds,
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
   bound(), pair_bound(), pair_candidates_bound() and merge_bound(), the
   shade kernels' of phase 4b's first cell (shade_bound()), the
   dispatch kernels' of phase 4d's still-life cell and, for
   stream_resolve, phase 8a's instanced cell, the light-tail and slot
   kernels' of phase 4e's first cells; `library_ms` on the append and
   the splat: one index_copy_ / index_add_;
   `route_ms` on the pair and merge entries: the route, merge_contrib;
   `split_ms` and `split_launches` on the khit and stream entries: the
   kernel at the split build, phase 10a, and its launches on phase 10b's
   main path), before it a `[glue]` line (the library sort's time a
   dispatch, and each traced graphed frame of phases 13-14: its kernels
   a replayed graph, those launched outside the graphs taken off; a PT
   band-bounce), then the card's name and power limit, and last the
   {"ok": true, "device": ...} line.  Every kernel must have launched on
   a main path.

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
    "pt_shade": "imbatracer_tpu/render/integrators/pt.py:241 (_pt_bounce's "
                "shading between its traversal calls, XLA-fused in _pt_band "
                ":536; no pallas_call)",
    "pt_shade_finish": "imbatracer_tpu/render/integrators/pt.py:241 "
                       "(_pt_bounce's NEE add after its any_hit, XLA-fused; "
                       "no pallas_call)",
    "vcm_light_start": "imbatracer_tpu/render/integrators/vcm.py:142 "
                       "(_light_pass's head before its loop, XLA-fused in "
                       "_vcm_light_band :1078; no pallas_call)",
    "vcm_light_shade": "imbatracer_tpu/render/integrators/vcm.py:237 "
                       "(_light_pass's body with _connect_to_camera :368 and "
                       "_bounce :425, XLA-fused in _vcm_light_band :1078; no "
                       "pallas_call)",
    "vcm_light_finish": "imbatracer_tpu/render/integrators/vcm.py:368 "
                        "(_connect_to_camera's select after its any_hit, "
                        "XLA-fused; no pallas_call)",
    "vcm_camera_shade": "imbatracer_tpu/render/integrators/vcm.py:547 "
                        "(_camera_body_fn's body with _direct_illum :858, "
                        "_connect :900 and _bounce :425, XLA-fused in "
                        "_vcm_camera_band :1124; no pallas_call)",
    "vcm_camera_finish": "imbatracer_tpu/render/integrators/vcm.py:663 (the "
                         "body's shadow-set adds after its batched any_hit, "
                         "XLA-fused; no pallas_call)",
    "dispatch_keys": "imbatracer_tpu/ops/pallas_stream.py:619 (sort_keys, "
                     "with _scene_bounds :660; XLA-fused around pallas_call "
                     ":583; no pallas_call)",
    "dispatch_rows": "imbatracer_tpu/ops/pallas_stream.py:698 "
                     "(_sorted_dispatch's gathers) and :751 (_rays8t); "
                     "XLA-fused; no pallas_call",
    "khit_resolve": "imbatracer_tpu/render/traverse.py:360-384 (the khit "
                    "while body, alpha_fn of render/integrators/pt.py:61-83)"
                    " and ops/pallas_khit.py:233 (khit_sorted's tail); "
                    "XLA-fused; no pallas_call",
    "stream_resolve": "imbatracer_tpu/ops/pallas_stream.py:769-790 "
                      "(closest_hit_stream / any_hit_stream's decode) and "
                      "render/traverse.py:276-297 (the re-trace body, "
                      "_retrace_mask); XLA-fused; no pallas_call",
    "collect_append": "imbatracer_tpu/render/light_cache.py:109-150 "
                      "(append_packed's drop-mode scatter, in "
                      "_vcm_light_band render/integrators/vcm.py:1078); "
                      "XLA; no pallas_call",
    "splat": "imbatracer_tpu/render/film.py:15-23 (splat's segment_sum with "
             "its trash segment, in _vcm_light_band render/integrators/"
             "vcm.py:1078); XLA; no pallas_call",
    "slot_gather": "imbatracer_tpu/render/traverse.py:296-299, :407-409 "
                   "(the masked while loops' carry into their bodies, "
                   "full-width in JAX); XLA-fused; no pallas_call",
    "slot_finish": "imbatracer_tpu/render/traverse.py:281-283, :356-358 "
                   "(the while loops' exit under MASK_MAX_ROUNDS) and "
                   ":288-293, :371-376 (the while bodies' carry select of "
                   "the hits); XLA-fused; no pallas_call",
    "select_keys": "imbatracer_tpu/render/light_cache.py:179-184, "
                   ":209-218 (select_shallowest's and canonicalize's sort "
                   "keys, jitted :165, :197, called at render/integrators/"
                   "vcm.py:1478-1482); XLA; no pallas_call",
    "select_gather": "imbatracer_tpu/render/light_cache.py:185-194, "
                     ":219-227 (their gathers of the packed rows); XLA; no "
                     "pallas_call",
    "grid_keys": "imbatracer_tpu/ops/pallas_merge.py:143-166 "
                 "(build_merge_grid's box, cell size and keys, jitted :135,"
                 " called at render/integrators/vcm.py:1105-1107); XLA; no "
                 "pallas_call",
    "grid_tiles": "imbatracer_tpu/ops/pallas_merge.py:171-198 "
                  "(build_merge_grid's gathers, concatenation, padding and "
                  "transposition into tiles); XLA; no pallas_call",
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


def graph_ms(fn, reps=10):
    """Mean device time of fn() over `reps` calls captured in one CUDA
    graph and replayed (CUDA events around a replay, after a warm-up
    call and a warm-up replay): the kernels' own time, without the
    host's wrapper, which cuda_ms times when it is slower than them."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    return cuda_ms(g.replay, 1) / reps


def reset_counters():
    from imbatracer_torch.ops import dispatch as dp
    from imbatracer_torch.ops import khit as kh
    from imbatracer_torch.ops import light_tail as lt
    from imbatracer_torch.ops import merge as mg
    from imbatracer_torch.ops import pairs as pm
    from imbatracer_torch.ops import select as sel
    from imbatracer_torch.ops import shade as sh
    from imbatracer_torch.ops import stream_traverse as st
    from imbatracer_torch.ops import vcm_shade as vs
    from imbatracer_torch.render import graphs
    from imbatracer_torch.render import traverse as tt

    st.reset_launches()
    sel.reset_launches()
    dp.reset_launches()
    lt.reset_launches()
    kh.reset_launches()
    mg.reset_launches()
    pm.reset_launches()
    sh.reset_launches()
    vs.reset_launches()
    graphs.reset_stats()
    for k in tt.MASK_STATS:
        tt.MASK_STATS[k] = 0


def counters():
    from imbatracer_torch.ops import dispatch as dp
    from imbatracer_torch.ops import khit as kh
    from imbatracer_torch.ops import light_tail as lt
    from imbatracer_torch.ops import merge as mg
    from imbatracer_torch.ops import pairs as pm
    from imbatracer_torch.ops import select as sel
    from imbatracer_torch.ops import shade as sh
    from imbatracer_torch.ops import stream_traverse as st
    from imbatracer_torch.ops import vcm_shade as vs
    from imbatracer_torch.render import graphs
    from imbatracer_torch.render import traverse as tt

    got = {k: v for k, v in st.LAUNCHES.items() if k not in st.PLAIN_KEYS}
    got.update({k: lt.LAUNCHES[k] for k in lt.KERNELS})
    got.update({k: sel.LAUNCHES[k] for k in sel.KERNELS})
    got.update({k: mg.LAUNCHES[k] for k in mg.GRID_KERNELS})
    got.update({f"pairs_{k}": v for k, v in pm.LAUNCHES.items()
                if k not in pm.PLAIN_KEYS})
    got.update({k: v for k, v in dp.LAUNCHES.items()
                if k not in dp.PLAIN_KEYS})
    return dict(got, stream_plain=st.LAUNCHES["plain"],
                candidates_plain=st.LAUNCHES["candidates_plain"],
                khit=kh.LAUNCHES["khit"], khit_plain=kh.LAUNCHES["plain"],
                merge=mg.LAUNCHES["merge"], merge_prep=mg.LAUNCHES["prep"],
                merge_plain=sum(mg.LAUNCHES[k] for k in mg.PLAIN_KEYS),
                pairs_plain=sum(pm.LAUNCHES[k] for k in pm.PLAIN_KEYS),
                pt_shade=sh.LAUNCHES["pt_shade"],
                pt_shade_finish=sh.LAUNCHES["pt_shade_finish"],
                shade_plain=sum(sh.LAUNCHES[k] for k in sh.PLAIN_KEYS),
                **{f"vcm_{k}": vs.LAUNCHES[k] for k in vs.KERNELS},
                vcm_shade_plain=sum(vs.LAUNCHES[k] for k in vs.PLAIN_KEYS),
                dispatch_plain=sum(dp.LAUNCHES[k] for k in dp.PLAIN_KEYS),
                light_tail_plain=sum(lt.LAUNCHES[k] for k in lt.PLAIN_KEYS),
                select_plain=sum(sel.LAUNCHES[k] for k in sel.PLAIN_KEYS),
                fallback_dispatches=pm.FALLBACK["dispatches"],
                fallback_rays=pm.FALLBACK["rays"], **tt.MASK_STATS,
                **{f"graph_{k}": v for k, v in graphs.GRAPH_STATS.items()})


def plain_runs(got):
    """Calls of any plain version (stream, candidate stage, khit, the
    merge and its preparation, every step of the pair route, the PT
    shading and its finish, the VCM bounces' shading and finishes, the
    dispatch glue and the re-trace's slots, the light band's tail, the
    frame's middle: the selection, and the grid with the merge)."""
    return (got["stream_plain"] + got["candidates_plain"] + got["khit_plain"]
            + got["merge_plain"] + got["pairs_plain"] + got["shade_plain"]
            + got["vcm_shade_plain"] + got["dispatch_plain"]
            + got["light_tail_plain"] + got["select_plain"])


def hold_dispatch_launches(label, got, resolve, slots=False):
    """A main path's dispatch glue: the keys and rows kernels and
    `resolve` (khit_resolve or stream_resolve) launched, every alpha test
    by the mask record (no flags variant), no plain version; with
    `slots` (a graphed masked path), the re-trace's two slot kernels
    too, once each a graph-ready masked dispatch."""
    need = ("dispatch_keys", "dispatch_rows", resolve)
    if slots:
        hold_slot_launches(label, got)
    missing = [k for k in need if not got[k]]
    flags = got["khit_resolve_flags"] + got["stream_resolve_flags"]
    if missing or flags or got["dispatch_plain"]:
        raise AssertionError(f"{label}: the dispatch kernels {missing} did "
                             f"not launch, {flags} resolves took opaque "
                             f"flags, or {got['dispatch_plain']} plain "
                             f"versions ran")


def hold_slot_launches(label, got):
    """A graphed masked path's slot kernels: slot_gather and slot_finish
    each launched once a masked dispatch, and slot_merge never (the merge
    runs in slot_finish's launch)."""
    n = {k: got[k] for k in SLOT_COUNTS}
    if not (n["slot_gather"] == n["slot_finish"] == got["dispatches"] > 0
            and n["slot_merge"] == 0):
        raise AssertionError(f"{label}: the slot kernels launched {n} "
                             f"times over {got['dispatches']} masked "
                             f"dispatches")


def hold_vcm_shade_launches(label, got, algo):
    """A VCM-family main path's shade and middle launches: every kernel
    its algorithm runs (the light band's start, bounce and connection
    finish, its tail's collect append and splat, the frame's middle --
    the selection's keys and gather, the photon grid's keys and tiles --
    the camera bounce and its shadow sets' finish) launched, and no plain
    version."""
    need = []
    if algo != "pt":
        need += ["vcm_light_start", "vcm_light_shade"]
        if algo != "ppm":
            need += ["vcm_light_finish", "splat"]
        if algo != "lt":
            need += ["collect_append", "select_keys", "select_gather"]
        if algo in ("vcm", "ppm"):
            need += ["grid_keys", "grid_tiles"]
    if algo != "lt":
        need.append("vcm_camera_shade")
        if algo != "ppm":
            need.append("vcm_camera_finish")
    missing = [k for k in need if not got[k]]
    plain = got["vcm_shade_plain"] + got["select_plain"]
    if missing or plain:
        raise AssertionError(f"{label}: the VCM shade and middle kernels "
                             f"{missing} did not launch, or {plain} plain "
                             f"versions ran")


def hold_shade_launches(label, got):
    """A PT main path's shade launches: one pt_shade and one
    pt_shade_finish a band-bounce, a graph replay each."""
    if not (got["pt_shade"] == got["pt_shade_finish"] == got["graph_replays"]
            > 0):
        raise AssertionError(f"{label}: {got['pt_shade']} pt_shade and "
                             f"{got['pt_shade_finish']} pt_shade_finish "
                             f"launches over {got['graph_replays']} "
                             f"band-bounces")


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


# The shade phase's gates (hold_shade): the RNG state equal on every lane,
# the flags on SHADE_FLAGS of the lanes, float columns within SHADE_REL *
# max(1, |x|) on SHADE_FLOATS of the lanes.
SHADE_FLAGS = 0.9999
SHADE_FLOATS = 0.999
SHADE_REL = 1e-5
# Float instructions a lane of pt_shade_kernel issues at the least (a
# diffuse lane with a triangle light: the interaction ~60, the light
# sample ~45, the BSDF eval ~70, the sample ~60, MIS, RR and the outputs
# ~40; transcendentals and divisions counted as one), for the bound.
SHADE_LANE_OPS = 275
# Bytes of a lane's columns: in (org, d, tmin, throughput, radiance,
# active, depth, last_pdf, last_specular, state; the hit's t, prim_id, u,
# v) and out (the next carry; the shadow ray's pos, dir, tmin, tmax, ok;
# contrib).
SHADE_LANE_IN = 12 + 12 + 4 + 12 + 12 + 1 + 4 + 4 + 1 + 8 + 16
SHADE_LANE_OUT = 12 + 12 + 4 + 12 + 12 + 1 + 4 + 4 + 1 + 8 + 33 + 12
# The finish kernel's lane: radiance, contrib, shadow_ok, occluded in,
# radiance out.
FINISH_LANE_BYTES = 12 + 12 + 1 + 1 + 12


def shade_carry(scene, meta, width, height, max_len, bounces, dev):
    """The middle band (up to NUM_RAYS lanes, whole rows) of PT frame 1
    at width x height after `bounces` bounces (the bounce as the renderer
    runs it, through the shade kernels), with its closest hit: (carry,
    hit, alpha_fn)."""
    from imbatracer_torch.frontend.renderer import (RenderSettings,
                                                    camera_for_scene)
    from imbatracer_torch.render.integrators import pt
    from imbatracer_torch.render.intersect import BIG
    from imbatracer_torch.render.traverse import closest_hit

    cam = camera_for_scene(meta, RenderSettings(width=width, height=height),
                           dev)
    n = min(NUM_RAYS, width * height)
    start = (width * height - n) // 2 // width * width
    org, d, state, _ = pt.camera_rays(cam, width, height, 1, 1,
                                      start_pixel=start, count=n)
    c = pt._init_carry(org, d, state)
    alpha_fn = pt.alpha_fn_for(scene) if meta.has_masks else None
    for _ in range(bounces):
        c = pt._pt_bounce(scene, c, alpha_fn=alpha_fn, has_bump=meta.has_bump,
                          max_len=max_len)
    hit = closest_hit(scene.bvh, c["org"], c["d"], c["tmin"], BIG,
                      alpha_fn=alpha_fn, active=c["active"], sort=True)
    return c, hit, alpha_fn


def hold_column(k, p):
    """(bit-equal share, within-tolerance share, max rel err, max abs err)
    of a kernel column against the plain one, lane by lane (a lane's
    components together; NaN equal to NaN).  Rel err: |k - p| / max(1,
    |p|) over the lanes where both are finite."""
    if k.dtype != torch.float32:
        eq = (k == p).reshape(k.shape[0], -1).all(dim=1) if k.dim() else (
            k == p).reshape(1)
        share = float(eq.double().mean())
        return share, share, 0.0, 0.0
    kk, pp = k.reshape(k.shape[0], -1), p.reshape(p.shape[0], -1)
    nan = torch.isnan(kk) & torch.isnan(pp)
    bits = (kk.view(torch.int32) == pp.view(torch.int32)) | nan
    fin = torch.isfinite(kk) & torch.isfinite(pp)
    diff = torch.where(fin, (kk - pp).abs(), 0.0)
    rel = torch.where(fin, diff / torch.clamp(pp.abs(), min=1.0), 0.0)
    within = bits | (fin & (rel <= SHADE_REL))
    return (float(bits.all(dim=1).double().mean()),
            float(within.all(dim=1).double().mean()), float(rel.max()),
            float(diff.max()))


def shade_bytes(scene, c, hit):
    """(bytes, detail): what pt_shade must move on this carry, each word
    once: every lane's columns in and out, the distinct shade-record rows
    its hits read (a miss reads row 0) and the distinct light rows its
    NEE samples pick.  Texel and environment-table reads are not counted
    (the bound stays a least time)."""
    from imbatracer_torch.core import rng

    lanes = c["active"].shape[0]
    rows = int(torch.unique(hit.prim_id.clamp(min=0)).numel())
    num_lights = scene.lights.kind.shape[0]
    _, (ul,) = rng.next_floats(c["state"], 1)
    picks = torch.clamp((ul * num_lights).to(torch.int32), max=num_lights - 1)
    lights = int(torch.unique(picks).numel())
    cols = scene.attrs.shade_rec.shape[1]
    nbytes = (lanes * (SHADE_LANE_IN + SHADE_LANE_OUT) + rows * cols * 4
              + lights * scene.lights.rec.shape[1] * 4)
    return nbytes, dict(lanes=lanes, shade_rows=rows, shade_cols=cols,
                        light_rows=lights)


def shade_bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the float instructions over the float32 instruction rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_INSTR_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def hold_shade(label, scene, meta, c, hit, alpha_fn, max_len, card, stats):
    """`[shade]`: pt_shade_cuda and pt_shade_finish_cuda against their
    plain versions on the same carry and hit on the card, column by
    column (bit-equal share, share within SHADE_REL, max rel and abs
    err), gated as SHADE_FLAGS and SHADE_FLOATS say; each kernel timed
    alone (graph_ms: 10 launches in one CUDA graph, the device's time)
    beside its plain composite and its bound.  Records the largest abs
    err and the first cell's times in `stats`."""
    from imbatracer_torch.ops import shade as sh
    from imbatracer_torch.render.traverse import any_hit

    kw = dict(has_bump=meta.has_bump, max_len=max_len)
    k_nxt, k_sh, k_con = sh.pt_shade_cuda(scene, c, hit, **kw)
    p_nxt, p_sh, p_con = sh.pt_shade_plain(scene, c, hit, **kw)
    occ = any_hit(scene.bvh, p_sh.pos, p_sh.dir, p_sh.tmin, p_sh.tmax,
                  alpha_fn=alpha_fn, active=p_sh.ok, sort=True)
    fin_args = (p_nxt["radiance"], p_con, p_sh.ok, occ, p_nxt["n_rays"])
    k_fin = sh.pt_shade_finish_cuda(*fin_args)
    p_fin = sh.pt_shade_finish_plain(*fin_args)
    torch.cuda.synchronize()
    cols = {k: (k_nxt[k], p_nxt[k]) for k in p_nxt}
    cols.update({f"shadow.{k}": (getattr(k_sh, k), getattr(p_sh, k))
                 for k in sh.ShadowRay._fields})
    cols["contrib"] = (k_con, p_con)
    cols["finish.radiance"] = (k_fin[0], p_fin[0])
    cols["finish.n_rays"] = (k_fin[1], p_fin[1])
    flags = ("active", "depth", "last_specular", "shadow.ok")
    bad, parts, err = [], [], {}
    for name, (k, p) in cols.items():
        bits, within, rel, abs_err = hold_column(k, p)
        parts.append(f"{name} {bits:.6f}" + (f"/{within:.6f} rel "
                     f"{rel:.2e}" if k.dtype == torch.float32 else ""))
        err[name] = abs_err
        need = (1.0 if name in ("state", "n_rays", "finish.n_rays") else
                SHADE_FLAGS if name in flags else
                SHADE_FLOATS if k.dtype == torch.float32 else 1.0)
        if within < need:
            bad.append(f"{name} {within:.6f} < {need}")
    alive = float(c["active"].double().mean())
    log(f"[shade] {label}: {c['active'].shape[0]} lanes, {alive:.4f} "
        f"active, depths {sorted(set(c['depth'].tolist()))}; bit-equal"
        f"/within {SHADE_REL} share a column: " + ", ".join(parts))
    if bad:
        raise AssertionError(f"[shade] {label}: the shade kernels disagree "
                             f"with the plain versions: {bad}")
    launch = partial(sh.pt_shade_cuda, scene, c, hit, **kw)
    fin_launch = partial(sh.pt_shade_finish_cuda, *fin_args)
    ms = graph_ms(launch)
    plain_ms = cuda_ms(partial(sh.pt_shade_plain, scene, c, hit, **kw), 3)
    fin_ms = graph_ms(fin_launch)
    fin_plain_ms = cuda_ms(partial(sh.pt_shade_finish_plain, *fin_args), 3)
    lanes = c["active"].shape[0]
    nbytes, detail = shade_bytes(scene, c, hit)
    bound_ms, bound_by = shade_bound(nbytes, lanes * SHADE_LANE_OPS)
    fin_bound = shade_bound(lanes * FINISH_LANE_BYTES, 0)
    log(f"[time] pt_shade kernel, {label}, {alive:.4f} alive [{card}]: "
        f"kernel {ms:.4f} ms (graph_ms; plain {plain_ms:.3f} ms, bound "
        f"{bound_ms:.4f} ms by {bound_by}, "
        f"{nbytes} bytes {detail}); pt_shade_finish kernel {fin_ms:.4f} ms "
        f"(graph_ms; plain {fin_plain_ms:.3f} ms, bound "
        f"{fin_bound[0]:.4f} ms by bytes)")
    stats["shade_err"] = max(stats.get("shade_err", 0.0), max(
        v for k, v in err.items() if not k.startswith("finish.")))
    stats["shade_finish_err"] = max(stats.get("shade_finish_err", 0.0),
                                    err["finish.radiance"])
    stats.setdefault("shade", (ms, None, (bound_ms, bound_by, detail)))
    stats.setdefault("shade_plain_ms", plain_ms)
    stats.setdefault("shade_finish", (fin_ms, None, (*fin_bound, {})))
    stats.setdefault("shade_finish_plain_ms", fin_plain_ms)


# Phase 4b's late still-life bounce: max_len 8, so its lanes at depth 6
# may still go on once.
LATE_BOUNCE = 6
# Phase 4b's ragged bands of the NEE add (pt_shade_finish_kernel: four
# lanes a thread, a scalar tail, a grid of at most four blocks an SM).
FINISH_LANES = (1, 3, 127, 129, 262143, 262144, 266277)


def unaligned(x):
    """x copied into a view one element past the start of its storage."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def hold_finish_ragged(dev, card):
    """`[shade]` ragged cells: pt_shade_finish_kernel against its plain
    version, bit for bit, on seeded radiance (signed zeros among it),
    contrib and shadow flags over FINISH_LANES lanes, from an aligned
    base and from one an element past it (the scalar route), with a
    carried count near 2^40: the radiance and the count, the carried
    count left as it was."""
    from imbatracer_torch.ops import shade as sh

    for lanes in FINISH_LANES:
        for base in ("aligned", "unaligned"):
            rs = np.random.RandomState(lanes % 97)
            rad = rs.randn(lanes, 3).astype(np.float32)
            rad[rs.rand(lanes) < 0.1] = -0.0
            args = [torch.from_numpy(a).to(dev) for a in (
                rad, rs.rand(lanes, 3).astype(np.float32),
                rs.rand(lanes) < 0.5, rs.rand(lanes) < 0.5)]
            if base == "unaligned":
                args = [unaligned(x) for x in args]
            n0 = torch.tensor((1 << 40) - 1000 + lanes % 97,
                              dtype=torch.int64, device=dev)
            k = sh.pt_shade_finish_cuda(*args, n0)
            p = sh.pt_shade_finish_plain(*args, n0)
            bad = bit_mismatches(k[0], p[0]) + int(
                int(k[1]) != int(p[1]) or int(n0) != (1 << 40) - 1000
                + lanes % 97)
            log(f"[shade] pt_shade_finish, {lanes} lanes from an {base} "
                f"base, {int(args[2].sum())} shadow rays, carried count "
                f"{int(n0)}: elements not bit-equal to the plain version "
                f"(radiance, count): {bad} [{card}]")
            if bad:
                raise AssertionError(f"[shade] pt_shade_finish at {lanes} "
                                     f"lanes ({base}): {bad} elements "
                                     f"differ from the plain version")


def shade_phase(dev, card, scenes, stats):
    """Phase 4b: the shade kernels against their plain versions on one
    NUM_RAYS band of the still life at bounces 0, 3 and LATE_BOUNCE (few
    of its lanes alive), of the cornell and of the bumped scene (the
    instanced scene's band: phase 8a), the NEE add on ragged bands
    (hold_finish_ragged), with the kernels' resources."""
    from imbatracer_torch.ops import shade as sh
    from imbatracer_torch.scene.procedural import make_bumped_scene

    phase("4b shade kernels vs plain")
    cells = (("still_life 1920x1080 bounce 0", scenes["still_life"], 1920,
              1080, 8, 0),
             ("still_life 1920x1080 bounce 3", scenes["still_life"], 1920,
              1080, 8, 3),
             (f"still_life 1920x1080 bounce {LATE_BOUNCE}",
              scenes["still_life"], 1920, 1080, 8, LATE_BOUNCE),
             ("cornell 1024x1024 bounce 1", scenes["cornell"], 1024, 1024, 10,
              1),
             ("bumped 1024x1024 bounce 0", make_bumped_scene(device=dev),
              1024, 1024, 10, 0))
    for label, (scene, meta), w, h, max_len, bounces in cells:
        c, hit, alpha_fn = shade_carry(scene, meta, w, h, max_len, bounces,
                                       dev)
        hold_shade(label, scene, meta, c, hit, alpha_fn, max_len, card,
                   stats)
    hold_finish_ragged(dev, card)
    for finish in (False, True):
        log_resources("pt_shade_finish kernel" if finish else
                      "pt_shade kernel", sh.resources(finish), card)


# Phase 4c: the VCM family's bounce shading kernels.  Gates as phase 4b's
# (SHADE_FLAGS, SHADE_FLOATS, SHADE_REL); the columns held as flags (a
# last-ulp difference may flip them) and those that must be equal.
VCM_SHADE_FLAGS = ("active", "shadow.ok", "rows.store", "rows.pixel",
                   "query.active", "finish.pixel")
VCM_SHADE_EXACT = ("state", "n_rays", "finish.n_rays", "finite", "path_id",
                   "rows.ints", "query.kind")
# Float instructions a lane issues at the least (a diffuse lane with a
# triangle light): the light start (seed, sample_emit ~50, the weights
# ~15), a light bounce (the interaction ~60, the camera connection with
# its BSDF eval ~120, the adjoint sample and pdf ~110, the weights ~30), a
# camera bounce without connections (the interaction, emitter MIS, NEE
# ~135, the sample and pdf ~110, the weights) and each connection (the
# vertex row, two BSDF evals ~140, the weights ~40), and a finish (three
# adds a shadow set).
VCM_LANE_OPS = {"light_start": 70, "light_shade": 320, "camera_shade": 330,
                "connection": 180, "camera_finish": 3, "light_finish": 0}
VCM_CONNECTIONS = 3           # the delta-light cornell cell's connections


def tensor_bytes(*xs):
    """Bytes of the tensors in xs (dicts and tuples searched, None
    skipped)."""
    n = 0
    for x in xs:
        if isinstance(x, dict):
            n += tensor_bytes(*x.values())
        elif isinstance(x, (tuple, list)):
            n += tensor_bytes(*x)
        elif torch.is_tensor(x):
            n += x.numel() * x.element_size()
    return n


def distinct_rows(idx, width):
    """Bytes of the distinct rows `idx` picks of a table `width` floats
    wide."""
    return int(torch.unique(idx).numel()) * width * 4


def vcm_frame_inputs(scene, meta, width, height, max_len, dev):
    """(camera, FrameInputs of frame 1, light_path_count, cache capacity)
    of a vcm frame at width x height with VCM_LPC light paths and the
    renderer's base radius."""
    from imbatracer_torch.frontend.engine import estimate_pixel_size
    from imbatracer_torch.frontend.renderer import (RenderSettings,
                                                    camera_for_scene)
    from imbatracer_torch.render.integrators import vcm

    settings = RenderSettings(width=width, height=height)
    cam = camera_for_scene(meta, settings, dev)
    base = estimate_pixel_size(scene, cam, meta) * settings.radius_factor
    (frame, base_radius, lpc, cap, pm_radius, eta_vc,
     eta_vm) = vcm.frame_constants(cam, 1, base, algo="vcm",
                                   num_pixels=width * height,
                                   light_path_count=VCM_LPC, max_len=max_len)
    return (cam, vcm.FrameInputs(cam, frame, base_radius, pm_radius, eta_vc,
                                 eta_vm), lpc, cap)


def light_kw(meta, cam, fi, lpc, max_len):
    from imbatracer_torch.render.integrators import vcm

    return dict(mis_eta_vc=fi.mis_eta_vc, mis_eta_vm=fi.mis_eta_vm,
                algo="vcm", light_path_count=lpc, max_len=max_len,
                has_bump=meta.has_bump, pixel_area=vcm.pixel_area(cam))


def vcm_light_band(scene, meta, cam, fi, lpc, max_len, bounces):
    """The middle NUM_RAYS light paths of the frame after `bounces`
    bounces (the renderer's route, through the kernels), with their
    closest hit: (carry, hit, alpha_fn)."""
    from imbatracer_torch.ops import vcm_shade as vs
    from imbatracer_torch.render.integrators import pt
    from imbatracer_torch.render.intersect import BIG
    from imbatracer_torch.render.traverse import closest_hit

    start = (lpc - NUM_RAYS) // 2
    alpha_fn = pt.alpha_fn_for(scene) if meta.has_masks else None
    c = vs.light_start(scene, fi.frame, fi.mis_eta_vc, lanes=NUM_RAYS,
                       light_path_count=lpc, path_start=start)
    kw = light_kw(meta, cam, fi, lpc, max_len)
    for i in range(bounces + 1):
        hit = closest_hit(scene.bvh, c["org"], c["d"], c["tmin"], BIG,
                          alpha_fn=alpha_fn, active=c["active"], sort=True)
        if i == bounces:
            return c, hit, alpha_fn
        rows = vs.light_rows(NUM_RAYS, 1, False, False, cam.pos.device)
        c, _ = vs.light_shade(scene, cam, c, hit, i, rows, **kw)


def hold_vcm_columns(label, cols, alive, stats, key, exact=False):
    """`[vcmshade]`: each (kernel, plain) column pair held as hold_column
    says, at phase 4b's gates, or with `exact` bit for bit on every lane;
    records the largest abs err under `key`."""
    bad, parts, err = [], [], 0.0
    for name, (k, p) in cols.items():
        bits, within, rel, abs_err = hold_column(k, p)
        parts.append(f"{name} {bits:.6f}" + (f"/{within:.6f} rel "
                     f"{rel:.2e}" if k.dtype == torch.float32 else ""))
        err = max(err, abs_err)
        need = (SHADE_FLAGS if name in VCM_SHADE_FLAGS else
                SHADE_FLOATS if k.dtype == torch.float32 else 1.0)
        if exact and bits < 1.0:
            bad.append(f"{name} {bits:.6f} bit-equal < 1")
        elif within < need:
            bad.append(f"{name} {within:.6f} < {need}")
    log(f"[vcmshade] {label}: {alive:.4f} active; bit-equal/within "
        f"{SHADE_REL} share a column: " + ", ".join(parts))
    if bad:
        raise AssertionError(f"[vcmshade] {label}: the VCM shade kernels "
                             f"disagree with the plain versions: {bad}")
    stats[key] = max(stats.get(key, 0.0), err)


def time_vcm(name, label, launch, plain, nbytes, ops, detail, card, stats):
    """`[time]` of one VCM shade kernel alone (graph_ms: 10 launches in
    one CUDA graph, the device's time) beside its plain composite (3
    calls) and its bound; the first cell's times go to `stats`."""
    ms = graph_ms(launch)
    plain_ms = cuda_ms(plain, 3)
    bound_ms, bound_by = shade_bound(nbytes, ops)
    log(f"[time] vcm {name} kernel, {label} [{card}]: kernel {ms:.4f} ms "
        f"(graph_ms; plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms by "
        f"{bound_by}, {nbytes} bytes, {ops} float instructions, {detail})")
    stats.setdefault(f"vcm_{name}", (ms, None, (bound_ms, bound_by, detail)))
    stats.setdefault(f"vcm_{name}_plain_ms", plain_ms)


def hold_vcm_light(label, scene, meta, cam, fi, lpc, max_len, bounce, card,
                   stats, start_too=False):
    """The light kernels against their plain versions on the middle band
    at light bounce `bounce` (with `start_too`, the band's start first,
    padded: its band end a pointer short of the band)."""
    from imbatracer_torch.ops import vcm_shade as vs
    from imbatracer_torch.render.traverse import any_hit

    dev = cam.pos.device
    num_lights = scene.lights.kind.shape[0]
    if start_too:
        start = torch.tensor((lpc - NUM_RAYS) // 2, dtype=torch.int32,
                             device=dev)
        end = start + NUM_RAYS - 1000
        kw = dict(lanes=NUM_RAYS, light_path_count=lpc, path_start=start,
                  path_end=end)
        k = vs.light_start_cuda(scene, fi.frame, fi.mis_eta_vc, **kw)
        p = vs.light_start_plain(scene, fi.frame, fi.mis_eta_vc, **kw)
        torch.cuda.synchronize()
        hold_vcm_columns(f"light start, {label}", {n: (k[n], p[n]) for n in p},
                         float(p["active"].double().mean()), stats,
                         "vcm_light_start_err")
        time_vcm("light_start", label,
                 partial(vs.light_start_cuda, scene, fi.frame, fi.mis_eta_vc,
                         **kw),
                 partial(vs.light_start_plain, scene, fi.frame,
                         fi.mis_eta_vc, **kw),
                 tensor_bytes(p) + distinct_rows(torch.clamp(
                     (p["path_id"] * num_lights) // lpc,
                     max=num_lights - 1), 24),
                 NUM_RAYS * VCM_LANE_OPS["light_start"],
                 dict(lanes=NUM_RAYS), card, stats)
    c, hit, alpha_fn = vcm_light_band(scene, meta, cam, fi, lpc, max_len,
                                         bounce)
    kw = light_kw(meta, cam, fi, lpc, max_len)
    rk = vs.light_rows(NUM_RAYS, 1, True, True, dev)
    rp = vs.light_rows(NUM_RAYS, 1, True, True, dev)
    k_nxt, k_sh = vs.light_shade_cuda(scene, cam, c, hit, bounce, rk, **kw)
    p_nxt, p_sh = vs.light_shade_plain(scene, cam, c, hit, bounce, rp, **kw)
    occ = any_hit(scene.bvh, p_sh.pos, p_sh.dir, p_sh.tmin, p_sh.tmax,
                  alpha_fn=alpha_fn, active=p_sh.ok, sort=True)
    fk = (rp.cc.clone(), rp.pixel.clone())
    fp = (rp.cc.clone(), rp.pixel.clone())
    vs.light_finish_cuda(*fk, p_sh.ok, occ)
    vs.light_finish_plain(*fp, p_sh.ok, occ)
    torch.cuda.synchronize()
    ints = list(INT_COLS)
    floats = [j for j in range(24) if j not in ints]
    cols = {n: (k_nxt[n], p_nxt[n]) for n in p_nxt}
    cols.update({f"shadow.{n}": (getattr(k_sh, n), getattr(p_sh, n))
                 for n in k_sh._fields})
    cols.update({"rows.floats": (rk.rec[:, floats], rp.rec[:, floats]),
                 "rows.ints": (rk.rec[:, ints].view(torch.int32),
                               rp.rec[:, ints].view(torch.int32)),
                 "rows.store": (rk.store, rp.store),
                 "rows.cc": (rk.cc, rp.cc), "rows.pixel": (rk.pixel,
                                                           rp.pixel)})
    alive = float(c["active"].double().mean())
    hits = float((c["active"] & (hit.prim_id >= 0)).double().mean())
    live = float(rp.store.double().mean())
    hold_vcm_columns(f"light bounce {bounce} ({hits:.4f} hit, {live:.4f} "
                     f"store a vertex), {label}", cols, alive, stats,
                     "vcm_light_shade_err", exact=True)
    hold_vcm_columns(f"light finish, bounce {bounce}, {label}",
                     {"finish.cc": (fk[0], fp[0]),
                      "finish.pixel": (fk[1], fp[1])}, alive, stats,
                     "vcm_light_finish_err")
    rows = distinct_rows(hit.prim_id.clamp(min=0),
                         scene.attrs.shade_rec.shape[1])
    reads = {n: c[n] for n in ("org", "d", "throughput", "active", "d_vc",
                               "d_vcm", "d_vm", "state", "finite",
                               "path_id")}
    nxt = {n: p_nxt[n] for n in vs.NEXT}
    time_vcm("light_shade", f"bounce {bounce} ({alive:.4f} alive on entry, "
             f"{hits:.4f} hit), {label}",
             partial(vs.light_shade_cuda, scene, cam, c, hit, bounce, rk,
                     **kw),
             partial(vs.light_shade_plain, scene, cam, c, hit, bounce, rp,
                     **kw),
             tensor_bytes(reads, hit, nxt, tuple(rp), tuple(p_sh)) + rows,
             NUM_RAYS * VCM_LANE_OPS["light_shade"],
             dict(lanes=NUM_RAYS, shade_row_bytes=rows), card, stats)
    time_vcm("light_finish", f"bounce {bounce}, {label}",
             partial(vs.light_finish_cuda, *fk, p_sh.ok, occ),
             partial(vs.light_finish_plain, *fp, p_sh.ok, occ),
             2 * tensor_bytes(fk) + tensor_bytes(p_sh.ok, occ), 0,
             dict(lanes=NUM_RAYS), card, stats)


def vcm_collect(scene, meta, cam, fi, lpc, max_len):
    """The collect cache of the frame's light pass (the renderer's eager
    route, through the kernels) and its count."""
    from imbatracer_torch.ops import vcm_shade as vs
    from imbatracer_torch.render import light_cache
    from imbatracer_torch.render.integrators import pt, vcm

    dev = cam.pos.device
    collect = light_cache.empty_collect(lpc * max_len, dev)
    band = vcm.light_bands(
        scene, fi, collect, sg=None, key=(), lanes=min(vcm.BAND_RAYS, lpc),
        algo="vcm", num_pixels=cam.width * cam.height, light_path_count=lpc,
        max_len=max_len,
        alpha_fn=pt.alpha_fn_for(scene) if meta.has_masks else None,
        has_bump=meta.has_bump, techniques=vs.TECHNIQUES)
    for start in range(0, lpc, vcm.BAND_RAYS):
        band(start, min(vcm.BAND_RAYS, lpc - start))
    return collect, collect.check()


def vcm_working_cache(scene, meta, cam, fi, lpc, cap, max_len):
    """`fi` with the working cache of the frame's light pass and its
    photon grid, as the frame selects and builds them."""
    from imbatracer_torch.render import light_cache
    from imbatracer_torch.render.integrators import vcm

    collect, count = vcm_collect(scene, meta, cam, fi, lpc, max_len)
    cache = light_cache.select_shallowest(
        collect.cache(), cap, count=count, **vcm.key_bounds(lpc, max_len))
    return vcm.working_cache(fi, cache, vcm.photon_grid(cache, fi.pm_radius),
                             None, ())


def camera_kw(meta, fi, lpc, max_len, conns):
    from imbatracer_torch.ops import vcm_shade as vs

    return dict(cache_count=fi.cache_count, cache_rec=fi.cache_rec,
                base_radius=fi.base_radius, mis_eta_vc=fi.mis_eta_vc,
                mis_eta_vm=fi.mis_eta_vm, algo="vcm", max_len=max_len,
                light_path_count=lpc, num_connections=conns,
                has_bump=meta.has_bump, techniques=vs.TECHNIQUES)


def connection_rows(scene, c, fi, conns):
    """(cache-row bytes, material-row bytes) the connections of the
    carry's lanes pick (their draws follow NEE's three)."""
    from imbatracer_torch.core import rng

    count = fi.cache_count
    state, _ = rng.next_floats(c["state"], 3)
    picks = []
    for _ in range(conns):
        state, (uc,) = rng.next_floats(state, 1)
        picks.append(torch.minimum((uc * count.float()).to(torch.int32),
                                   torch.clamp(count - 1, min=0)))
    j = torch.unique(torch.cat(picks)).long()
    mats = fi.cache_rec[j, 14].contiguous().view(torch.int32)
    return (int(j.numel()) * 24 * 4, distinct_rows(
        mats.clamp(min=0), scene.materials.rec.shape[1]))


def hold_vcm_camera(label, scene, meta, cam, fi, lpc, max_len, bounce,
                    conns, card, stats):
    """The camera kernels against their plain versions on the middle
    NUM_RAYS band of the frame's camera pass at camera bounce `bounce`
    (the bounces before it through the renderer's route and the
    kernels), with `conns` connections a bounce."""
    from imbatracer_torch.core import rng
    from imbatracer_torch.ops import vcm_shade as vs
    from imbatracer_torch.render.integrators import pt, vcm
    from imbatracer_torch.render.intersect import BIG
    from imbatracer_torch.render.traverse import any_hit, closest_hit

    w, h = cam.width, cam.height
    dev = cam.pos.device
    start = (w * h - NUM_RAYS) // 2 // w * w
    alpha_fn = pt.alpha_fn_for(scene) if meta.has_masks else None
    c = vcm._camera_carry(cam, fi.frame, width=w, height=h, spp=1,
                          light_path_count=lpc, start_pixel=start,
                          band_pixels=NUM_RAYS)
    c["n_rays"] = torch.zeros((), dtype=torch.int64, device=dev)
    kinds = tuple(sorted(set(scene.materials.kind.tolist())))
    for i in range(bounce):
        c = vcm._camera_bounce(
            scene, c, i, cache_count=fi.cache_count, cache_rec=fi.cache_rec,
            grid=fi.grid, pm_radius=fi.pm_radius, base_radius=fi.base_radius,
            mis_eta_vc=fi.mis_eta_vc, mis_eta_vm=fi.mis_eta_vm, algo="vcm",
            max_len=max_len, light_path_count=lpc, num_connections=conns,
            has_bump=meta.has_bump, alpha_fn=alpha_fn,
            techniques=vs.TECHNIQUES, mat_kinds=kinds)
    hit = closest_hit(scene.bvh, c["org"], c["d"], c["tmin"], BIG,
                      alpha_fn=alpha_fn, active=c["active"], sort=True)
    kw = camera_kw(meta, fi, lpc, max_len, conns)
    k_nxt, k_sh, k_q = vs.camera_shade_cuda(scene, c, hit, bounce, **kw)
    p_nxt, p_sh, p_q = vs.camera_shade_plain(scene, c, hit, bounce, **kw)
    occ = any_hit(scene.bvh, p_sh.pos, p_sh.dir, p_sh.tmin, p_sh.tmax,
                  alpha_fn=alpha_fn, active=p_sh.ok, sort=True)
    fin = (p_nxt["radiance"], p_sh.contrib, p_sh.ok, occ, p_nxt["n_rays"])
    k_fin = vs.camera_finish_cuda(*fin)
    p_fin = vs.camera_finish_plain(*fin)
    torch.cuda.synchronize()
    cols = {n: (k_nxt[n], p_nxt[n]) for n in p_nxt}
    cols.update({f"shadow.{n}": (getattr(k_sh, n), getattr(p_sh, n))
                 for n in k_sh._fields})
    for n in ("pos", "normal", "gn", "w_out", "d_vcm", "d_vm", "active",
              "throughput"):
        cols[f"query.{n}"] = (getattr(k_q, n), getattr(p_q, n))
    for n in ("kind", "kd", "ks", "ns"):
        cols[f"query.{n}"] = (k_q.params[n], p_q.params[n])
    what = (f"camera bounce {bounce}, {conns} connection"
            f"{'s' if conns > 1 else ''}, {label}")
    alive = float(c["active"].double().mean())
    hold_vcm_columns(what, cols, alive, stats, "vcm_camera_shade_err")
    hold_vcm_columns(f"camera finish, {what}",
                     {"finish.radiance": (k_fin[0], p_fin[0]),
                      "finish.n_rays": (k_fin[1], p_fin[1])}, alive, stats,
                     "vcm_camera_finish_err")
    num_lights = scene.lights.kind.shape[0]
    _, (ul,) = rng.next_floats(c["state"], 1)
    lights = distinct_rows(torch.clamp((ul * num_lights).to(torch.int32),
                                       max=num_lights - 1), 24)
    shade = distinct_rows(hit.prim_id.clamp(min=0),
                          scene.attrs.shade_rec.shape[1])
    cache_b, mat_b = connection_rows(scene, c, fi, conns)
    reads = {n: c[n] for n in ("org", "d", "throughput", "radiance",
                               "active", "d_vc", "d_vcm", "d_vm", "state")}
    nbytes = (tensor_bytes(reads, hit, p_nxt, tuple(p_sh), k_q)
              + shade + lights + cache_b + mat_b)
    time_vcm("camera_shade", f"bounce {bounce}, {label}",
             partial(vs.camera_shade_cuda, scene, c, hit, bounce, **kw),
             partial(vs.camera_shade_plain, scene, c, hit, bounce, **kw),
             nbytes, NUM_RAYS * (VCM_LANE_OPS["camera_shade"] + conns
                                 * VCM_LANE_OPS["connection"]),
             dict(lanes=NUM_RAYS, connections=conns, shade_row_bytes=shade,
                  light_row_bytes=lights, cache_row_bytes=cache_b,
                  material_row_bytes=mat_b), card, stats)
    sets = p_sh.ok.shape[0] // NUM_RAYS
    time_vcm("camera_finish", f"bounce {bounce}, {label}",
             partial(vs.camera_finish_cuda, *fin),
             partial(vs.camera_finish_plain, *fin),
             tensor_bytes(fin, k_fin[0]), NUM_RAYS * sets
             * VCM_LANE_OPS["camera_finish"], dict(lanes=NUM_RAYS,
                                                   sets=sets), card, stats)


# The still life's light bounces phase 4c holds the light kernel at: all
# alive, 42% alive on entry, and a late one with few lanes alive.
LIGHT_BOUNCES = (0, 3, 6)


def vcm_shade_phase(dev, card, scenes, stats):
    """Phase 4c: the VCM shade kernels against their plain versions on
    NUM_RAYS bands of the still life (light start, light bounces 0, 3 and
    6, the last at a low alive share, camera bounces 0 and 3 over the
    working cache of a light pass) and of
    the cornell with delta lights (light bounce 0, camera bounce 1 with
    VCM_CONNECTIONS connections); the kernels' resources.  The instanced
    scene's cell: phase 8a."""
    from imbatracer_torch.ops import vcm_shade as vs

    phase("4c VCM shade kernels vs plain")
    scene, meta = scenes["still_life"]
    cam, fi, lpc, cap = vcm_frame_inputs(scene, meta, 1920, 1080, 8, dev)
    label = f"still_life 1920x1080, {lpc} light paths"
    for bounce in LIGHT_BOUNCES:
        hold_vcm_light(label, scene, meta, cam, fi, lpc, 8, bounce, card,
                       stats, start_too=bounce == 0)
    fi = vcm_working_cache(scene, meta, cam, fi, lpc, cap, 8)
    log(f"[vcmshade] {label}: working cache {int(fi.cache_count)} vertices")
    for bounce in (0, 3):
        hold_vcm_camera(label, scene, meta, cam, fi, lpc, 8, bounce, 1,
                        card, stats)
    del fi
    delta = delta_light_cornell(dev)
    cam, fi, lpc, cap = vcm_frame_inputs(*delta, 1024, 1024, 8, dev)
    label = "cornell with point, spot and dir lights 1024x1024"
    hold_vcm_light(label, *delta, cam, fi, lpc, 8, 0, card, stats,
                   start_too=True)
    fi = vcm_working_cache(*delta, cam, fi, lpc, cap, 8)
    hold_vcm_camera(label, *delta, cam, fi, lpc, 8, 1, VCM_CONNECTIONS, card,
                    stats)
    for k in vs.RESOURCE_KERNELS:
        log_resources(f"vcm {k} kernel", vs.resources(k), card)


# Phase 4d: the traversal dispatch glue (ops/dispatch.py, csrc/dispatch.cu).
# Bytes behind bound_ms, each word once: keys read a slot's org and d (24
# B), its active flag and lane index where given and write its key; rows
# read perm (8 B), org and d, the active flag, lane index, tcur and the
# tmin / tmax words where they are arrays and write a 32 B row; the khit
# resolve reads perm, a (R, 32) row and the need flag and writes the need
# flag, and tcur and the hit where it takes them, and reads the distinct
# mask-record rows (40 B) of the hits it tests; the stream resolve reads
# perm and a (R, 8) row, the re-trace flag in re-trace mode, writes the
# hit (16 B) or a flag, and reads the mask rows of the hits it tests.
# Texel reads are not counted: the bound stays a least time.
DISPATCH_KERNELS = ("dispatch_keys", "dispatch_rows", "khit_resolve",
                    "stream_resolve")
BAND_KERNELS = {}             # traced graphed frames' kernels a replay


def bit_mismatches(k, p):
    """Elements of a kernel output that differ from the plain one's, bit
    for bit (a float as its int32 bits)."""
    if k.dtype == torch.float32:
        k, p = k.view(torch.int32), p.view(torch.int32)
    return int((k != p).sum())


def lane_bytes(x, n):
    """Bytes a dispatch reads of a lane array `x` (stride 0: one word)."""
    return 0 if x is None else (x.element_size() * (n if x.stride(0) else 1))


def tested_rows(ids, opaque, need):
    """Distinct ids among the hits a resolve alpha-tests: a row's hits in
    order while none before was present and opaque.  ids, opaque (n, K);
    need (n,)."""
    done = ~need
    tested = []
    for k in range(ids.shape[1]):
        valid = ids[:, k] >= 0
        tested.append(ids[:, k][~done & valid])
        done = done | (valid & opaque[:, k])
    return int(torch.unique(torch.cat(tested)).numel())


def hold_dispatch(label, scene, c, hit, alpha_fn, card, stats, record):
    """`[dispatch]`: the four dispatch kernels against their plain versions
    on a carry's bounce rays, in the main path's two forms -- a first
    round over every lane, and a re-trace round over a slot map (every
    third active lane) with its state by slot and tmin' past the slot's
    hit -- bit for bit: keys, rows, the khit resolve of the khit kernel's
    rows (flat masked scenes), the stream resolve's closest, re-trace
    (masked scenes) and occlusion modes on the stream kernel's rows.  Each
    kernel timed alone (graph_ms: 10 launches in one CUDA graph, the
    device's time; the resolves in place, idempotent) in the first form
    beside its plain version (3 calls) and its bound; the kernels in
    `record` go into `stats`."""
    from imbatracer_torch.ops import dispatch as dp
    from imbatracer_torch.ops import khit as kh
    from imbatracer_torch.ops import stream_traverse as st
    from imbatracer_torch.render import traverse as tt

    bvh = scene.bvh
    org, d, act = c["org"], c["d"], c["active"]
    n, dev = org.shape[0], org.device
    rs = np.random.RandomState(13)
    tmin = st.full_lanes(c["tmin"], n, dev)
    tmax = st.full_lanes(st.BIG, n, dev)
    tmax_any = torch.as_tensor(rs.uniform(0.1, 3.0, n) * float(
        scene.bsphere.radius), dtype=torch.float32, device=dev)
    slots = act.nonzero()[:, 0][::3].contiguous()
    masked, khit_route = alpha_fn is not None, (alpha_fn is not None
                                                and not bvh.two_level)
    bad = dict.fromkeys(DISPATCH_KERNELS, 0)
    timed, nbytes = {}, {}

    def both(name, kernel, plain, state):
        """Run kernel and plain on copies of `state` (kwargs; Hits
        included); count the elements they leave different."""
        def copy(x):
            return tt.Hit(*(v.clone() for v in x)) if isinstance(
                x, tt.Hit) else (x.clone() if torch.is_tensor(x) else x)
        a = {k: copy(v) for k, v in state.items()}
        b = {k: copy(v) for k, v in state.items()}
        kernel(**a)
        plain(**b)
        for k in state:
            if isinstance(state[k], tt.Hit):
                bad[name] += sum(bit_mismatches(x, y)
                                 for x, y in zip(a[k], b[k]))
            elif torch.is_tensor(state[k]) and k not in ("disp", "out"):
                bad[name] += bit_mismatches(a[k], b[k])
        return a

    for form in ("first", "retrace"):
        first = form == "first"
        ln = None if first else slots
        m = n if first else slots.shape[0]
        a = act if first else torch.ones(m, dtype=torch.bool, device=dev)
        tc = None if first else hit.t[slots].contiguous()
        kw = dict(active=a, center=bvh.center, lanes=ln, tcur=tc,
                  step=not first)
        keys = dp.keys_cuda(org, d, a, bvh.bounds, bvh.center, ln)
        bad["dispatch_keys"] += bit_mismatches(keys, dp.keys_plain(
            org, d, a, bvh.bounds, bvh.center, ln))
        perm = torch.sort(keys, stable=True)[1]
        rows = dp.rows_cuda(org, d, tmin, tmax, perm, m, **kw)
        bad["dispatch_rows"] += bit_mismatches(rows, dp.rows_plain(
            org, d, tmin, tmax, perm, m, **kw))
        disp = dp.Dispatch(rows, perm, m, ln, False)
        state_tmin = (tmin[:m].clone(memory_format=torch.contiguous_format)
                      if first else tc.clone())
        if khit_route:
            out = kh.khit_cuda(rows, bvh.sbox, bvh.tiles)
            kstate = dict(disp=disp, out=out, need_in=a,
                          need_out=torch.empty_like(a), tcur=state_tmin,
                          hit=tt._miss(m, dev), alpha_fn=alpha_fn)
            res = both("khit_resolve", dp.khit_resolve_cuda,
                       dp.khit_resolve_plain, kstate)
            if first:
                t4, u4, v4, id4 = dp._khit_columns(out[:m], 4)
                opq = dp.khit_opaque(out[:m], alpha_fn, 4)
                mrows = tested_rows(id4, opq, a[perm])
                nbytes["khit_resolve"] = (
                    m * (8 + 32 * 4 + 1 + 1)
                    + 4 * int(res["need_out"].sum())
                    + 16 * int((res["hit"].prim_id >= 0).sum())
                    + 40 * mrows)
                timed["khit_resolve"] = (
                    partial(dp.khit_resolve_cuda, **kstate),
                    partial(dp.khit_resolve_plain, **kstate))
        out = st.traverse_cuda(rows, bvh.sbox, bvh.tiles, False,
                               inst=bvh.inst)
        closest = dict(disp=disp, out=out, mode=dp.CLOSEST,
                       hit=tt._hits(m, dev))
        res = both("stream_resolve", dp.stream_resolve_cuda,
                   dp.stream_resolve_plain, closest)
        sstate = closest
        if masked:
            sstate = dict(disp=disp, out=out, mode=dp.RETRACE,
                          hit=res["hit"], flag=torch.empty_like(a),
                          retrace_in=a, select=not first, alpha_fn=alpha_fn)
            both("stream_resolve", dp.stream_resolve_cuda,
                 dp.stream_resolve_plain, sstate)
        if first:
            rid = out[:m, 3].to(torch.int32)
            sel = a[perm] & (rid >= 0)
            mrows = (int(torch.unique(rid[sel]).numel()) if masked else 0)
            nbytes["stream_resolve"] = m * (8 + 8 * 4 + 16 + 2 * masked) \
                + 40 * mrows
            timed["stream_resolve"] = (
                partial(dp.stream_resolve_cuda, **sstate),
                partial(dp.stream_resolve_plain, **sstate))
            nbytes["dispatch_keys"] = m * (24 + 1 + 4)
            nbytes["dispatch_rows"] = (m * (8 + 24 + 1 + 32)
                                       + lane_bytes(tmin, m)
                                       + lane_bytes(tmax, m))
            timed["dispatch_keys"] = (
                partial(dp.keys_cuda, org, d, a, bvh.bounds, bvh.center),
                partial(dp.keys_plain, org, d, a, bvh.bounds, bvh.center))
            timed["dispatch_rows"] = (
                partial(dp.rows_cuda, org, d, tmin, tmax, perm, m, **kw),
                partial(dp.rows_plain, org, d, tmin, tmax, perm, m, **kw))
            sort_ms = cuda_ms(lambda: torch.sort(keys, stable=True), 10)
        rows_any = dp.rows_cuda(org, d, tmin, st.full_lanes(
            tmax_any, n, dev), perm, m, **kw)
        occ = st.traverse_cuda(rows_any, bvh.sbox, bvh.tiles, True,
                               inst=bvh.inst)
        both("stream_resolve", dp.stream_resolve_cuda,
             dp.stream_resolve_plain,
             dict(disp=disp, out=occ, mode=dp.OCCLUSION,
                  flag=torch.empty_like(a)))
    torch.cuda.synchronize()
    log(f"[dispatch] {label}: {n} lanes, {float(act.double().mean()):.4f} "
        f"active, re-trace slots {slots.shape[0]}; elements not bit-equal "
        f"to the plain version: {bad} [{card}]")
    if any(bad.values()):
        raise AssertionError(f"[dispatch] {label}: the dispatch kernels "
                             f"disagree with their plain versions: {bad}")
    for name, (kernel, plain) in timed.items():
        ms = graph_ms(kernel)
        plain_ms = cuda_ms(plain, 3)
        bound_ms, bound_by = shade_bound(nbytes[name], 0)
        log(f"[time] {name} kernel, {label} [{card}]: kernel {ms:.4f} ms "
            f"(graph_ms; plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
            f"by {bound_by}, {nbytes[name]} bytes)")
        if name in record:
            stats[name] = (ms, None, (bound_ms, bound_by,
                                      dict(bytes=nbytes[name], lanes=n)))
            stats[f"{name}_plain_ms"] = plain_ms
            stats[f"{name}_err"] = 0.0
    log(f"[time] library sort a dispatch (torch.sort, stable, {n} int32 "
        f"keys), {label} [{card}]: {sort_ms:.4f} ms")
    if "dispatch_keys" in record:
        stats["library_sort_ms"] = sort_ms


def dispatch_phase(dev, card, scenes, stats):
    """Phase 4d: the dispatch kernels against their plain versions on
    NUM_RAYS-lane bands of bounce rays (shade_carry: PT frame 1 after its
    first bounce) of the still life and the cornell (the instanced
    scene's: phase 8a), with the kernels' resources."""
    from imbatracer_torch.ops import dispatch as dp

    phase("4d dispatch glue kernels vs plain")
    record = {"dispatch_keys", "dispatch_rows", "khit_resolve"}
    for key, w, h, max_len in (("still_life", 1920, 1080, 8),
                               ("cornell", 1024, 1024, 10)):
        scene, meta = scenes[key]
        c, hit, alpha_fn = shade_carry(scene, meta, w, h, max_len, 1, dev)
        hold_dispatch(f"{key} {w}x{h} bounce 1", scene, c, hit, alpha_fn,
                      card, stats, record)
        record = set()
    for k in DISPATCH_KERNELS:
        log_resources(f"{k} kernel", dp.resources(k), card)


# Phase 4e: the light band's tail (ops/light_tail.py, csrc/light_tail.cu)
# and the graph-ready re-trace's slot kernels (ops/dispatch.py,
# csrc/dispatch.cu).  Bytes behind bound_ms, each word once: the append
# reads each staged row's flag and prefix (5 B) and the count, copies the
# rows that fit (96 B in, 96 B out) and writes the count and lost; the
# splat reads each row's pixel id (4 B) and the contributions of the rows
# with one (12 B) and writes the fresh film (12 B a pixel); the slot
# gather reads a slot's lane index (8 B), the count and its distinct
# lanes' tcur and hit (16-20 B) and writes the slot's two flags, tcur and
# hit and the dropped count; the finish reads every active flag and
# every slot's unresolved and valid flags (1 B each) and three counts and
# writes the overflow and five counts, and merges the hits: reads a
# valid slot's lane index and hit (24 B) and writes its lane's hit (16
# B).
INT_COLS = (14, 21, 22)       # mat_id, path_length, path_id of a cache row
SLOT_KERNELS = ("slot_gather", "slot_finish")
# The launch counts of the slots that the counter lines print: the merge's
# reads 0, its work done in slot_finish's launch.
SLOT_COUNTS = ("slot_gather", "slot_merge", "slot_finish")
TAIL_KERNELS = ("collect_append", "splat")


def light_band_tail(scene, meta, cam, fi, lpc, max_len):
    """The staged rows of the middle NUM_RAYS-path light band of a vcm
    frame (vcm._light_pass as the renderer runs it, through the kernels,
    its append and splat recorded instead of run): (valid (N,), rows (N,
    24), contrib (N, 3), pixel (N,)), N = max_len * NUM_RAYS."""
    from imbatracer_torch.render.integrators import pt, vcm

    got = {}

    class Recorder:
        def append(self, valid, rows):
            got["rows"] = (valid.clone(), rows.clone())

    def splat(contrib, pixel, num_pixels):
        got["cc"] = (contrib.clone(), pixel.clone())
        return torch.zeros((num_pixels, 3), device=contrib.device)

    orig = vcm.splat
    vcm.splat = splat
    try:
        vcm._light_pass(
            scene, cam, fi.frame, fi.mis_eta_vc, fi.mis_eta_vm, Recorder(),
            algo="vcm", num_pixels=cam.width * cam.height,
            light_path_count=lpc, max_len=max_len,
            alpha_fn=pt.alpha_fn_for(scene) if meta.has_masks else None,
            has_bump=meta.has_bump, path_start=(lpc - NUM_RAYS) // 2,
            band_paths=NUM_RAYS)
    finally:
        vcm.splat = orig
    return got["rows"] + got["cc"]


def hold_append(label, valid, rows, cap, count0, card, stats, timed):
    """`[tail]`: collect_append_cuda against collect_append_plain from the
    same seeded buffer of cap + 1 rows holding `count0` rows: rec[:cap],
    count and lost bit-equal, lost the rows past the capacity, and
    CollectCache.check raising exactly when one did not fit.  With
    `timed`, the wrapper (the library prefix, the copy and the tail; the
    count's reset taken off) beside the plain version, one index_copy_
    of the plain version's targets, and the bound."""
    from imbatracer_torch.ops import light_tail as lt
    from imbatracer_torch.render.light_cache import CollectCache

    dev = rows.device
    gen = torch.Generator(device=dev).manual_seed(cap)
    rec0 = torch.randn((cap + 1, rows.shape[1]), generator=gen, device=dev)
    c0 = torch.full((), count0, dtype=torch.int32, device=dev)

    def state():
        return CollectCache(rec0.clone(), c0.clone(), torch.zeros_like(c0))

    a, b = state(), state()
    lt.collect_append_cuda(a.rec, a.count, a.lost, valid, rows)
    lt.collect_append_plain(b.rec, b.count, b.lost, valid, rows)
    torch.cuda.synchronize()
    nvalid = int(valid.sum())
    fit = max(min(nvalid, cap - count0), 0)
    bad = (bit_mismatches(a.rec[:cap], b.rec[:cap])
           + bit_mismatches(a.count, b.count) + bit_mismatches(a.lost, b.lost))
    lost = count0 + nvalid - cap
    try:
        a.check()
        raised = False
    except RuntimeError:
        raised = True
    log(f"[tail] collect append, {label}: {rows.shape[0]} staged rows, "
        f"{nvalid} valid, capacity {cap}, {count0} rows before; count "
        f"{int(a.count)}, lost {int(a.lost)}, check raised {raised}; "
        f"elements not bit-equal to the plain version: {bad} [{card}]")
    if (bad or int(a.lost) != max(lost, 0) or raised != (lost > 0)
            or int(a.count) != min(count0 + nvalid, cap)):
        raise AssertionError(f"[tail] collect append, {label}: the kernel "
                             f"disagrees with the plain version or lost "
                             f"the wrong rows")
    if not timed:
        return
    rec, cnt, lost_t = a.rec, a.count, a.lost
    reset = lambda: cnt.copy_(c0)
    v = valid.to(torch.int32)
    slot = c0 + (torch.cumsum(v, 0, dtype=torch.int32) - v)
    target = torch.where(valid & (slot < cap), slot, cap).long()
    reset_ms = graph_ms(reset)
    ms = graph_ms(lambda: (reset(), lt.collect_append_cuda(
        rec, cnt, lost_t, valid, rows))) - reset_ms
    wrapper_ms = cuda_ms(lambda: (reset(), lt.collect_append_cuda(
        rec, cnt, lost_t, valid, rows)), 10) - cuda_ms(reset, 10)
    plain_ms = cuda_ms(lambda: (reset(), lt.collect_append_plain(
        rec, cnt, lost_t, valid, rows)), 3) - cuda_ms(reset, 3)
    library_ms = cuda_ms(lambda: rec.index_copy_(0, target, rows), 3)
    nbytes = rows.shape[0] * 5 + 4 + fit * 96 * 2 + 8
    bound_ms, bound_by = shade_bound(nbytes, 0)
    log(f"[time] collect_append kernel, {label} [{card}]: kernel {ms:.4f} "
        f"ms (device, graphed launches: library prefix, copy, tail; the "
        f"wrapper {wrapper_ms:.4f} ms; plain {plain_ms:.3f} ms, library "
        f"index_copy_ {library_ms:.3f} ms, bound {bound_ms:.4f} ms by "
        f"{bound_by}, {nbytes} bytes)")
    stats["collect_append"] = (ms, None, (bound_ms, bound_by,
                                          dict(bytes=nbytes, rows=fit)))
    stats.update(collect_append_plain_ms=plain_ms, collect_append_err=0.0,
                 collect_append_library_ms=library_ms)


def hold_splat(label, contrib, pixel, num_pixels, card, stats):
    """`[tail]`: splat_cuda against splat_plain on a band's camera
    connections (both add with atomics): film mean within DIST_VCM_MEAN
    relative, DIST_VCM_PIXELS of the pixels within DIST_VCM_REL (phase
    14's rule); timed beside the plain version, one index_add_ of the
    plain version's pixel ids into a zeroed film, and the bound."""
    from imbatracer_torch.ops import light_tail as lt

    k = lt.splat_cuda(contrib, pixel, num_pixels)
    p = lt.splat_plain(contrib, pixel, num_pixels)
    mean, within, worst = vcm_parity(k, p)
    err = float((k - p).abs().max())
    n = int((pixel >= 0).sum())
    log(f"[tail] splat, {label}: {pixel.shape[0]} rows, {n} with a pixel; "
        f"film mean rel {mean:.3e}, pixels within {DIST_VCM_REL} "
        f"{within:.6f}, max rel {worst:.3e}, max abs {err:.3e} [{card}]")
    if not (mean <= DIST_VCM_MEAN and within >= DIST_VCM_PIXELS
            and float(k.mean()) > 0.0):
        raise AssertionError(f"[tail] splat, {label}: the kernel's film "
                             f"disagrees with the plain version's")
    pid = torch.where(pixel >= 0, pixel, num_pixels).long()
    film = torch.zeros((num_pixels + 1, 3), device=contrib.device)
    ms = graph_ms(lambda: lt.splat_cuda(contrib, pixel, num_pixels))
    wrapper_ms = cuda_ms(lambda: lt.splat_cuda(contrib, pixel, num_pixels),
                         10)
    plain_ms = cuda_ms(lambda: lt.splat_plain(contrib, pixel, num_pixels), 3)
    library_ms = cuda_ms(lambda: film.index_add_(0, pid, contrib), 3)
    nbytes = pixel.shape[0] * 4 + n * 12 + num_pixels * 12
    bound_ms, bound_by = shade_bound(nbytes, 0)
    log(f"[time] splat kernel, {label} [{card}]: kernel {ms:.4f} ms "
        f"(device, graphed launches: the film's zeros and the kernel; the "
        f"wrapper {wrapper_ms:.4f} ms; plain {plain_ms:.3f} ms, library "
        f"index_add_ {library_ms:.3f} ms, bound {bound_ms:.4f} ms by "
        f"{bound_by}, {nbytes} bytes)")
    stats["splat"] = (ms, None, (bound_ms, bound_by,
                                 dict(bytes=nbytes, rows=n)))
    stats.update(splat_plain_ms=plain_ms, splat_err=err,
                 splat_library_ms=library_ms)


def recorded_slots(scene, c, alpha_fn):
    """The arguments of the graph-ready re-trace's slot gather on a
    carry's bounce rays (render/traverse.gather_slots recorded in one
    masked closest hit with an overflow counter): (need, slots, hit,
    tcur)."""
    from imbatracer_torch.render import traverse as tt
    from imbatracer_torch.render.intersect import BIG

    got = []
    orig = tt.gather_slots

    def record(need, slots, hit, tcur=None):
        got.append((need.clone(), slots, tt.Hit(*(x.clone() for x in hit)),
                    None if tcur is None else tcur.clone()))
        return orig(need, slots, hit, tcur)

    tt.gather_slots = record
    try:
        tt.closest_hit(scene.bvh, c["org"], c["d"], c["tmin"], BIG,
                       alpha_fn=alpha_fn, active=c["active"], sort=True,
                       overflow=torch.zeros((), dtype=torch.int32,
                                            device=c["org"].device))
    finally:
        tt.gather_slots = orig
    return got[0]


def random_slots_case(n, density, slots, seed, dev, tcur=True):
    """Seeded inputs of a slot gather over n lanes: (active, need, hit,
    tcur); `need` a `density` share of the active lanes (none active at
    density 0)."""
    from imbatracer_torch.render import traverse as tt

    rs = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(a).to(dev)
    act = rs.rand(n) < (0.8 if density else 0.0)
    need = act & (rs.rand(n) < density / 0.8)
    hit = tt.Hit(t(rs.uniform(0, 9, n).astype(np.float32)),
                 t(rs.randint(-1, 5000, n).astype(np.int32)),
                 t(rs.rand(n).astype(np.float32)),
                 t(rs.rand(n).astype(np.float32)))
    return (t(act), t(need), hit,
            t(rs.uniform(0, 9, n).astype(np.float32)) if tcur else None)


def slot_mismatches(k, p):
    """Elements of two slot selections (dispatch.Slots) not bit-equal: the
    slots' lanes, flags, tcur and hits, the count and the dropped lanes
    (an output one has and the other lacks: 1)."""
    bad = 0
    for x, y in zip(k[:4] + tuple(k.hit) + k[5:],
                    p[:4] + tuple(p.hit) + p[5:]):
        if (x is None) != (y is None):
            bad += 1
        elif x is not None:
            bad += bit_mismatches(x, y)
    return bad


def dispatch_cases():
    """tests/torch_dispatch_cases.py, the shapes and cases the dispatch
    tests share (numpy only)."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tests")
    if tests not in sys.path:
        sys.path.insert(1, tests)
    import torch_dispatch_cases
    return torch_dispatch_cases


def selection_inputs(case, two_level, seed, dev):
    """Seeded inputs of the slot selection case `case` (SELECT_CASES of
    dispatch_cases()) over a NUM_RAYS-lane band at the flat or two-level
    slot share, on `dev`: (need, slots, hit, tcur or None)."""
    from imbatracer_torch.render import traverse as tt

    need, slots, hit, tcur = dispatch_cases().select_case(
        case, NUM_RAYS, 40 + seed, lambda n: tt.retrace_slots(n, two_level),
        not two_level)
    t = lambda a: torch.from_numpy(a).to(dev)
    return (t(need), slots, tt.Hit(*map(t, hit)),
            None if tcur is None else t(tcur))


def hold_selections(dev, card):
    """`[slots]` selection cells: slot_gather_kernel, which selects the
    slots from the need flags in one launch, against its plain version
    (nonzero_static, the sum, the gathers) bit for bit in every case of
    the dispatch tests' SELECT_CASES (no lane in need, every lane, as
    many as the slots, more, only the last lane, lanes that fill no whole
    word or tile of the kernel) at the flat (1,024) and two-level
    (65,536) slot shares of a NUM_RAYS-lane band, each launched twice
    (the status words are back at 0 after a launch)."""
    from imbatracer_torch.ops import dispatch as dp

    for two_level in (False, True):
        for seed, case in enumerate(dispatch_cases().SELECT_CASES):
            need, slots, hit, tcur = selection_inputs(case, two_level, seed,
                                                      dev)
            n = need.shape[0]
            p = dp.slot_gather_plain(need, slots, hit, tcur)
            bad = [slot_mismatches(dp.slot_gather_cuda(need, slots, hit,
                                                       tcur), p)
                   for _ in range(2)]
            torch.cuda.synchronize()
            label = (f"selection {case}, {'two-level' if two_level else 'flat'}"
                     f" share")
            log(f"[slots] {label}: {n} lanes, {int(p.count)} in need, "
                f"{slots} slots ({int(p.valid.sum())} valid, "
                f"{int(p.dropped)} dropped); elements not bit-equal to the "
                f"plain version, two launches: {bad} [{card}]")
            if any(bad):
                raise AssertionError(f"[slots] {label}: the selection "
                                     f"disagrees with its plain version: "
                                     f"{bad}")


def time_loop_test(dev, card):
    """`[time]` lines of the WHILE nodes' flag kernel (csrc/graph_cond.cu
    set_conditional) at the flat (1,024) and two-level (65,536) slot
    shares of a NUM_RAYS-lane band: a captured step that runs one
    re-trace loop over the slots' need flags (the last one set) with a
    one-kernel body (a scalar add), its condition a graphs.LoopTest (the
    flag kernel tests the flags and the cap and counts the rounds: one
    launch at the entry, one a pass) and the composite it replaced (a
    ones fill, need.any() & (rounds < cap) and the flag kernel on that
    flag before the node; the round's add, the same test and the flag
    kernel at the end of each pass); cap 1 (the entry alone) and 33 (32
    passes).  Each replay checked for its passes and rounds first; device
    ms a replay (CUDA events), the entry and a pass apart."""
    from imbatracer_torch.render import graphs
    from imbatracer_torch.render import traverse as tt

    sg = graphs.SceneGraphs(dev)
    for two_level in (False, True):
        slots = tt.retrace_slots(NUM_RAYS, two_level)
        ms = {}
        for passes in (0, 32):
            cap = passes + 1
            for form in ("kernel", "composite"):
                state = {"need": torch.zeros(slots, dtype=torch.bool,
                                             device=dev),
                         "x": torch.zeros((), device=dev),
                         "count": torch.ones((), dtype=torch.int32,
                                             device=dev),
                         "rounds": torch.zeros((), dtype=torch.int32,
                                               device=dev)}
                state["need"][-1] = True

                def step(s_, overflow, form=form, cap=cap):
                    def body():
                        s_["x"].add_(1.0)

                    if form == "kernel":
                        graphs.while_loop(graphs.LoopTest(
                            s_["need"], s_["count"], s_["rounds"], cap),
                            body)
                        return
                    s_["rounds"].fill_(1)

                    def counted():
                        body()
                        s_["rounds"].add_(1)

                    graphs.while_loop(
                        lambda: s_["need"].any() & (s_["rounds"] < cap),
                        counted)

                g = sg.phase(("loop_test", form, two_level, passes), step,
                             state)
                state["x"].zero_()
                g.replay()
                got = (float(state["x"]), int(state["rounds"]))
                if got != (passes, passes + 1):
                    raise AssertionError(
                        f"[time] loop test ({form}, {slots} slots): "
                        f"(passes, rounds) {got}, not {(passes, cap)}")
                ms[form, passes] = cuda_ms(g.replay, 20)
        a_pass = {f: (ms[f, 32] - ms[f, 0]) / 32
                  for f in ("kernel", "composite")}
        log(f"[time] set_conditional, the WHILE node's loop test over "
            f"{slots} slots [{card}]: the entry with the node {ms['kernel', 0]:.4f} "
            f"ms (the composite {ms['composite', 0]:.4f}), a pass with its "
            f"one-kernel body {a_pass['kernel']:.4f} ms (the composite "
            f"{a_pass['composite']:.4f}); replays of 32 passes "
            f"{ms['kernel', 32]:.4f} / {ms['composite', 32]:.4f} ms; bound "
            f"{(slots + 8) / HBM_BYTES_PER_S * 1e3:.6f} ms by bytes (the "
            f"slots' flags)")


def finish_case(k, act, seed):
    """Seeded inputs of the finish after the slot gather `k` (dispatch.Slots
    on the card): (slots, rounds, counts, where, deltas): `k` with seeded
    slot hits and a seeded half of its valid slots left unresolved,
    seeded rounds, a seeded counts vector whose slot 0 is the overflow
    counter (FINISH_KEYS at slots 3-7), and five seeded per-run counts of
    the loop's body (keys, rows, khit, its resolve, the round, as the
    graphs fold them)."""
    from imbatracer_torch.ops import dispatch as dp
    from imbatracer_torch.render import traverse as tt

    n = k.idx.shape[0]
    rs = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(a).to(act.device)
    sub = tt.Hit(t(rs.uniform(0, 9, n).astype(np.float32)),
                 t(rs.randint(-1, 5000, n).astype(np.int32)),
                 t(rs.rand(n).astype(np.float32)),
                 t(rs.rand(n).astype(np.float32)))
    left = k._replace(hit=sub, need=k.valid & t(rs.rand(n) < 0.5))
    rounds = t(np.asarray(rs.randint(1, 9), dtype=np.int32))
    counts = t(rs.randint(0, 100, 14).astype(np.int32))
    where = (list(range(3, 3 + len(dp.FINISH_KEYS))),
             [key.startswith("max_") for key in dp.FINISH_KEYS])
    deltas = [(int(x), 1) for x in rs.choice([1, 2] + list(range(8, 14)), 5,
                                             replace=False)]
    return left, rounds, counts, where, deltas


def finish_mismatches(act, left, rounds, counts0, where, deltas, hit):
    """Elements not bit-equal between slot_finish_kernel, one launch that
    merges the slots' hits into a copy of `hit` in place and updates a
    copy of `counts0`, and its plain version, slot_finish_plain then
    slot_merge_plain: the merged hit and the counts (the overflow their
    slot 0)."""
    from imbatracer_torch.ops import dispatch as dp
    from imbatracer_torch.render import traverse as tt

    ck, cp = counts0.clone(), counts0.clone()
    own = tt.Hit(*(x.clone() for x in hit))
    got = dp.slot_finish_cuda(ck[0], act, left, rounds, (ck,) + where,
                              deltas, hit=own)
    want = dp.slot_finish_plain(cp[0], act, left, rounds, (cp,) + where,
                                deltas, hit=hit)
    bad = bit_mismatches(ck, cp) + sum(bit_mismatches(x, y)
                                       for x, y in zip(got, want))
    return bad + sum(x is not y for x, y in zip(got, own))


def hold_slots(label, act, need, slots, hit, tcur, seed, card, stats,
               record):
    """`[slots]`: the two slot kernels against their plain versions, bit
    for bit: the gather (the slots selected from the need flags, their
    state, the count and the dropped lanes); the finish (finish_case's
    inputs) in one launch against slot_finish_plain then slot_merge_plain:
    the slots' hits merged into a copy of `hit` where the slots are
    valid, and the overflow and device counts with the loop body's
    per-run counts folded in.  Each kernel timed alone beside its plain
    version and its bound; with `record`, into `stats`."""
    from imbatracer_torch.ops import dispatch as dp
    from imbatracer_torch.render import traverse as tt

    n = need.shape[0]
    bad = dict.fromkeys(SLOT_KERNELS, 0)
    k = dp.slot_gather_cuda(need, slots, hit, tcur)
    p = dp.slot_gather_plain(need, slots, hit, tcur)
    bad["slot_gather"] = slot_mismatches(k, p)
    left, rounds, counts0, where, deltas = finish_case(k, act, seed)
    bad["slot_finish"] = finish_mismatches(act, left, rounds, counts0, where,
                                           deltas, hit)
    torch.cuda.synchronize()
    nvalid, ncount = int(k.valid.sum()), int(k.count)
    log(f"[slots] {label}: {n} lanes, {int(act.sum())} active, {ncount} "
        f"in need, {slots} slots ({nvalid} valid, {int(k.dropped)} "
        f"dropped); elements not bit-equal to the plain version: {bad} "
        f"[{card}]")
    if any(bad.values()):
        raise AssertionError(f"[slots] {label}: the slot kernels disagree "
                             f"with their plain versions: {bad}")
    lanes = nvalid + int(nvalid < slots)
    tw = 4 if tcur is not None else 0
    nbytes = {"slot_gather": n + slots * (8 + 2 + 16 + tw) + 8
              + lanes * (16 + tw),
              "slot_finish": n + 2 * slots + 12 + 24 + 8 * len(deltas)
              + nvalid * (8 + 16 + 16)}
    ck, cp = counts0.clone(), counts0.clone()
    hit_copy = tt.Hit(*(x.clone() for x in hit))

    def finish_plain():
        dp.slot_finish_plain(cp[0], act, left, rounds, (cp,) + where, deltas,
                             hit=hit)

    fns = {"slot_gather": (partial(dp.slot_gather_cuda, need, slots, hit,
                                   tcur),
                           partial(dp.slot_gather_plain, need, slots, hit,
                                   tcur)),
           "slot_finish": (partial(dp.slot_finish_cuda, ck[0], act, left,
                                   rounds, (ck,) + where, deltas,
                                   hit=hit_copy), finish_plain)}
    for name, (kernel, plain) in fns.items():
        ms = graph_ms(kernel)
        wrapper_ms = cuda_ms(kernel, 10)
        plain_ms = cuda_ms(plain, 3)
        bound_ms, bound_by = shade_bound(nbytes[name], 0)
        # The selection's composite (nonzero_static, the sum, the gathers)
        # graphed, as the graph routes ran it: the yardstick.
        also = (f"; the plain composite graphed {graph_ms(plain):.4f} ms"
                if name == "slot_gather" else
                f"; the hits of {nvalid} valid slots merged")
        log(f"[time] {name} kernel, {label} [{card}]: kernel {ms:.4f} ms "
            f"(device, graphed launches; the wrapper {wrapper_ms:.4f} ms; "
            f"plain {plain_ms:.3f} ms, bound {bound_ms:.5f} ms by "
            f"{bound_by}, {nbytes[name]} bytes{also})")
        if record:
            stats[name] = (ms, None, (bound_ms, bound_by,
                                      dict(bytes=nbytes[name], lanes=n,
                                           slots=slots)))
            stats.update({f"{name}_plain_ms": plain_ms, f"{name}_err": 0.0})


def tail_phase(dev, card, scenes, stats):
    """Phase 4e: the light band's tail kernels against their plain
    versions on the middle NUM_RAYS-path band of a still-life vcm frame
    at 1920x1080 with VCM_LPC light paths (its 8 x NUM_RAYS staged rows):
    the append into an empty collect cache of the frame's capacity, into
    one holding all but half the band's valid rows (it overflows: lost
    and CollectCache.check's raise) and into a full one; the splat of the
    band's camera connections.  Then the slot kernels on the still life's
    bounce-1 rays as its graph-ready khit re-trace gathers them, and on
    seeded need masks at both slot shares: no lane active, past the
    slots, within them; the selection's cells (hold_selections).  The
    kernels' resources."""
    from imbatracer_torch.ops import dispatch as dp
    from imbatracer_torch.ops import light_tail as lt
    from imbatracer_torch.render import traverse as tt

    phase("4e light-band tail and re-trace slot kernels vs plain")
    scene, meta = scenes["still_life"]
    cam, fi, lpc, _ = vcm_frame_inputs(scene, meta, 1920, 1080, 8, dev)
    valid, rows, contrib, pixel = light_band_tail(scene, meta, cam, fi, lpc,
                                                  8)
    label = f"still_life 1920x1080 band of {NUM_RAYS} of {lpc} light paths"
    nvalid = int(valid.sum())
    cap = lpc * 8
    hold_append(label, valid, rows, cap, 0, card, stats, timed=True)
    hold_append(f"{label}, overflowing", valid, rows, nvalid + 1000,
                1000 + nvalid // 2, card, stats, timed=False)
    hold_append(f"{label}, full", valid, rows, nvalid, nvalid, card, stats,
                timed=False)
    hold_splat(label, contrib, pixel, 1920 * 1080, card, stats)
    del valid, rows, contrib, pixel
    c, _, alpha_fn = shade_carry(scene, meta, 1920, 1080, 8, 1, dev)
    need, slots, hit, tcur = recorded_slots(scene, c, alpha_fn)
    hold_slots("still_life 1920x1080 bounce 1, the khit re-trace's",
               c["active"], need, slots, hit, tcur, 1, card, stats,
               record=True)
    for density, two_level, seed in ((0.0, False, 2), (0.01, False, 3),
                                     (0.2, True, 4), (0.3, True, 5)):
        slots = tt.retrace_slots(NUM_RAYS, two_level)
        act, need, hit, tcur = random_slots_case(NUM_RAYS, density, slots,
                                                 seed, dev, not two_level)
        hold_slots(f"seeded need {density} of the lanes, "
                   f"{'two-level' if two_level else 'flat'} share",
                   act, need, slots, hit, tcur, seed, card, stats,
                   record=False)
    hold_selections(dev, card)
    time_loop_test(dev, card)
    for k in ("collect_append", "collect_tail", "splat"):
        log_resources(f"{k} kernel", lt.resources(k), card)
    for k in SLOT_KERNELS:
        log_resources(f"{k} kernel", dp.resources(k), card)


MIDDLE_KERNELS = ("select_keys", "select_gather", "grid_keys", "grid_tiles")


def hold_middle(label, name, pairs, card):
    """`[middle]`: the elements of each (kernel output, plain output) pair
    not bit-equal, which must be 0 (a pair of other shapes or types:
    every element)."""
    bad = sum(bit_mismatches(k.contiguous(), p.contiguous())
              if k.shape == p.shape and k.dtype == p.dtype
              else max(k.numel(), p.numel(), 1) for k, p in pairs)
    log(f"[middle] {name}, {label}: elements not bit-equal to the plain "
        f"version: {bad} [{card}]")
    if bad:
        raise AssertionError(f"[middle] {name}, {label}: the kernel "
                             f"disagrees with its plain version")


def time_middle(name, label, launch, plain, nbytes, card, stats,
                library=None, detail=""):
    """`[time]` of one middle kernel: its device time over 10 graphed
    launches (graph_ms), its plain version (3 calls), its bytes bound
    and, with `library`, one library call of the same function; the
    first cell's times go to `stats`."""
    ms = graph_ms(launch)
    plain_ms = cuda_ms(plain, 3)
    library_ms = None if library is None else cuda_ms(library, 3)
    bound_ms, bound_by = shade_bound(nbytes, 0)
    lib = "" if library is None else f", library {library_ms:.4f} ms"
    log(f"[time] {name} kernel, {label} [{card}]: kernel {ms:.4f} ms "
        f"(device, graphed launches; plain {plain_ms:.3f} ms{lib}, bound "
        f"{bound_ms:.4f} ms by {bound_by}, {nbytes} bytes{detail})")
    stats.setdefault(name, (ms, None, (bound_ms, bound_by,
                                       dict(bytes=nbytes))))
    stats.setdefault(f"{name}_plain_ms", plain_ms)
    stats.setdefault(f"{name}_library_ms", library_ms)
    stats.setdefault(f"{name}_err", 0.0)


def hold_selection(label, rec, n, cap, bounds, card, stats, timed):
    """The selection's kernels against their plain versions on the first
    n (valid) rows of the packed collect rows `rec`: the admission keys
    in both widths, the canonical keys of the kept rows, the gather's
    rows (zero past the kept ones) and its box; returns the working
    cache (LightVertexCache, with the card's box).  With `timed`, each
    kernel's `[time]` line."""
    from imbatracer_torch.ops import select as sel
    from imbatracer_torch.render.light_cache import LightVertexCache

    b1 = sel.key_bits(bounds["lengths"], bounds["paths"])
    b2 = sel.key_bits(bounds["paths"], bounds["lengths"])
    order1, kept, rows = None, n, rec.shape[0]
    if cap < rec.shape[0]:
        pairs = [(sel.select_keys_cuda(rec, n, None, sel.SHALLOW, b),
                  sel.select_keys_plain(rec, n, None, sel.SHALLOW, b))
                 for b in (b1, None)]
        hold_middle(label, f"admission keys ({b1}-bit minor and 64-bit)",
                    pairs, card)
        order1 = torch.sort(pairs[0][0], stable=True)[1][:cap]
        kept, rows = min(n, cap), cap
    k2 = sel.select_keys_cuda(rec, kept, order1, sel.CANONICAL, b2)
    hold_middle(label, "canonical keys of the kept rows", [(k2, (
        sel.select_keys_plain(rec, kept, order1, sel.CANONICAL, b2)))], card)
    order2 = torch.sort(k2, stable=True)[1]
    out, box = sel.select_gather_cuda(rec, order1, order2, rows)
    ref, _ = sel.select_gather_plain(rec, order1, order2, rows)
    hold_middle(label, "gathered rows", [(out, ref)], card)
    got, want = sel.box_floats(box), sel.box_plain(ref, kept)
    log(f"[middle] box, {label}: {got.tolist()} (plain min and max "
        f"{want.tolist()}); rows past the kept {kept} all zero "
        f"{not bool(out[kept:].any())} [{card}]")
    if not torch.equal(got, want) or bool(out[kept:].any()):
        raise AssertionError(f"[middle] box, {label}: the gather's box or "
                             f"its rows past the kept ones are wrong")
    if timed:
        nk, i64 = 4 if b1 is not None else 8, 8
        time_middle("select_keys", f"{label}, admission keys of {n} rows",
                    lambda: sel.select_keys_cuda(rec, n, None, sel.SHALLOW,
                                                 b1),
                    lambda: sel.select_keys_plain(rec, n, None, sel.SHALLOW,
                                                  b1),
                    n * (8 + nk), card, stats)
        time_middle("select_keys", f"{label}, canonical keys of {kept} "
                    f"kept rows", lambda: sel.select_keys_cuda(
                        rec, kept, order1, sel.CANONICAL, b2),
                    lambda: sel.select_keys_plain(rec, kept, order1,
                                                  sel.CANONICAL, b2),
                    kept * (i64 + 8 + nk), card, {})
        src = order2 if order1 is None else order1[order2]
        time_middle("select_gather", f"{label}, {kept} kept rows of {rows}",
                    lambda: sel.select_gather_cuda(rec, order1, order2, rows),
                    lambda: sel.select_gather_plain(rec, order1, order2,
                                                    rows),
                    kept * (2 * i64 + 96) + rows * 96 + 24, card, stats,
                    library=lambda: torch.index_select(rec, 0, src),
                    detail="; library: index_select of the composed order")
    count = torch.tensor(kept, dtype=torch.int32, device=rec.device)
    return LightVertexCache(out, count, box)


def hold_grid(label, cache, radius, card, stats, timed):
    """The grid's kernels against their plain versions on a working
    cache: keys, bbox_min, inv_cell, radius_sqr, then (the same sort)
    tiles and padded keys, every element bit-equal."""
    from imbatracer_torch.ops import merge as mg

    rec, count = cache.rec, cache.count
    rows = rec.shape[0]
    valid = torch.arange(rows, device=rec.device) < count
    key, bmin, inv, r2 = mg.grid_keys_cuda(rec, count, cache.box, radius)
    pkey, pbmin, pinv = mg.grid_keys_plain(cache.pos, valid, radius)
    hold_middle(label, "grid keys, bbox_min, inv_cell, radius_sqr",
                [(key, pkey), (bmin, pbmin), (inv, pinv),
                 (r2, radius * radius)], card)
    ks, order = torch.sort(key, stable=True)
    cols = (cache.pos, valid, cache.w_out, cache.throughput, cache.d_vcm,
            cache.d_vm)
    tiles, keys = mg.grid_tiles_cuda(rec, count, ks, order)
    ptiles, pkeys = mg.grid_tiles_plain(ks, order, *cols)
    hold_middle(label, "grid tiles and padded keys",
                [(tiles, ptiles), (keys, pkeys)], card)
    if not timed:
        return
    n = int(count)
    time_middle("grid_keys", f"{label}, {n} photons of {rows}",
                lambda: mg.grid_keys_cuda(rec, count, cache.box, radius),
                lambda: mg.grid_keys_plain(cache.pos, valid, radius),
                n * 12 + rows * 4 + 24 + 20, card, stats)
    time_middle("grid_tiles", f"{label}, {tiles.shape[0]} tiles",
                lambda: mg.grid_tiles_cuda(rec, count, ks, order),
                lambda: mg.grid_tiles_plain(ks, order, *cols),
                rows * (8 + 4 + 48) + tiles.numel() * 4 + keys.numel() * 4,
                card, stats)


def middle_phase(dev, card, scenes, stats):
    """Phase 4f: the frame's middle kernels against their plain versions
    on the still life's collect cache from a real light pass at
    1920x1080 with VCM_LPC light paths (the frame's selection to its
    working capacity), on the same rows cut to half their count and
    canonicalised without a cut, and on an empty cache; each kernel timed on the first; the whole middle through
    the kernels and through the plain versions, with peak memory; the
    kernels' resources."""
    from imbatracer_torch.ops import merge as mg
    from imbatracer_torch.ops import select as sel
    from imbatracer_torch.render import light_cache
    from imbatracer_torch.render.integrators import vcm

    phase("4f the frame's middle: selection and photon grid kernels vs "
          "plain")
    scene, meta = scenes["still_life"]
    cam, fi, lpc, cap = vcm_frame_inputs(scene, meta, 1920, 1080, 8, dev)
    collect, n = vcm_collect(scene, meta, cam, fi, lpc, 8)
    rec = collect.cache().rec
    bounds = vcm.key_bounds(lpc, 8)
    label = (f"still_life 1920x1080, {n} collected of {rec.shape[0]} rows, "
             f"capacity {cap}")
    cache = hold_selection(label, rec, n, cap, bounds, card, stats,
                           timed=True)
    hold_grid(label, cache, fi.pm_radius, card, stats, timed=True)
    half = hold_selection(f"{label}, cut to {n // 2}", rec, n, n // 2,
                          bounds, card, stats, timed=False)
    hold_grid(f"{label}, cut to {n // 2}", half, fi.pm_radius, card, stats,
              timed=False)
    whole = hold_selection(f"{label}, canonical order alone", rec, n,
                           rec.shape[0], bounds, card, stats, timed=False)
    del half, whole
    empty = hold_selection("an empty cache", rec, 0, cap, bounds, card, stats,
                           timed=False)
    hold_grid("an empty cache", empty, fi.pm_radius, card, stats,
              timed=False)

    def kernels():
        c = light_cache.select_shallowest(collect.cache(), cap, count=n,
                                          **bounds)
        return vcm.photon_grid(c, fi.pm_radius)

    def plain():
        b1 = sel.key_bits(bounds["lengths"], bounds["paths"])
        b2 = sel.key_bits(bounds["paths"], bounds["lengths"])
        o1 = torch.sort(sel.select_keys_plain(rec, n, None, sel.SHALLOW, b1),
                        stable=True)[1][:cap]
        kept = min(n, cap)
        o2 = torch.sort(sel.select_keys_plain(rec, kept, o1, sel.CANONICAL,
                                              b2), stable=True)[1]
        rows, _ = sel.select_gather_plain(rec, o1, o2, cap)
        valid = torch.arange(cap, device=dev) < kept
        return mg.build_merge_grid(rows[:, 0:3], valid, fi.pm_radius,
                                   rows[:, 3:6], rows[:, 15:18], rows[:, 19],
                                   rows[:, 20])

    got, want = kernels(), plain()
    hold_middle(label, "the whole middle (kernels) against the plain route",
                [(getattr(got, k), getattr(want, k))
                 for k in ("tiles", "keys", "bbox_min", "inv_cell",
                           "radius_sqr")], card)
    del got, want
    peaks = {}
    for name, fn in (("kernels", kernels), ("plain", plain)):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        peaks[name] = (cuda_ms(fn, 3),
                       (torch.cuda.max_memory_allocated() - held) / 2**20)
    ms = peaks["kernels"][0]
    log(f"[middle] the whole middle, {label} [{card}]: through the kernels "
        f"and the library sorts {ms:.3f} ms, peak {peaks['kernels'][1]:.1f} "
        f"MiB above the frame's; the plain versions on the card "
        f"{peaks['plain'][0]:.3f} ms, peak {peaks['plain'][1]:.1f} MiB "
        f"(CUDA events, 3 calls)")
    stats["middle_ms"] = ms
    for k in ("keys32", "keys64", "gather"):
        log_resources(f"select {k} kernel", sel.resources(k), card)
    for k in ("keys", "tiles"):
        log_resources(f"grid {k} kernel", mg.grid_resources(k), card)
    del collect, rec, cache, empty
    torch.cuda.empty_cache()


def delta_light_cornell(dev):
    """The cornell with a point, a spot and a directional light beside its
    triangle light (tests/torch_shade_cases.py's delta lights)."""
    from imbatracer_torch.render.lights import (LIGHT_DIR, LIGHT_POINT,
                                                LIGHT_SPOT,
                                                build_light_table)
    from imbatracer_torch.scene.procedural import make_cornell_scene

    scene, meta = make_cornell_scene(device=dev)
    dn = np.asarray((0.2, -0.6, -1.0), np.float32)
    host = lambda x: x.cpu().numpy()
    lt = scene.lights
    rows = [dict(kind=int(host(lt.kind)[i]), p0=host(lt.p0)[i],
                 p1=host(lt.p1)[i], p2=host(lt.p2)[i],
                 normal=host(lt.normal)[i], intensity=host(lt.intensity)[i],
                 area=float(host(lt.area)[i]),
                 cos_angle=float(host(lt.cos_angle)[i]))
            for i in range(lt.kind.shape[0])]
    rows += [
        dict(kind=LIGHT_POINT, p0=(0.2, 1.7, -0.1), intensity=(6.0, 5.0, 3.5)),
        dict(kind=LIGHT_SPOT, p0=(0.0, 1.9, 0.0), normal=(0.0, -1.0, 0.0),
             intensity=(6.0, 5.0, 3.5), cos_angle=np.cos(np.deg2rad(40.0))),
        dict(kind=LIGHT_DIR, normal=dn / np.linalg.norm(dn),
             intensity=(1.5, 1.3, 1.0))]
    kinds = tuple(sorted({r["kind"] for r in rows}))
    return dataclasses.replace(scene, lights=build_light_table(rows, dev),
                               light_kinds=kinds), meta


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


# Kernels whose launches and device time a traced frame reports by name:
# the WHILE nodes' flag kernel (csrc/graph_cond.cu), the dispatch glue's
# kernels and the library sort's.
TRACED_KERNELS = ("set_conditional", "dispatch_keys_kernel",
                  "dispatch_rows_kernel", "khit_resolve_kernel",
                  "stream_resolve_kernel", "slot_gather_kernel",
                  "slot_finish_kernel",
                  "collect_append_kernel", "collect_tail_kernel",
                  "splat_kernel", "select_keys_kernel",
                  "select_gather_kernel", "grid_keys_kernel",
                  "grid_tiles_kernel", "DeviceRadixSort",
                  "CatArrayBatchedCopy",
                  "index_elementwise_kernel", "indexFunc")
# The light band's tail: the kernels of csrc/light_tail.cu.
TAIL_TRACED = ("collect_append_kernel", "collect_tail_kernel",
               "splat_kernel")


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
    for part in TRACED_KERNELS:
        ns = sum(v[0] for k, v in dev.items() if part in k)
        n = sum(v[1] for k, v in dev.items() if part in k)
        log(f"[profile]   kernel {part}: {n} launches, {ns / 1e6:.3f} ms"
            f" ({ns / 1e3 / max(n, 1):.2f} us each)")


def film_parity(dev, label, builder):
    from imbatracer_torch.render.camera import make_camera
    from imbatracer_torch.render.integrators.pt import render_pt_frame

    films = {}
    for where in (dev, "cpu"):
        scene, meta = builder(device=where)
        cam = make_camera(meta.cam_pos, meta.cam_dir, meta.cam_up, 64, 64,
                          60.0, device=where)
        films[str(where)] = render_pt_frame(
            scene, cam, 5, 64, 64, spp=16, max_len=10,
            has_masks=meta.has_masks, has_bump=meta.has_bump).cpu().numpy()
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
    hold_vcm_shade_launches("still_life vcm", got, "vcm")
    hold_dispatch_launches("still_life vcm", got, "khit_resolve", slots=True)
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
    from imbatracer_torch.frontend.engine import ALGO_MAP

    w, h = FAMILY_SIZE
    r, got, ms, _ = family_frames(scene, meta, algo, w, h, 8, frames)
    log(f"[family] {label} {w}x{h} {algo}: {ms:.1f} ms/frame over "
        f"{frames} frames; launches {got}")
    if plain_runs(got) or (algo == "ppm" and got["merge"] == 0):
        raise AssertionError(f"{label} {algo}: a plain version ran or the "
                             f"merge kernel did not")
    if algo != "pt":                  # the dedicated path tracer
        hold_vcm_shade_launches(f"{label} {algo}", got,
                                ALGO_MAP.get(algo, algo))
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
        w, h = INST_SIZE
        c, hit, alpha_fn = shade_carry(scene, meta, w, h, 8, 1, dev)
        hold_shade(f"instanced {w}x{h} bounce 1", scene, meta, c, hit,
                   alpha_fn, 8, card, stats)
        hold_dispatch(f"instanced {w}x{h} bounce 1", scene, c, hit, alpha_fn,
                      card, stats, {"stream_resolve"})
        need, slots, s_hit, tcur = recorded_slots(scene, c, alpha_fn)
        hold_slots(f"instanced {w}x{h} bounce 1, the two-level re-trace's",
                   c["active"], need, slots, s_hit, tcur, 6, card, stats,
                   record=False)
        del c, hit, need, s_hit
        cam, fi, lpc, cap = vcm_frame_inputs(scene, meta, w, h, 8, dev)
        label = f"instanced {w}x{h}, {lpc} light paths"
        hold_vcm_light(label, scene, meta, cam, fi, lpc, 8, 1, card, stats)
        fi = vcm_working_cache(scene, meta, cam, fi, lpc, cap, 8)
        hold_vcm_camera(label, scene, meta, cam, fi, lpc, 8, 1, 1, card,
                        stats)
        del fi

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
        hold_vcm_shade_launches("instanced vcm", got, "vcm")
        hold_dispatch_launches("instanced vcm", got, "stream_resolve",
                               slots=True)
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


# Kernels that a launch counter counts, for holding a trace against the
# counters: (the counter keys, the kernel's name as a whole word).
COUNTED_TRACED = ((("khit",), "khit_kernel"), (("merge",), "merge_kernel"),
                  (("dispatch_keys",), "dispatch_keys_kernel"),
                  (("dispatch_rows",), "dispatch_rows_kernel"),
                  (("khit_resolve", "khit_resolve_flags"),
                   "khit_resolve_kernel"),
                  (("slot_gather",), "slot_gather_kernel"),
                  (("slot_finish",), "slot_finish_kernel"),
                  (("pt_shade",), "pt_shade_kernel"),
                  (("pt_shade_finish",), "pt_shade_finish_kernel"),
                  (("vcm_light_shade",), "vcm_light_shade_kernel"),
                  (("vcm_camera_shade",), "vcm_camera_shade_kernel"))


def trace_route(fn, frame, graph):
    """One frame of fn traced with torch.profiler: (wall ms, device busy
    ms, kernels, cudaLaunchKernel calls, cudaGraphLaunch calls), and for
    each kernel of COUNTED_TRACED its launches in the trace and by the
    launch counters, set to 0 just before the frame and read just after
    (`counted`: {kernel: (traced, counted)})."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    reset_counters()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.time()
        fn(frame, graph)
        torch.cuda.synchronize()
        wall = 1e3 * (time.time() - t0)
    got = counters()
    dev, host = trace_totals(prof.profiler.kineto_results.events())
    calls = lambda pre: sum(n for name, (_, n) in host.items()
                            if name.startswith(pre))
    tail = [v for k, v in dev.items() if any(p in k for p in TAIL_TRACED)]
    counted = {}
    for keys, kernel in COUNTED_TRACED:
        word = re.compile(rf"\b{kernel}\b")
        n = sum(c for name, (_, c) in dev.items() if word.search(name))
        if n or any(got.get(k) for k in keys):
            counted[kernel] = (n, sum(got.get(k, 0) for k in keys))
    return dict(wall=wall, busy=sum(ns for ns, _ in dev.values()) / 1e6,
                kernels=sum(n for _, n in dev.values()),
                launch_kernel=calls("cudaLaunchKernel"),
                graph_launch=calls("cudaGraphLaunch"),
                tail_ms=sum(ns for ns, _ in tail) / 1e6,
                tail_n=sum(n for _, n in tail), counted=counted)


def log_traced_counts(tag, cell, name, t, card):
    """`[traced]`: a traced frame's launches of each counted kernel
    against the launch counters.  Where they differ, the profiler dropped
    events (counted, not traced) or gave them other kernels' names
    (traced beyond the count, seen in a long process's later traces), and
    the line says that the trace's busy time and kernel times are not a
    measurement of the frame.  A profiler fault fails no phase: the
    frame's work is held by its films and counters."""
    c = t["counted"]
    missing = sum(max(m - n, 0) for n, m in c.values())
    extra = sum(max(n - m, 0) for n, m in c.values())
    log(f"[traced] {tag} {cell}: one traced frame {name}: launches traced "
        f"/ counted " + ", ".join(f"{k} {n}/{m}" for k, (n, m) in c.items())
        + ("; every counted launch traced, none beyond"
           if not missing and not extra else
           f"; {missing} counted launches not traced, {extra} traced beyond "
           f"the count: the profiler dropped or misnamed events, so this "
           f"trace is not a measurement of the frame") + f" [{card}]")


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


def hold_route_slots(cell, graphed, eager):
    """The re-trace's slot kernels: once each a masked dispatch in every
    graphed frame with one, never in an eager frame."""
    for r in graphed:
        if r["launches"]["dispatches"]:
            hold_slot_launches(cell, r["launches"])
    if any(r["launches"][k] for r in eager for k in SLOT_COUNTS):
        raise AssertionError(f"{cell}: the eager route launched the slot "
                             f"kernels")


def band_kernels(cell, t, card):
    """The kernels a replayed graph of a traced graphed frame runs, those
    launched outside the graphs taken off: (kernels - cudaLaunchKernel) /
    cudaGraphLaunch, a PT frame's band-bounce; kept for the output."""
    k = (t["kernels"] - t["launch_kernel"]) / max(t["graph_launch"], 1)
    BAND_KERNELS[cell] = round(k, 1)
    log(f"[glue] {cell}: traced graphed frame, {k:.1f} kernels a replayed "
        f"graph ({t['kernels']} kernels, {t['launch_kernel']} launched "
        f"outside the {t['graph_launch']} graph replays) [{card}]")


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
        ok = ok and (r["launches"]["pt_shade"]
                     == r["launches"]["pt_shade_finish"]
                     == r["route"]["band_bounces"])
    hold_route_slots(cell, g, e)
    n = len(g)
    mean_ms = lambda rs: sum(r["ms"] for r in rs) / n
    each = lambda rs: ", ".join(f"{r['ms']:.1f}" for r in rs)
    keys = ROUTE_KEYS[:5] + ("pt_shade", "pt_shade_finish") + \
        DISPATCH_KERNELS + SLOT_COUNTS + ("graph_captures",
                                          "graph_replays", "graph_reruns")
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
        log_traced_counts("graphs", cell, name, t, card)
    band_kernels(cell, traced[None], card)
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
                   "vcm_light_start", "vcm_light_shade", "vcm_light_finish",
                   "vcm_camera_shade", "vcm_camera_finish",
                   *DISPATCH_KERNELS, *SLOT_COUNTS, *TAIL_KERNELS,
                   *MIDDLE_KERNELS, "graph_captures", "graph_replays",
                   "graph_reruns")


def hold_vcm_graph_cell(cell, algo, runs, traced, card):
    """Log one phase-14 cell's two routes over the same frames and hold
    them against each other: the default must have replayed captured
    graphs with no capture and no rerun in the timed frames, film means
    within DIST_VCM_MEAN and DIST_VCM_PIXELS of the pixels within
    DIST_VCM_REL, traced rays equal, no plain version run, and both
    routes' frames through the VCM shade kernels of `algo` (the
    renderer's name)."""
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
    hold_route_slots(cell, g, e)
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
            log_traced_counts("vcmgraphs", cell, name, t, card)
    if traced.get(None) is not None:
        band_kernels(cell, traced[None], card)
        t = traced[None]
        log(f"[lighttail] {cell}: traced graphed frame: light-band tail "
            f"{t['tail_ms']:.3f} ms over {t['tail_n']} launches "
            f"({', '.join(TAIL_TRACED)}); {BAND_KERNELS[cell]} kernels a "
            f"replayed graph, device busy {t['busy']:.1f} ms (idle "
            f"{100.0 * (1.0 - t['busy'] / t['wall']):.1f}%), {t['kernels']} "
            f"kernels [{card}]")
    if not ok:
        raise AssertionError(f"{cell}: the graphed and eager routes "
                             f"disagree, or the default did not replay")
    for r in g + e:
        hold_vcm_shade_launches(cell, r["launches"], algo)


def vcm_graph_phase(dev, card, scenes):
    """Phase 14: each cell of VCM_GRAPH_CELLS through render_vcm_frame on
    the default route (CUDA graphs on the card) and graph=False, a
    warm-up frame of each (the captures), then the same frame numbers
    interleaved, then, on the 1080p cells, one traced frame of each; the
    re-trace's rounds held (hold_rounds)."""
    from imbatracer_torch.frontend.engine import ALGO_MAP
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
            hold_vcm_graph_cell(label, ALGO_MAP.get(algo, algo), runs,
                                traced, card)
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


def build_libraries():
    """Phase 2: every native library at once, loaded, with each kernel
    entry's ptxas lines."""
    from imbatracer_torch import libbuild
    from imbatracer_torch.accel import native
    from imbatracer_torch.ops import dispatch as dp
    from imbatracer_torch.ops import khit as kh
    from imbatracer_torch.ops import light_tail as lt
    from imbatracer_torch.ops import merge as mg
    from imbatracer_torch.ops import pairs as pm
    from imbatracer_torch.ops import select as sel
    from imbatracer_torch.ops import shade as sh
    from imbatracer_torch.ops import stream_traverse as st
    from imbatracer_torch.ops import vcm_shade as vs
    from imbatracer_torch.render import graphs

    phase("2 build")
    t0 = time.time()
    libs = (st.LIB, kh.LIB, mg.LIB, pm.LIB, sh.LIB, vs.LIB, dp.LIB, lt.LIB,
            sel.LIB, mg.GRID_LIB, graphs.COND_LIB, native.LIB)
    paths = libbuild.build_all(libs)
    for load in (st._library, kh._library, mg._library, pm._library,
                 sh._library, vs._library, dp._library, lt._library,
                 sel._library, mg._grid_library, graphs._cond_library):
        load()
    log(f"[build] {len(paths)} libraries in {time.time() - t0:.1f} s: "
        + ", ".join(os.path.relpath(p) for p in paths))
    for lib in libs:
        info = libbuild.BUILD_INFO.get(lib.name, {})
        log(f"[build] {lib.source}: {info.get('seconds', 0.0):.1f} s")
        for line in libbuild.ptxas_lines(lib.name):
            log(f"[build]   {line}")


def shade_phases_alone():
    """Phases 2 and 4b-4f alone: the shade, dispatch, light-tail and
    middle kernels against their plain versions on the cornell and the
    still life (`python -c "import chip_smoke;
    chip_smoke.shade_phases_alone()"` from the repository root, on the
    card)."""
    from imbatracer_torch.device import card_line, get_device
    from imbatracer_torch.scene.procedural import (make_cornell_scene,
                                                   make_still_life_like)

    dev = get_device("cuda")
    card = card_line(dev)
    build_libraries()
    scenes = {"cornell": make_cornell_scene(device=dev),
              "still_life": make_still_life_like(device=dev)}
    stats = {}
    shade_phase(dev, card, scenes, stats)
    vcm_shade_phase(dev, card, scenes, stats)
    dispatch_phase(dev, card, scenes, stats)
    tail_phase(dev, card, scenes, stats)
    middle_phase(dev, card, scenes, stats)
    log(f"[done] {time.time() - _START:.1f} s")


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
    from imbatracer_torch.device import card_line, get_device
    from imbatracer_torch.ops import khit as kh
    from imbatracer_torch.ops import stream_traverse as st
    from imbatracer_torch.scene.procedural import (make_big_scene,
                                                   make_bumped_scene,
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

    build_libraries()

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
    shade_phase(dev, card, scenes, stats)
    vcm_shade_phase(dev, card, scenes, stats)
    dispatch_phase(dev, card, scenes, stats)
    tail_phase(dev, card, scenes, stats)
    middle_phase(dev, card, scenes, stats)

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
        hold_shade_launches(label, got)
        hold_dispatch_launches(label, got, "stream_resolve")
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
    hold_shade_launches("still_life", sl_got)
    hold_dispatch_launches("still_life", sl_got, "khit_resolve", slots=True)
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
    film_parity(dev, "cornell", make_cornell_scene)
    film_parity(dev, "masked", make_masked_scene)
    film_parity(dev, "small still life", partial(
        make_still_life_like, num_objects=40, num_cards=16))
    film_parity(dev, "bumped", make_bumped_scene)

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
        kernel_entry("pt_shade", src + "pt_shade.cu", REPLACES["pt_shade"],
                     sl_got["pt_shade"], stats["shade_err"], stats["shade"],
                     stats["shade_plain_ms"]),
        kernel_entry("pt_shade_finish", src + "pt_shade.cu",
                     REPLACES["pt_shade_finish"], sl_got["pt_shade_finish"],
                     stats["shade_finish_err"], stats["shade_finish"],
                     stats["shade_finish_plain_ms"]),
        *[kernel_entry(f"vcm_{k}", src + "vcm_shade.cu",
                       REPLACES[f"vcm_{k}"], vcm_got[f"vcm_{k}"],
                       stats[f"vcm_{k}_err"], stats[f"vcm_{k}"],
                       stats[f"vcm_{k}_plain_ms"])
          for k in ("light_start", "light_shade", "light_finish",
                    "camera_shade", "camera_finish")],
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
    for name, got in (("dispatch_keys", sl_got), ("dispatch_rows", sl_got),
                      ("khit_resolve", sl_got),
                      ("stream_resolve", inst_got), ("slot_gather", sl_got),
                      ("slot_finish", sl_got)):
        kernels.append(kernel_entry(
            name, src + "dispatch.cu", REPLACES[name], got[name],
            stats[f"{name}_err"], stats[name], stats[f"{name}_plain_ms"]))
    for name in TAIL_KERNELS:
        kernels.append(kernel_entry(
            name, src + "light_tail.cu", REPLACES[name], vcm_got[name],
            stats[f"{name}_err"], stats[name], stats[f"{name}_plain_ms"],
            library_ms=stats[f"{name}_library_ms"]))
    for name in MIDDLE_KERNELS:
        kernels.append(kernel_entry(
            name, src + ("select.cu" if name.startswith("select")
                         else "grid_build.cu"), REPLACES[name],
            vcm_got[name], stats[f"{name}_err"], stats[name],
            stats[f"{name}_plain_ms"],
            library_ms=stats[f"{name}_library_ms"]))
    for k in kernels:
        if not k["launches"]:
            raise AssertionError(f"{k['name']} was not launched on a main "
                                 f"path")
    log(f"[done] {time.time() - _START:.1f} s")
    log(f"[glue] library sort a dispatch (torch.sort of {NUM_RAYS} keys): "
        f"{stats['library_sort_ms']:.4f} ms; traced graphed frames, kernels "
        f"a replayed graph (a PT band-bounce): {BAND_KERNELS} [{card}]")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
