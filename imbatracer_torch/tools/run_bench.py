"""Benchmark and regression harness of the port (torch twin of the
repository's tools/run_bench.py, after the reference's test/run_bench.py).

    python -m imbatracer_torch.tools.run_bench [-t SECONDS] [--proxies] ...

Renders headless under a time budget, in this process, and writes one CSV
row a run: name, algorithm, time, samples, fps, ms/frame, RMSE and PSNR
against the run's golden (8-bit quantised, as ImageMagick's `compare
-metric RMSE`; blank where the golden is missing or of another size).
`--converge` turns the budget into a deadline and each run PASSes or
FAILs on reaching the RMSE; `--curve-dir` records RMSE over time;
`--sweep key=v1,v2` repeats every selected run once a value of a
RenderSettings field; `--selfcheck-instances` renders the instanced scene
through its two-level and its flattened build and gates their PSNR.

Scenes: the reference renderer's cornell rows, which run only with
`--reference DIR` (the reference's test/ directory; nothing outside this
checkout is looked up otherwise), the procedural `proc:` URIs, and
`gen:card`, the instanced scene scene/generate.CARD writes, which takes
the place of the reference's cornell_instances.scene in BASELINE config 5
and the self-check (no golden renders it, so its rows report no RMSE).
Each row also counts the CUDA-graph replays and the eager reruns of its
timed frames.  Runs on the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import os
import tempfile
import time
import traceback

from ..device import card_line, get_device, synchronize
from ..frontend.engine import make_frame_fn
from ..frontend.renderer import ProgressiveRenderer, RenderSettings
from ..render import graphs
from ..scene import generate, procedural
from ..scene.build import build_scene
from ..utils.metrics import load_reference_png, psnr, rmse

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# (name, scene, golden image, algorithm, width, height, extra settings):
# the reference's golden set, its cornell family, the scenes under its
# test/scenes/ and the goldens under its test/references/.  They run only
# with --reference, its test/ directory.
DEFAULT_RUNS = [
    ("cornell_pt", "cornell/cornell_org.scene",
     "ref_cornell_org.png", "pt", 1024, 1024, {}),
    ("cornell_bpt", "cornell/cornell_indirect.scene",
     "ref_cornell_indirect.png", "bpt", 1024, 1024, {}),
    # bpt against the PT-rendered org golden (the indirect golden carries
    # the reference light pass's extra lamp rebounce).
    ("cornell_bpt_org", "cornell/cornell_org.scene",
     "ref_cornell_org.png", "bpt", 1024, 1024, {}),
    # radius_factor 2.0: the reference bench's setting (cmd_line.h:70).
    ("cornell_vcm", "cornell/cornell_specular.scene",
     "ref_cornell_specular.png", "vcm", 1024, 1024,
     {"radius_factor": 2.0}),
    ("cornell_vcm_front", "cornell/cornell_specular_front.scene",
     "ref_cornell_specular_front.png", "vcm", 1024, 1024,
     {"radius_factor": 2.0}),
    ("cornell_water_vcm", "cornell/cornell_water.scene",
     "ref_cornell_water.png", "vcm", 1024, 1024,
     {"radius_factor": 2.0}),
    ("cornell_instances_pt", "cornell/cornell_instances.scene", "", "pt",
     1024, 1024, {}),
    # Short-budget radius rows (the JAX harness's tuned defaults).
    ("cornell_vcm_r8", "cornell/cornell_specular.scene",
     "ref_cornell_specular.png", "vcm", 1024, 1024,
     {"radius_factor": 8.0}),
    ("cornell_water_vcm_r8", "cornell/cornell_water.scene",
     "ref_cornell_water.png", "vcm", 1024, 1024,
     {"radius_factor": 8.0}),
    ("cornell_vcm_r16", "cornell/cornell_specular.scene",
     "ref_cornell_specular.png", "vcm", 1024, 1024,
     {"radius_factor": 16.0}),
    ("cornell_vcm_r12", "cornell/cornell_specular.scene",
     "ref_cornell_specular.png", "vcm", 1024, 1024,
     {"radius_factor": 12.0}),
]

# BASELINE.json configs 1-5 (`--proxies`, or `--only`): the still-life
# proxy for the absent Still Life OBJ; goldens are long PT self-renders
# (render_golden.py) keyed by scene, size and max_path_len.
GOLDENS = os.path.join(ROOT, "goldens")
PROXY_RUNS = [
    # config 1: CPU-reference parity run, 512^2, 4 bounces, 16 spp
    ("still_life_pt_512_16spp", "proc:still_life",
     f"{GOLDENS}/still_life_512_len4.png", "pt", 512, 512,
     {"max_path_len": 4, "spp": 16}),
    # config 2: full material set + env light, 1080p PT, 8 bounces
    ("still_life_pt_1080p", "proc:still_life",
     f"{GOLDENS}/still_life_1080p_len8.png", "pt", 1920, 1080,
     {"max_path_len": 8}),
    # config 3: BDPT full connections + MIS, 1080p progressive
    ("still_life_bpt_1080p", "proc:still_life",
     f"{GOLDENS}/still_life_1080p_len8.png", "bpt", 1920, 1080,
     {"max_path_len": 8}),
    # config 4: PPM, 1M photons a frame
    ("still_life_ppm_1M", "proc:still_life",
     f"{GOLDENS}/still_life_1080p_len10.png", "ppm", 1920, 1080,
     {"light_path_count": 1 << 20}),
    # config 5: VCM on an instanced multi-mesh scene, 1080p: gen:card for
    # the reference's cornell_instances.scene, which goldens/
    # instances_1080p_len10.png renders, so no golden
    ("instances_vcm_1080p", "gen:card", "", "vcm", 1920, 1080, {}),
]

# URI -> (function, keyword arguments): scene/procedural.py's generators
# for "proc:", scene/generate.py's writers for "gen:" (the files written
# into a temporary directory and built by build_scene).
PROC_SCENES = {
    "proc:still_life": ("make_still_life_like", {}),
    "proc:big": ("make_big_scene", {}),
    "proc:big264": ("make_big_scene", {"num_boxes": 22000}),
    "proc:leaves": ("make_leaf_scene", {}),
    "gen:card": ("write_instanced_scene", generate.CARD),
}

KEYS = ["name", "algorithm", "time", "samples", "fps", "ms_per_frame",
        "rmse", "psnr", "converged_at", "gate", "error", "graph_replays",
        "graph_reruns"]


def reference_runs(test_dir):
    """DEFAULT_RUNS with their scenes and goldens under the reference's
    test/ directory `test_dir`."""
    return [(name, os.path.join(test_dir, "scenes", scene),
             os.path.join(test_dir, "references", golden) if golden else "",
             *rest) for name, scene, golden, *rest in DEFAULT_RUNS]


def build_any_scene(scene_path, device, force_flatten=False):
    """build_scene for `.scene` files and "gen:" URIs, the procedural
    generators for "proc:" URIs; `force_flatten` as build_scene's."""
    if scene_path.startswith("proc:"):
        fn_name, kw = PROC_SCENES[scene_path]
        return getattr(procedural, fn_name)(device=device, **kw)
    if scene_path.startswith("gen:"):
        fn_name, kw = PROC_SCENES[scene_path]
        with tempfile.TemporaryDirectory(prefix="imba_gen_") as tmp:
            path = getattr(generate, fn_name)(tmp, **kw)
            return build_scene(path, device=device,
                               force_flatten=force_flatten)
    return build_scene(scene_path, device=device, force_flatten=force_flatten)


def run_one(name, scene_path, golden, algo, width, height, extra, seconds,
            converge_rmse=0.0, curve_path="", curve_every=5.0,
            device="cuda"):
    """One benchmark run; returns its row.

    Plain mode: render for `seconds` (or `extra`'s max_samples), report
    the final RMSE / PSNR.  Convergence-gate mode (the reference's
    run_bench.py:254-296): with `converge_rmse` > 0 and a golden, the
    run PASSes iff the RMSE reaches it within the budget.  With
    `curve_path` (and a golden) every `curve_every` seconds adds a (time,
    frames, rmse, psnr) row to that CSV."""
    dev = get_device(device)
    scene, meta = build_any_scene(scene_path, dev)
    settings = RenderSettings(width=width, height=height, algorithm=algo,
                              max_time_sec=seconds, **extra)
    frame_fn, _ = make_frame_fn(scene, meta, settings)
    r = ProgressiveRenderer(frame_fn, settings, dev)
    # Outside the budget, as the reference excludes start-up: the first
    # frame builds the kernels and captures the CUDA graphs.
    r.step()
    r.image()
    r.reset()

    ref = None
    if golden and os.path.exists(golden):
        ref = load_reference_png(golden)
        if ref.shape[0] * ref.shape[1] != width * height:
            ref = None

    curve = []
    converged_at = ""
    before = dict(graphs.GRAPH_STATS)
    t0 = time.time()
    if (converge_rmse > 0 or curve_path) and ref is not None:
        next_sample = 0.0
        while time.time() - t0 < seconds:
            r.step()
            el = time.time() - t0
            if el >= next_sample:
                next_sample = el + curve_every
                img = r.image()            # waits for the frame
                e = rmse(img, ref)
                curve.append((round(el, 2), r.frames, round(e, 5),
                              round(psnr(img, ref), 2)))
                if converge_rmse > 0 and e <= converge_rmse:
                    converged_at = round(el, 2)
                    break
    else:
        r.run(quiet=True)
    elapsed = time.time() - t0
    img = r.image()

    if curve_path and curve:
        os.makedirs(os.path.dirname(curve_path) or ".", exist_ok=True)
        with open(curve_path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["time", "frames", "rmse", "psnr"])
            w.writerows(curve)

    row = {
        "name": name,
        "algorithm": algo,
        "time": round(elapsed, 2),
        "samples": r.frames * settings.spp,
        "fps": round(r.frames / elapsed, 3),
        "ms_per_frame": round(1000 * elapsed / max(r.frames, 1), 2),
        "rmse": "",
        "psnr": "",
        "graph_replays": graphs.GRAPH_STATS["replays"] - before["replays"],
        "graph_reruns": graphs.GRAPH_STATS["reruns"] - before["reruns"],
    }
    if ref is not None:
        row["rmse"] = round(rmse(img, ref), 5)
        row["psnr"] = round(psnr(img, ref), 2)
    if converge_rmse > 0:
        row["converged_at"] = converged_at
        # No golden: nothing to converge against, SKIP rather than FAIL.
        if ref is None:
            row["gate"] = "SKIP"
        else:
            row["gate"] = "PASS" if converged_at != "" else "FAIL"
    return row


def run_instances_selfcheck(seconds=30.0, size=512, device="cuda"):
    """Golden-free image check of two-level instancing: gen:card rendered
    through its two-level build and its flattened build, the same frames
    and RNG, PASS at PSNR >= 40 dB between the two.  Its graph counts
    cover both routes, warm-up frames included."""
    dev = get_device(device)
    scene_path = "gen:card"
    before = dict(graphs.GRAPH_STATS)
    imgs = []
    frames = 0
    for force_flatten in (False, True):
        scene, meta = build_any_scene(scene_path, dev, force_flatten)
        if scene.bvh.two_level == force_flatten:
            raise ValueError(f"{scene_path}: force_flatten={force_flatten} "
                             f"built a {scene.bvh.mode} BVH")
        settings = RenderSettings(width=size, height=size, algorithm="pt")
        frame_fn, _ = make_frame_fn(scene, meta, settings)
        r = ProgressiveRenderer(frame_fn, settings, dev)
        r.step()
        synchronize(dev)
        t0 = time.time()
        if not imgs:
            while time.time() - t0 < seconds:
                r.step()
                synchronize(dev)
            frames = r.frames
        else:
            while r.frames < frames:
                r.step()
        imgs.append(r.image())
        del scene, frame_fn, r
    p = psnr(imgs[0], imgs[1])
    return {"name": "instances_selfcheck", "algorithm": "pt",
            "time": round(seconds, 1), "samples": frames,
            "psnr": round(p, 2), "gate": "PASS" if p >= 40.0 else "FAIL",
            "graph_replays": graphs.GRAPH_STATS["replays"] - before["replays"],
            "graph_reruns": graphs.GRAPH_STATS["reruns"] - before["reruns"]}


def parse_sweep(spec):
    """'key=v1,v2' -> (key, [values converted to the field's type]);
    ("", [None]) without a sweep.  The key must be a RenderSettings field:
    the port has none of the JAX package's IMBA_* environment knobs."""
    if not spec:
        return "", [None]
    key, vals = spec.split("=", 1)
    key = key.strip()
    if key.startswith("IMBA_"):
        raise ValueError(f"--sweep {key}: the port has no IMBA_* "
                         f"environment knobs; sweep a RenderSettings field")
    names = [f.name for f in dataclasses.fields(RenderSettings)]
    if key not in names:
        raise ValueError(f"--sweep {key}: not a RenderSettings field "
                         f"({', '.join(names)})")
    field_t = type(getattr(RenderSettings(), key))
    return key, [field_t(v.strip()) for v in vals.split(",") if v.strip()]


def write_rows(path, rows):
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=KEYS, extrasaction="ignore")
        w.writeheader()
        w.writerows(rows)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m imbatracer_torch.tools.run_bench")
    ap.add_argument("-t", "--time", type=float, default=30.0,
                    help="render budget per run (reference default 30 s)")
    ap.add_argument("-o", "--out", default="results/torch_bench.csv")
    ap.add_argument("--only", default="",
                    help="substring filter on run names; a trailing '$' "
                         "asks for the exact name")
    ap.add_argument("--converge", type=float, default=0.0,
                    help="convergence-gate mode: required RMSE (e.g. 2.0); "
                         "the budget becomes a deadline and each run "
                         "PASSes/FAILs (reference run_bench.py:254-296)")
    ap.add_argument("--gate-budgets", default="",
                    help="per-algorithm gate deadlines overriding -t in "
                         "converge mode, e.g. 'pt=60,bpt=180,vcm=300'")
    ap.add_argument("--curve-dir", default="",
                    help="write per-run RMSE-over-time CSV curves here")
    ap.add_argument("--curve-every", type=float, default=5.0,
                    help="curve sampling interval in seconds")
    ap.add_argument("--size", type=int, default=0,
                    help="override render size (golden checks then skip)")
    ap.add_argument("--selfcheck-instances", action="store_true",
                    help="run the instanced-vs-flattened image self-check")
    ap.add_argument("--proxies", action="store_true",
                    help="include the BASELINE config 1-5 proxy runs")
    ap.add_argument("--sweep", default="",
                    help="parameter sweep: 'key=v1,v2,v3' repeats every "
                         "selected run once per value; key is a "
                         "RenderSettings field (light_path_count, "
                         "num_connections, radius_factor, spp, "
                         "max_path_len, ...)")
    ap.add_argument("--reference", default="",
                    help="the reference renderer's test/ directory; its "
                         "cornell rows run only when it is given")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    sweep_key, sweep_vals = parse_sweep(args.sweep)
    gate_budgets = {}
    if args.gate_budgets:
        for part in args.gate_budgets.split(","):
            k, v = part.split("=")
            gate_budgets[k.strip()] = float(v)
    dev = get_device(args.device)
    print(f"device: {card_line(dev)}", flush=True)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    rows = []
    runs = reference_runs(args.reference) if args.reference else DEFAULT_RUNS
    if args.proxies or args.only:
        runs = runs + PROXY_RUNS
    for run in runs:
        if args.only:
            if args.only.endswith("$"):
                if run[0] != args.only[:-1]:
                    continue
            elif args.only not in run[0]:
                continue
        name, scene_path, golden, algo, w, h, extra = run
        if run in DEFAULT_RUNS:         # without --reference
            print(f"skip {name}: scene missing (no --reference)")
            continue
        if (not scene_path.startswith(("proc:", "gen:"))
                and not os.path.exists(scene_path)):
            print(f"skip {name}: scene missing")
            continue
        print(f"== {name} ({algo}, {args.time}s) ==", flush=True)
        if args.size:
            w = h = args.size
        curve_path = (os.path.join(args.curve_dir, f"curve_{name}.csv")
                      if args.curve_dir else "")
        budget = args.time
        if args.converge > 0 and algo in gate_budgets:
            budget = gate_budgets[algo]
        for sv in sweep_vals:
            run_name, run_extra = name, dict(extra)
            if sv is not None:
                run_name = f"{name}[{sweep_key}={sv}]"
                run_extra[sweep_key] = sv
                print(f"-- sweep {sweep_key}={sv}", flush=True)
            try:
                row = run_one(run_name, scene_path, golden, algo, w, h,
                              run_extra, seconds=budget,
                              converge_rmse=args.converge,
                              curve_path=curve_path,
                              curve_every=args.curve_every, device=dev)
            except Exception as e:  # a failed run is a row; go on
                traceback.print_exc()
                print(f"FAILED: {type(e).__name__}: {str(e)[:200]}",
                      flush=True)
                row = {"name": run_name, "algorithm": algo, "time": "",
                       "samples": "", "fps": "", "ms_per_frame": "",
                       "rmse": "", "psnr": "", "error": type(e).__name__}
            print(row, flush=True)
            rows.append(row)
            write_rows(args.out, rows)      # a later crash loses nothing
    if args.selfcheck_instances:
        print("== instances_selfcheck ==", flush=True)
        try:
            row = run_instances_selfcheck(seconds=args.time,
                                          size=args.size or 512, device=dev)
        except Exception as e:
            traceback.print_exc()
            print(f"FAILED: {type(e).__name__}: {str(e)[:200]}", flush=True)
            row = {"name": "instances_selfcheck", "algorithm": "pt",
                   "error": type(e).__name__}
        print(row, flush=True)
        rows.append(row)
        write_rows(args.out, rows)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
