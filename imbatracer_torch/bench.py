"""Headline benchmark of the port (torch twin of the repository's root
bench.py): sustained throughput of the PT frame in Mrays/s, the
reference's rays/s metric, with two secondaries in ms/frame.

    python -m imbatracer_torch.bench [--device cuda|cpu] [--out-dir DIR]

Workloads, as the JAX bench has them:
  headline    make_cornell_scene() (the JAX bench reads the reference's
              cornell_org.scene where its checkout exists): 1024^2, spp 1,
              max_len 10, render_pt_frame with its ray count; one warm-up
              frame, then 20 timed frames.
  big scene   make_big_scene(4000) at 1024^2, max_len 6, through
              make_frame_fn: one warm-up frame, then 4 timed frames.
  still life  make_still_life_like() at 1920x1080, max_len 8, through
              make_frame_fn: one warm-up frame, then 3 timed frames.

The warm-up frame builds the kernels at first use (nvcc) and captures the
CUDA graphs, outside the timed window.  The timed frames keep their ray
counts on the device, summed as tensors, and read them once after one
synchronize at the end: the value is total rays / wall seconds / 1e6.
Earlier lines give the per-frame ms from CUDA events (median, min, max)
and the graph replays and reruns of the timed frames (a rerun is a frame
rendered again on the eager route).

Output: `results/torch_bench_headline.json`, `torch_bench_big.json` and
`torch_bench_1080p.json` under `--out-dir`, and as the last line of
stdout one JSON object {"metric", "value", "unit", "card"}, `card` the
card's name and power limit.  The three files are removed before the
runs; a secondary that fails writes none and makes the exit code 1,
after the headline's line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time
import traceback

import torch

from .device import card_line, get_device, synchronize
from .frontend.engine import make_frame_fn
from .frontend.renderer import RenderSettings, camera_for_scene
from .ops import khit as khit_mod
from .ops import stream_traverse as st
from .render import graphs
from .render.integrators.pt import render_pt_frame
from .scene import procedural


class FrameTimer:
    """Per-frame milliseconds: CUDA events around each frame on a card,
    read after the caller's final synchronize; the host clock on the
    CPU, where a frame runs to its end before it returns."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def _mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def start(self):
        self.marks.append([self._mark(), None])

    def stop(self):
        self.marks[-1][1] = self._mark()

    def ms(self) -> list:
        if self.cuda:
            return [a.elapsed_time(b) for a, b in self.marks]
        return [(b - a) * 1000.0 for a, b in self.marks]


def launch_counts() -> dict:
    """The traversal kernels' launch counters, graph replays included,
    plain versions left out."""
    got = {k: v for k, v in st.LAUNCHES.items() if k not in st.PLAIN_KEYS}
    got["khit"] = khit_mod.LAUNCHES["khit"]
    return got


def per_frame(before: dict, frames: int) -> dict:
    """Launches a frame since the `before` counts, kernels that ran."""
    return {k: (v - before[k]) / frames
            for k, v in launch_counts().items() if v != before[k]}


def pt_throughput(size=1024, frames=20, device="cuda"):
    """The headline: Mrays/s of render_pt_frame (spp 1, max_len 10)
    over `frames` frames after one warm-up frame.  Returns (headline
    dict, details) with the details' total rays, wall seconds, per-frame
    ms, launches a frame and graph counts of the timed frames."""
    dev = get_device(device)
    scene, meta = procedural.make_cornell_scene(device=dev)
    max_len = 10
    settings = RenderSettings(width=size, height=size, spp=1,
                              max_path_len=max_len)
    cam = camera_for_scene(meta, settings, dev)

    def frame(i):
        return render_pt_frame(scene, cam, i, size, size, spp=1,
                               max_len=max_len, has_masks=meta.has_masks,
                               has_bump=meta.has_bump, with_stats=True)

    frame(0)                                   # builds and captures
    synchronize(dev)
    before = dict(graphs.GRAPH_STATS)
    launched = launch_counts()
    timer = FrameTimer(dev)
    total = torch.zeros((), dtype=torch.int64, device=dev)
    t0 = time.perf_counter()
    for i in range(1, frames + 1):
        timer.start()
        _, n_rays = frame(i)
        timer.stop()
        total = total + n_rays
    synchronize(dev)
    elapsed = time.perf_counter() - t0
    rays = int(total)
    ms = timer.ms()
    headline = {"metric": "pt_megastep_throughput_cornell_1024",
                "value": round(rays / elapsed / 1e6, 2), "unit": "Mrays/s"}
    details = dict(
        scene=meta.name, size=size, max_len=max_len, frames=frames,
        rays=rays, seconds=elapsed, mrays=rays / elapsed / 1e6,
        ms_median=statistics.median(ms), ms_min=min(ms), ms_max=max(ms),
        launches=per_frame(launched, frames),
        **{k: graphs.GRAPH_STATS[k] - before[k] for k in before})
    return headline, details


def frame_ms(scene, meta, width, height, max_len, frames, device):
    """(wall ms/frame, launches a frame) of make_frame_fn's PT frame
    over `frames` frames after one warm-up frame, with one synchronize at
    the end."""
    settings = RenderSettings(width=width, height=height, spp=1,
                              algorithm="pt", max_path_len=max_len)
    frame_fn, _ = make_frame_fn(scene, meta, settings)
    frame_fn(0)
    synchronize(device)
    launched = launch_counts()
    t0 = time.perf_counter()
    for i in range(1, frames + 1):
        frame_fn(i)
    synchronize(device)
    ms = (time.perf_counter() - t0) * 1000.0 / frames
    return ms, per_frame(launched, frames)


def big_scene_metric(boxes=4000, size=1024, frames=4, device="cuda"):
    """PT ms/frame (max_len 6) on make_big_scene(boxes), the stream
    kernel's path."""
    dev = get_device(device)
    scene, meta = procedural.make_big_scene(boxes, device=dev)
    ms, launches = frame_ms(scene, meta, size, size, 6, frames, dev)
    return {"metric": "pt_frame_ms_bigscene_1024", "tris": int(meta.num_tris),
            "mode": scene.bvh.mode, "value": round(ms, 1), "unit": "ms/frame",
            "launches_per_frame": launches}


def still_life_metric(width=1920, height=1080, frames=3, device="cuda"):
    """PT ms/frame (max_len 8) on the 1080p still-life proxy (BASELINE
    config 2: the full material set, env and area lights, alpha-masked
    cards), the khit kernel's path."""
    dev = get_device(device)
    scene, meta = procedural.make_still_life_like(device=dev)
    ms, launches = frame_ms(scene, meta, width, height, 8, frames, dev)
    return {"metric": "pt_frame_ms_still_life_1080p",
            "tris": int(meta.num_tris), "mode": scene.bvh.mode,
            "value": round(ms, 1), "unit": "ms/frame",
            "launches_per_frame": launches}


def write_json(out_dir, name, obj):
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(obj, f)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m imbatracer_torch.bench")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out-dir", default="results",
                    help="directory of the torch_bench_*.json artifacts")
    args = ap.parse_args(argv)
    dev = get_device(args.device)
    card = card_line(dev)
    names = ("torch_bench_headline.json", "torch_bench_big.json",
             "torch_bench_1080p.json")
    for name in names:          # no stale file outlives a failed run
        with contextlib.suppress(FileNotFoundError):
            os.remove(os.path.join(args.out_dir, name))

    headline, d = pt_throughput(device=dev)
    print(f"[bench] pt {d['scene']} {d['size']}x{d['size']} spp 1 max_len "
          f"{d['max_len']}: {d['frames']} frames, {d['rays']} rays in "
          f"{d['seconds']:.4f} s, {d['mrays']:.4f} Mrays/s; per-frame ms "
          f"median {d['ms_median']:.3f} min {d['ms_min']:.3f} max "
          f"{d['ms_max']:.3f}; launches a frame {d['launches']}; graphs "
          f"over the timed frames: captures {d['captures']} replays "
          f"{d['replays']} reruns {d['reruns']} [{card}]", flush=True)

    # The secondaries never cost the headline its line (as in JAX), but a
    # failed one costs the exit code.
    rc = 0
    for name, fn in zip(names[1:], (big_scene_metric, still_life_metric)):
        try:
            res = dict(fn(device=dev), card=card)
        except Exception:
            sys.stderr.write(f"{name}: the metric failed\n")
            traceback.print_exc()
            rc = 1
            continue
        write_json(args.out_dir, name, res)
        print(f"[bench] {res['metric']}: {res['value']} {res['unit']} "
              f"({res['tris']} tris, {res['mode']}; launches a frame "
              f"{res['launches_per_frame']}) [{card}]", flush=True)

    headline["card"] = card
    write_json(args.out_dir, names[0], headline)
    print(json.dumps(headline), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
