#!/usr/bin/env python3
"""Where a vcm frame's light-band tail spends device time on a CUDA card.

Three traces (torch.profiler) of the still life at 1920x1080 with 2^20
light paths, max_len 8:

* one eager light band of 262,144 paths (render/integrators/vcm.py
  `_light_pass`), with record_function ranges around its collect append
  (`CollectCache.append`) and its camera splat (`vcm.splat`): each
  range's device time and the kernels launched inside it, by name;
* the selection of that band's collect cache (`select_shallowest`),
  which a frame runs once, outside the graphs, in a range of its own;
* one graphed vcm frame through make_frame_fn and the renderer, after a
  warm-up frame: wall and device busy time, the kernels with the most
  device time, by name, and the light tail's kernels and any index or
  cat kernels; then one graphed PT frame of the same scene (wall, busy,
  kernels).

`--root DIR` imports the port from DIR (another checkout, for example a
parent commit unpacked under the git-ignored `out/`), so two trees can be
traced in one call on one card.  Run from the repository root:

    python3 scripts/trace_light_band.py [--root DIR] [--top N]
"""

import argparse
import os
import sys
import time


def _args():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout whose port is traced")
    p.add_argument("--top", type=int, default=12,
                   help="kernels listed a trace")
    return p.parse_args()


ARGS = _args()
sys.path.insert(0, os.path.abspath(ARGS.root))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa

from imbatracer_torch.frontend.engine import (estimate_pixel_size,  # noqa
                                              make_frame_fn)
from imbatracer_torch.frontend.renderer import (ProgressiveRenderer,  # noqa
                                                RenderSettings,
                                                camera_for_scene)
from imbatracer_torch.render import light_cache  # noqa: E402
from imbatracer_torch.render.integrators import pt, vcm  # noqa: E402
from imbatracer_torch.scene.procedural import make_still_life_like  # noqa

W, H, LPC, MAX_LEN, BAND = 1920, 1080, 1 << 20, 8, 1 << 18
ACTS = [ProfilerActivity.CPU, ProfilerActivity.CUDA]


def ranged(name, fn):
    def wrapped(*a, **k):
        with record_function(name):
            return fn(*a, **k)
    return wrapped


def kernels_under(evt, out):
    """Append the (name, us) of every kernel launched under a profiler
    event and its descendants to `out`."""
    out.extend((k.name, k.duration) for k in evt.kernels)
    for ch in evt.cpu_children:
        kernels_under(ch, out)
    return out


def by_name(rows):
    """{name: [us, launches]} of (name, us) pairs."""
    tot = {}
    for name, us in rows:
        t = tot.setdefault(name, [0.0, 0])
        t[0] += us
        t[1] += 1
    return tot


def show(tag, tot, top):
    us = sum(v[0] for v in tot.values())
    n = sum(v[1] for v in tot.values())
    print(f"[lighttrace] {tag}: {us / 1e3:.3f} ms device over {n} kernels",
          flush=True)
    for name, (t, k) in sorted(tot.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"[lighttrace]   {t / 1e3:9.3f} ms {k:6d}x  {name[:160]}",
              flush=True)


def main():
    dev = torch.device("cuda")
    card = os.popen("nvidia-smi --query-gpu=name,power.limit "
                    "--format=csv,noheader").read().strip()
    print(f"[lighttrace] root {os.path.abspath(ARGS.root)}; {card}; torch "
          f"{torch.__version__}", flush=True)
    scene, meta = make_still_life_like(device=dev)
    settings = RenderSettings(width=W, height=H, spp=1,
                              max_path_len=MAX_LEN, algorithm="vcm")
    cam = camera_for_scene(meta, settings, dev)
    base = estimate_pixel_size(scene, cam, meta) * settings.radius_factor
    (frame, base_radius, lpc, _, pm_radius, eta_vc,
     eta_vm) = vcm.frame_constants(cam, 1, base, algo="vcm",
                                   num_pixels=W * H, light_path_count=LPC,
                                   max_len=MAX_LEN)
    vcm.splat = ranged("tail.splat", vcm.splat)
    light_cache.CollectCache.append = ranged(
        "tail.append", light_cache.CollectCache.append)

    def band(collect):
        return vcm._light_pass(
            scene, cam, frame, eta_vc, eta_vm, collect, algo="vcm",
            num_pixels=W * H, light_path_count=lpc, max_len=MAX_LEN,
            alpha_fn=pt.alpha_fn_for(scene), has_bump=meta.has_bump,
            path_start=(lpc - BAND) // 2, band_paths=BAND)

    collect = light_cache.empty_collect(lpc * MAX_LEN, dev)
    band(collect)                                 # builds the kernels
    collect = light_cache.empty_collect(lpc * MAX_LEN, dev)
    torch.cuda.synchronize()
    with profile(activities=ACTS) as prof:
        band(collect)
        torch.cuda.synchronize()
    for evt in prof.events():
        if evt.name in ("tail.append", "tail.splat"):
            show(f"eager light band, range {evt.name}",
                 by_name(kernels_under(evt, [])), ARGS.top)
    with profile(activities=ACTS) as prof:
        with record_function("tail.select"):
            light_cache.select_shallowest(collect.cache(), 2 * lpc)
        torch.cuda.synchronize()
    for evt in prof.events():
        if evt.name == "tail.select":
            show("the collect cache's selection (eager, once a frame)",
                 by_name(kernels_under(evt, [])), ARGS.top)
    del collect

    settings.light_path_count = LPC
    tot = graphed_frame(scene, meta, settings, "vcm")
    for part in ("collect_append_kernel", "collect_tail_kernel",
                 "splat_kernel", "index", "CatArrayBatchedCopy"):
        us = sum(v[0] for k, v in tot.items() if part in k)
        n = sum(v[1] for k, v in tot.items() if part in k)
        print(f"[lighttrace]   kernels named *{part}*: {us / 1e3:.3f} ms, "
              f"{n} launches", flush=True)
    settings = RenderSettings(width=W, height=H, spp=1,
                              max_path_len=MAX_LEN, algorithm="pt")
    graphed_frame(scene, meta, settings, "pt")


def graphed_frame(scene, meta, settings, tag):
    """Trace one graphed frame after a warm-up frame (the captures); log
    its wall and device busy time and top kernels; {name: [us, n]}."""
    frame_fn, _ = make_frame_fn(scene, meta, settings)
    renderer = ProgressiveRenderer(frame_fn, settings, scene.device)
    renderer.step()
    torch.cuda.synchronize()
    with profile(activities=ACTS) as prof:
        t0 = time.time()
        renderer.step()
        torch.cuda.synchronize()
        wall = 1e3 * (time.time() - t0)
    rows = [(e.name(), e.duration_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]
    tot = by_name(rows)
    print(f"[lighttrace] graphed {tag} frame: wall {wall:.1f} ms",
          flush=True)
    show(f"graphed {tag} frame", tot, ARGS.top)
    return tot


if __name__ == "__main__":
    main()
