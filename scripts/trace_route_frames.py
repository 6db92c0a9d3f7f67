#!/usr/bin/env python3
"""Trace chip_smoke.py's phase-14 still-life vcm frame on its own, several
times, each trace held against the launch counters.

The cell is phase 14's (the still life at 1920x1080, max_len 8, 2^20
light paths, through render_vcm_frame on the graphed and eager routes):
a warm-up frame of each route (the captures), the timed frames
interleaved as there, then the graphed frame traced `--traces` times and
the eager one once.  Each trace logs its wall and device busy time and
its kernels (`[vcmgraphs]`), and its launches of each counted kernel
beside the launch counters (`[traced]`: a launch counted and not traced
is an event the profiler dropped, one traced beyond the count a
misnamed one).  Also logs the registers, shared and local memory of the
PT bounce's NEE add and the re-trace's finish (`[res]`).  Run from the
repository root on a CUDA card:

    python3 scripts/trace_route_frames.py [--traces N]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--traces", type=int, default=2,
                   help="traces of the graphed frame")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("trace_route_frames: CUDA is not available")
    from imbatracer_torch.device import card_line, get_device
    from imbatracer_torch.ops import dispatch as dp
    from imbatracer_torch.ops import shade as sh
    from imbatracer_torch.scene.procedural import make_still_life_like

    dev = get_device("cuda")
    card = card_line(dev)
    cs.log(f"[device] {card}; torch {torch.__version__}")
    cs.build_libraries()
    cs.log_resources("pt_shade_finish_kernel", sh.resources(True), card)
    cs.log_resources("slot_finish_kernel", dp.resources("slot_finish"),
                     card)
    cell = "still_life vcm 1920x1080 max_len 8"
    scene, meta = make_still_life_like(device=dev)
    fn = cs.route_fn(scene, meta, "vcm", 1920, 1080, 8, "graph")
    cs.warm_captures(fn, scene)
    fn(0, False)
    frames = cs.GRAPH_FRAMES
    runs = {None: [], False: []}
    for f in range(1, frames + 1):
        for graph in ((None, False) if f % 2 else (False, None)):
            runs[graph].append(cs.run_route(fn, f, graph))
    cs.log(f"[vcmgraphs] {cell}: ms/frame graphed "
           f"{[round(r['ms'], 1) for r in runs[None]]}, eager "
           f"{[round(r['ms'], 1) for r in runs[False]]} [{card}]")
    traces = [(f"graphed, trace {i + 1}", None) for i in range(args.traces)]
    for name, graph in traces + [("eager", False)]:
        t = cs.trace_route(fn, frames + 1, graph)
        cs.log(f"[vcmgraphs] {cell}: one traced frame {name}: wall "
               f"{t['wall']:.1f} ms, device busy {t['busy']:.1f} ms (idle "
               f"{100.0 * (1.0 - t['busy'] / t['wall']):.1f}%), "
               f"{t['kernels']} kernels, {t['launch_kernel']} "
               f"cudaLaunchKernel, {t['graph_launch']} cudaGraphLaunch "
               f"[{card}]")
        cs.log_traced_counts("vcmgraphs", cell, name, t, card)


if __name__ == "__main__":
    main()
