"""Command-line frontend (torch twin of imbatracer_tpu.frontend.cli).

    python -m imbatracer_torch <scene.scene> [out.png] [flags]

The JAX CLI's flags, names and defaults: `-a` algorithm, `-w` / `-h2`
size, `-s` / `-t` sample and time budgets, `-q` quiet, the integrator
knobs (connections clamped to [1, 8], light paths defaulting to
width*height/2 with the per-family cap), `--gamma`, headless
intermediate dumps (`--intermediate-path` / `--intermediate-time`),
`--sbvh` (a spatial-split BVH for a flat scene, kept in the disk cache
as every flat scene's BVH is) and `--interactive` (the live terminal
preview, frontend/interactive.py).  `--device` (cuda by default, or cpu)
picks where the scene lives and renders; the port never falls back from
one to the other.

With `--device cuda` and more than one visible card, the CLI starts one
rank a card (parallel/launch.py; CUDA_VISIBLE_DEVICES picks the cards),
each builds the scene on its card and every frame is rendered across
them (parallel/shard.py), as the JAX CLI shards over its chips; rank 0
writes the PNG and prints the perf line, and in `--interactive` keeps
the terminal while the others follow its camera.  `--device cpu` is one
process.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..device import get_device
from ..parallel import launch
from ..scene.build import build_scene
from ..utils.log import logger
from .engine import ALGORITHMS, make_frame_fn
from .renderer import ProgressiveRenderer, RenderSettings

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="imbatracer-torch",
        description="GPU global illumination renderer (PyTorch + CUDA)",
    )
    p.add_argument("scene", help="path to a .scene file")
    p.add_argument("output", nargs="?", default="render.png",
                   help="output PNG")
    p.add_argument("-a", "--algorithm", default="pt", choices=ALGORITHMS)
    p.add_argument("-w", "--width", type=int, default=512)
    p.add_argument("-h2", "--height", type=int, default=512)
    p.add_argument("-f", "--fov", type=float, default=60.0)
    p.add_argument("-s", "--max-samples", type=int, default=2 ** 31 - 1,
                   help="stop after this many samples per pixel")
    p.add_argument("-t", "--max-time", type=float, default=float("inf"),
                   help="stop after this many seconds")
    p.add_argument("--spp", type=int, default=1,
                   help="samples per pixel per frame")
    p.add_argument("--max-path-len", type=int, default=10)
    p.add_argument("--light-path-count", type=int, default=0)
    p.add_argument("-c", "--connections", type=int, default=1)
    p.add_argument("-k", "--knn", type=int, default=10)
    p.add_argument("-r", "--radius-factor", type=float, default=2.0)
    p.add_argument("--gamma", type=float, default=0.5)
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("--sbvh", action="store_true",
                   help="spatial-split BVH build (slower build, faster "
                        "traversal on thin-triangle scenes; cached)")
    p.add_argument("--intermediate-path", default="")
    p.add_argument("--intermediate-time", type=float, default=float("inf"))
    p.add_argument("--interactive", action="store_true",
                   help="interactive preview: WASD/QE move, IJKL look, "
                        "live terminal view (the reference's render "
                        "window; needs a TTY)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the scene lives and renders")
    return p


def settings_from_args(args) -> RenderSettings:
    connections = min(max(args.connections, 1), 8)
    if connections != args.connections:
        logger.warning("connections clamped to %d", connections)
    return RenderSettings(
        width=args.width,
        height=args.height,
        fov=args.fov,
        spp=args.spp,
        max_path_len=args.max_path_len,
        gamma=args.gamma,
        max_samples=args.max_samples,
        max_time_sec=args.max_time,
        algorithm=args.algorithm,
        light_path_count=args.light_path_count,
        num_connections=connections,
        num_knn=args.knn,
        radius_factor=args.radius_factor,
        intermediate_path=args.intermediate_path,
        intermediate_time=args.intermediate_time,
    )


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    settings = settings_from_args(args)
    device = get_device(args.device)
    cards = torch.cuda.device_count() if device.type == "cuda" else 1
    if cards > 1:
        if args.interactive:
            from .interactive import require_tty

            require_tty()
        logger.info("sharding over %d cards", cards)
        launch.spawn(render_rank, cards, "cuda", "nccl", args=(argv,))
        return 0
    return render(args, settings, device)


def render_rank(comm, argv):
    """One rank of a render across `comm`'s ranks: the CLI's arguments,
    the scene built on the rank's device.  The spawned rank 0 of
    `--interactive` reads the terminal on file descriptor 0, which the
    launch leaves open in its ranks."""
    args = build_parser().parse_args(argv)
    if args.interactive and comm.rank == 0:
        sys.stdin = open(0, closefd=False)
    return render(args, settings_from_args(args), comm.device, comm=comm)


def render(args, settings, device, comm=None):
    """Build the scene on `device` and render it (across `comm`'s ranks,
    when given); the leader writes the PNG."""
    quiet = args.quiet or (comm is not None and comm.rank != 0)
    scene, meta = build_scene(args.scene, quiet=quiet, device=device,
                              spatial=args.sbvh)
    if not quiet:
        logger.info("scene %s: %d tris, %d lights, algo=%s, device %s",
                    meta.name, meta.num_tris, meta.num_lights,
                    args.algorithm, device)

    if args.interactive:
        from .interactive import follow_interactive, run_interactive

        if comm is not None and comm.rank != 0:
            follow_interactive(scene, meta, settings, comm)
        else:
            run_interactive(scene, meta, settings, args.output, comm=comm)
        return 0

    frame_fn, _cam = make_frame_fn(scene, meta, settings, comm=comm)
    renderer = ProgressiveRenderer(frame_fn, settings, device, comm=comm)
    renderer.run(quiet=args.quiet)
    if renderer.leader:
        renderer.save(args.output)
    return 0
