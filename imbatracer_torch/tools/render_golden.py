"""Self-rendered goldens (torch twin of the repository's
tools/render_golden.py): a long PT render of a scene that has no
reference image, the reference's own method (test/render_refs.sh), saved
as a tone-mapped 8-bit PNG, with a convergence self-check: the RMSE
between the image at half the budget and the final one.

    python -m imbatracer_torch.tools.render_golden still_life_512_len4 -t 900
    python -m imbatracer_torch.tools.render_golden --list

Writes `results/torch_goldens/<name>.png` (`-o` for another path); the
tracked goldens/ stay the JAX renderer's.  Runs on the card unless
`--device cpu`.
"""

from __future__ import annotations

import argparse
import os
import time

from ..device import get_device, synchronize
from ..frontend.engine import make_frame_fn
from ..frontend.renderer import ProgressiveRenderer, RenderSettings
from ..io.image import encode_png
from ..utils.metrics import quantize, rmse
from .run_bench import ROOT, build_any_scene

GOLDEN_DIR = os.path.join(ROOT, "results", "torch_goldens")

# name -> (scene uri, width, height, max_path_len); the instanced golden
# renders gen:card in place of the reference's cornell_instances.scene.
GOLDENS = {
    "still_life_512_len4": ("proc:still_life", 512, 512, 4),
    "still_life_1080p_len8": ("proc:still_life", 1920, 1080, 8),
    "still_life_1080p_len10": ("proc:still_life", 1920, 1080, 10),
    "still_life_512_len10": ("proc:still_life", 512, 512, 10),
    "instances_1080p_len10": ("gen:card", 1920, 1080, 10),
}


def golden_path(name: str) -> str:
    return os.path.join(GOLDEN_DIR, name + ".png")


def render_golden(name: str, seconds: float, out: str = "",
                  device="cuda") -> str:
    """Render GOLDENS[name] with PT for `seconds` after one warm-up
    frame, print the half-vs-final RMSE, write the PNG; returns its
    path."""
    dev = get_device(device)
    scene_uri, width, height, max_len = GOLDENS[name]
    scene, meta = build_any_scene(scene_uri, dev)
    settings = RenderSettings(width=width, height=height, algorithm="pt",
                              max_path_len=max_len, max_time_sec=seconds)
    frame_fn, _ = make_frame_fn(scene, meta, settings)
    r = ProgressiveRenderer(frame_fn, settings, dev)
    r.step()                    # builds the kernels, captures the graphs
    r.image()
    r.reset()

    t0 = time.time()
    half = None
    half_frames = 0
    while time.time() - t0 < seconds:
        r.step()
        synchronize(dev)
        if half is None and time.time() - t0 >= seconds / 2:
            half = r.image()
            half_frames = r.frames
    img = r.image()
    conv = rmse(half, img) if half is not None else float("nan")
    print(f"{name}: {r.frames} frames in {time.time() - t0:.0f} s; "
          f"half-vs-final rmse {conv:.5f} (half at {half_frames} frames)")

    out = out or golden_path(name)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "wb") as f:
        f.write(encode_png(quantize(img)))
    print(f"wrote {out}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m imbatracer_torch.tools.render_golden")
    ap.add_argument("names", nargs="*", help="golden names (see --list)")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("-t", type=float, default=900.0,
                    help="render budget per golden, seconds")
    ap.add_argument("-o", default="", help="output path (single name only)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.list or not args.names:
        for k, v in GOLDENS.items():
            print(f"{k}: {v}")
        return 0
    for n in args.names:
        render_golden(n, args.t, args.o if len(args.names) == 1 else "",
                      args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
