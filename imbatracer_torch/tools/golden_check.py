"""Render a scene and compare it against a golden image (torch twin of
the repository's scripts/golden_check.py).

    python -m imbatracer_torch.tools.golden_check scene golden
        [seconds] [size] [algo] [--device cuda|cpu] [-o out.png]

Defaults: 60 s, 1024^2, pt; the scene and the golden are always given
(the JAX script's defaults point into the reference's checkout).  Prints the device, the first frame's seconds (kernel
builds and graph captures), the perf line, and RMSE / PSNR against the
golden; writes the render to `-o` (default
results/torch_golden_check_<scene>.png).
"""

from __future__ import annotations

import argparse
import os
import time

from ..device import card_line, get_device, synchronize
from ..frontend.engine import ALGORITHMS, make_frame_fn
from ..frontend.renderer import ProgressiveRenderer, RenderSettings
from ..scene.build import build_scene
from ..utils.metrics import load_reference_png, psnr, rmse


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m imbatracer_torch.tools.golden_check")
    ap.add_argument("scene")
    ap.add_argument("golden")
    ap.add_argument("seconds", nargs="?", type=float, default=60.0)
    ap.add_argument("size", nargs="?", type=int, default=1024)
    ap.add_argument("algo", nargs="?", default="pt", choices=ALGORITHMS)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("-o", "--out", default="")
    args = ap.parse_args(argv)

    dev = get_device(args.device)
    print("device:", card_line(dev))
    scene, meta = build_scene(args.scene, device=dev)
    settings = RenderSettings(width=args.size, height=args.size,
                              max_time_sec=args.seconds, spp=1,
                              algorithm=args.algo)
    frame_fn, _ = make_frame_fn(scene, meta, settings)
    r = ProgressiveRenderer(frame_fn, settings, dev)
    t0 = time.time()
    r.step()
    synchronize(dev)
    print(f"first frame (kernel builds, graph captures): "
          f"{time.time() - t0:.1f}s")
    img = r.run(quiet=True)
    tag = os.path.basename(args.scene).split(".")[0]
    out = args.out or os.path.join("results",
                                   f"torch_golden_check_{tag}.png")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    r.save(out)

    ref = load_reference_png(args.golden)
    if ref.shape[:2] != img.shape[:2]:
        print(f"size mismatch: ref {ref.shape} vs img {img.shape}")
        return 1
    print(f"RMSE: {rmse(img, ref):.5f}  PSNR: {psnr(img, ref):.2f} dB  "
          f"frames: {r.frames}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
