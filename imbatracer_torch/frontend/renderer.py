"""Progressive render orchestration (torch twin of
imbatracer_tpu.frontend.renderer): accumulate per-frame films, stop on a
sample or time budget, log progress, dump intermediate images, report the
reference-format perf line, write the tone-mapped PNG."""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..io.image import store_png
from ..render.camera import Camera, make_camera
from ..render.film import tonemap
from ..utils.log import logger


@dataclass
class RenderSettings:
    """The render knobs of the reference's UserSettings."""

    width: int = 512
    height: int = 512
    fov: float = 60.0
    spp: int = 1
    max_path_len: int = 10
    gamma: float = 0.5
    max_samples: int = 2 ** 31 - 1
    max_time_sec: float = float("inf")
    algorithm: str = "pt"
    light_path_count: int = 0      # 0 -> width*height/2, capped (below)
    num_connections: int = 1
    # The JAX package's k-nearest photon count of its windowed hash-grid
    # merge; the port merges exactly (ops/merge.py) and never reads it.
    num_knn: int = 10
    radius_factor: float = 2.0
    intermediate_path: str = ""
    intermediate_time: float = float("inf")

    def resolved_light_path_count(self) -> int:
        """An explicit count wins.  The default is the reference's
        width*height/2, capped per family as the JAX package caps it: the
        merge-free estimators (BPT, LT) at 2^16, the merging ones at 2^17
        (the JAX renderer measured equal-or-better quality at a fixed time
        budget with fewer, cheaper light paths)."""
        if self.light_path_count:
            return self.light_path_count
        cap = 1 << 16 if self.algorithm in ("bpt", "lt") else 1 << 17
        return min((self.width * self.height) // 2, cap)


class ProgressiveRenderer:
    """Accumulates frames from `frame_fn(frame_index) -> (H*W, 3)` films
    on `device`."""

    def __init__(self, frame_fn, settings: RenderSettings, device):
        self.frame_fn = frame_fn
        self.s = settings
        self.device = torch.device(device)
        self.reset()

    def reset(self):
        """Restart accumulation (camera moved / scene changed)."""
        self.accum = torch.zeros((self.s.width * self.s.height, 3),
                                 dtype=torch.float32, device=self.device)
        self.frames = 0

    def step(self):
        self.accum = self.accum + self.frame_fn(self.frames)
        self.frames += 1

    def run(self, quiet: bool = False):
        """Render until the sample or time budget is spent; unless
        `quiet`, log samples, fps and ms/frame every 10 s; every
        `intermediate_time` seconds write `<intermediate_path>_<s>s.png`;
        print the perf line in the reference's format."""
        s = self.s
        t_start = time.time()
        t_last_report = t_last_dump = t_start
        frame_ms = []
        while True:
            t0 = time.time()
            self.step()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            frame_ms.append((time.time() - t0) * 1000.0)
            elapsed = time.time() - t_start
            samples = self.frames * s.spp
            if not quiet and time.time() - t_last_report > 10.0:
                logger.info("%d samples, %.2f fps, %.2f ms/frame", samples,
                            self.frames / elapsed, np.mean(frame_ms[-20:]))
                t_last_report = time.time()
            if (s.intermediate_path
                    and time.time() - t_last_dump >= s.intermediate_time):
                self.save(f"{s.intermediate_path}_{int(elapsed)}s.png")
                t_last_dump = time.time()
            if samples >= s.max_samples or elapsed >= s.max_time_sec:
                break
        elapsed = time.time() - t_start
        samples = self.frames * s.spp
        fps = self.frames / max(elapsed, 1e-9)
        ms = 1000.0 * elapsed / max(self.frames, 1)
        print(f"Done after {elapsed} seconds, {samples} samples @ {fps} "
              f"frames per second, {ms} ms per frame")
        return self.image()

    def image(self) -> np.ndarray:
        """Current tone-mapped [0, 1] HxWx3 image."""
        weight = 1.0 / max(self.frames * self.s.spp, 1)
        img = tonemap(self.accum, weight, self.s.gamma)
        return img.cpu().numpy().reshape(self.s.height, self.s.width, 3)

    def raw(self) -> np.ndarray:
        return self.accum.cpu().numpy().reshape(self.s.height, self.s.width,
                                                3)

    def save(self, path: str):
        store_png(path, self.image(), weight=1.0, gamma=1.0)
        logger.info("wrote %s", path)


def camera_for_scene(meta, settings: RenderSettings, device) -> Camera:
    return make_camera(meta.cam_pos, meta.cam_dir, meta.cam_up,
                       settings.width, settings.height, settings.fov,
                       device=device)
