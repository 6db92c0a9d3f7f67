"""Image error metrics (torch-free NumPy twin of
imbatracer_tpu.utils.metrics): both images are tone-mapped [0, 1] RGB,
quantised to 8 bits, and RMSE is normalised to [0, 1], as ImageMagick's
`compare -metric RMSE` reports it; PSNR derives from the same quantity.
"""

from __future__ import annotations

import numpy as np

from ..io.image import load_png


def quantize(img01: np.ndarray) -> np.ndarray:
    return np.clip(img01 * 255.0 + 0.5, 0, 255).astype(np.uint8)


def rmse(a01: np.ndarray, b01: np.ndarray) -> float:
    """Normalised RMSE between two [0,1] RGB images after 8-bit
    quantisation."""
    a = quantize(a01).astype(np.float64) / 255.0
    b = quantize(b01).astype(np.float64) / 255.0
    return float(np.sqrt(np.mean((a - b) ** 2)))


def psnr(a01: np.ndarray, b01: np.ndarray) -> float:
    r = rmse(a01, b01)
    if r <= 0:
        return float("inf")
    return float(-20.0 * np.log10(r))


def load_reference_png(path: str) -> np.ndarray:
    """Load a golden PNG as [0,1] RGB (already tone-mapped)."""
    return load_png(path)[..., :3].astype(np.float32) / 255.0
