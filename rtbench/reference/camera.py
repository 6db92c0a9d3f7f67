"""Frozen copy of the program's `render/camera.py`, for the benchmark's plain
reference; its own description follows.

Pinhole camera (torch twin of imbatracer_tpu.render.camera).

Conventions: `fov` is the horizontal field of view in degrees; the
image-plane distance in pixel units is `width / (2 tan(fov/2))`; the basis
is right = normalize(cross(dir, up)), down = cross(dir, right); raster y
grows downward; pixel (x, y) maps to plane offsets a = x - w/2 (right) and
b = (w/h)(y - h/2) (down).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .vecmath import dot, normalize
from .tensors import TensorData


@dataclass
class Camera(TensorData):
    pos: torch.Tensor             # (3,)
    forward: torch.Tensor         # (3,) unit
    right: torch.Tensor           # (3,) unit
    down: torch.Tensor            # (3,) unit
    img_plane_dist: torch.Tensor  # () pixel units
    width: int
    height: int


def make_camera(pos, direction, up, width: int, height: int, fov_deg: float,
                device) -> Camera:
    pos = np.asarray(pos, np.float64)
    f = np.asarray(direction, np.float64)
    f = f / np.linalg.norm(f)
    r = np.cross(f, np.asarray(up, np.float64))
    r = r / np.linalg.norm(r)
    d = np.cross(f, r)
    img_plane_dist = width / (2.0 * np.tan(np.deg2rad(fov_deg) * 0.5))
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return Camera(pos=t(pos), forward=t(f), right=t(r), down=t(d),
                  img_plane_dist=t(img_plane_dist), width=int(width),
                  height=int(height))


def generate_ray(cam: Camera, raster_x, raster_y):
    """Primary ray through raster position (x, y); returns (org, dir)."""
    a = raster_x - 0.5 * cam.width
    b = (cam.width / cam.height) * (raster_y - 0.5 * cam.height)
    p = (cam.forward * cam.img_plane_dist + cam.right * a[..., None]
         + cam.down * b[..., None])
    d = normalize(p)
    org = cam.pos.expand(d.shape)
    return org, d


def world_to_raster(cam: Camera, world_pos):
    """Project world points to raster coords; returns (raster_x, raster_y,
    depth_along_forward)."""
    dp = world_pos - cam.pos
    depth = dot(dp, cam.forward)
    safe = torch.where(torch.abs(depth) < 1e-8, 1e-8, depth)
    a = dot(dp, cam.right) * cam.img_plane_dist / safe
    b = dot(dp, cam.down) * cam.img_plane_dist / safe
    rx = 0.5 * cam.width + a
    ry = 0.5 * cam.height + (cam.height / cam.width) * b
    return rx, ry, depth


def raster_to_id(cam: Camera, rx, ry):
    """Raster position -> pixel id, -1 outside."""
    x = torch.floor(rx).to(torch.int32)
    y = torch.floor(ry).to(torch.int32)
    inside = (x >= 0) & (x < cam.width) & (y >= 0) & (y < cam.height)
    return torch.where(inside, y * cam.width + x, -1)
