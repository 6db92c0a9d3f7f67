"""Frozen copy of the program's `core/math3d.py`, for the benchmark's plain
reference; its own description follows.

Host-side (NumPy) instance transforms for scene building: the port's
own copy of the parts of imbatracer_tpu.core.math3d that scene
construction uses (translate / scale / Euler rotation, the instance
matrix, point and normal transforms).  Float64 throughout, as the JAX
package computes them, so flattened vertices round alike."""

from __future__ import annotations

import numpy as np


def translate(t) -> np.ndarray:
    m = np.eye(4, dtype=np.float64)
    m[:3, 3] = t
    return m


def scale(s) -> np.ndarray:
    m = np.eye(4, dtype=np.float64)
    m[0, 0], m[1, 1], m[2, 2] = s
    return m


def rotate_x(deg: float) -> np.ndarray:
    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    m = np.eye(4, dtype=np.float64)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return m


def rotate_y(deg: float) -> np.ndarray:
    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    m = np.eye(4, dtype=np.float64)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return m


def rotate_z(deg: float) -> np.ndarray:
    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    m = np.eye(4, dtype=np.float64)
    m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, -s, s, c
    return m


def euler(rx: float, ry: float, rz: float) -> np.ndarray:
    """Euler-angle rotation in degrees, X then Y then Z (the `.scene`
    `rot` directive)."""
    return rotate_z(rz) @ rotate_y(ry) @ rotate_x(rx)


def instance_matrix(pos, scl, rot_deg) -> np.ndarray:
    """pos / scale / rot (Euler degrees) -> an instance's 4x4 mesh->world
    transform."""
    return translate(pos) @ euler(*rot_deg) @ scale(scl)


def transform_points(m: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Apply a 4x4 to an (N, 3) array of points."""
    return pts @ m[:3, :3].T + m[:3, 3]


def transform_normals(m: np.ndarray, normals: np.ndarray) -> np.ndarray:
    """Normals transform by the inverse-transpose; renormalised."""
    inv_t = np.linalg.inv(m[:3, :3]).T
    n = normals @ inv_t.T
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    return n / np.maximum(ln, 1e-20)
