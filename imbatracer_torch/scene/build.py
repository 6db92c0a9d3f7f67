"""Scene assembly: flat world-space triangle arrays -> port DeviceScene
(torch-native counterpart of imbatracer_tpu.scene.build.
assemble_device_scene).

The host side is NumPy plus the port's own native binned-SAH builder
(accel/native.py, csrc/bvh_builder.cpp) and leaf packing
(accel/flatten.py), copies of the JAX package's host modules.  The
arrays are laid out exactly as the JAX builder lays them out and then go
through `convert.scene_from_numpy`, so both packages hold identical
scene data.
"""

from __future__ import annotations

import time

import numpy as np

from ..accel.builder import triangle_bboxes
from ..accel.flatten import thread_bvh
from ..accel.native import build_bvh_native
from ..render import lights as light_mod
from ..render.envmap import ENV_KEYS
from ..utils.log import logger
from .textures import pack_textures
from .types import shade_columns


def _geom_normals(v0, v1, v2):
    n = np.cross(v1 - v0, v2 - v0)
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    return (n / np.maximum(ln, 1e-20)).astype(np.float32)


def _atlas_arrays(images):
    atlas = pack_textures(images, device="cpu")
    return {f"textures.{k}": getattr(atlas, k).numpy()
            for k in ("texels", "offset", "width", "height")}


def _light_arrays(rows):
    table = light_mod.build_light_table(rows, device="cpu")
    return {f"lights.{k}": getattr(table, k).numpy() for k in
            ("rec", "kind", "p0", "p1", "p2", "normal", "intensity", "area",
             "cos_angle")}


def assemble_arrays(v0, v1, v2, attrs, mat_rows, light_rows, textures,
                    env=None):
    """BVH build + table assembly on the host.  Returns (arrays, stats):
    the shared scene array dict (see convert.py) and the BVH stats.
    `env`: the scene's EnvMapData (render/envmap.py) or None."""
    lo = np.minimum(np.minimum(v0.min(0), v1.min(0)), v2.min(0))
    hi = np.maximum(np.maximum(v0.max(0), v1.max(0)), v2.max(0))
    center = 0.5 * (lo + hi)
    radius = float(np.linalg.norm(hi - center)) + 1e-6

    t_bvh = time.time()
    blo, bhi = triangle_bboxes(v0, v1, v2)
    threaded = thread_bvh(build_bvh_native(blo, bhi), v0, v1, v2)
    logger.info("BVH: %s in %.2fs", threaded.stats, time.time() - t_bvh)

    arr = lambda key, dt=np.float32: np.asarray([m[key] for m in mat_rows],
                                                dt)
    M = len(mat_rows)
    mat_rec = np.zeros((M, 24), np.float32)
    mat_rec[:, 0] = arr("kind", np.int32).view(np.float32)
    mat_rec[:, 1:4] = arr("kd")
    mat_rec[:, 4:7] = arr("ks")
    mat_rec[:, 7:10] = arr("tf")
    mat_rec[:, 10] = arr("ns")
    mat_rec[:, 11] = arr("ior")
    mat_rec[:, 12:15] = arr("emit")
    mat_rec[:, 15] = arr("kd_tex", np.int32).view(np.float32)
    mat_rec[:, 16] = arr("bump_tex", np.int32).view(np.float32)
    mat_rec[:, 17] = arr("mask_tex", np.int32).view(np.float32)

    gn = _geom_normals(v0, v1, v2)
    F = v0.shape[0]
    attr_rec = np.zeros((F, 24), np.float32)
    attr_rec[:, 0:3] = attrs["n0"]
    attr_rec[:, 3:6] = attrs["n1"]
    attr_rec[:, 6:9] = attrs["n2"]
    attr_rec[:, 9:12] = gn
    attr_rec[:, 12:14] = attrs["uv0"]
    attr_rec[:, 14:16] = attrs["uv1"]
    attr_rec[:, 16:18] = attrs["uv2"]
    for col, key in ((18, "mat_id"), (19, "light_id"), (20, "inst_id"),
                     (21, "local_id")):
        attr_rec[:, col] = attrs[key].astype(np.int32).view(np.float32)

    mid = attrs["mat_id"]
    lid = attrs["light_id"]
    tri_area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
    shade_rec = np.zeros((F, 48), np.float32)
    shade_rec[:, 0:22] = attr_rec[:, 0:22]
    shade_rec[:, 22] = arr("kind", np.int32)[mid].view(np.float32)
    shade_rec[:, 23:26] = arr("kd")[mid]
    shade_rec[:, 26:29] = arr("ks")[mid]
    shade_rec[:, 29:32] = arr("tf")[mid]
    shade_rec[:, 32] = arr("ns")[mid]
    shade_rec[:, 33] = arr("ior")[mid]
    shade_rec[:, 34:37] = arr("emit")[mid]
    shade_rec[:, 37] = np.where(lid >= 0, tri_area, 0.0).astype(np.float32)
    shade_rec[:, 38] = arr("kd_tex", np.int32)[mid].view(np.float32)
    shade_rec[:, 39] = arr("bump_tex", np.int32)[mid].view(np.float32)
    shade_rec[:, 40] = arr("mask_tex", np.int32)[mid].view(np.float32)

    mat_kinds = tuple(sorted({int(m["kind"]) for m in mat_rows}))
    light_kinds = (tuple(sorted({int(r["kind"]) for r in light_rows}))
                   or (light_mod.LIGHT_POINT,))  # dummy black point light
    shade_cols = shade_columns(
        mat_kinds, has_textures=len(textures) > 0,
        has_bump=bool((arr("bump_tex", np.int32) >= 0).any()),
        has_masks=bool((arr("mask_tex", np.int32) >= 0).any()))

    atlas = _atlas_arrays(textures)
    mask_tex_tri = arr("mask_tex", np.int32)[mid]
    mask_rec = None
    if (mask_tex_tri >= 0).any():
        mt = np.maximum(mask_tex_tri, 0)
        mask_rec = np.zeros((F, 10), np.float32)
        mask_rec[:, 0] = mask_tex_tri.view(np.float32)
        mask_rec[:, 1] = atlas["textures.width"][mt].view(np.float32)
        mask_rec[:, 2] = atlas["textures.height"][mt].view(np.float32)
        mask_rec[:, 3] = atlas["textures.offset"][mt].view(np.float32)
        mask_rec[:, 4:6] = attrs["uv0"]
        mask_rec[:, 6:8] = attrs["uv1"]
        mask_rec[:, 8:10] = attrs["uv2"]

    arrays = {
        "bvh.tri_v0": threaded.tri_v0, "bvh.tri_e1": threaded.tri_e1,
        "bvh.tri_e2": threaded.tri_e2, "bvh.tri_id": threaded.tri_id,
        "attrs.rec": attr_rec,
        "attrs.shade_rec": shade_rec[:, list(shade_cols)],
        "attrs.gn": gn, "attrs.mask_rec": mask_rec,
        "attrs.shade_cols": shade_cols,
        "materials.rec": mat_rec, "materials.kind": arr("kind", np.int32),
        "materials.kd_tex": arr("kd_tex", np.int32),
        "materials.bump_tex": arr("bump_tex", np.int32),
        "materials.mask_tex": arr("mask_tex", np.int32),
        "bsphere.center": np.asarray(center, np.float32),
        "bsphere.radius": np.asarray(radius, np.float32),
        "bsphere.inv_radius_sqr": np.asarray(1.0 / (radius * radius),
                                             np.float32),
        "mat_kinds": mat_kinds, "light_kinds": light_kinds,
        **atlas, **_light_arrays(light_rows),
    }
    for key in ("kd", "ks", "tf", "ns", "ior", "emit"):
        arrays[f"materials.{key}"] = arr(key)
    for key in ("n0", "n1", "n2", "uv0", "uv1", "uv2", "mat_id", "light_id",
                "inst_id", "local_id"):
        arrays[f"attrs.{key}"] = attrs[key]
    for key in ENV_KEYS:
        arrays[f"env.{key}"] = (None if env is None
                                else getattr(env, key).cpu().numpy())
    return arrays, threaded.stats


def assemble_device_scene(v0, v1, v2, attrs, mat_rows, light_rows, textures,
                          env, device):
    """Shared tail of scene construction; returns (DeviceScene, stats)."""
    from ..convert import scene_from_numpy

    arrays, stats = assemble_arrays(v0, v1, v2, attrs, mat_rows, light_rows,
                                    textures, env)
    return scene_from_numpy(arrays, device), stats
