"""Scene arrays <-> port scene.

A scene crosses between the JAX package and the port as a flat dict of
NumPy arrays (plus the static kind tuples), keyed "<field>.<subfield>"
after the DeviceScene layout both packages share.  `scene_to_numpy` reads
any DeviceScene-shaped dataclass (the JAX one or the port's) into that
dict; `scene_from_numpy` builds the port's scene from it.  A flat scene
carries its packed triangles (`BVH_KEYS`) and the port computes the
stream-tile packing (sbox, tiles, center) from them; a two-level
("stream2") scene carries its tiles and instance metadata
(`BVH2_KEYS`, tile_idx / inst_of in the JAX package's (1, 1, S) shape)
and no packed triangles.  The port's own builder (scene/build.py) goes
through the same dict, so the same arrays give the same scene either way.
"""

from __future__ import annotations

import numpy as np

from .accel.device import DeviceBvh
from .render.envmap import ENV_KEYS, EnvMapData
from .render.lights import BSphere, LightTable
from .render.materials import MaterialTable
from .scene.textures import TextureAtlas
from .scene.types import DeviceScene, TriAttrs

BVH_KEYS = ("tri_v0", "tri_e1", "tri_e2", "tri_id")
BVH2_KEYS = ("sbox", "tiles", "tile_idx", "inst_of", "itab")
TABLES = {
    "attrs": ("rec", "shade_rec", "n0", "n1", "n2", "uv0", "uv1", "uv2",
              "gn", "mat_id", "light_id", "inst_id", "local_id"),
    "materials": ("rec", "kind", "kd", "ks", "tf", "ns", "ior", "emit",
                  "kd_tex", "bump_tex", "mask_tex"),
    "lights": ("rec", "kind", "p0", "p1", "p2", "normal", "intensity",
               "area", "cos_angle"),
    "textures": ("texels", "offset", "width", "height"),
    "bsphere": ("center", "radius", "inv_radius_sqr"),
}


def _np(x):
    if hasattr(x, "detach"):
        x = x.detach().cpu()
    return np.asarray(x)


def _is_two_level(bvh) -> bool:
    return getattr(bvh, "tile_idx", None) is not None


def scene_to_numpy(scene) -> dict:
    """Flatten a DeviceScene (JAX or port) into the shared array dict;
    the environment map's tables ride along as "env.*" (None without
    one)."""
    if _is_two_level(scene.bvh):
        out = {f"bvh.{k}": _np(getattr(scene.bvh, k)) for k in BVH2_KEYS}
        for k in ("tile_idx", "inst_of"):
            out[f"bvh.{k}"] = out[f"bvh.{k}"].reshape(1, 1, -1)
    else:
        out = {f"bvh.{k}": _np(getattr(scene.bvh, k)) for k in BVH_KEYS}
    for table, keys in TABLES.items():
        obj = getattr(scene, table)
        for k in keys:
            out[f"{table}.{k}"] = _np(getattr(obj, k))
    mask_rec = scene.attrs.mask_rec
    out["attrs.mask_rec"] = None if mask_rec is None else _np(mask_rec)
    out["attrs.shade_cols"] = tuple(scene.attrs.shade_cols)
    env = getattr(scene, "env", None)
    for k in ENV_KEYS:
        out[f"env.{k}"] = None if env is None else _np(getattr(env, k))
    out["mat_kinds"] = tuple(scene.mat_kinds)
    out["light_kinds"] = tuple(scene.light_kinds)
    return out


def scene_from_numpy(arrays: dict, device, pairs: bool = False
                     ) -> DeviceScene:
    """The port's DeviceScene on `device` from the shared array dict;
    `pairs` is the BVH's pairs switch (accel/device.py)."""
    import torch

    t = lambda a: torch.as_tensor(np.array(a), device=device)

    def table(name):
        return {k: t(arrays[f"{name}.{k}"]) for k in TABLES[name]}

    mask_rec = arrays.get("attrs.mask_rec")
    env = None
    if arrays.get("env.img") is not None:
        env = EnvMapData(**{k: t(arrays[f"env.{k}"]) for k in ENV_KEYS})
    if arrays.get("bvh.tile_idx") is not None:
        bvh = DeviceBvh.from_two_level(
            *(np.asarray(arrays[f"bvh.{k}"]) for k in BVH2_KEYS),
            device=device, pairs=pairs)
    else:
        bvh = DeviceBvh.from_packed(*(np.asarray(arrays[f"bvh.{k}"])
                                      for k in BVH_KEYS), device=device,
                                    pairs=pairs)
    return DeviceScene(
        bvh=bvh,
        attrs=TriAttrs(**table("attrs"),
                       mask_rec=None if mask_rec is None else t(mask_rec),
                       shade_cols=tuple(arrays["attrs.shade_cols"])),
        materials=MaterialTable(**table("materials")),
        lights=LightTable(**table("lights")),
        textures=TextureAtlas(**table("textures")),
        bsphere=BSphere(**table("bsphere")),
        env=env,
        mat_kinds=tuple(arrays["mat_kinds"]),
        light_kinds=tuple(arrays["light_kinds"]),
    )
