"""Device-resident scene representation (torch twin of
imbatracer_tpu.scene.types): one dataclass of tensors, fully SoA, with
instances flattened to world space at build time."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from ..accel.device import DeviceBvh
from ..render.envmap import EnvMapData
from ..render.lights import BSphere, LightTable
from ..render.materials import MaterialTable
from ..tensors import TensorData
from .textures import TextureAtlas


@dataclass
class TriAttrs(TensorData):
    """Per flat triangle shading attributes.

    `rec` (F, 24): [n0(0:3), n1(3:6), n2(6:9), gn(9:12), uv0(12:14),
    uv1(14:16), uv2(16:18), mat_id(18), light_id(19), inst_id(20),
    local_id(21) (i32 bits), pad(22:24)].
    `shade_rec` (F, len(shade_cols)): rec[0:22] joined with the material
    row and emitter data, canonical columns [.. 0..21 .., kind(22),
    kd(23:26), ks(26:29), tf(29:32), ns(32), ior(33), emit(34:37),
    area(37), kd_tex(38), bump_tex(39), mask_tex(40), pad..48], keeping
    only the canonical columns named by `shade_cols`, in order.
    """

    rec: torch.Tensor
    shade_rec: torch.Tensor
    n0: torch.Tensor
    n1: torch.Tensor
    n2: torch.Tensor
    uv0: torch.Tensor
    uv1: torch.Tensor
    uv2: torch.Tensor
    gn: torch.Tensor
    mat_id: torch.Tensor
    light_id: torch.Tensor
    inst_id: torch.Tensor
    local_id: torch.Tensor
    mask_rec: Optional[torch.Tensor] = None
    shade_cols: tuple = tuple(range(48))


def shade_columns(mat_kinds: tuple, has_textures: bool, has_bump: bool,
                  has_masks: bool) -> tuple:
    """Canonical shade_rec columns the shading step can consume (the same
    subset imbatracer_tpu.scene.types.shade_columns keeps by default)."""
    kinds = set(mat_kinds) if mat_kinds else {0, 1, 2, 3, 4, 5}
    cols = list(range(12))                    # n0 n1 n2 gn
    if has_textures or has_masks:
        cols += list(range(12, 18))           # uv0 uv1 uv2
    cols += [18, 19]                          # mat_id, light_id
    cols += [22, 23, 24, 25]                  # kind, kd
    if kinds & {1, 2, 3, 4}:
        cols += [26, 27, 28]                  # ks
    if 2 in kinds:
        cols += [29, 30, 31]                  # tf
    if kinds & {1, 3, 4, 5}:
        cols += [32]                          # ns
    if 2 in kinds:
        cols += [33]                          # ior
    cols += [34, 35, 36, 37]                  # emit, area
    if has_textures:
        cols += [38]                          # kd_tex
    if has_bump and has_textures:
        cols += [39]                          # bump_tex
    if has_masks:
        cols += [40]                          # mask_tex
    return tuple(cols)


@dataclass
class DeviceScene(TensorData):
    bvh: DeviceBvh
    attrs: TriAttrs
    materials: MaterialTable
    lights: LightTable
    textures: TextureAtlas
    bsphere: BSphere
    env: Optional[EnvMapData] = None
    # Static per-scene facts: the sorted sets of material / light kinds
    # present; `()` means "unknown, evaluate every kind".
    mat_kinds: tuple = ()
    light_kinds: tuple = ()

    @property
    def num_lights(self):
        return self.lights.kind.shape[0]

    @property
    def device(self) -> torch.device:
        return self.bvh.tiles.device


@dataclass
class SceneMeta:
    """Host-side static facts about a built scene."""

    name: str = ""
    num_tris: int = 0
    num_materials: int = 0
    num_lights: int = 0
    num_textures: int = 0
    has_env: bool = False
    has_masks: bool = False
    has_bump: bool = False
    cam_pos: tuple = (0.0, 0.0, 0.0)
    cam_dir: tuple = (0.0, 0.0, -1.0)
    cam_up: tuple = (0.0, 1.0, 0.0)
    bvh_stats: dict = field(default_factory=dict)
