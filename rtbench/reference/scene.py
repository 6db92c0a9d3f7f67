"""The reference's scene: the tables the plain shading reads, built from
the benchmark's raw scene description, and the triangle clusters its
plain traversal (`traverse.py`) tests.

A raw description (`RawScene`) is what the benchmark's generators make
and what the program's scene build also receives: world-space triangles
(v0, v1, v2), per-triangle attributes (normals, uvs, material and light
ids), material rows, light rows, texture images, the environment image
and the camera.  Everything here is worked out again from it: the joined
shade record and the mask record follow the row layout of the program's
`scene/build.py` `assemble_arrays` (a frozen copy of its arithmetic), so
that the plain shading indexes them alike; no table of the program's is
read.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from . import lights as light_mod
from .envmap import EnvMapData, build_envmap
from .lights import BSphere, LightTable, build_light_table
from .materials import MaterialTable
from .textures import TextureAtlas, pack_textures


@dataclass
class RawScene:
    """A scene description as the generators make it (NumPy, host)."""

    v0: np.ndarray            # (F, 3) f32 world space
    v1: np.ndarray
    v2: np.ndarray
    attrs: dict               # n0 n1 n2 (F, 3), uv0 uv1 uv2 (F, 2), mat_id,
    #                           light_id, inst_id, local_id (F,) i32
    mat_rows: list            # dicts: kind kd ks tf ns ior emit *_tex
    light_rows: list          # dicts as lights.build_light_table takes
    textures: list            # (H, W, >=3) f32 images
    env_image: Optional[np.ndarray] = None
    env_intensity: tuple = (1.0, 1.0, 1.0)
    cam_pos: tuple = (0.0, 0.0, 0.0)
    cam_dir: tuple = (0.0, 0.0, -1.0)
    cam_up: tuple = (0.0, 1.0, 0.0)
    extra: dict = field(default_factory=dict)

    @property
    def has_masks(self) -> bool:
        return any(m["mask_tex"] >= 0 for m in self.mat_rows)

    @property
    def has_bump(self) -> bool:
        return any(m["bump_tex"] >= 0 for m in self.mat_rows)


@dataclass
class Attrs:
    shade_rec: torch.Tensor
    shade_cols: tuple
    mask_rec: Optional[torch.Tensor]


@dataclass
class RefScene:
    attrs: Attrs
    materials: MaterialTable
    lights: LightTable
    textures: TextureAtlas
    bsphere: BSphere
    env: Optional[EnvMapData]
    mat_kinds: tuple
    light_kinds: tuple
    # Traversal (traverse.py): world-space triangles sorted into
    # clusters, or, for a scene of instances, each mesh's mesh-space
    # clusters under the instances' world boxes and transforms.
    clusters: Optional["Clusters"]
    instances: Optional["Instances"]


@dataclass
class Clusters:
    """Triangles in Morton order of their centroids, cut into runs of
    `size` with a box each; the last run padded with a degenerate
    triangle far outside the scene (id -1), which no ray hits."""

    tri: dict              # v0 e1 e2 (N, 3), id (N,) i64, masked (N,) bool
    lo: torch.Tensor       # (C, 3)
    hi: torch.Tensor
    start: torch.Tensor    # (C,) first triangle of each cluster
    size: int


@dataclass
class Instances:
    """Two-level instancing: each instance's world box, its world->mesh
    affine (x_mesh = rot @ x_world + off) and its mesh's clusters; a
    mesh triangle's flat id is its instance's `base` plus its local id."""

    lo: torch.Tensor       # (I, 3) world boxes
    hi: torch.Tensor
    rot: torch.Tensor      # (I, 3, 3)
    off: torch.Tensor      # (I, 3)
    mesh: torch.Tensor     # (I,) i64
    base: torch.Tensor     # (I,) i64
    meshes: list           # Clusters of each mesh, ids local


def shade_columns(mat_kinds: tuple, has_textures: bool, has_bump: bool,
                  has_masks: bool) -> tuple:
    """The canonical shade-record columns the plain shading reads."""
    kinds = set(mat_kinds) if mat_kinds else {0, 1, 2, 3, 4, 5}
    cols = list(range(12))
    if has_textures or has_masks:
        cols += list(range(12, 18))
    cols += [18, 19]
    cols += [22, 23, 24, 25]
    if kinds & {1, 2, 3, 4}:
        cols += [26, 27, 28]
    if 2 in kinds:
        cols += [29, 30, 31]
    if kinds & {1, 3, 4, 5}:
        cols += [32]
    if 2 in kinds:
        cols += [33]
    cols += [34, 35, 36, 37]
    if has_textures:
        cols += [38]
    if has_bump and has_textures:
        cols += [39]
    if has_masks:
        cols += [40]
    return tuple(cols)


def _morton(c: np.ndarray) -> np.ndarray:
    """30-bit Morton codes of points already scaled to [0, 1023]."""
    x = c.astype(np.uint64)
    out = np.zeros(len(c), np.uint64)
    for bit in range(10):
        for axis in range(3):
            out |= ((x[:, axis] >> np.uint64(bit)) & np.uint64(1)) << \
                np.uint64(3 * bit + axis)
    return out


def build(raw: RawScene, device, cluster_size: int = 32) -> RefScene:
    """The reference's tables and clusters on `device`."""
    v0, v1, v2, attrs = raw.v0, raw.v1, raw.v2, raw.attrs
    mat_rows, light_rows, textures = raw.mat_rows, raw.light_rows, raw.textures
    lo = np.minimum(np.minimum(v0.min(0), v1.min(0)), v2.min(0))
    hi = np.maximum(np.maximum(v0.max(0), v1.max(0)), v2.max(0))
    center = 0.5 * (lo + hi)
    radius = float(np.linalg.norm(hi - center)) + 1e-6

    arr = lambda key, dt=np.float32: np.asarray([m[key] for m in mat_rows], dt)
    n = np.cross(v1 - v0, v2 - v0)
    gn = (n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True),
                         1e-20)).astype(np.float32)
    F = v0.shape[0]
    mid = attrs["mat_id"]
    lid = attrs["light_id"]
    tri_area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
    rec = np.zeros((F, 48), np.float32)
    rec[:, 0:3] = attrs["n0"]
    rec[:, 3:6] = attrs["n1"]
    rec[:, 6:9] = attrs["n2"]
    rec[:, 9:12] = gn
    rec[:, 12:14] = attrs["uv0"]
    rec[:, 14:16] = attrs["uv1"]
    rec[:, 16:18] = attrs["uv2"]
    for col, key in ((18, "mat_id"), (19, "light_id"), (20, "inst_id"),
                     (21, "local_id")):
        rec[:, col] = attrs[key].astype(np.int32).view(np.float32)
    rec[:, 22] = arr("kind", np.int32)[mid].view(np.float32)
    rec[:, 23:26] = arr("kd")[mid]
    rec[:, 26:29] = arr("ks")[mid]
    rec[:, 29:32] = arr("tf")[mid]
    rec[:, 32] = arr("ns")[mid]
    rec[:, 33] = arr("ior")[mid]
    rec[:, 34:37] = arr("emit")[mid]
    rec[:, 37] = np.where(lid >= 0, tri_area, 0.0).astype(np.float32)
    rec[:, 38] = arr("kd_tex", np.int32)[mid].view(np.float32)
    rec[:, 39] = arr("bump_tex", np.int32)[mid].view(np.float32)
    rec[:, 40] = arr("mask_tex", np.int32)[mid].view(np.float32)

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

    mat_kinds = tuple(sorted({int(m["kind"]) for m in mat_rows}))
    light_kinds = (tuple(sorted({int(r["kind"]) for r in light_rows}))
                   or (light_mod.LIGHT_POINT,))
    cols = shade_columns(mat_kinds, has_textures=len(textures) > 0,
                         has_bump=raw.has_bump, has_masks=raw.has_masks)
    atlas = pack_textures(textures, device="cpu")
    mask_tex_tri = arr("mask_tex", np.int32)[mid]
    mask_rec = None
    if (mask_tex_tri >= 0).any():
        mt = np.maximum(mask_tex_tri, 0)
        mask_rec = np.zeros((F, 10), np.float32)
        mask_rec[:, 0] = mask_tex_tri.view(np.float32)
        mask_rec[:, 1] = atlas.width.numpy()[mt].view(np.float32)
        mask_rec[:, 2] = atlas.height.numpy()[mt].view(np.float32)
        mask_rec[:, 3] = atlas.offset.numpy()[mt].view(np.float32)
        mask_rec[:, 4:6] = attrs["uv0"]
        mask_rec[:, 6:8] = attrs["uv1"]
        mask_rec[:, 8:10] = attrs["uv2"]

    env = None
    if raw.env_image is not None:
        env = build_envmap(raw.env_image, raw.env_intensity, device=device)

    masked = mask_tex_tri >= 0
    clusters = instances = None
    two_level = raw.extra.get("two_level")
    if two_level is None:
        clusters = _clusters(v0, v1, v2, np.arange(F), masked, device,
                             cluster_size)
    else:
        instances = _instances(two_level, masked, device, cluster_size)

    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    return RefScene(
        attrs=Attrs(shade_rec=t(rec[:, list(cols)]), shade_cols=cols,
                    mask_rec=None if mask_rec is None else t(mask_rec)),
        materials=MaterialTable(
            rec=t(mat_rec), kind=t(arr("kind", np.int32)), kd=t(arr("kd")),
            ks=t(arr("ks")), tf=t(arr("tf")), ns=t(arr("ns")),
            ior=t(arr("ior")), emit=t(arr("emit")),
            kd_tex=t(arr("kd_tex", np.int32)),
            bump_tex=t(arr("bump_tex", np.int32)),
            mask_tex=t(arr("mask_tex", np.int32))),
        lights=build_light_table(light_rows, device),
        textures=atlas.to(device),
        bsphere=BSphere(center=t(np.asarray(center, np.float32)),
                        radius=t(np.asarray(radius, np.float32)),
                        inv_radius_sqr=t(np.asarray(1.0 / (radius * radius),
                                                    np.float32))),
        env=env, mat_kinds=mat_kinds, light_kinds=light_kinds,
        clusters=clusters, instances=instances)


def _widen(lo, hi):
    """Boxes widened by a relative margin, so that rounding in the slab
    test never culls a triangle that the exact test would hit."""
    margin = 1e-4 * np.maximum(np.abs(lo), np.abs(hi)).max(-1, keepdims=True) \
        + 1e-6
    return lo - margin, hi + margin


def _clusters(v0, v1, v2, ids, masked, device, size: int) -> Clusters:
    lo = np.minimum(np.minimum(v0.min(0), v1.min(0)), v2.min(0))
    hi = np.maximum(np.maximum(v0.max(0), v1.max(0)), v2.max(0))
    cen = (v0 + v1 + v2) / 3.0
    scaled = (cen - lo) / np.maximum(hi - lo, 1e-20) * 1023.0
    order = np.argsort(_morton(np.clip(scaled, 0, 1023)), kind="stable")
    pad = (-len(v0)) % size
    far = np.full((pad, 3), 1e20, np.float32)
    sv0 = np.concatenate([v0[order], far])
    sv1 = np.concatenate([v1[order], far])
    sv2 = np.concatenate([v2[order], far])
    sid = np.concatenate([np.asarray(ids, np.int64)[order],
                          np.full(pad, -1, np.int64)])
    C = len(sid) // size
    tlo = np.minimum(np.minimum(sv0, sv1), sv2).reshape(C, size, 3)
    thi = np.maximum(np.maximum(sv0, sv1), sv2).reshape(C, size, 3)
    clo, chi = _widen(tlo.min(1), thi.max(1))
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    tri = dict(v0=t(sv0), e1=t(sv1 - sv0), e2=t(sv2 - sv0), id=t(sid),
               masked=t(np.concatenate([masked[order], np.zeros(pad, bool)])))
    return Clusters(tri=tri, lo=t(clo), hi=t(chi),
                    start=torch.arange(C, device=device) * size, size=size)


def _instances(two_level: dict, masked, device, size: int) -> Instances:
    """`two_level`: meshes, a list of mesh-space (v0, v1, v2), and
    instances, a list of (mesh index, 4x4 mesh->world matrix, flat id of
    its first triangle)."""
    meshes = two_level["meshes"]
    first = {}
    for mi, _, base in two_level["instances"]:
        first.setdefault(mi, base)
    clusters = []
    for mi, (v0, v1, v2) in enumerate(meshes):
        b, n = first.get(mi), len(v0)
        mask = masked[b:b + n] if b is not None else np.zeros(n, bool)
        clusters.append(_clusters(v0, v1, v2, np.arange(n), mask, device,
                                  size))
    lo, hi, rot, off, mesh, base = [], [], [], [], [], []
    for mi, m4, b in two_level["instances"]:
        v = np.concatenate(meshes[mi]).astype(np.float64)
        corners = np.stack(np.meshgrid(*[(v[:, a].min(), v[:, a].max())
                                         for a in range(3)],
                                       indexing="ij"), -1).reshape(8, 3)
        w = corners @ m4[:3, :3].T + m4[:3, 3]
        lo.append(w.min(0))
        hi.append(w.max(0))
        inv = np.linalg.inv(m4)
        rot.append(inv[:3, :3])
        off.append(inv[:3, 3])
        mesh.append(mi)
        base.append(b)
    lo, hi = _widen(np.asarray(lo, np.float32), np.asarray(hi, np.float32))
    t = lambda a, dt=np.float32: torch.as_tensor(np.asarray(a, dt),
                                                 device=device)
    return Instances(lo=t(lo), hi=t(hi), rot=t(rot), off=t(off),
                     mesh=t(mesh, np.int64), base=t(base, np.int64),
                     meshes=clusters)
