"""Scene building: `.scene` / OBJ / MTL assets -> port DeviceScene
(torch-native counterpart of imbatracer_tpu.scene.build).

`build_scene` runs the JAX package's pipeline in its order: parse the
`.scene` file; per mesh, load the OBJ with its MTL and textures and
dedupe (v, t, n) corners; expand instances to flat world-space arrays
with one triangle-light row per instanced emissive face; append the
`.scene` lights and the environment map; decide on two-level instancing
and build it; assemble.

Material conversion: illum 5 -> MIRROR, illum 7 -> GLASS, Ks > 0 ->
GLOSSY, else DIFFUSE; Ke > 0 marks an emitter; map_Kd / map_bump / map_d
resolve against the OBJ's directory; a texture that cannot be decoded
becomes the magenta placeholder.

Two-level instancing ("stream2", accel/instancing.py) is taken on the
scene's shape alone, on either device (the JAX package takes it only on
a TPU): more than one instance, more than 1,024 flat triangles and at
least twice as many flat as unique triangles; `force_flatten` turns it
off.  Shading records stay flat per instance.

The host side is NumPy plus the port's own native binned-SAH builder
(accel/native.py, csrc/bvh_builder.cpp) and leaf packing
(accel/flatten.py), copies of the JAX package's host modules.  The
arrays are laid out exactly as the JAX builder lays them out and then go
through `convert.scene_from_numpy`, so both packages hold identical
scene data.  `spatial` (the CLI's `--sbvh`) builds a flat scene through
the native split-BVH builder instead (accel/native.build_sbvh_native);
two-level scenes ignore it, as in the JAX package.  `build_scene` keeps
each flat scene's packed triangles in the on-disk BVH cache
(io/bvh_cache.py), keyed by the mesh and `.scene` files and the build
kind, and loads them from there while those files are unchanged.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np

from ..accel.builder import triangle_bboxes
from ..accel.flatten import thread_bvh
from ..accel.native import build_bvh_native, build_sbvh_native
from ..core import math3d
from ..io import bvh_cache
from ..io import image as image_io
from ..io import obj as obj_io
from ..io.scene_file import SceneDesc, parse_scene_file
from ..render import lights as light_mod
from ..render import materials as mat_mod
from ..render.envmap import ENV_KEYS, build_envmap
from ..utils.log import logger
from .textures import pack_textures
from .types import SceneMeta, shade_columns


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


def _packed_triangles(v0, v1, v2, spatial):
    """Leaf-packed triangles of the native binned-SAH build, or of the
    split build with `spatial`."""
    if spatial:
        nodes = build_sbvh_native(np.stack([v0, v1, v2], axis=1))
    else:
        nodes = build_bvh_native(*triangle_bboxes(v0, v1, v2))
    return thread_bvh(nodes, v0, v1, v2)


def _bvh_arrays(v0, v1, v2, two_level, spatial=False, cache=None):
    """(bvh arrays of the shared dict, stats): the native build over the
    flat triangles (split with `spatial`; through the disk cache when
    `cache` = (file, key)), or the two-level build of `two_level` =
    (mesh_tris, inst_list)."""
    t_bvh = time.time()
    if two_level is None:
        packed = None if cache is None else bvh_cache.load_accel(*cache)
        if packed is not None:
            logger.info("BVH loaded from cache: %s", packed.stats)
        else:
            packed = _packed_triangles(v0, v1, v2, spatial)
            logger.info("BVH%s: %s in %.2fs", " (sbvh)" if spatial else "",
                        packed.stats, time.time() - t_bvh)
            if cache is not None:
                bvh_cache.store_accel(cache[0], packed, cache[1])
        stats = packed.stats
        arrays = {f"bvh.{k}": getattr(packed, k)
                  for k in ("tri_v0", "tri_e1", "tri_e2", "tri_id")}
    else:
        from ..accel.instancing import build_two_level

        tl = build_two_level(*two_level)
        stats = dict(tl.stats)
        arrays = {f"bvh.{k}": getattr(tl, k)
                  for k in ("sbox", "tiles", "tile_idx", "inst_of", "itab")}
        logger.info("two-level BVH: %s in %.2fs", stats, time.time() - t_bvh)
    return arrays, stats


def assemble_arrays(v0, v1, v2, attrs, mat_rows, light_rows, textures,
                    env=None, two_level=None, spatial=False, cache=None):
    """BVH build + table assembly on the host.  Returns (arrays, stats):
    the shared scene array dict (see convert.py) and the BVH stats.
    `env`: the scene's EnvMapData (render/envmap.py) or None;
    `two_level`: None (flat BVH over v0/v1/v2) or (mesh_tris, inst_list)
    for accel/instancing.build_two_level; `spatial`: a split build of a
    flat BVH; `cache`: None or the (file, key) of a flat BVH's disk
    cache (io/bvh_cache.py)."""
    lo = np.minimum(np.minimum(v0.min(0), v1.min(0)), v2.min(0))
    hi = np.maximum(np.maximum(v0.max(0), v1.max(0)), v2.max(0))
    center = 0.5 * (lo + hi)
    radius = float(np.linalg.norm(hi - center)) + 1e-6

    bvh_arrays, stats = _bvh_arrays(v0, v1, v2, two_level, spatial, cache)

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
        **bvh_arrays,
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
    return arrays, stats


def assemble_device_scene(v0, v1, v2, attrs, mat_rows, light_rows, textures,
                          env, device, two_level=None, pairs: bool = False,
                          spatial: bool = False, cache=None):
    """Shared tail of scene construction; returns (DeviceScene, stats).
    `pairs` is the BVH's pairs switch (accel/device.py); `spatial` and
    `cache` as in assemble_arrays."""
    from ..convert import scene_from_numpy

    arrays, stats = assemble_arrays(v0, v1, v2, attrs, mat_rows, light_rows,
                                    textures, env, two_level, spatial,
                                    cache)
    return scene_from_numpy(arrays, device, pairs=pairs), stats


# --------------------------------------------------------------------------
# The file-based builder (.scene + OBJ / MTL + textures)
# --------------------------------------------------------------------------

@dataclass
class HostMesh:
    """One loaded OBJ in object space (indexed, SoA)."""

    verts: np.ndarray       # (V, 3)
    normals: np.ndarray     # (V, 3) per-vertex shading normals
    uvs: np.ndarray         # (V, 2)
    tris: np.ndarray        # (T, 3) vertex indices
    mat_ids: np.ndarray     # (T,) global material ids


class MaterialConverter:
    """Global material / texture registry across all meshes of a scene."""

    def __init__(self):
        self.rows = []
        self.textures = []
        self._tex_ids = {}
        # Slot 0: dummy diffuse for faces without a material.
        self.add_default()

    def add_default(self):
        self.rows.append(
            dict(kind=mat_mod.MAT_DIFFUSE, kd=(1.0, 1.0, 1.0), ks=(0, 0, 0),
                 tf=(0, 0, 0), ns=1.0, ior=1.0, emit=(0, 0, 0),
                 kd_tex=-1, bump_tex=-1, mask_tex=-1))
        return len(self.rows) - 1

    def load_texture(self, path: str) -> int:
        if path in self._tex_ids:
            return self._tex_ids[path]
        img = image_io.load_image(path)
        if img is None:
            logger.warning("texture load FAILED: %s", path)
            img = image_io.magenta_placeholder()
        tid = len(self.textures)
        self.textures.append(img)
        self._tex_ids[path] = tid
        return tid

    def convert(self, mtl, base_dir: str) -> int:
        """One OBJ material (io/obj.ObjMaterial or None) -> material-table
        row id."""
        if mtl is None:
            return self.add_default()

        def tex(name):
            return (self.load_texture(os.path.join(base_dir, name)) if name
                    else -1)

        kd_tex = tex(mtl.map_kd)
        bump_tex = tex(mtl.map_bump)
        mask_tex = tex(mtl.map_d)
        is_emissive = max(mtl.ke) > 0.0
        is_phong = max(mtl.ks) > 0.0

        if mtl.illum == 5:
            row = dict(kind=mat_mod.MAT_MIRROR, kd=(0, 0, 0), ks=mtl.ks,
                       tf=(0, 0, 0), ns=mtl.ns, ior=1.0)
        elif mtl.illum == 7:
            row = dict(kind=mat_mod.MAT_GLASS, kd=(0, 0, 0), ks=mtl.ks,
                       tf=mtl.tf, ns=1.0, ior=mtl.ni)
        elif is_phong:
            row = dict(kind=mat_mod.MAT_GLOSSY, kd=mtl.kd, ks=mtl.ks,
                       tf=(0, 0, 0), ns=mtl.ns, ior=1.0)
        else:
            row = dict(kind=mat_mod.MAT_DIFFUSE, kd=mtl.kd, ks=(0, 0, 0),
                       tf=(0, 0, 0), ns=1.0, ior=1.0)
        row.update(emit=mtl.ke if is_emissive else (0.0, 0.0, 0.0),
                   kd_tex=kd_tex, bump_tex=bump_tex, mask_tex=mask_tex)
        self.rows.append(row)
        return len(self.rows) - 1


def load_mesh(obj_path: str, conv: MaterialConverter) -> HostMesh:
    """Load one OBJ into an indexed HostMesh with global material ids."""
    base_dir = os.path.dirname(os.path.abspath(obj_path))
    f = obj_io.load_obj(obj_path)
    mtl_lib = {}
    for lib in f.mtl_libs:
        obj_io.load_mtl(os.path.join(base_dir, lib), mtl_lib)

    # Convert materials in usemtl order; name "" -> dummy slot 0.
    local_to_global = [0 if name == "" else
                       conv.convert(mtl_lib.get(name), base_dir)
                       for name in f.material_names]

    # Dedupe (v, t, n) corner triples into a vertex buffer.
    corner_map = {}
    verts, uvs, norms = [], [], []
    tri_idx = []
    mat_ids = []
    any_normals = False
    for mat_local, corners in f.triangles:
        idx3 = []
        for c in corners:
            slot = corner_map.get(c)
            if slot is None:
                slot = len(verts)
                corner_map[c] = slot
                verts.append(f.vertices[c[0]])
                uvs.append(f.texcoords[c[1]])
                norms.append(f.normals[c[2]])
                if c[2] != 0:
                    any_normals = True
            idx3.append(slot)
        tri_idx.append(idx3)
        mat_ids.append(local_to_global[mat_local])

    verts = np.asarray(verts, np.float32).reshape(-1, 3)
    uvs = np.asarray(uvs, np.float32).reshape(-1, 2)
    norms = np.asarray(norms, np.float32).reshape(-1, 3)
    tris = np.asarray(tri_idx, np.int32).reshape(-1, 3)
    mat_ids = np.asarray(mat_ids, np.int32)

    if not any_normals:
        norms = compute_vertex_normals(verts, tris)
    else:
        norms = repair_normals(verts, tris, norms)
    return HostMesh(verts=verts, normals=norms, uvs=uvs, tris=tris,
                    mat_ids=mat_ids)


def compute_vertex_normals(verts: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals."""
    e1 = verts[tris[:, 1]] - verts[tris[:, 0]]
    e2 = verts[tris[:, 2]] - verts[tris[:, 0]]
    fn = np.cross(e1, e2)  # length = 2 * area -> area weighting for free
    out = np.zeros_like(verts)
    for k in range(3):
        np.add.at(out, tris[:, k], fn)
    ln = np.linalg.norm(out, axis=-1, keepdims=True)
    return out / np.maximum(ln, 1e-20)


def repair_normals(verts, tris, norms) -> np.ndarray:
    """Replace NaN / zero-length shading normals with recomputed ones."""
    ln = np.linalg.norm(norms, axis=-1, keepdims=True)
    bad = ~np.isfinite(ln[:, 0]) | (ln[:, 0] < 1e-12)
    norms = np.where(bad[:, None], 0.0, norms / np.maximum(ln, 1e-20))
    if bad.any():
        recomputed = compute_vertex_normals(verts, tris)
        norms[bad] = recomputed[bad]
    return norms


def flatten_instances(desc: SceneDesc, meshes: list, materials: list):
    """Expand instances into world-space flat triangle arrays, with one
    triangle-light row per instanced emissive face.  Returns (v0, v1, v2,
    attrs, light_rows)."""
    v0s, v1s, v2s = [], [], []
    n0s, n1s, n2s = [], [], []
    uv0s, uv1s, uv2s = [], [], []
    mats, insts, locals_ = [], [], []
    light_rows = []
    light_ids = []

    emit_lookup = np.array([max(m["emit"]) > 0.0 for m in materials],
                           dtype=bool)

    for inst_id, inst in enumerate(desc.instances):
        mesh = meshes[inst.mesh_idx]
        m = math3d.instance_matrix(inst.pos, inst.scale, inst.rot)
        wv = math3d.transform_points(m, mesh.verts).astype(np.float32)
        wn = math3d.transform_normals(m, mesh.normals).astype(np.float32)
        t = mesh.tris
        a, b, c = wv[t[:, 0]], wv[t[:, 1]], wv[t[:, 2]]
        v0s.append(a)
        v1s.append(b)
        v2s.append(c)
        n0s.append(wn[t[:, 0]])
        n1s.append(wn[t[:, 1]])
        n2s.append(wn[t[:, 2]])
        uv0s.append(mesh.uvs[t[:, 0]])
        uv1s.append(mesh.uvs[t[:, 1]])
        uv2s.append(mesh.uvs[t[:, 2]])
        mats.append(mesh.mat_ids)
        insts.append(np.full(len(t), inst_id, np.int32))
        locals_.append(np.arange(len(t), dtype=np.int32))

        # Instanced emissive faces become per-face TRI lights.
        lid = np.full(len(t), -1, np.int32)
        for ti in np.nonzero(emit_lookup[mesh.mat_ids])[0]:
            intensity = materials[mesh.mat_ids[ti]]["emit"]
            normal = np.cross(b[ti] - a[ti], c[ti] - a[ti])
            area = 0.5 * np.linalg.norm(normal)
            if area < 1e-12:
                continue
            lid[ti] = len(light_rows)
            light_rows.append(
                dict(kind=light_mod.LIGHT_TRI, p0=a[ti], p1=b[ti], p2=c[ti],
                     normal=normal / (2.0 * area), intensity=intensity,
                     area=area))
        light_ids.append(lid)

    cat = lambda xs: np.concatenate(xs, axis=0)
    attrs = dict(
        n0=cat(n0s), n1=cat(n1s), n2=cat(n2s),
        uv0=cat(uv0s), uv1=cat(uv1s), uv2=cat(uv2s),
        mat_id=cat(mats), light_id=cat(light_ids),
        inst_id=cat(insts), local_id=cat(locals_),
    )
    return cat(v0s), cat(v1s), cat(v2s), attrs, light_rows


def _scene_lights(desc: SceneDesc):
    """Parsed .scene lights -> light-table rows."""
    rows = []
    for light in desc.lights:
        p = light.params
        if light.kind == "point":
            rows.append(dict(kind=light_mod.LIGHT_POINT, p0=p[0:3],
                             intensity=p[3:6]))
        elif light.kind == "dir":
            d = np.asarray(p[0:3], np.float32)
            d /= np.linalg.norm(d)
            rows.append(dict(kind=light_mod.LIGHT_DIR, normal=d,
                             intensity=p[3:6]))
        elif light.kind == "spot":
            d = np.asarray(p[3:6], np.float32)
            d /= np.linalg.norm(d)
            # The .scene angle is the full cone angle in degrees.
            rows.append(dict(kind=light_mod.LIGHT_SPOT, p0=p[0:3], normal=d,
                             cos_angle=np.cos(np.deg2rad(p[6]) * 0.5),
                             intensity=p[7:10]))
    return rows


def wants_two_level(num_instances: int, num_tris: int,
                    unique_tris: int) -> bool:
    """The two-level decision: instances multiply the geometry."""
    return (num_instances > 1 and num_tris > 1024
            and num_tris >= 2 * unique_tris)


def _cache_entry(desc: SceneDesc, scene_path: str, spatial: bool):
    """(file, key) of a flat scene's BVH in the disk cache, or None when
    the cache directory cannot be made."""
    mesh_files = [mp if os.path.isabs(mp) else os.path.join(desc.base_dir, mp)
                  for mp in desc.mesh_paths]
    key = bvh_cache.fingerprint(mesh_files + [scene_path])
    if spatial:
        key += ":sbvh"
    directory = bvh_cache.cache_dir()
    try:
        os.makedirs(directory, exist_ok=True)
    except OSError:
        return None
    name = os.path.basename(scene_path) + "." + key.replace(":", "_")
    return os.path.join(directory, name + ".npz"), key


def build_scene(scene_path: str, quiet: bool = False, *, device,
                force_flatten: bool = False, pairs: bool = False,
                spatial: bool = False):
    """Load + build everything on `device`.  Returns (DeviceScene,
    SceneMeta).  `force_flatten` skips two-level instancing even where it
    is taken (the self-check renders both routes and compares); `pairs`
    is the BVH's pairs switch (accel/device.py); `spatial` builds a flat
    scene's BVH with spatial splits (two-level scenes ignore it).  A flat
    scene's BVH goes through the disk cache (io/bvh_cache.py)."""
    t_start = time.time()
    desc = parse_scene_file(scene_path)

    conv = MaterialConverter()
    meshes = []
    for mp in desc.mesh_paths:
        path = mp if os.path.isabs(mp) else os.path.join(desc.base_dir, mp)
        if not quiet:
            logger.info("loading mesh %s", path)
        meshes.append(load_mesh(path, conv))

    v0, v1, v2, attrs, light_rows = flatten_instances(desc, meshes,
                                                      conv.rows)
    num_tris = v0.shape[0]
    logger.info("scene: %d world-space triangles, %d materials, %d "
                "textures", num_tris, len(conv.rows), len(conv.textures))

    # Scene lights from the .scene file go after the triangle lights.
    light_rows.extend(_scene_lights(desc))

    env = None
    if desc.env_path:
        path = os.path.join(desc.base_dir, desc.env_path)
        env_img = image_io.load_image(path)
        if env_img is None:
            logger.warning("env map load failed: %s", path)
        else:
            env = build_envmap(env_img, desc.env_intensity)
            light_rows.append(dict(kind=light_mod.LIGHT_ENV,
                                   intensity=(1, 1, 1)))

    two_level = None
    unique_tris = sum(len(m.tris) for m in meshes)
    if not force_flatten and wants_two_level(len(desc.instances), num_tris,
                                             unique_tris):
        face_base = 0
        inst_list = []
        for inst in desc.instances:
            m4 = math3d.instance_matrix(inst.pos, inst.scale, inst.rot)
            inst_list.append(dict(mesh_idx=inst.mesh_idx, matrix=m4,
                                  face_base=face_base))
            face_base += len(meshes[inst.mesh_idx].tris)
        mesh_tris = [(m.verts[m.tris[:, 0]], m.verts[m.tris[:, 1]],
                      m.verts[m.tris[:, 2]]) for m in meshes]
        two_level = (mesh_tris, inst_list)
        logger.info("two-level instancing: %d instances, %d unique tris "
                    "(%d flat)", len(inst_list), unique_tris, num_tris)

    cache = None if two_level else _cache_entry(desc, scene_path, spatial)
    scene, stats = assemble_device_scene(
        v0, v1, v2, attrs, conv.rows, light_rows, conv.textures, env,
        device, two_level=two_level, pairs=pairs, spatial=spatial,
        cache=cache)
    meta = SceneMeta(
        name=os.path.basename(scene_path),
        num_tris=num_tris,
        num_materials=len(conv.rows),
        num_lights=len(light_rows),
        num_textures=len(conv.textures),
        has_env=env is not None,
        has_masks=any(m["mask_tex"] >= 0 for m in conv.rows),
        has_bump=any(m["bump_tex"] >= 0 for m in conv.rows),
        cam_pos=desc.cam_pos,
        cam_dir=desc.cam_dir,
        cam_up=desc.cam_up,
        bvh_stats=stats,
    )
    logger.info("scene built in %.2fs", time.time() - t_start)
    return scene, meta
