"""Wavefront OBJ / MTL parsing (host-side, pure Python + NumPy): the
port's own copy of imbatracer_tpu.io.obj.

Negative indices, multi-material (`usemtl`) groups, polygon-fan
triangulation, and the MTL fields the material converter consumes
(ka/kd/ks/ke/ns/ni/d/illum + map_kd / map_bump / map_d).  Output is plain
Python/NumPy; device upload happens at scene assembly.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np


@dataclass
class ObjMaterial:
    name: str = ""
    ka: tuple = (0.0, 0.0, 0.0)
    kd: tuple = (0.0, 0.0, 0.0)
    ks: tuple = (0.0, 0.0, 0.0)
    ke: tuple = (0.0, 0.0, 0.0)
    ns: float = 1.0
    ni: float = 1.0
    tf: tuple = (0.0, 0.0, 0.0)
    tr: float = 1.0
    d: float = 1.0
    illum: int = 2
    map_ka: str = ""
    map_kd: str = ""
    map_ks: str = ""
    map_ke: str = ""
    map_bump: str = ""
    map_d: str = ""


@dataclass
class ObjFile:
    vertices: np.ndarray = None          # (V, 3) float32
    normals: np.ndarray = None           # (N, 3) float32
    texcoords: np.ndarray = None         # (T, 2) float32
    # faces: list of (material_name, list[ (v,t,n) triangle index triples ])
    # Triangles grouped per material; indices already resolved to 0-based.
    triangles: list = field(default_factory=list)  # [(mat_index, (i0, i1, i2) x3 triple)]
    material_names: list = field(default_factory=list)  # usemtl order, index 0 = default ""
    mtl_libs: list = field(default_factory=list)


def _parse_index(tok: str, nv: int, nt: int, nn: int):
    """Resolve one OBJ `v/t/n` token to 0-based indices (0 = missing)."""
    parts = tok.split("/")
    v = int(parts[0]) if parts[0] else 0
    t = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    n = int(parts[2]) if len(parts) > 2 and parts[2] else 0
    # OBJ is 1-based; negative indices count from the end.
    if v < 0:
        v += nv + 1
    if t < 0:
        t += nt + 1
    if n < 0:
        n += nn + 1
    return v, t, n


def load_obj(path: str) -> ObjFile:
    vertices = [(0.0, 0.0, 0.0)]   # slot 0 = "missing" sentinel, like 1-based OBJ
    normals = [(0.0, 0.0, 0.0)]
    texcoords = [(0.0, 0.0)]
    triangles = []
    material_names = [""]
    mat_index = {"": 0}
    cur_mat = 0
    mtl_libs = []

    with open(path, "r", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            cmd = tok[0]
            if cmd == "v":
                vertices.append((float(tok[1]), float(tok[2]), float(tok[3])))
            elif cmd == "vn":
                normals.append((float(tok[1]), float(tok[2]), float(tok[3])))
            elif cmd == "vt":
                texcoords.append((float(tok[1]), float(tok[2])))
            elif cmd == "f":
                nv, nt, nn = len(vertices) - 1, len(texcoords) - 1, len(normals) - 1
                idx = [_parse_index(t, nv, nt, nn) for t in tok[1:]]
                # Fan triangulation of polygons.
                for k in range(1, len(idx) - 1):
                    triangles.append((cur_mat, (idx[0], idx[k], idx[k + 1])))
            elif cmd == "usemtl":
                name = tok[1] if len(tok) > 1 else ""
                if name not in mat_index:
                    mat_index[name] = len(material_names)
                    material_names.append(name)
                cur_mat = mat_index[name]
            elif cmd == "mtllib":
                mtl_libs.append(line.split(None, 1)[1])

    return ObjFile(
        vertices=np.asarray(vertices, np.float32),
        normals=np.asarray(normals, np.float32),
        texcoords=np.asarray(texcoords, np.float32),
        triangles=triangles,
        material_names=material_names,
        mtl_libs=mtl_libs,
    )


def _f3(tok):
    return (float(tok[1]), float(tok[2]), float(tok[3]))


def load_mtl(path: str, out: dict | None = None) -> dict:
    """Parse an MTL file into {name: ObjMaterial}."""
    materials = out if out is not None else {}
    cur = None
    if not os.path.exists(path):
        return materials
    with open(path, "r", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            cmd = tok[0].lower()
            try:
                if cmd == "newmtl":
                    cur = ObjMaterial(name=tok[1] if len(tok) > 1 else "")
                    materials[cur.name] = cur
                elif cur is None:
                    continue
                elif cmd == "ka":
                    cur.ka = _f3(tok)
                elif cmd == "kd":
                    cur.kd = _f3(tok)
                elif cmd == "ks":
                    cur.ks = _f3(tok)
                elif cmd == "ke":
                    cur.ke = _f3(tok)
                elif cmd == "ns":
                    cur.ns = float(tok[1])
                elif cmd == "ni":
                    cur.ni = float(tok[1])
                elif cmd == "tf":
                    cur.tf = _f3(tok)
                elif cmd == "tr":
                    cur.tr = float(tok[1])
                elif cmd == "d":
                    cur.d = float(tok[1])
                elif cmd == "illum":
                    cur.illum = int(float(tok[1]))
                elif cmd == "map_ka":
                    cur.map_ka = line.split(None, 1)[1]
                elif cmd == "map_kd":
                    cur.map_kd = line.split(None, 1)[1]
                elif cmd == "map_ks":
                    cur.map_ks = line.split(None, 1)[1]
                elif cmd == "map_ke":
                    cur.map_ke = line.split(None, 1)[1]
                elif cmd in ("map_bump", "bump"):
                    cur.map_bump = line.split(None, 1)[1]
                elif cmd == "map_d":
                    cur.map_d = line.split(None, 1)[1]
            except (ValueError, IndexError):
                continue  # tolerate malformed lines
    return materials
