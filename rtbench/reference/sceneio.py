"""The reference's reader of `.scene` files: frozen copies of the
program's `io/scene_file.py` (the parser), `io/obj.py` (OBJ and MTL),
the PNG and Radiance HDR decoders of `io/image.py`, and of
`scene/build.py`'s material conversion, mesh loading and instance
flattening, ending in the raw description (`scene.RawScene`) that the
reference's tables are built from.  The benchmark writes the scene's
files once; the program's `build_scene` and this reader each read them.
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass, field

import numpy as np

from . import lights as light_mod
from . import materials as mat_mod
from . import math3d
from .scene import RawScene


def _chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def encode_png(rgb8: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> PNG file bytes (8-bit RGB, filter 0 rows)."""
    h, w, c = rgb8.shape
    if c != 3 or rgb8.dtype != np.uint8:
        raise ValueError("encode_png expects an (H, W, 3) uint8 image")
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           rgb8.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (None, Sub, Up, Average, Paeth) of a
    decompressed IDAT stream; returns (h, w * bpp) uint8 rows."""
    stride = w * bpp
    buf = np.frombuffer(raw, np.uint8)
    if buf.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {buf.size} bytes, expected "
                         f"{h * (stride + 1)}")
    rows = buf.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        elif ftype in (1, 3, 4):
            # Left-neighbour filters run byte by byte along the row.
            cur = np.zeros(stride, np.int32)
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = prev[i]
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (
                        b if pb <= pc else c)
                cur[i] = (line[i] + pred) & 0xFF
        else:
            raise ValueError(f"unknown PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def load_png(path: str) -> np.ndarray:
    """8-bit RGB or RGBA PNG file -> (H, W, 3 or 4) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    channels = {2: 3, 6: 4}.get(ctype)
    if depth != 8 or channels is None or interlace != 0:
        raise ValueError(f"{path}: only 8-bit RGB/RGBA non-interlaced PNGs "
                         f"are supported (depth {depth}, colour type "
                         f"{ctype}, interlace {interlace})")
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, w, channels)
    return rows.reshape(h, w, channels)


def load_hdr(path: str) -> np.ndarray:
    """Radiance .hdr (RGBE) decoder, flat and adaptive-RLE scanlines.
    Returns (H, W, 4) float32, alpha 1."""
    with open(path, "rb") as f:
        data = f.read()

    # Header: lines until the blank line, then the resolution line.
    pos = 0
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"not a Radiance HDR file: {path}")
    while True:
        eol = data.index(b"\n", pos)
        line = data[pos:eol]
        pos = eol + 1
        if line == b"":
            break
    eol = data.index(b"\n", pos)
    res = data[pos:eol].split()
    pos = eol + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"unsupported HDR orientation: {res}")
    height, width = int(res[1]), int(res[3])

    rgbe = np.zeros((height, width, 4), np.uint8)
    buf = np.frombuffer(data, np.uint8, offset=pos)
    bp = 0
    for y in range(height):
        if width < 8 or width > 0x7FFF or buf[bp] != 2 or buf[bp + 1] != 2:
            # Flat (non-RLE) scanline.
            rgbe[y] = buf[bp:bp + width * 4].reshape(width, 4)
            bp += width * 4
            continue
        if (int(buf[bp + 2]) << 8 | int(buf[bp + 3])) != width:
            raise ValueError("HDR scanline length mismatch")
        bp += 4
        for c in range(4):
            x = 0
            while x < width:
                count = int(buf[bp])
                bp += 1
                if count > 128:  # run
                    count -= 128
                    rgbe[y, x:x + count, c] = buf[bp]
                    bp += 1
                else:  # literal
                    rgbe[y, x:x + count, c] = buf[bp:bp + count]
                    bp += count
                x += count

    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 136)).astype(np.float32)
    out = np.empty((height, width, 4), np.float32)
    out[..., :3] = (rgbe[..., :3].astype(np.float32) + 0.5) * scale[..., None]
    out[..., 3] = 1.0
    return out


def _png_rgba(path: str) -> np.ndarray:
    img = load_png(path)
    if img.shape[-1] == 3:
        img = np.concatenate(
            [img, np.full(img.shape[:2] + (1,), 255, np.uint8)], axis=-1)
    return img.astype(np.float32) / 255.0


def load_image(path: str):
    """PNG and Radiance HDR files, as the program's loader returns them:
    float32 RGBA in [0, 1] (HDR unbounded), top-left origin.  The
    generated scenes use no other format."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        return _png_rgba(path)
    if ext in (".hdr", ".pic"):
        return load_hdr(path)
    raise ValueError(f"the reference reads PNG and HDR files only: {path}")


@dataclass
class InstanceDesc:
    mesh_idx: int
    pos: tuple = (0.0, 0.0, 0.0)
    scale: tuple = (1.0, 1.0, 1.0)
    rot: tuple = (0.0, 0.0, 0.0)


@dataclass
class LightDesc:
    kind: str                  # "point" | "dir" | "spot"
    params: tuple              # kind-specific floats


@dataclass
class SceneDesc:
    cam_pos: tuple = (0.0, 0.0, 0.0)
    cam_dir: tuple = (0.0, 0.0, -1.0)
    cam_up: tuple = (0.0, 1.0, 0.0)
    mesh_paths: list = field(default_factory=list)
    accel_paths: list = field(default_factory=list)   # parallel to mesh_paths; "" = none
    lights: list = field(default_factory=list)
    env_path: str = ""
    env_intensity: tuple = (1.0, 1.0, 1.0)
    instances: list = field(default_factory=list)
    base_dir: str = ""


def parse_scene_file(path: str) -> SceneDesc:
    desc = SceneDesc(base_dir=os.path.dirname(os.path.abspath(path)))
    cur_instance = None

    with open(path, "r", errors="replace") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            cmd = tok[0]
            if cmd == "pos":
                v = tuple(float(x) for x in tok[1:4])
                if cur_instance is not None:
                    cur_instance.pos = v
                else:
                    desc.cam_pos = v
            elif cmd == "dir":
                desc.cam_dir = tuple(float(x) for x in tok[1:4])
            elif cmd == "up":
                desc.cam_up = tuple(float(x) for x in tok[1:4])
            elif cmd == "mesh":
                desc.mesh_paths.append(line.split(None, 1)[1])
                desc.accel_paths.append("")
                cur_instance = None
            elif cmd == "accel":
                if desc.accel_paths:
                    desc.accel_paths[-1] = line.split(None, 1)[1]
            elif cmd == "point_light":
                # pos(3) intensity(3)
                desc.lights.append(LightDesc("point", tuple(float(x) for x in tok[1:7])))
            elif cmd == "dir_light":
                # dir(3) intensity(3)
                desc.lights.append(LightDesc("dir", tuple(float(x) for x in tok[1:7])))
            elif cmd == "spot_light":
                # pos(3) dir(3) angle intensity(3)
                desc.lights.append(LightDesc("spot", tuple(float(x) for x in tok[1:11])))
            elif cmd == "env":
                parts = tok[1:]
                # Last 1 or 3 numeric fields are intensity; the rest is a path
                # (paths may contain spaces only in theory; keep it simple).
                desc.env_path = parts[0]
                vals = [float(x) for x in parts[1:]] if len(parts) > 1 else [1.0]
                if len(vals) == 1:
                    desc.env_intensity = (vals[0],) * 3
                else:
                    desc.env_intensity = tuple(vals[:3])
            elif cmd == "instance":
                cur_instance = InstanceDesc(mesh_idx=int(tok[1]))
                desc.instances.append(cur_instance)
            elif cmd == "scale" and cur_instance is not None:
                cur_instance.scale = tuple(float(x) for x in tok[1:4])
            elif cmd == "rot" and cur_instance is not None:
                cur_instance.rot = tuple(float(x) for x in tok[1:4])

    if not desc.instances:
        desc.instances = [InstanceDesc(mesh_idx=i) for i in range(len(desc.mesh_paths))]
    return desc


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
        img = load_image(path)
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
    f = load_obj(obj_path)
    mtl_lib = {}
    for lib in f.mtl_libs:
        load_mtl(os.path.join(base_dir, lib), mtl_lib)

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


def load_scene(scene_path: str) -> RawScene:
    """The raw description of a `.scene` file, as the program's
    build_scene assembles it before its BVH build: flat world-space
    triangles, the instanced emissive faces' triangle lights, then the
    file's lights, then the environment light."""
    desc = parse_scene_file(scene_path)
    conv = MaterialConverter()
    meshes = []
    for mp in desc.mesh_paths:
        path = mp if os.path.isabs(mp) else os.path.join(desc.base_dir, mp)
        meshes.append(load_mesh(path, conv))
    v0, v1, v2, attrs, light_rows = flatten_instances(desc, meshes,
                                                      conv.rows)
    light_rows.extend(_scene_lights(desc))
    env_img = None
    if desc.env_path:
        env_img = load_image(os.path.join(desc.base_dir, desc.env_path))
        light_rows.append(dict(kind=light_mod.LIGHT_ENV, intensity=(1, 1, 1)))
    return RawScene(v0=v0, v1=v1, v2=v2, attrs=attrs, mat_rows=conv.rows,
                    light_rows=light_rows, textures=conv.textures,
                    env_image=env_img, env_intensity=desc.env_intensity,
                    cam_pos=desc.cam_pos, cam_dir=desc.cam_dir,
                    cam_up=desc.cam_up,
                    extra=dict(instances=len(desc.instances),
                               unique_tris=sum(len(m.tris) for m in meshes),
                               two_level=_two_level(desc, meshes)))


def _two_level(desc: SceneDesc, meshes: list) -> dict:
    """The meshes in mesh space and the instances (mesh index, 4x4
    mesh->world matrix, flat id of the first triangle, in the order of
    flatten_instances), for the reference's two-level traversal."""
    insts, base = [], 0
    for inst in desc.instances:
        m4 = math3d.instance_matrix(inst.pos, inst.scale, inst.rot)
        insts.append((inst.mesh_idx, np.asarray(m4, np.float64), base))
        base += len(meshes[inst.mesh_idx].tris)
    tris = [tuple(m.verts[m.tris[:, k]].astype(np.float32) for k in range(3))
            for m in meshes]
    return dict(meshes=tris, instances=insts)
