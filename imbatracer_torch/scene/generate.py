"""Writes an instanced `.scene` with its OBJ / MTL / PNG / HDR files: the
asset-free stand-in for an instanced multi-mesh scene lit by area and
environment light (modelled on the reference's cornell_instances, with
the lights of the BASELINE's config 5).  Everything is generated from a
seed, so the files and the scene built from them are the same on every
machine.

Meshes (one OBJ each, one shared MTL):
  ground   an n x n quad grid with `vt`, diffuse with a checker map_Kd;
  sphere   a UV sphere with `vt` and `vn`, glossy (Ks, Ns 64);
  blob     a displaced sphere with `vt`, two `usemtl` groups: diffuse with
           a map_bump, and mirror (illum 5);
  crystal  a UV sphere with positions only, glass (illum 7, Ni 1.5);
  card     one quad written as a polygon (fan-triangulated) with a disc
           map_d alpha mask;
  panel    one quad written with negative indices, emissive (Ke): the
           area light.
The `.scene` adds an RLE Radiance sky with a sun disc (`env sky.hdr`),
optional point / dir / spot lights, and `instance` blocks with varied
pos / scale / rot.  `CARD` is the size `chip_smoke.py` renders on the
card; the tests write small ones.
"""

from __future__ import annotations

import math
import os

import numpy as np

from ..io.image import encode_png

# The card's scene: ~950k flat triangles from ~39k unique.
CARD = dict(grid=64, sphere=(100, 101), blob=(64, 64), crystal=(32, 32),
            counts=dict(ground=1, sphere=32, blob=32, crystal=16, card=256,
                        panel=4),
            tex=256, sky_size=(256, 128), spread=25.0, lights=())

MESHES = ("ground", "sphere", "blob", "crystal", "card", "panel")

MTL = """\
newmtl ground
Kd 0.8 0.8 0.8
map_Kd checker.png
newmtl glossy
Kd 0.2 0.3 0.6
Ks 0.5 0.5 0.5
Ns 64
newmtl blob_diffuse
Kd 0.7 0.5 0.3
map_bump bump.png
newmtl blob_mirror
Ks 0.9 0.9 0.9
Ns 1000
illum 5
newmtl glass
Ks 1 1 1
Tf 1 1 1
Ni 1.5
illum 7
newmtl card
Kd 0.3 0.7 0.2
map_d disc.png
newmtl lamp
Kd 0.8 0.8 0.8
Ke 20 18 14
"""


def _fmt(rows, tag):
    return "".join(f"{tag} " + " ".join(f"{x:.6f}" for x in r) + "\n"
                   for r in rows)


def _sphere(nu, nv, radius_fn=None):
    """(verts (V, 3), uvs (V, 2), normals (V, 3), tris (T, 3) 0-based) of
    a UV sphere of nu x nv cells, poles without degenerate triangles;
    `radius_fn(theta, phi)` displaces it."""
    th = np.linspace(0.0, math.pi, nv + 1)
    ph = np.linspace(0.0, 2.0 * math.pi, nu + 1)
    T, P = np.meshgrid(th, ph, indexing="ij")
    n = np.stack([np.sin(T) * np.cos(P), np.cos(T), np.sin(T) * np.sin(P)],
                 axis=-1)
    r = 1.0 if radius_fn is None else radius_fn(T, P)[..., None]
    verts = (n * r).reshape(-1, 3)
    uvs = np.stack([P / (2 * math.pi), 1.0 - T / math.pi], -1).reshape(-1, 2)
    vid = lambda i, j: i * (nu + 1) + j
    tris = []
    for i in range(nv):
        for j in range(nu):
            a, b = vid(i, j), vid(i, j + 1)
            c, d = vid(i + 1, j), vid(i + 1, j + 1)
            if i > 0:
                tris.append((a, b, d))
            if i < nv - 1:
                tris.append((a, d, c))
    return verts, uvs, n.reshape(-1, 3), np.asarray(tris)


def _faces(tris, fmt):
    return "".join("f " + " ".join(fmt(v + 1) for v in t) + "\n"
                   for t in tris)


def _obj_ground(n):
    xs = np.linspace(-30.0, 30.0, n + 1)
    X, Z = np.meshgrid(xs, xs, indexing="ij")
    verts = np.stack([X, np.zeros_like(X), Z], -1).reshape(-1, 3)
    uvs = np.stack([X / 6.0, Z / 6.0], -1).reshape(-1, 2)
    vid = lambda i, j: i * (n + 1) + j
    tris = []
    for i in range(n):
        for j in range(n):
            a, b = vid(i, j), vid(i, j + 1)
            c, d = vid(i + 1, j), vid(i + 1, j + 1)
            tris += [(a, b, d), (a, d, c)]
    return ("mtllib materials.mtl\n" + _fmt(verts, "v") + _fmt(uvs, "vt")
            + "usemtl ground\n" + _faces(tris, lambda v: f"{v}/{v}"))


def _obj_sphere(nu, nv):
    verts, uvs, norms, tris = _sphere(nu, nv)
    return ("mtllib materials.mtl\n" + _fmt(verts, "v") + _fmt(uvs, "vt")
            + _fmt(norms, "vn") + "usemtl glossy\n"
            + _faces(tris, lambda v: f"{v}/{v}/{v}"))


def _obj_blob(nu, nv):
    verts, uvs, _, tris = _sphere(
        nu, nv, lambda t, p: 1.0 + 0.2 * np.sin(3 * t) * np.cos(4 * p))
    half = len(tris) // 2
    fmt = lambda v: f"{v}/{v}"
    return ("mtllib materials.mtl\n" + _fmt(verts, "v") + _fmt(uvs, "vt")
            + "usemtl blob_diffuse\n" + _faces(tris[:half], fmt)
            + "usemtl blob_mirror\n" + _faces(tris[half:], fmt))


def _obj_crystal(nu, nv):
    verts, _, _, tris = _sphere(nu, nv)
    return ("mtllib materials.mtl\n" + _fmt(verts, "v") + "usemtl glass\n"
            + _faces(tris, str))


def _obj_card():
    verts = [(-0.5, 0.0, 0.0), (0.5, 0.0, 0.0), (0.5, 1.5, 0.0),
             (-0.5, 1.5, 0.0)]
    uvs = [(0, 0), (1, 0), (1, 1), (0, 1)]
    return ("mtllib materials.mtl\n" + _fmt(verts, "v") + _fmt(uvs, "vt")
            + "usemtl card\nf 1/1 2/2 3/3 4/4\n")


def _obj_panel():
    verts = [(-1.5, 0.0, -1.5), (1.5, 0.0, -1.5), (1.5, 0.0, 1.5),
             (-1.5, 0.0, 1.5)]                       # normal -y: faces down
    return ("mtllib materials.mtl\n" + _fmt(verts, "v")
            + "usemtl lamp\nf -4 -3 -2 -1\n")


def _png(path, img01):
    with open(path, "wb") as f:
        f.write(encode_png((np.clip(img01, 0, 1) * 255 + 0.5).astype(
            np.uint8)))


def _textures(out_dir, n, rs):
    u = (np.arange(n) + 0.5) / n
    U, V = np.meshgrid(u, u, indexing="xy")
    checker = ((np.floor(U * 8) + np.floor(V * 8)) % 2)[..., None]
    _png(os.path.join(out_dir, "checker.png"),
         0.25 + 0.6 * checker * np.array([1.0, 0.9, 0.7]))
    bump = 0.5 + 0.25 * np.sin(U * 24) * np.cos(V * 18) + 0.1 * rs.rand(n, n)
    _png(os.path.join(out_dir, "bump.png"), np.repeat(bump[..., None], 3, -1))
    disc = ((U - 0.5) ** 2 + (V - 0.5) ** 2 <= 0.25)[..., None]
    _png(os.path.join(out_dir, "disc.png"), np.repeat(disc, 3, -1) * 1.0)


def rgbe(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) float radiance -> (H, W, 4) uint8 RGBE."""
    v = img.max(axis=-1)
    m, e = np.frexp(v)
    scale = np.where(v < 1e-32, 0.0, m * 256.0 / np.maximum(v, 1e-32))
    out = np.zeros(img.shape[:2] + (4,), np.uint8)
    out[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    out[..., 3] = np.where(v < 1e-32, 0, e + 128).astype(np.uint8)
    return out


def _rle_channel(row: np.ndarray) -> bytes:
    """One scanline channel in Radiance adaptive RLE: runs of >= 3 equal
    bytes as (128 + n, byte), the rest as literal packets (n, bytes)."""
    out, i, n = bytearray(), 0, len(row)
    lit = []
    while i < n:
        j = i
        while j < n and j - i < 127 and row[j] == row[i]:
            j += 1
        if j - i >= 3:
            if lit:
                out += bytes([len(lit)]) + bytes(lit)
                lit = []
            out += bytes([128 + j - i, int(row[i])])
            i = j
        else:
            lit.append(int(row[i]))
            i += 1
            if len(lit) == 128:
                out += bytes([128]) + bytes(lit)
                lit = []
    if lit:
        out += bytes([len(lit)]) + bytes(lit)
    return bytes(out)


def write_hdr(path: str, img: np.ndarray, rle: bool = True) -> None:
    """Radiance .hdr writer: flat RGBE scanlines, or adaptive RLE ones
    (needs 8 <= width <= 0x7FFF)."""
    h, w = img.shape[:2]
    px = rgbe(img)
    body = bytearray()
    for y in range(h):
        if not rle:
            body += px[y].tobytes()
            continue
        body += bytes([2, 2, w >> 8, w & 0xFF])
        for c in range(4):
            body += _rle_channel(px[y, :, c])
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
                + f"-Y {h} +X {w}\n".encode() + bytes(body))


def sky_image(w: int, h: int) -> np.ndarray:
    """Lat-long sky: a blue gradient with a bright sun disc."""
    t = (np.arange(h) + 0.5) / h
    s = (np.arange(w) + 0.5) / w
    T, S = np.meshgrid(t, s, indexing="ij")
    img = np.stack([0.3 + 0.5 * T, 0.45 + 0.4 * T, 0.9 + 0.1 * T], -1)
    img *= np.where(T > 0.5, 0.2, 1.0)[..., None]    # darker below horizon
    sun = (T - 0.22) ** 2 + ((S - 0.3) * 2) ** 2 < 0.0009
    img[sun] = (400.0, 380.0, 320.0)
    return img.astype(np.float32)


def _instances(counts, spread, rs):
    """`instance` blocks: (mesh index, pos, scale, rot) per instance."""
    out = []
    for mi, name in enumerate(MESHES):
        for k in range(counts.get(name, 0)):
            x, z = rs.uniform(-spread, spread, 2)
            if name == "ground":
                out.append((mi, (0, 0, 0), (1, 1, 1), (0, 0, 0)))
            elif name == "panel":
                ang = 2 * math.pi * k / max(counts[name], 1)
                out.append((mi, (8 * math.cos(ang), 12.0, 8 * math.sin(ang)),
                            (1, 1, 1), (0, 0, 0)))
            elif name == "card":
                s = rs.uniform(0.8, 1.6)
                out.append((mi, (x, 0.0, z), (s, s, s),
                            (0, rs.uniform(0, 360), 0)))
            else:
                s = rs.uniform(0.5, 1.3)
                out.append((mi, (x, s, z), (s, s * rs.uniform(0.8, 1.2), s),
                            tuple(rs.uniform(0, 360, 3))))
    return out


def write_instanced_scene(out_dir: str, grid: int = 8,
                          sphere=(20, 12), blob=(12, 8), crystal=(8, 6),
                          counts=None, tex: int = 32, sky_size=(32, 16),
                          spread: float = 6.0,
                          lights=("point", "dir", "spot"),
                          seed: int = 0) -> str:
    """Write the scene's files into `out_dir`; returns the `.scene`
    path.  The defaults make a small scene for the tests (9 instances,
    ~2.1k flat triangles from ~0.8k unique); `**CARD` the card's."""
    counts = counts or dict(ground=1, sphere=4, blob=1, crystal=1, card=1,
                            panel=1)
    rs = np.random.RandomState(seed)
    os.makedirs(out_dir, exist_ok=True)
    objs = dict(ground=_obj_ground(grid), sphere=_obj_sphere(*sphere),
                blob=_obj_blob(*blob), crystal=_obj_crystal(*crystal),
                card=_obj_card(), panel=_obj_panel())
    for name, text in objs.items():
        with open(os.path.join(out_dir, f"{name}.obj"), "w") as f:
            f.write(text)
    with open(os.path.join(out_dir, "materials.mtl"), "w") as f:
        f.write(MTL)
    _textures(out_dir, tex, rs)
    write_hdr(os.path.join(out_dir, "sky.hdr"), sky_image(*sky_size))

    lines = ["# generated instanced scene",
             "pos 0 7 30", "dir 0 -0.2 -1", "up 0 1 0"]
    lines += [f"mesh {name}.obj" for name in MESHES]
    light_lines = dict(point="point_light 0 6 4 40 40 36",
                       dir="dir_light -0.3 -1 -0.2 0.6 0.6 0.5",
                       spot="spot_light 3 8 3 0 -1 0 50 60 55 50")
    lines += [light_lines[k] for k in lights]
    lines.append("env sky.hdr 1.0")
    for mi, pos, scl, rot in _instances(counts, spread, rs):
        lines += [f"instance {mi}", "pos %.5f %.5f %.5f" % tuple(pos),
                  "scale %.5f %.5f %.5f" % tuple(scl),
                  "rot %.5f %.5f %.5f" % tuple(rot)]
    path = os.path.join(out_dir, "instances.scene")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path
