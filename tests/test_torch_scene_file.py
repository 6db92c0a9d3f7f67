"""The port's host-side asset loaders against the JAX package's, on
generated files: the `.scene` parser, OBJ / MTL parsing, Radiance HDR
(flat and RLE scanlines), Targa (raw and RLE, both origins; JAX's loader
is PIL's) and PNG textures through `load_image`, and the instance
matrix.  All bit for bit (tolerance 0): the two share the arithmetic."""

import os
from dataclasses import asdict

import numpy as np
import pytest

from imbatracer_tpu.core import math3d as jmath
from imbatracer_tpu.io import image as jimage
from imbatracer_tpu.io import obj as jobj
from imbatracer_tpu.io import scene_file as jscene
from imbatracer_torch.core import math3d as tmath
from imbatracer_torch.io import image as timage
from imbatracer_torch.io import obj as tobj
from imbatracer_torch.io import scene_file as tscene
from imbatracer_torch.scene.generate import sky_image, write_hdr, \
    write_instanced_scene
from torch_threads import cap_torch_threads

cap_torch_threads()


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("assets"))
    write_instanced_scene(d)
    return d


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_parse_scene_file_matches_jax(scene_dir, tmp_path):
    path = os.path.join(scene_dir, "instances.scene")
    extra = tmp_path / "extra.scene"
    # Meshes without instance blocks get one identity instance each; an
    # `accel` line attaches to the last mesh; a 3-value env intensity.
    extra.write_text("pos 1 2 3\nmesh a.obj\naccel a.bvh\nmesh b.obj\n"
                     "env sky.hdr 0.5 0.25 2\n")
    for p in (path, str(extra)):
        j, t = jscene.parse_scene_file(p), tscene.parse_scene_file(p)
        assert t.instances and len(t.instances) == len(j.instances)
        for k in ("cam_pos", "cam_dir", "cam_up", "mesh_paths",
                  "accel_paths", "env_path", "env_intensity", "base_dir"):
            assert getattr(t, k) == getattr(j, k), k
        assert [(x.kind, x.params) for x in t.lights] == \
            [(x.kind, x.params) for x in j.lights]
        assert [(x.mesh_idx, x.pos, x.scale, x.rot) for x in t.instances] == \
            [(x.mesh_idx, x.pos, x.scale, x.rot) for x in j.instances]
    desc = tscene.parse_scene_file(path)
    assert {x.kind for x in desc.lights} == {"point", "dir", "spot"}


@pytest.mark.parametrize("name", ["ground", "sphere", "blob", "crystal",
                                  "card", "panel"])
def test_load_obj_and_mtl_match_jax(scene_dir, name):
    path = os.path.join(scene_dir, f"{name}.obj")
    j, t = jobj.load_obj(path), tobj.load_obj(path)
    for k in ("vertices", "normals", "texcoords"):
        _same(getattr(t, k), getattr(j, k))
    assert t.triangles == j.triangles
    assert t.material_names == j.material_names
    assert t.mtl_libs == j.mtl_libs == ["materials.mtl"]
    mtl = os.path.join(scene_dir, "materials.mtl")
    tm, jm = tobj.load_mtl(mtl), jobj.load_mtl(mtl)
    assert {k: asdict(v) for k, v in tm.items()} == \
        {k: asdict(v) for k, v in jm.items()}
    assert len(tm) == 7


def test_obj_polygons_and_negative_indices(tmp_path):
    p = tmp_path / "poly.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0 2 0\nvt 0 0\n"
                 "usemtl a\nf 1 2 3 4 5\nusemtl b\nf -3/1 -2/1 -1/1\n"
                 "usemtl a\nf 1 3 5\n")
    j, t = jobj.load_obj(str(p)), tobj.load_obj(str(p))
    assert t.triangles == j.triangles
    assert len(t.triangles) == 5 and t.material_names == ["", "a", "b"]
    assert t.triangles[3] == (2, ((3, 1, 0), (4, 1, 0), (5, 1, 0)))


@pytest.mark.parametrize("rle,width", [(True, 32), (False, 32), (True, 6)])
def test_load_hdr_matches_jax(tmp_path, rle, width):
    """Adaptive-RLE and flat scanlines (a width under 8 is always
    flat)."""
    path = str(tmp_path / "sky.hdr")
    write_hdr(path, sky_image(width, 16), rle=rle and width >= 8)
    t = timage.load_hdr(path)
    _same(t, jimage.load_hdr(path))
    assert t.shape == (16, width, 4) and t[..., :3].min() > 0.0
    _same(timage.load_image(path), t)


def _tga(path, img, rle, top):
    """Write (H, W, C) uint8 RGB / RGBA / grey as a Targa file."""
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    itype = (3 if c == 1 else 2) | (8 if rle else 0)
    px = img.reshape(h, w, c)
    if c >= 3:
        px = np.concatenate([px[..., 2::-1], px[..., 3:]], axis=-1)  # BGR(A)
    if not top:
        px = px[::-1]
    if rle:                       # packets within a scanline, as PIL reads
        body = bytearray()
        for row in px:
            i = 0
            while i < w:
                j = i
                while j < w and j - i < 128 and (row[j] == row[i]).all():
                    j += 1
                n = j - i if j - i >= 2 else 1
                if j - i >= 2:
                    body += bytes([0x80 | (n - 1)]) + row[i].tobytes()
                else:
                    body += bytes([0]) + row[i].tobytes()
                i += n
    else:
        body = px.tobytes()
    hdr = bytes([0, 0, itype, 0, 0, 0, 0, 0, 0, 0, 0, 0, w & 255, w >> 8,
                 h & 255, h >> 8, 8 * c, (0x20 if top else 0)
                 | (8 if c == 4 else 0)])
    with open(path, "wb") as f:
        f.write(hdr + bytes(body))


@pytest.mark.parametrize("channels", [3, 4, 1])
@pytest.mark.parametrize("rle,top", [(False, False), (True, True),
                                     (True, False)])
def test_load_tga_matches_jax(tmp_path, channels, rle, top):
    rs = np.random.RandomState(channels)
    shape = (24, 32) if channels == 1 else (24, 32, channels)
    img = rs.randint(0, 256, shape).astype(np.uint8)
    img[4:12] = img[4, 0]                       # runs for the RLE packets
    path = str(tmp_path / "t.tga")
    _tga(path, img, rle, top)
    t = timage.load_tga(path)
    _same(t, jimage.load_tga(path))
    assert t.shape == (24, 32, 4)
    want = img if channels != 1 else img[..., None]
    np.testing.assert_array_equal(
        np.round(t[..., :min(channels, 3)] * 255).astype(np.uint8),
        want[..., :3] if channels >= 3 else want)
    _same(timage.load_image(path), t)


def test_load_image_png_and_failures(scene_dir, tmp_path):
    png = os.path.join(scene_dir, "checker.png")
    t = timage.load_image(png)
    _same(t, jimage.load_image(png))
    assert t.shape == (32, 32, 4) and (t[..., 3] == 1.0).all()
    bad = tmp_path / "broken.png"
    bad.write_bytes(b"not a png")
    assert timage.load_image(str(bad)) is None
    assert jimage.load_image(str(bad)) is None
    assert timage.load_image(str(tmp_path / "missing.tga")) is None
    # JPEG / BMP are not decoded by the port (no PIL on the card's host).
    jpg = tmp_path / "x.jpg"
    jpg.write_bytes(b"\xff\xd8\xff")
    assert timage.load_image(str(jpg)) is None
    _same(timage.magenta_placeholder(), jimage.magenta_placeholder())


@pytest.mark.parametrize("pos,scl,rot", [
    ((0, 0, 0), (1, 1, 1), (0, 0, 0)),
    ((2.5, 0.3, -1.0), (0.7, 0.7, 0.7), (0, 40, 0)),
    ((-2.0, -0.2, 1.5), (1.6, 1.2, 1.6), (10, 0, 25)),
    ((0.5, 1.5, 2.0), (0.5, 0.5, 0.5), (0, 160, 80))])
def test_instance_matrix_and_transforms_match_jax(pos, scl, rot):
    m = tmath.instance_matrix(pos, scl, rot)
    _same(m, jmath.instance_matrix(pos, scl, rot))
    pts = np.random.RandomState(0).randn(50, 3).astype(np.float32)
    _same(tmath.transform_points(m, pts), jmath.transform_points(m, pts))
    _same(tmath.transform_normals(m, pts), jmath.transform_normals(m, pts))
