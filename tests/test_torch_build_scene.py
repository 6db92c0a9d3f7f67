"""The port's file-based scene builder (scene/build.build_scene) against
the JAX package's, on generated `.scene` / OBJ / MTL / PNG / HDR files.

* Flattened (`force_flatten=True`): every array of the scene equals
  JAX's `build_scene` bit for bit (on the CPU the JAX package always
  flattens), and the port's stream tiles equal the JAX package's
  `pack_stream_tiles` on JAX's packed triangles (its CPU BVH is in "xla"
  mode and holds no tiles).
* Two-level: the port's `build_two_level` equals JAX's on the same
  inputs bit for bit, and `build_scene` takes that route on the scene's
  shape alone and uploads those arrays.
* A texture that cannot be decoded becomes the magenta placeholder.
* The generated scene covers every MTL path and every `.scene` light.
* JAX's native builder is loaded in this process (tests/
  torch_jax_native.py): a process whose in-place build of it failed
  gets it back, so JAX never falls back to its NumPy builder here.
"""

import os
import shutil

import numpy as np
import pytest

from imbatracer_tpu.accel import native as jnative
from imbatracer_tpu.accel.instancing import build_two_level as jtwo
from imbatracer_tpu.ops.pallas_stream import pack_stream_tiles
from imbatracer_tpu.scene.build import build_scene as jbuild
from imbatracer_torch.accel.instancing import build_two_level as ttwo
from imbatracer_torch.convert import scene_to_numpy
from imbatracer_torch.core import math3d
from imbatracer_torch.io.scene_file import parse_scene_file
from imbatracer_torch.render import lights as L
from imbatracer_torch.render import materials as M
from imbatracer_torch.scene import build as tb
from imbatracer_torch.scene.generate import write_instanced_scene
from torch_jax_native import ensure_jax_native
from torch_threads import cap_torch_threads

cap_torch_threads()
ensure_jax_native()


@pytest.fixture(scope="module")
def scene_path(tmp_path_factory):
    return write_instanced_scene(str(tmp_path_factory.mktemp("scene")))


@pytest.fixture(autouse=True)
def _jax_bvh_cache(tmp_path, monkeypatch):
    """Keep the JAX builder's on-disk BVH cache inside the test's tmp."""
    monkeypatch.setenv("IMBATRACER_CACHE_DIR", str(tmp_path / "accel"))


def _bits(x):
    return np.ascontiguousarray(x).view(np.uint8)


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        va, vb = a[k], b[k]
        if va is None or isinstance(va, tuple):
            assert va == vb, k
            continue
        assert va.dtype == vb.dtype and va.shape == vb.shape, k
        np.testing.assert_array_equal(_bits(va), _bits(vb), err_msg=k)


def _flat_matches_jax(path):
    js, jmeta = jbuild(path, quiet=True)
    ts, tmeta = tb.build_scene(path, quiet=True, device="cpu",
                               force_flatten=True)
    assert not ts.bvh.two_level
    ja = scene_to_numpy(js)
    _assert_same(ja, scene_to_numpy(ts))
    for k in ("name", "num_tris", "num_materials", "num_lights",
              "num_textures", "has_env", "has_masks", "has_bump", "cam_pos",
              "cam_dir", "cam_up"):
        assert getattr(tmeta, k) == getattr(jmeta, k), k
    sbox, tiles, center = pack_stream_tiles(
        ja["bvh.tri_v0"], ja["bvh.tri_e1"], ja["bvh.tri_e2"],
        ja["bvh.tri_id"])
    for got, want in ((ts.bvh.sbox, sbox), (ts.bvh.tiles, tiles),
                      (ts.bvh.center, center)):
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    return ts, tmeta


def test_flattened_scene_matches_jax(scene_path):
    _flat_matches_jax(scene_path)


def test_lost_native_builder_is_restored(scene_path, monkeypatch):
    """A process that lost the race for the JAX package's libbvh.so
    (get_lib() None for good) gets a working library back from
    ensure_jax_native, built outside imbatracer_tpu/, and the flattened
    scene matches JAX's again."""
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", True)
    monkeypatch.setattr(jnative, "_LIB", jnative._LIB)
    assert jnative.get_lib() is None
    lib = ensure_jax_native()
    assert lib is not None and jnative.get_lib() is lib
    assert os.path.dirname(jnative._LIB) != os.path.dirname(jnative._SRC)
    _flat_matches_jax(scene_path)


def _two_level_inputs(path):
    desc = parse_scene_file(path)
    conv = tb.MaterialConverter()
    meshes = [tb.load_mesh(os.path.join(desc.base_dir, p), conv)
              for p in desc.mesh_paths]
    mesh_tris = [(m.verts[m.tris[:, 0]], m.verts[m.tris[:, 1]],
                  m.verts[m.tris[:, 2]]) for m in meshes]
    insts, base = [], 0
    for inst in desc.instances:
        insts.append(dict(mesh_idx=inst.mesh_idx, matrix=math3d.instance_matrix(
            inst.pos, inst.scale, inst.rot), face_base=base))
        base += len(meshes[inst.mesh_idx].tris)
    return mesh_tris, insts, base, sum(len(m.tris) for m in meshes)


def test_two_level_matches_jax(scene_path):
    mesh_tris, insts, flat, unique = _two_level_inputs(scene_path)
    assert tb.wants_two_level(len(insts), flat, unique)
    j, t = jtwo(mesh_tris, insts), ttwo(mesh_tris, insts)
    for k in ("sbox", "tiles", "tile_idx", "inst_of", "itab"):
        a, b = getattr(t, k), getattr(j, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=k)
    assert t.stats == j.stats
    assert t.tiles.shape[0] < t.sbox.shape[0]           # shared mesh tiles

    scene, meta = tb.build_scene(scene_path, quiet=True, device="cpu")
    assert scene.bvh.two_level and scene.bvh.tri_v0 is None
    assert meta.bvh_stats == t.stats and meta.num_tris == flat
    arrays = scene_to_numpy(scene)
    for k in ("sbox", "tiles", "itab"):
        np.testing.assert_array_equal(_bits(arrays[f"bvh.{k}"]),
                                      _bits(getattr(t, k)), err_msg=k)
    for k in ("tile_idx", "inst_of"):             # uploaded as int32
        assert arrays[f"bvh.{k}"].dtype == np.int32
        np.testing.assert_array_equal(arrays[f"bvh.{k}"], getattr(t, k))
    assert not bool(scene.bvh.center.any())
    # The shading tables are the flattened scene's.
    flat_scene, _ = tb.build_scene(scene_path, quiet=True, device="cpu",
                                   force_flatten=True)
    fa = scene_to_numpy(flat_scene)
    for k in arrays:
        if not k.startswith("bvh."):
            va, vb = arrays[k], fa[k]
            if va is None or isinstance(va, tuple):
                assert va == vb, k
            else:
                np.testing.assert_array_equal(_bits(va), _bits(vb), err_msg=k)


def test_failed_texture_is_magenta(scene_path, tmp_path):
    d = str(tmp_path / "broken")
    shutil.copytree(os.path.dirname(scene_path), d)
    mtl = os.path.join(d, "materials.mtl")
    with open(mtl) as f:
        text = f.read()
    with open(mtl, "w") as f:
        f.write(text.replace("map_Kd checker.png", "map_Kd missing.png"))
    with open(os.path.join(d, "bump.png"), "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n truncated")
    ts, _ = _flat_matches_jax(os.path.join(d, "instances.scene"))
    tex = ts.textures
    kd_tex = int(ts.materials.kd_tex[1])
    bump_tex = int(ts.materials.bump_tex[3])
    for tid in (kd_tex, bump_tex):
        off, w, h = (int(tex.offset[tid]), int(tex.width[tid]),
                     int(tex.height[tid]))
        assert (w, h) == (4, 4)
        texels = tex.texels[off:off + w * h].numpy()
        np.testing.assert_array_equal(texels, np.tile([1.0, 0.0, 1.0],
                                                      (16, 1)))


def test_generated_scene_covers_every_path(scene_path):
    scene, meta = tb.build_scene(scene_path, quiet=True, device="cpu")
    kinds = set(scene.materials.kind.tolist())
    assert {M.MAT_DIFFUSE, M.MAT_GLOSSY, M.MAT_MIRROR, M.MAT_GLASS} <= kinds
    assert set(scene.light_kinds) == {L.LIGHT_TRI, L.LIGHT_POINT,
                                      L.LIGHT_DIR, L.LIGHT_SPOT, L.LIGHT_ENV}
    mats = scene.materials
    assert bool((mats.kd_tex >= 0).any()) and bool((mats.bump_tex >= 0).any())
    assert bool((mats.mask_tex >= 0).any())
    assert bool((mats.emit.amax(dim=1) > 0).any())
    assert float(mats.ior.max()) == 1.5
    assert meta.has_env and meta.has_masks and meta.has_bump
    assert meta.num_textures == 3 and scene.attrs.mask_rec is not None
    # One triangle light per instanced emissive face (the panel's two).
    assert int((scene.lights.kind == L.LIGHT_TRI).sum()) == 2
