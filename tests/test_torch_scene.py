"""The port's own scene assembly (imbatracer_torch.scene) against the JAX
builder: every array of the scene -- triangle records, joined shade
records and their column subset, material / light / texture tables, the
bounding sphere, the static kind sets -- must be bit-identical, and the
port's stream-tile packing (sbox, tiles, center) must equal the JAX
package's pack_stream_tiles on the same triangles.  The port builds its
BVH with its own native builder (csrc/bvh_builder.cpp), and raises when
that builder cannot run instead of building another tree."""

import numpy as np
import pytest
import torch

from imbatracer_tpu.ops.pallas_stream import pack_stream_tiles
from imbatracer_tpu.scene import procedural as jproc
from imbatracer_torch.convert import scene_from_numpy, scene_to_numpy
from imbatracer_torch.scene import procedural as tproc
from torch_threads import cap_torch_threads

cap_torch_threads()

SCENES = [
    ("make_cornell_scene", {}),
    ("make_cornell_scene", dict(mirror_box=True, glass_sphere=True)),
    ("make_cornell_scene", dict(light="point")),
    ("make_cornell_scene", dict(light="spot", with_boxes=False)),
    ("make_cornell_scene", dict(light="dir")),
    ("make_big_scene", dict(num_boxes=150)),
    ("make_masked_scene", {}),
    ("make_leaf_scene", dict(num_leaves=200)),
    ("make_still_life_like", dict(num_objects=40, num_cards=16)),
]


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


@pytest.mark.parametrize("name,kw", SCENES)
def test_port_assembly_matches_jax(name, kw):
    js, jmeta = getattr(jproc, name)(**kw)
    ts, tmeta = getattr(tproc, name)(device="cpu", **kw)
    ja = scene_to_numpy(js)
    _assert_same(ja, scene_to_numpy(ts))
    assert (tmeta.num_tris, tmeta.num_lights, tmeta.cam_pos, tmeta.has_masks,
            tmeta.has_env) == (jmeta.num_tris, jmeta.num_lights,
                               jmeta.cam_pos, jmeta.has_masks, jmeta.has_env)

    sbox, tiles, center = pack_stream_tiles(
        ja["bvh.tri_v0"], ja["bvh.tri_e1"], ja["bvh.tri_e2"],
        ja["bvh.tri_id"])
    for got, want in ((ts.bvh.sbox, sbox), (ts.bvh.tiles, tiles),
                      (ts.bvh.center, center)):
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))

    # The JAX scene's arrays carried across give the same port scene.
    carried = scene_from_numpy(ja, "cpu")
    _assert_same(scene_to_numpy(carried), scene_to_numpy(ts))
    assert torch.equal(carried.bvh.tiles, ts.bvh.tiles)


def test_to_device_moves_every_tensor():
    ts, _ = tproc.make_cornell_scene(device="cpu")
    moved = ts.to("cpu")
    assert moved.mat_kinds == ts.mat_kinds
    assert moved.attrs.shade_cols == ts.attrs.shade_cols
    assert moved.device == torch.device("cpu")
    _assert_same(scene_to_numpy(moved), scene_to_numpy(ts))


def test_native_builder_raises_instead_of_falling_back(monkeypatch, tmp_path):
    from imbatracer_torch import libbuild
    from imbatracer_torch.accel import native

    # A builder that reports no nodes.
    class _Lib:
        @staticmethod
        def imba_build_bvh(*args):
            return 0

    monkeypatch.setattr(native, "get_lib", lambda: _Lib)
    with pytest.raises(RuntimeError, match="returned 0 nodes"):
        tproc.make_cornell_scene(device="cpu")
    monkeypatch.undo()

    # A builder source that does not compile.
    (tmp_path / "bvh_builder.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(libbuild, "CSRC", str(tmp_path))
    monkeypatch.setattr(libbuild, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="building bvh_builder.cpp"):
        tproc.make_cornell_scene(device="cpu")


def test_native_builder_matches_numpy_builder_contract():
    """The explicit NumPy builder and the native one both cover every
    primitive exactly once in 1-4 triangle leaves."""
    from imbatracer_torch.accel.builder import build_bvh, triangle_bboxes
    from imbatracer_torch.accel.flatten import thread_bvh
    from imbatracer_torch.accel.native import LIB, build_bvh_native
    from imbatracer_torch.libbuild import BUILD_DIR

    rs = np.random.RandomState(1)
    v0 = rs.uniform(-5, 5, (300, 3)).astype(np.float32)
    v1 = v0 + rs.uniform(-0.3, 0.3, (300, 3)).astype(np.float32)
    v2 = v0 + rs.uniform(-0.3, 0.3, (300, 3)).astype(np.float32)
    lo, hi = triangle_bboxes(v0, v1, v2)
    for nodes in (build_bvh(lo, hi), build_bvh_native(lo, hi)):
        p = thread_bvh(nodes, v0, v1, v2)
        ids = p.tri_id[p.tri_id >= 0]
        assert sorted(ids.tolist()) == list(range(300))
        assert p.tri_id.shape[0] % 4 == 0
    assert LIB.path().startswith(BUILD_DIR)


def test_native_library_path_tracks_sources(monkeypatch, tmp_path):
    """A library's build path is keyed by its source and header bytes, so
    editing either rebuilds; the path lies in the build directory."""
    from imbatracer_torch import libbuild

    (tmp_path / "k.cu").write_text("// kernel\n")
    (tmp_path / "k.cuh").write_text("// header\n")
    monkeypatch.setattr(libbuild, "CSRC", str(tmp_path))
    monkeypatch.setattr(libbuild, "BUILD_DIR", str(tmp_path / "build"))
    lib = libbuild.NativeLib("k", "k.cu", headers=("k.cuh",))
    first = lib.path()
    assert first.startswith(str(tmp_path / "build")) and first.endswith(".so")
    assert lib.path() == first
    (tmp_path / "k.cuh").write_text("// header, edited\n")
    second = lib.path()
    assert second != first
    (tmp_path / "k.cu").write_text("// kernel, edited\n")
    assert lib.path() not in (first, second)
    assert libbuild.NativeLib("k", "k.cu", headers=("k.cuh",),
                              cuda=False).path() != lib.path()
