"""Padding chunks of the stream-tile packing, which the CUDA traversal
kernels skip: a chunk whose box is inverted (lo.x > hi.x) holds 16
padding slots (id < 0), and every chunk with a live slot has lo <= hi on
each axis, so skipping the inverted chunks drops no triangle (the plain
versions still walk them and find nothing there).  Held on the port's
packing of make_big_scene(4000), a small still life, the generated
instanced scene's two-level tiles and its flattened build; the packing
equals the JAX package's (`pack_stream_tiles` on the same packed
triangles, `build_two_level` on the same meshes and instances)."""

import os

import numpy as np
import pytest
import torch

from imbatracer_tpu.accel.instancing import build_two_level as jtwo
from imbatracer_tpu.ops.pallas_stream import pack_stream_tiles
from imbatracer_torch.accel.instancing import build_two_level as ttwo
from imbatracer_torch.core import math3d
from imbatracer_torch.io.scene_file import parse_scene_file
from imbatracer_torch.ops import stream_traverse as st
from imbatracer_torch.scene import build as tb
from imbatracer_torch.scene.generate import write_instanced_scene
from imbatracer_torch.scene.procedural import (make_big_scene,
                                               make_still_life_like)
from torch_threads import cap_torch_threads

cap_torch_threads()

CASES = ["big_4000", "still_life", "instanced", "flattened"]


@pytest.fixture(scope="module")
def scene_path(tmp_path_factory):
    return write_instanced_scene(str(tmp_path_factory.mktemp("pad")))


def _two_level_inputs(path):
    desc = parse_scene_file(path)
    conv = tb.MaterialConverter()
    meshes = [tb.load_mesh(os.path.join(desc.base_dir, p), conv)
              for p in desc.mesh_paths]
    mesh_tris = [(m.verts[m.tris[:, 0]], m.verts[m.tris[:, 1]],
                  m.verts[m.tris[:, 2]]) for m in meshes]
    insts, base = [], 0
    for inst in desc.instances:
        insts.append(dict(mesh_idx=inst.mesh_idx,
                          matrix=math3d.instance_matrix(inst.pos, inst.scale,
                                                        inst.rot),
                          face_base=base))
        base += len(meshes[inst.mesh_idx].tris)
    return mesh_tris, insts


def _flat_tiles(bvh):
    """The port's tiles and the JAX package's packing of the same packed
    triangles."""
    want = pack_stream_tiles(*(x.numpy() for x in (
        bvh.tri_v0, bvh.tri_e1, bvh.tri_e2, bvh.tri_id)))
    return (bvh.sbox, bvh.tiles, bvh.center), want


@pytest.mark.parametrize("case", CASES)
def test_inverted_chunks_hold_only_padding(case, scene_path):
    if case == "big_4000":
        scene, _ = make_big_scene(4000, device="cpu")
        got, want = _flat_tiles(scene.bvh)
    elif case == "still_life":
        scene, _ = make_still_life_like(device="cpu", num_objects=120,
                                        num_cards=60)
        got, want = _flat_tiles(scene.bvh)
    elif case == "flattened":
        scene, _ = tb.build_scene(scene_path, quiet=True, device="cpu",
                                  force_flatten=True)
        got, want = _flat_tiles(scene.bvh)
    else:
        mesh_tris, insts = _two_level_inputs(scene_path)
        t, j = ttwo(mesh_tris, insts), jtwo(mesh_tris, insts)
        got = tuple(torch.from_numpy(getattr(t, k)) for k in
                    ("sbox", "tiles", "tile_idx", "inst_of", "itab"))
        want = tuple(getattr(j, k) for k in
                     ("sbox", "tiles", "tile_idx", "inst_of", "itab"))
    for g, w in zip(got, want):
        assert g.numpy().dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy().view(np.uint8),
                                      np.ascontiguousarray(w).view(np.uint8))

    tiles = got[1]
    cbox = st.cbox_rows(tiles)                               # (T, 64, 6)
    ids = tiles[:, 4, :].reshape(tiles.shape[0], st.SUPER, st.CHUNK)
    live = (ids >= 0.0).any(dim=-1)                          # (T, 64)
    inverted = cbox[..., 0] > cbox[..., 3]
    assert bool((ids[inverted] < 0.0).all())
    assert torch.equal(inverted, ~live)
    lo, hi = cbox[..., 0:3][live], cbox[..., 3:6][live]
    assert bool((lo <= hi).all())
    assert int(live.sum()) > 0
    if case in ("big_4000", "flattened"):
        # Leaf packing pads the last super-chunk, so some chunks are
        # padding, and skipping them is where the work goes down.
        assert bool(inverted.any())
