"""The traversal roofline's byte count on a tiny scene."""

import pytest

from rtbench import spec
from rtbench.reference import card, sceneio, still_life
from rtbench.scenes import instanced_card, still_life as still_life_kind

roofline = spec.metric_reader("traversal_roofline")


def test_bytes_per_frame():
    # 1,000 rays of 32 B in and 32 B out, 2 ray kinds x 3 bounces of a
    # 720-byte scene.
    assert roofline.bytes_per_frame(1000, 720, 3) == 1000 * 64 + 6 * 720


def test_scene_bytes_flat():
    raw = still_life.make_still_life_like(num_objects=10, num_cards=2)
    assert still_life_kind.scene_bytes(raw) == raw.v0.shape[0] * 36
    assert raw.v0.shape[0] == 2 + 2 + 10 * 12 + 2 * 2


def test_scene_bytes_instanced(tmp_path):
    path = card.write_instanced_scene(str(tmp_path / "s"))
    raw = sceneio.load_scene(path)
    assert instanced_card.scene_bytes(path) == (
        raw.extra["unique_tris"] * 36 + raw.extra["instances"] * 96)
    assert (raw.extra["instances"], raw.extra["unique_tris"]) == (9, 820)
    two = raw.extra["two_level"]
    assert len(two["instances"]) == 9
    assert sum(len(v0) for v0, _, _ in two["meshes"]) == 820


def test_share_of_the_bound():
    ctx = dict(rays=2.0e6, frames=2, scene_bytes=36_000, max_len=8,
               dtot={"khit_kernel(x)": [10_000_000, 4]}, sound=True)
    b = roofline.bytes_per_frame(1.0e6, 36_000, 8)
    got = roofline.read(ctx)
    assert got == pytest.approx(100.0 * b / 3.35e12 / 5e-3)
    assert roofline.read(dict(ctx, rays=None)) is None
