"""The plain reference against the program's own plain route on the CPU
(both are plain PyTorch there, so they agree bit for bit), the frozen
generators against the program's, and the control against the
limits."""

import os

import numpy as np
import pytest
import torch

from rtbench import check, run, spec
from rtbench.reference import camera as ref_camera
from rtbench.reference import card, still_life
from rtbench.reference import scene as ref_scene
from rtbench.tests.small_cells import small_cell

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def test_still_life_inputs_are_the_program_generators():
    from imbatracer_torch.convert import scene_to_numpy
    from imbatracer_torch.scene.procedural import make_still_life_like

    kind = spec.scene_kind("still_life")
    raw = still_life.make_still_life_like(num_objects=200, num_cards=30)
    ours, _ = kind.program_scene(raw, "cpu")
    theirs, meta = make_still_life_like(num_objects=200, num_cards=30,
                                        device="cpu")
    a, b = scene_to_numpy(ours), scene_to_numpy(theirs)
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k
    assert (raw.cam_pos, raw.cam_dir) == (meta.cam_pos, meta.cam_dir)


def test_card_writer_is_the_program_writer(tmp_path):
    from imbatracer_torch.scene.generate import write_instanced_scene

    ours = card.write_instanced_scene(str(tmp_path / "a"))
    theirs = write_instanced_scene(str(tmp_path / "b"))
    names = sorted(os.listdir(tmp_path / "a"))
    assert names == sorted(os.listdir(tmp_path / "b"))
    for n in names:
        with open(tmp_path / "a" / n, "rb") as f, \
                open(tmp_path / "b" / n, "rb") as g:
            assert f.read() == g.read(), n
    assert os.path.basename(ours) == os.path.basename(theirs)


def _films(cell, frame, lowp=False):
    """The program's plain frame and the reference's at every pixel."""
    from imbatracer_torch.frontend.engine import make_frame_fn
    from imbatracer_torch.frontend.renderer import RenderSettings

    rs = cell.traffic["render"]
    kind = spec.scene_kind(cell.config["scene"])
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        handle = kind.prepare(cell.config, d)
        scene, meta = kind.program_scene(handle, "cpu")
        fn, _ = make_frame_fn(scene, meta, RenderSettings(**rs))
        prog = fn(frame)
        raw = kind.reference_inputs(handle)
    ref = ref_scene.build(raw, "cpu")
    cam = ref_camera.make_camera(raw.cam_pos, raw.cam_dir, raw.cam_up,
                                 rs["width"], rs["height"],
                                 rs.get("fov", 60.0), device="cpu")
    render = run.reference_renderer(rs, raw)
    pid = torch.arange(rs["width"] * rs["height"])
    return prog, render(ref, cam, frame, pid), render(ref, cam, frame, pid,
                                                      lowp=True)


@pytest.mark.parametrize("cell", CELLS)
def test_reference_is_the_program_on_the_cpu_and_the_control_fails(cell):
    c = small_cell(cell, width=32, height=18)
    prog, ref, lowp = _films(c, 12345)
    got = check.compare(prog, ref)
    assert got["bad"] == 0
    assert got["prog_sum"] == pytest.approx(got["ref_sum"], rel=1e-5)
    # The control, the reference in bfloat16 in the program's place,
    # fails the cell's limits.
    ctl = check.judge([check.compare(lowp, ref)], [0.0], c.limits)
    assert not check.passed(ctl)
    assert ctl["mismatch_pct"]["value"] > c.limits["mismatch_pct"]


def test_rows_render_as_in_the_whole_frame():
    c = small_cell("instanced_card.vcm.1080p", width=32, height=18)
    rs = c.traffic["render"]
    kind = spec.scene_kind("instanced_card")
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        raw = kind.reference_inputs(kind.prepare(c.config, d))
    ref = ref_scene.build(raw, "cpu")
    cam = ref_camera.make_camera(raw.cam_pos, raw.cam_dir, raw.cam_up, 32,
                                 18, 60.0, device="cpu")
    render = run.reference_renderer(rs, raw)
    full = render(ref, cam, 7, torch.arange(32 * 18))
    pid = check.pixel_ids([2, 9, 17], 32, "cpu")
    torch.testing.assert_close(render(ref, cam, 7, pid), full[pid],
                               rtol=0, atol=0)


def test_two_level_traversal_finds_the_flat_hits(tmp_path):
    """The instances' mesh-space traversal and the flat world-space one
    find the same triangles, at t apart by rounding alone."""
    import dataclasses

    from rtbench.reference import sceneio, traverse

    raw = sceneio.load_scene(card.write_instanced_scene(str(tmp_path / "s")))
    two = ref_scene.build(raw, "cpu")
    flat = ref_scene.build(dataclasses.replace(raw, extra={}), "cpu")
    assert two.instances is not None and flat.instances is None
    cam = ref_camera.make_camera(raw.cam_pos, raw.cam_dir, raw.cam_up, 48,
                                 27, 60.0, device="cpu")
    i = torch.arange(48 * 27)
    org, d = ref_camera.generate_ray(cam, (i % 48).float() + 0.5,
                                     (i // 48).float() + 0.5)
    g = torch.Generator().manual_seed(5)
    d = torch.cat([d, torch.nn.functional.normalize(
        torch.randn(1024, 3, generator=g), dim=-1)])
    org = torch.cat([org, org[:1024]])
    zero = torch.zeros(org.shape[0])
    on = torch.ones_like(zero, dtype=torch.bool)
    a = traverse.closest_hit(two, org, d, zero, 1e30, on, True)
    b = traverse.closest_hit(flat, org, d, zero, 1e30, on, True)
    assert int((b.prim_id >= 0).sum()) > 500
    assert torch.equal(a.prim_id, b.prim_id)
    hit = b.prim_id >= 0
    torch.testing.assert_close(a.t[hit], b.t[hit], rtol=1e-5, atol=0)
    tmax = torch.full_like(zero, 2.0)
    assert torch.equal(traverse.any_hit(two, org, d, zero + 1e-3, tmax, on,
                                        True),
                       traverse.any_hit(flat, org, d, zero + 1e-3, tmax, on,
                                        True))
