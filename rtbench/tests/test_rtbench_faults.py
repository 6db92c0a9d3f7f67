"""The harness's run of a cell with the timed path broken underneath
comes out not correct: once for each fault a renderer's cell can have.
It skips the harness's look for a card and runs the rest on the CPU at
a small size (tests/small_cells.py)."""

import pytest
import torch

from rtbench import run
from rtbench.tests.small_cells import small_cell

CELLS = ["still_life.pt.1080p", "instanced_card.vcm.1080p"]


def _run(cell, seed=2**31 + 77):
    return run.run_cell(small_cell(cell), seed, 0.3, False,
                        torch.device("cpu"))


def _broken_frames(monkeypatch, alter):
    """Make the engine's frame function return alter(film)."""
    from imbatracer_torch.frontend import engine

    make = engine.make_frame_fn

    def broken(*a, **kw):
        fn, cam = make(*a, **kw)
        return (lambda frame, stats=None: alter(fn(frame))), cam

    monkeypatch.setattr(engine, "make_frame_fn", broken)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_state_left_unchanged(cell, monkeypatch):
    from imbatracer_torch.frontend.renderer import ProgressiveRenderer

    def step(self):
        self.frame_fn(self.frames)
        self.frames += 1

    monkeypatch.setattr(ProgressiveRenderer, "step", step)
    res = _run(cell)
    assert not res["correct"]
    assert res["checks"]["accum_gap"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_pixels_left_out_the_mean_over_the_rest(cell, monkeypatch):
    def half(film):
        keep = (torch.arange(film.shape[0]) % 2 == 0)[:, None]
        return torch.where(keep, 2.0 * film, 0.0)

    _broken_frames(monkeypatch, half)
    res = _run(cell)
    assert not res["correct"]
    assert res["checks"]["mismatch_pct"]["value"] > 50


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_where_it_is_produced(cell, monkeypatch):
    from imbatracer_torch.ops import shade

    finish = shade.pt_shade_finish_plain

    def altered(radiance, contrib, ok, occluded, n_rays):
        r, n = finish(radiance, 1.02 * contrib, ok, occluded, n_rays)
        return r, n

    if cell.endswith("pt.1080p"):
        monkeypatch.setattr(shade, "pt_shade_finish_plain", altered)
    else:
        from imbatracer_torch.ops import vcm_shade

        cfinish = vcm_shade.camera_finish_plain

        def altered_vcm(radiance, contrib, ok, occluded, n_rays):
            return cfinish(radiance, 1.02 * contrib, ok, occluded, n_rays)
        monkeypatch.setattr(vcm_shade, "camera_finish_plain", altered_vcm)
    res = _run(cell)
    assert not res["correct"]
