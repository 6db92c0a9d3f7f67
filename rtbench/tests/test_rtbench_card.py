"""On the card: a short run of a cell at its own size is correct, and
the control, the bfloat16 reference in the program's place, fails its
limits there.  Marked `cuda`; skips without a card."""

import pytest
import torch

from rtbench import check, control, run, spec


@pytest.mark.cuda
def test_short_run_is_correct_on_the_card(cuda_device):
    run.run_environment(spec.ROOT)
    run.build_libraries()
    cell = spec.load_cell("still_life.pt.1080p")
    res = run.run_cell(cell, 2**31 + 5, 1.0, False, cuda_device,
                       sync=torch.cuda.synchronize)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"


@pytest.mark.cuda
def test_control_fails_at_the_cells_size(cuda_device):
    cell = spec.load_cell("still_life.pt.1080p")
    (got,) = control.control_readings(cell, [2**31 + 9], cuda_device)
    checks = {k: dict(value=got[k], limit=cell.limits[k])
              for k in ("mismatch_pct", "mean_gap_pct")}
    assert not check.passed(checks)
