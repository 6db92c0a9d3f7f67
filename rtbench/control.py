"""The check's control: the reference computed in the next precision
below the one the program states (bfloat16 for float32), put where the
program's film would be, at the cell's own size.

    python3 -m rtbench.control --workload <cell> --seeds 11,12,13

For each seed it renders the frames and pixel rows that a run of that
seed would check first (the window's first frames), with the reference
in float32 and with its carried floats and hits stored in bfloat16
(`reference/pt.py`, `reference/vcm.py` `lowp`), and prints the compared
numbers of check.py for the bfloat16 film against the float32 one, one
JSON line a seed.  Its readings are the upper ends from which the
limits in `checks/<cell>.json` were set; the benchmark's own runs do not
run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

from . import check, run, spec


def control_readings(cell, seeds, device, sync=lambda: None):
    from .reference import camera as ref_camera
    from .reference import scene as ref_scene

    rs = cell.traffic["render"]
    kind = spec.scene_kind(cell.config["scene"])
    out = []
    with tempfile.TemporaryDirectory(prefix="rtbench_") as workdir:
        raw = kind.reference_inputs(kind.prepare(cell.config, workdir))
        ref = ref_scene.build(raw, device)
        cam = ref_camera.make_camera(raw.cam_pos, raw.cam_dir, raw.cam_up,
                                     rs["width"], rs["height"],
                                     rs.get("fov", 60.0), device=device)
        render = run.reference_renderer(rs, raw)
        for seed in seeds:
            t0 = time.perf_counter()
            rows = check.sample_rows(rs["height"],
                                     int(cell.traffic["check"]["rows"]), seed)
            pid = check.pixel_ids(rows, rs["width"], device)
            parts = []
            for k in range(int(cell.traffic["check"]["frames"])):
                frame = seed % run.FRAME_SPAN + k
                want = render(ref, cam, frame, pid)
                got = render(ref, cam, frame, pid, lowp=True)
                parts.append(check.compare(got, want))
            sync()
            got = check.judge(parts, [0.0], cell.limits)
            out.append(dict(seed=seed, seconds=time.perf_counter() - t0,
                            **{k: v["value"] for k, v in got.items()
                               if k != "accum_gap"}))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    run.run_environment(spec.ROOT)
    cell = spec.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for r in control_readings(cell, [int(s) for s in args.seeds.split(",")],
                              dev, sync=lambda: torch.cuda.synchronize(dev)):
        print(json.dumps(dict(workload=cell.name, **r)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
