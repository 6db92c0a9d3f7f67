#!/usr/bin/env python3
"""The masked re-trace's needs on the port's eager VCM-family frames, on
a CUDA card: for each pass (light, camera) and traversal call
(closest_hit, any_hit), the masked dispatches of a few eager frames,
the most rounds one needed (MASK_STATS "max_rounds"), the most lanes one
carried past its first round ("max_lanes") against the graph-ready
re-trace's slots, and the dispatches the plan of render/traverse.py
(KHIT_ROUNDS or RETRACE_ROUNDS, the slot shares) would leave unresolved,
which would make a graphed frame render again eagerly.

Run from the repository root: `python3 scripts/torch_retrace_rounds.py`.
Cells: the still life (VCM_LPC light paths) and the generated instanced
scene at 1920x1080, vcm; bpt, ppm and lt on the still life at 480x270;
bpt on the instanced scene at 480x270; max_len 8.
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from imbatracer_torch import libbuild  # noqa: E402
from imbatracer_torch.accel import native  # noqa: E402
from imbatracer_torch.device import card_line  # noqa: E402
from imbatracer_torch.ops import khit as kh  # noqa: E402
from imbatracer_torch.ops import merge as mg  # noqa: E402
from imbatracer_torch.ops import pairs as pm  # noqa: E402
from imbatracer_torch.ops import stream_traverse as st  # noqa: E402
from imbatracer_torch.render import traverse as tt  # noqa: E402
from imbatracer_torch.render.integrators import vcm  # noqa: E402

CELLS = (("still_life", "vcm", 1920, 1080, 3),
         ("instanced", "vcm", 1920, 1080, 3),
         ("still_life", "bpt", 480, 270, 2),
         ("still_life", "ppm", 480, 270, 2),
         ("still_life", "lt", 480, 270, 2),
         ("instanced", "bpt", 480, 270, 2))


def record_dispatches(records, tag):
    """Wrap vcm's traversal calls and passes so that each masked dispatch
    appends (pass, call, lanes, rounds, lanes past round 1)."""
    def call(name):
        orig = getattr(vcm, name)

        def f(bvh, org, *a, alpha_fn=None, **k):
            if alpha_fn is None:
                return orig(bvh, org, *a, alpha_fn=alpha_fn, **k)
            tt.MASK_STATS["max_rounds"] = tt.MASK_STATS["max_lanes"] = 0
            out = orig(bvh, org, *a, alpha_fn=alpha_fn, **k)
            records.append((tag[0], name, org.shape[0],
                            tt.MASK_STATS["max_rounds"],
                            tt.MASK_STATS["max_lanes"]))
            return out
        setattr(vcm, name, f)

    def tagged(name, t):
        orig = getattr(vcm, name)

        def f(*a, **k):
            tag[0] = t
            try:
                return orig(*a, **k)
            finally:
                tag[0] = "?"
        setattr(vcm, name, f)

    for name in ("closest_hit", "any_hit"):
        call(name)
    tagged("_light_pass", "light")
    tagged("camera_film", "camera")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_retrace_rounds: CUDA is not available")
    from imbatracer_torch.scene.build import build_scene
    from imbatracer_torch.scene.generate import CARD, write_instanced_scene
    from imbatracer_torch.scene.procedural import make_still_life_like

    t0 = time.time()
    libbuild.build_all((st.LIB, kh.LIB, mg.LIB, pm.LIB, native.LIB))
    dev = torch.device("cuda")
    card = card_line(dev)
    records, tag = [], ["?"]
    record_dispatches(records, tag)
    tmp = tempfile.mkdtemp(prefix="imba_rounds_")
    scenes = {"still_life": make_still_life_like(device=dev),
              "instanced": build_scene(write_instanced_scene(tmp, **CARD),
                                       quiet=True, device=dev)}
    for key, algo, w, h, frames in CELLS:
        fn = cs.route_fn(*scenes[key], algo, w, h, 8, "graph")
        records.clear()
        for f in range(frames):
            fn(f, False)
        two = scenes[key][0].bvh.two_level
        rounds = tt.retrace_plan(two)[0]
        groups = {}
        for t, name, n, r, lanes in records:
            groups.setdefault((t, name), []).append((n, r, lanes))
        for (t, name), rs in sorted(groups.items()):
            slots = lambda n: tt.retrace_slots(n, two)
            over = sum(1 for n, r, lanes in rs
                       if r > rounds or lanes > slots(n))
            worst = max(rs, key=lambda x: x[2] / slots(x[0]))
            print(f"[rounds] {key} {algo} {w}x{h} {t} {name}: {len(rs)} "
                  f"masked dispatches over {frames} eager frames, lanes "
                  f"{sorted(set(n for n, _, _ in rs))}; most rounds "
                  f"{max(r for _, r, _ in rs)}, most lanes past round 1 "
                  f"{max(lanes for _, _, lanes in rs)} (of "
                  f"{slots(worst[0])} slots); past the plan ({rounds} "
                  f"rounds) {over} [{card}]", flush=True)
    print(f"[done] {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
