#!/usr/bin/env python3
"""The kernels redesigned for Hopper against their earlier design, on one
card in one process: vcm_light_shade_kernel (csrc/vcm_shade.cu) and
slot_finish_kernel (csrc/dispatch.cu).

The earlier design is another checkout's source (--root, for example the
parent commit unpacked under the git-ignored out/), built with this
tree's nvcc flags into build/imbatracer_torch/ and launched through this
tree's wrappers, whose C interface both share.  Each kernel is timed as
chip_smoke.graph_ms (10 launches captured in one CUDA graph, after a
warm-up), earlier, redesigned, redesigned, earlier, on chip_smoke.py's
inputs:

* the light bounce: the middle 2^18-lane band of a still-life vcm frame
  at 1920x1080 with 2^20 light paths at light bounces 0, 3 and 6 (phase
  4c's), the cornell with delta lights at 1024^2, bounce 0, and the
  instanced scene at 1920x1080, bounce 1; the two designs' outputs must
  be equal bit for bit on the lanes that go on past the hit test, and on
  the others in what both write alike (the flags, the ray, tmin, the
  throughput and the RNG word): there the redesign writes
  vcm_shade.DEAD_LIGHT's rows and the carry's partial weights as they
  came in;
* the finish: the still life's bounce-1 rays as its graph-ready khit
  re-trace gathers them and phase 4e's seeded need masks at both slot
  shares; the earlier kernel adds no per-run counts (the loop's body
  added them a round, one 0-d add each), so both run without them and
  must agree bit for bit, and the redesign is timed once more with five
  (its call in a graphed frame).

Each `[ab]` line names the card and its power limit, with the bound of
the bytes the function moves (chip_smoke.py's count) and each build's
registers, local bytes and resident blocks.  Run from the repository
root:

    python3 scripts/redesign_ab.py --root out/parent
"""

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
from functools import partial

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from imbatracer_torch import libbuild  # noqa: E402
from imbatracer_torch.device import card_line, get_device  # noqa: E402
from imbatracer_torch.ops import dispatch as dp  # noqa: E402
from imbatracer_torch.ops import vcm_shade as vs  # noqa: E402
from imbatracer_torch.render import traverse as tt  # noqa: E402


class _Built:
    """A NativeLib stand-in whose library is already built."""

    def __init__(self, path):
        self.path = path

    def build(self):
        return self.path


def earlier_builds(root):
    """{module: (ctypes library, ptxas lines)} of the earlier sources."""
    out, procs = {}, []
    os.makedirs(libbuild.BUILD_DIR, exist_ok=True)
    inc = os.path.join(os.path.abspath(root), "imbatracer_torch", "csrc")
    for mod in (dp, vs):
        so = os.path.join(libbuild.BUILD_DIR, f"lib{mod.LIB.name}_earlier.so")
        cmd = [libbuild._nvcc(), *libbuild.NVCC_FLAGS, "-I", inc, "-o", so,
               os.path.join(inc, mod.LIB.source)]
        procs.append((mod, so, subprocess.Popen(
            cmd, stderr=subprocess.PIPE, text=True)))
    for mod, so, p in procs:
        err = p.communicate()[1]
        if p.returncode != 0:
            raise RuntimeError(f"building the earlier {mod.LIB.source} "
                               f"failed:\n{err}")
        out[mod] = (load(mod, so), err)
    return out


def load(mod, path):
    """The library at `path`, its argument types set by mod._library()."""
    keep, mod.LIB, mod._lib = mod.LIB, _Built(path), None
    try:
        return mod._library()
    finally:
        mod.LIB, mod._lib = keep, None


def ptxas(log, kernel):
    """A build log's stack, spill and register lines of `kernel`."""
    lines = log.splitlines()
    for k, ln in enumerate(lines):
        if "Compiling entry function" in ln and kernel in ln:
            return "; ".join(x.split(":", 1)[-1].strip()
                             for x in lines[k + 1:k + 4]
                             if "stack frame" in x or "registers" in x)
    return "built before this process (its log: the build's)"


def turns(mod, libs, fn):
    """graph_ms of fn() with each library in turn: earlier, redesigned,
    redesigned, earlier; ([earlier], [redesigned])."""
    got = {"earlier": [], "redesigned": []}
    for which in ("earlier", "redesigned", "redesigned", "earlier"):
        mod._lib = libs[which]
        got[which].append(cs.graph_ms(fn))
    mod._lib = libs["redesigned"]
    return got["earlier"], got["redesigned"]


def res(mod, libs, name, card):
    for which in ("earlier", "redesigned"):
        mod._lib = libs[which]
        cs.log_resources(f"{which} {name} kernel", mod.resources(name), card)
    mod._lib = libs["redesigned"]


def fmt(ms):
    return " / ".join(f"{x:.4f}" for x in ms)


# What the light bounce writes alike in both designs on a lane that does
# not go on past the hit test.
ALIKE = ("org", "d", "tmin", "throughput", "active", "state", "finite",
         "path_id", "shadow.ok", "rows.store")


def light_outputs(nxt, sh, rows):
    """{name: tensor} of light_shade's outputs."""
    cols = dict(nxt)
    cols.update({f"shadow.{k}": v for k, v in sh._asdict().items()})
    cols.update({f"rows.{k}": v for k, v in rows._asdict().items()})
    return cols


def differ(x, y):
    """Elements of x and y not bit-equal (NaN against NaN equal)."""
    if x.dim() and x.dtype == torch.float32:
        nan = torch.isnan(x) & torch.isnan(y)
        return int(((x.view(torch.int32) != y.view(torch.int32))
                    & ~nan).sum())
    return int((x != y).sum())


def light_case(libs, label, scene, meta, cam, fi, lpc, bounce, card):
    c, hit, _ = cs.vcm_light_band(scene, meta, cam, fi, lpc, 8, bounce)
    kw = cs.light_kw(meta, cam, fi, lpc, 8)
    dev = cam.pos.device
    outs, rows = {}, {}
    for which in ("earlier", "redesigned"):
        vs._lib = libs[which]
        rows[which] = vs.light_rows(cs.NUM_RAYS, 1, True, True, dev)
        nxt, sh = vs.light_shade_cuda(scene, cam, c, hit, bounce,
                                      rows[which], **kw)
        outs[which] = light_outputs(nxt, sh, rows[which])
    # A lane that goes on writes its path length, bounce + 2, into its
    # vertex row; DEAD_LIGHT's row holds 0 there.
    live = rows["redesigned"].rec[:, 21].view(torch.int32) != 0
    bad = {}
    for name, x in outs["redesigned"].items():
        y = outs["earlier"][name]
        k = differ(x, y) if name in ALIKE else differ(x[live], y[live])
        if k:
            bad[name] = k
    if bad:
        raise AssertionError(f"[ab] vcm_light_shade {label} bounce {bounce}: "
                             f"the designs differ: {bad}")
    fn = partial(vs.light_shade_cuda, scene, cam, c, hit, bounce,
                 rows["redesigned"], **kw)
    earlier, new = turns(vs, libs, fn)
    shade = cs.distinct_rows(hit.prim_id.clamp(min=0),
                             scene.attrs.shade_rec.shape[1])
    reads = {n: c[n] for n in ("org", "d", "throughput", "active", "d_vc",
                               "d_vcm", "d_vm", "state", "finite",
                               "path_id")}
    vs._lib = libs["redesigned"]
    nxt, sh = fn()
    nbytes = (cs.tensor_bytes(reads, hit, {n: nxt[n] for n in vs.NEXT},
                              tuple(rows["redesigned"]), tuple(sh)) + shade)
    bound_ms, by = cs.shade_bound(
        nbytes, cs.NUM_RAYS * cs.VCM_LANE_OPS["light_shade"])
    alive = float(c["active"].double().mean())
    cs.log(f"[ab] vcm_light_shade_kernel, {label}, light bounce {bounce}, "
           f"{alive:.4f} alive on entry, {float(live.double().mean()):.4f} "
           f"past the hit test: earlier {fmt(earlier)} ms, redesigned "
           f"{fmt(new)} ms, bound {bound_ms:.4f} ms by {by} ({nbytes} "
           f"bytes); outputs bit-equal but the rows and partial weights of "
           f"lanes that do not go on [{card}]")


def finish_case(libs, label, act, need, slots, hit, tcur, seed, card):
    idx = torch.nonzero_static(need, size=slots, fill_value=0)[:, 0]
    count = need.sum(dtype=torch.int32)
    s = dp.slot_gather_cuda(idx, count, hit, tcur)
    rs = np.random.RandomState(seed)
    dev = need.device
    s = s._replace(need=s.valid & torch.from_numpy(
        rs.rand(slots) < 0.5).to(dev))
    rounds = torch.tensor(int(rs.randint(1, 9)), dtype=torch.int32,
                          device=dev)
    counts0 = torch.from_numpy(rs.randint(0, 100, 14).astype(np.int32)).to(
        dev)
    where = (list(range(3, 3 + len(dp.FINISH_KEYS))),
             [k.startswith("max_") for k in dp.FINISH_KEYS])
    deltas = [(1, 1), (2, 1), (8, 1), (9, 1), (10, 1)]
    got = {}
    for which in ("earlier", "redesigned"):
        dp._lib = libs[which]
        got[which] = counts0.clone()
        dp.slot_finish_cuda(got[which][0], act, s, rounds,
                            (got[which],) + where)
    bad = cs.bit_mismatches(got["earlier"], got["redesigned"])
    if bad:
        raise AssertionError(f"[ab] slot_finish {label}: {bad} counts "
                             f"differ")
    ck = counts0.clone()
    fn = partial(dp.slot_finish_cuda, ck[0], act, s, rounds, (ck,) + where)
    earlier, new = turns(dp, libs, fn)
    dp._lib = libs["redesigned"]
    folded = cs.graph_ms(partial(dp.slot_finish_cuda, ck[0], act, s, rounds,
                                 (ck,) + where, deltas))
    n = act.shape[0]
    nbytes = n + slots + 12 + 24
    bound_ms, by = cs.shade_bound(nbytes, 0)
    cs.log(f"[ab] slot_finish_kernel, {label} ({n} lanes, {slots} slots, "
           f"{int(count)} in need): earlier {fmt(earlier)} ms, redesigned "
           f"{fmt(new)} ms, with 5 per-run counts folded in {folded:.4f} ms, "
           f"bound {bound_ms:.5f} ms by {by} ({nbytes} bytes); counts "
           f"bit-equal [{card}]")


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", required=True,
                   help="checkout holding the earlier design")
    args = p.parse_args()
    from imbatracer_torch.scene.build import build_scene
    from imbatracer_torch.scene.generate import CARD, write_instanced_scene
    from imbatracer_torch.scene.procedural import make_still_life_like

    dev = get_device("cuda")
    card = card_line(dev)
    new = {dp: dp._library(), vs: vs._library()}
    built = earlier_builds(args.root)
    logs = {dp: libbuild.BUILD_INFO.get(dp.LIB.name, {}).get("log", ""),
            vs: libbuild.BUILD_INFO.get(vs.LIB.name, {}).get("log", "")}
    libs = {mod: {"earlier": built[mod][0], "redesigned": new[mod]}
            for mod in (dp, vs)}
    for mod, kernel in ((vs, "vcm_light_shade_kernel"),
                        (dp, "slot_finish_kernel")):
        cs.log(f"[ab] {kernel} ptxas: earlier {ptxas(built[mod][1], kernel)}"
               f"; redesigned {ptxas(logs[mod], kernel)} [{card}]")
    res(vs, libs[vs], "light_shade", card)
    res(dp, libs[dp], "slot_finish", card)

    scene, meta = make_still_life_like(device=dev)
    cam, fi, lpc, _ = cs.vcm_frame_inputs(scene, meta, 1920, 1080, 8, dev)
    label = f"still_life 1920x1080, {lpc} light paths"
    for bounce in cs.LIGHT_BOUNCES:
        light_case(libs[vs], label, scene, meta, cam, fi, lpc, bounce, card)
    c, _, alpha_fn = cs.shade_carry(scene, meta, 1920, 1080, 8, 1, dev)
    need, slots, hit, tcur = cs.recorded_slots(scene, c, alpha_fn)
    finish_case(libs[dp], "still_life 1920x1080 bounce 1, the khit "
                "re-trace's", c["active"], need, slots, hit, tcur, 1, card)
    del c, need, hit, tcur
    for density, two_level, seed in ((0.0, False, 2), (0.01, False, 3),
                                     (0.2, True, 4), (0.3, True, 5)):
        slots = tt.retrace_slots(cs.NUM_RAYS, two_level)
        act, need, hit, tcur = cs.random_slots_case(
            cs.NUM_RAYS, density, slots, seed, dev, not two_level)
        finish_case(libs[dp], f"seeded need {density} of the lanes, "
                    f"{'two-level' if two_level else 'flat'} share", act,
                    need, slots, hit, tcur, seed, card)
    del scene
    delta = cs.delta_light_cornell(dev)
    cam, fi, lpc, _ = cs.vcm_frame_inputs(*delta, 1024, 1024, 8, dev)
    light_case(libs[vs], "cornell with point, spot and dir lights "
               "1024x1024", *delta, cam, fi, lpc, 0, card)
    del delta
    tmp = tempfile.mkdtemp(prefix="imba_ab_")
    inst = build_scene(write_instanced_scene(tmp, **CARD), quiet=True,
                       device=dev)
    cam, fi, lpc, _ = cs.vcm_frame_inputs(*inst, 1920, 1080, 8, dev)
    light_case(libs[vs], f"instanced 1920x1080, {lpc} light paths", *inst,
               cam, fi, lpc, 1, card)
    shutil.rmtree(tmp, ignore_errors=True)
    cs.log("[ab] done")


if __name__ == "__main__":
    main()
