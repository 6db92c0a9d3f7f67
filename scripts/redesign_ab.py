#!/usr/bin/env python3
"""The two kernels redesigned for Hopper against their earlier design, on
one card in one process: dispatch_rows_kernel (csrc/dispatch.cu) and
vcm_camera_shade_kernel (csrc/vcm_shade.cu).

The earlier design is another checkout's source (--root, for example the
parent commit unpacked under the git-ignored out/), built with this
tree's nvcc flags into build/imbatracer_torch/ and launched through this
tree's wrappers, whose C interface both share.  Each kernel is timed as
chip_smoke.graph_ms (10 launches captured in one CUDA graph, after a
warm-up), earlier, redesigned, redesigned, earlier, on chip_smoke.py's
inputs:

* the rows: the bounce-1 rays of the still life at 1920x1080, the
  cornell at 1024^2 and the instanced scene at 1920x1080 (phases 4d and
  8a), a first round over every lane and a re-trace round over every
  third active lane (state by slot, tmin' past the slot's hit); the two
  designs' rows must be equal bit for bit;
* the camera bounce: the middle 2^18-lane band of a still-life vcm frame
  at 1920x1080 with 2^20 light paths at camera bounces 0, 1 and 3 with 1
  and 3 connections (phase 4c's bands), and the cornell with delta lights
  at 1024^2, bounce 1, 3 connections; the two designs' outputs must be
  equal bit for bit but in the shadow rows of lanes dead on entry, which
  the redesign writes as vcm_shade.DEAD_SHADOW.

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

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from imbatracer_torch import libbuild  # noqa: E402
from imbatracer_torch.core import rng  # noqa: E402
from imbatracer_torch.device import card_line, get_device  # noqa: E402
from imbatracer_torch.ops import dispatch as dp  # noqa: E402
from imbatracer_torch.ops import stream_traverse as st  # noqa: E402
from imbatracer_torch.ops import vcm_shade as vs  # noqa: E402


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


def rows_cases(libs, scenes, card):
    for label, (scene, meta), (w, h, max_len) in scenes:
        dev = scene.device
        c, hit, _ = cs.shade_carry(scene, meta, w, h, max_len, 1, dev)
        org, d, act = c["org"], c["d"], c["active"]
        n = org.shape[0]
        bvh = scene.bvh
        tmin = st.full_lanes(c["tmin"], n, dev)
        tmax = st.full_lanes(st.BIG, n, dev)
        slots = act.nonzero()[:, 0][::3].contiguous()
        for form in ("first", "re-trace"):
            first = form == "first"
            ln = None if first else slots
            m = n if first else slots.shape[0]
            a = act if first else torch.ones(m, dtype=torch.bool, device=dev)
            tc = None if first else hit.t[slots].contiguous()
            perm = torch.sort(dp.keys_cuda(org, d, a, bvh.bounds, bvh.center,
                                           ln), stable=True)[1]
            fn = partial(dp.rows_cuda, org, d, tmin, tmax, perm, m, active=a,
                         center=bvh.center, lanes=ln, tcur=tc,
                         step=not first)
            outs = {}
            for which in ("earlier", "redesigned"):
                dp._lib = libs[which]
                outs[which] = fn()
            bad = cs.bit_mismatches(outs["earlier"], outs["redesigned"])
            if bad:
                raise AssertionError(f"[ab] dispatch_rows {label} {form}: "
                                     f"{bad} elements differ")
            earlier, new = turns(dp, libs, fn)
            nbytes = (m * (8 + 24 + 1 + 32) + cs.lane_bytes(tmin, m)
                      + cs.lane_bytes(tmax, m) + (0 if first else 12 * m))
            bound_ms, by = cs.shade_bound(nbytes, 0)
            cs.log(f"[ab] dispatch_rows_kernel, {label} bounce 1, {form} "
                   f"round ({m} rows): earlier {fmt(earlier)} ms, "
                   f"redesigned {fmt(new)} ms, bound {bound_ms:.4f} ms by "
                   f"{by} ({nbytes} bytes); rows bit-equal [{card}]")


def camera_carry(scene, meta, cam, fi, lpc, bounce):
    """The middle NUM_RAYS band of the frame's camera pass at camera
    bounce `bounce` (phase 4c's), with its closest hit."""
    from imbatracer_torch.render.integrators import pt, vcm
    from imbatracer_torch.render.intersect import BIG
    from imbatracer_torch.render.traverse import closest_hit

    w, h, dev = cam.width, cam.height, cam.pos.device
    start = (w * h - cs.NUM_RAYS) // 2 // w * w
    alpha_fn = pt.alpha_fn_for(scene) if meta.has_masks else None
    c = vcm._camera_carry(cam, fi.frame, width=w, height=h, spp=1,
                          light_path_count=lpc, start_pixel=start,
                          band_pixels=cs.NUM_RAYS)
    c["n_rays"] = torch.zeros((), dtype=torch.int64, device=dev)
    kinds = tuple(sorted(set(scene.materials.kind.tolist())))
    for i in range(bounce):
        c = vcm._camera_bounce(
            scene, c, i, cache_count=fi.cache_count, cache_rec=fi.cache_rec,
            grid=fi.grid, pm_radius=fi.pm_radius,
            base_radius=fi.base_radius, mis_eta_vc=fi.mis_eta_vc,
            mis_eta_vm=fi.mis_eta_vm, algo="vcm", max_len=8,
            light_path_count=lpc, num_connections=1, has_bump=meta.has_bump,
            alpha_fn=alpha_fn, techniques=vs.TECHNIQUES, mat_kinds=kinds)
    hit = closest_hit(scene.bvh, c["org"], c["d"], c["tmin"], BIG,
                      alpha_fn=alpha_fn, active=c["active"], sort=True)
    return c, hit


def outputs(got):
    """{name: tensor} of camera_shade's outputs."""
    nxt, sh, q = got
    cols = dict(nxt)
    cols.update({f"shadow.{k}": v for k, v in sh._asdict().items()})
    cols.update({f"query.{k}": v for k, v in q._asdict().items()
                 if k != "params"})
    cols.update({f"query.{k}": v for k, v in q.params.items()})
    return cols


def camera_case(libs, label, scene, meta, cam, fi, lpc, bounce, conns,
                card):
    c, hit = camera_carry(scene, meta, cam, fi, lpc, bounce)
    kw = cs.camera_kw(meta, fi, lpc, 8, conns)
    fn = partial(vs.camera_shade_cuda, scene, c, hit, bounce, **kw)
    outs = {}
    for which in ("earlier", "redesigned"):
        vs._lib = libs[which]
        outs[which] = outputs(fn())
    dead = ~c["active"]
    sets = outs["redesigned"]["shadow.ok"].shape[0] // dead.shape[0]
    live_rows = (~dead).repeat(sets)
    bad = {}
    for name, x in outs["redesigned"].items():
        y = outs["earlier"][name]
        if name.startswith("shadow."):
            x, y = x[live_rows], y[live_rows]
        if x.dim() and x.dtype == torch.float32:
            nan = torch.isnan(x) & torch.isnan(y)
            k = int(((x.view(torch.int32) != y.view(torch.int32))
                     & ~nan).sum())
        else:
            k = int((x != y).sum())
        if k:
            bad[name] = k
    if bad:
        raise AssertionError(f"[ab] vcm_camera_shade {label}: the designs "
                             f"differ: {bad}")
    earlier, new = turns(vs, libs, fn)
    _, (ul,) = rng.next_floats(c["state"], 1)
    num_lights = scene.lights.kind.shape[0]
    lights = cs.distinct_rows(torch.clamp((ul * num_lights).to(torch.int32),
                                          max=num_lights - 1), 24)
    shade = cs.distinct_rows(hit.prim_id.clamp(min=0),
                             scene.attrs.shade_rec.shape[1])
    cache_b, mat_b = cs.connection_rows(scene, c, fi, conns)
    reads = {n: c[n] for n in ("org", "d", "throughput", "radiance",
                               "active", "d_vc", "d_vcm", "d_vm", "state")}
    vs._lib = libs["redesigned"]
    nxt, sh, q = fn()
    nbytes = (cs.tensor_bytes(reads, hit, nxt, tuple(sh), q) + shade
              + lights + cache_b + mat_b)
    bound_ms, by = cs.shade_bound(nbytes, cs.NUM_RAYS * (
        cs.VCM_LANE_OPS["camera_shade"] + conns
        * cs.VCM_LANE_OPS["connection"]))
    alive = float(c["active"].double().mean())
    cs.log(f"[ab] vcm_camera_shade_kernel, {label}, camera bounce {bounce}, "
           f"{conns} connection{'s' if conns > 1 else ''}, {alive:.4f} "
           f"alive on entry: earlier {fmt(earlier)} ms, redesigned "
           f"{fmt(new)} ms, bound {bound_ms:.4f} ms by {by} ({nbytes} "
           f"bytes); outputs bit-equal but dead lanes' shadow rows "
           f"[{card}]")


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", required=True,
                   help="checkout holding the earlier design")
    args = p.parse_args()
    from imbatracer_torch.scene.build import build_scene
    from imbatracer_torch.scene.generate import CARD, write_instanced_scene
    from imbatracer_torch.scene.procedural import (make_cornell_scene,
                                                   make_still_life_like)

    dev = get_device("cuda")
    card = card_line(dev)
    new = {dp: dp._library(), vs: vs._library()}
    built = earlier_builds(args.root)
    logs = {dp: libbuild.BUILD_INFO.get(dp.LIB.name, {}).get("log", ""),
            vs: libbuild.BUILD_INFO.get(vs.LIB.name, {}).get("log", "")}
    libs = {mod: {"earlier": built[mod][0], "redesigned": new[mod]}
            for mod in (dp, vs)}
    for mod, kernel in ((dp, "dispatch_rows_kernel"),
                        (vs, "vcm_camera_shade_kernel")):
        cs.log(f"[ab] {kernel} ptxas: earlier {ptxas(built[mod][1], kernel)}"
               f"; redesigned {ptxas(logs[mod], kernel)} [{card}]")
    res(dp, libs[dp], "dispatch_rows", card)
    res(vs, libs[vs], "camera_shade", card)

    still = make_still_life_like(device=dev)
    cornell = make_cornell_scene(device=dev)
    tmp = tempfile.mkdtemp(prefix="imba_ab_")
    inst = build_scene(write_instanced_scene(tmp, **CARD), quiet=True,
                       device=dev)
    rows_cases(libs[dp], (("still_life 1920x1080", still, (1920, 1080, 8)),
                          ("cornell 1024x1024", cornell, (1024, 1024, 10)),
                          ("instanced 1920x1080", inst, (1920, 1080, 8))),
               card)
    del inst
    shutil.rmtree(tmp, ignore_errors=True)

    scene, meta = still
    cam, fi, lpc, cap = cs.vcm_frame_inputs(scene, meta, 1920, 1080, 8, dev)
    fi = cs.vcm_working_cache(scene, meta, cam, fi, lpc, cap, 8)
    for bounce in (0, 1, 3):
        for conns in (1, 3):
            camera_case(libs[vs], f"still_life 1920x1080, {lpc} light paths",
                        scene, meta, cam, fi, lpc, bounce, conns, card)
    del fi
    delta = cs.delta_light_cornell(dev)
    cam, fi, lpc, cap = cs.vcm_frame_inputs(*delta, 1024, 1024, 8, dev)
    fi = cs.vcm_working_cache(*delta, cam, fi, lpc, cap, 8)
    camera_case(libs[vs], "cornell with point, spot and dir lights "
                "1024x1024", *delta, cam, fi, lpc, 1, 3, card)
    cs.log("[ab] done")


if __name__ == "__main__":
    main()
