"""The PT bounce's shading: two hand-written CUDA kernels, their plain
PyTorch versions, and the scene tables the kernels read.

No Pallas kernel stands behind these: JAX compiles a whole PT band into
one program (imbatracer_tpu/render/integrators/pt.py `_pt_band`, the
bounce `_pt_bounce`), and XLA fuses the bounce's shading around the
traversal calls into a handful of fusions.  The card's counterpart of
those fusions is one kernel a side of the shadow ray:

  * `pt_shade` does all that the bounce does between its closest hit and
    its shadow ray's any hit, and after them but the NEE add: the
    environment-miss and emitter-hit MIS terms, the surface interaction
    (shade-record row, attribute lerp, kd texture, bump normal), NEE
    light sampling with the BSDF's value and pdf toward the light, the
    shadow ray, Russian roulette and BSDF sampling, and the next carry;
  * `pt_shade_finish` adds the NEE term where the shadow ray was not
    occluded and counts the shadow rays.

The radiance sums keep the plain version's order (env term, emitter
term, NEE), so the films stay as they were.  Both kernels count traced
rays on the card (one atomicAdd a warp onto a copy of the carried
count) and read nothing on the host, so they run inside the captured
bounce (render/graphs.py).

Dispatch: `pt_shade` and `pt_shade_finish` launch the kernels
(csrc/pt_shade.cu, device functions in csrc/shading.cuh) for CUDA
tensors and run the plain versions for CPU tensors; nothing falls back
from one to the other.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import NamedTuple

import numpy as np
import torch

from ..core import rng as rng_mod
from ..core.sampling import mis_power_heuristic, russian_roulette_prob
from ..core.vecmath import dot, normalize
from ..libbuild import NativeLib
from ..render import envmap as envmap_mod
from ..render import lights as light_mod
from ..render import materials as mat_mod
from ..render.intersect import BIG
from ..render.surface import make_interaction
from . import stream_traverse as st

# Launch counts: one per kernel launch on the CUDA route, one per call of
# a plain version.  chip_smoke.py reads them to show the main path ran
# through the kernels.
LAUNCHES = {"pt_shade": 0, "pt_shade_finish": 0, "plain": 0,
            "finish_plain": 0}
PLAIN_KEYS = ("plain", "finish_plain")

# Columns of the canonical shade record (scene/types.py TriAttrs).
SHADE_COLUMNS = 48


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class ShadowRay(NamedTuple):
    pos: torch.Tensor    # (R, 3) origin, the shading point
    dir: torch.Tensor    # (R, 3) toward the sampled light
    tmin: torch.Tensor   # (R,) the offset
    tmax: torch.Tensor   # (R,) the light's distance less the offset
    ok: torch.Tensor     # (R,) bool: the lanes that cast it


# --------------------------------------------------------------------------
# The plain PyTorch versions
# --------------------------------------------------------------------------

def pt_shade_plain(scene, c, hit, *, has_bump: bool, max_len: int):
    """The bounce's shading on the carry `c` and its closest hit `hit`:
    (next carry, ShadowRay, contrib (R, 3)).  The next carry's radiance
    holds the env and emitter terms, its n_rays the closest-hit rays;
    pt_shade_finish adds the NEE term and the shadow rays."""
    LAUNCHES["plain"] += 1
    num_lights = scene.lights.kind.shape[0]
    first = c["depth"] == 0
    n_rays = c["n_rays"] + c["active"].sum()

    # ---- environment misses ----------------------------------------------
    miss = c["active"] & (hit.prim_id < 0)
    radiance = c["radiance"]
    if scene.env is not None:
        li, pdf_direct_w, _ = envmap_mod.radiance(
            scene.env, normalize(c["d"]), scene.bsphere.inv_radius_sqr)
        pdf_di = pdf_direct_w / num_lights
        w = torch.where(first | c["last_specular"], 1.0,
                        mis_power_heuristic(c["last_pdf"], pdf_di))
        radiance = radiance + torch.where(
            miss[..., None], c["throughput"] * li * w[..., None], 0.0)
    active = c["active"] & ~miss

    isect = make_interaction(scene, hit, c["org"], c["d"], has_bump=has_bump)

    # ---- emitter hits ----------------------------------------------------
    is_emitter = active & (isect.light_id >= 0)
    cos_geom = dot(isect.gn, isect.w_out)
    cos_shade = dot(isect.normal, isect.w_out)
    area = torch.clamp(isect.area, min=1e-12)
    d_sqr = hit.t * hit.t
    pdf_di_emit = (1.0 / area) / num_lights * d_sqr / torch.where(
        cos_shade <= 0.0, 1.0, cos_shade)
    w_emit = torch.where(first | c["last_specular"], 1.0,
                         mis_power_heuristic(c["last_pdf"], pdf_di_emit))
    emit_ok = is_emitter & (cos_geom > 0.0) & (cos_shade > 0.0)
    radiance = radiance + torch.where(
        emit_ok[..., None], c["throughput"] * isect.emit * w_emit[..., None],
        0.0)
    active = active & ~is_emitter

    # ---- next-event estimation -------------------------------------------
    st, (ul, ua, ub) = rng_mod.next_floats(c["state"], 3)
    light_idx = torch.clamp((ul * num_lights).to(torch.int32),
                            max=num_lights - 1)
    ds = light_mod.sample_direct(scene.lights, light_idx, isect.pos, ua, ub,
                                 scene.bsphere, scene.env,
                                 kinds=scene.light_kinds)
    f_nee, pdf_hit, _ = mat_mod.eval_pdf_bsdf(
        isect.params, isect.normal, isect.gn, isect.w_out, ds.dir,
        kinds=scene.mat_kinds)
    pdf_lightpick = 1.0 / num_lights
    pdf_di = pdf_lightpick * ds.pdf_direct_w
    w_nee = torch.where(ds.is_delta, 1.0,
                        pdf_di / torch.clamp(pdf_di + pdf_hit, min=1e-20))
    contrib = (c["throughput"] * f_nee * ds.radiance
               * (torch.abs(dot(isect.normal, ds.dir)) * w_nee
                  / pdf_lightpick)[..., None])
    shadow_ok = (active & (pdf_hit > 0.0) & (pdf_di > 0.0)
                 & torch.any(contrib > 0.0, dim=-1))
    offset = 1e-3 * torch.where(ds.distance >= BIG, 1.0, ds.distance)
    shadow = ShadowRay(isect.pos, ds.dir, offset, ds.distance - offset,
                       shadow_ok)

    # ---- bounce ----------------------------------------------------------
    st, (urr, u1, u2, u3) = rng_mod.next_floats(st, 4)
    rr_pdf = russian_roulette_prob(c["throughput"])
    survive = urr < rr_pdf
    wi, f, pdf, spec, valid = mat_mod.sample_bsdf(
        isect.params, isect.normal, isect.gn, isect.w_out, u1, u2, u3,
        kinds=scene.mat_kinds)
    cos_term = torch.abs(dot(isect.normal, wi))
    new_throughput = c["throughput"] * f * (
        cos_term / torch.clamp(pdf * rr_pdf, min=1e-20))[..., None]
    active = active & survive & valid & (c["depth"] + 1 < max_len)
    a3 = active[..., None]
    nxt = dict(
        org=torch.where(a3, isect.pos, c["org"]),
        d=torch.where(a3, wi, c["d"]),
        tmin=torch.where(active, 1e-3 * hit.t, c["tmin"]),
        throughput=torch.where(a3, new_throughput, c["throughput"]),
        radiance=radiance,
        active=active,
        depth=torch.where(active, c["depth"] + 1, c["depth"]),
        last_pdf=torch.where(active, pdf, c["last_pdf"]),
        last_specular=torch.where(active, spec, c["last_specular"]),
        state=st,
        n_rays=n_rays,
    )
    return nxt, shadow, contrib


def pt_shade_finish_plain(radiance, contrib, shadow_ok, occluded, n_rays):
    """(radiance plus contrib where the shadow ray was cast and not
    occluded, n_rays plus the shadow rays)."""
    LAUNCHES["finish_plain"] += 1
    radiance = radiance + torch.where((shadow_ok & ~occluded)[..., None],
                                      contrib, 0.0)
    return radiance, n_rays + shadow_ok.sum()


# --------------------------------------------------------------------------
# The scene tables
# --------------------------------------------------------------------------

def column_map(shade_cols) -> list:
    """For each canonical shade-record column, its position in the
    scene's record (TriAttrs.shade_cols), -1 where it was pruned."""
    pos = [-1] * SHADE_COLUMNS
    for i, col in enumerate(shade_cols):
        pos[col] = i
    return pos


def scalar_divisor(x) -> np.float32:
    """The float32 factor that torch's CUDA division of a float32 tensor
    by the Python scalar `x` multiplies with: the scalar's reciprocal
    (aten's div_true_kernel_cuda on a CPU scalar)."""
    return np.float32(1.0 / x)


# Pointer arguments of imba_pt_shade, in the order of enum Ptr in
# csrc/pt_shade.cu: CARRY_IN, HIT_IN, TABLE_PTRS, CARRY_IN again (out),
# n_rays, ShadowRay's fields, contrib.
CARRY_IN = ("org", "d", "tmin", "throughput", "radiance", "active", "depth",
            "last_pdf", "last_specular", "state")
HIT_IN = ("t", "prim_id", "u", "v")
TABLE_PTRS = ("shade_rec", "light_rec", "texels", "tex_offset", "tex_width",
              "tex_height", "env_img", "env_pdf", "env_row_cdf",
              "env_marginal_cdf")
# Int arguments (enum Int): the scene's, the SHADE_COLUMNS entries of its
# column map, then the call's (lanes, has_bump, max_len); float arguments
# (enum Flt).
TABLE_INTS = ("rows", "cols", "lights", "textures", "texels", "img_h",
              "img_w", "tab_h", "tab_w", "has_env", "has_textures")
TABLE_FLOATS = ("lights_f", "inv_lights", "pick", "inv_pick", "img_wm1",
                "img_hm1", "tab_w_f", "tab_h_f", "inv_tab_w", "inv_tab_h")
# What the VCM kernels (ops/vcm_shade.py) read besides: the material rows
# (a light vertex's material) and the bounding sphere (sample_emit).
EMIT_PTRS = ("mat_rec", "bs_center", "bs_radius", "bs_inv_r2")


class SceneTables:
    """What the shade kernel reads of a scene: the pointers of its shade
    record, light rows, texture atlas and environment tables (tensors
    held here, so they live as long as the tables), the column map, and
    the host facts that torch reads off shapes (the light count, whether
    there are textures and an environment map, the environment's sizes),
    with the float32 constants torch derives from them; and for the VCM
    kernels the pointers of the material rows and the bounding sphere
    (`emit_ptrs`) and the material count."""

    def __init__(self, scene):
        keep = lambda x: x.contiguous()
        attrs, tex, env = scene.attrs, scene.textures, scene.env
        self.tensors = dict(
            shade_rec=keep(attrs.shade_rec), light_rec=keep(scene.lights.rec),
            texels=keep(tex.texels), tex_offset=keep(tex.offset),
            tex_width=keep(tex.width), tex_height=keep(tex.height))
        if env is not None:
            self.tensors.update(
                env_img=keep(env.img), env_pdf=keep(env.pdf_table),
                env_row_cdf=keep(env.row_cdf),
                env_marginal_cdf=keep(env.marginal_cdf))
        self.tensors.update(
            mat_rec=keep(scene.materials.rec),
            bs_center=keep(scene.bsphere.center),
            bs_radius=keep(scene.bsphere.radius),
            bs_inv_r2=keep(scene.bsphere.inv_radius_sqr))
        self.ptrs = [self.tensors[k].data_ptr() if k in self.tensors else None
                     for k in TABLE_PTRS]
        self.emit_ptrs = [self.tensors[k].data_ptr() for k in EMIT_PTRS]
        self.num_mats = scene.materials.rec.shape[0]
        num_lights = scene.lights.kind.shape[0]
        img_h, img_w = (0, 0) if env is None else env.img.shape[:2]
        tab_h, tab_w = (0, 0) if env is None else env.pdf_table.shape
        ints = dict(rows=attrs.shade_rec.shape[0],
                    cols=attrs.shade_rec.shape[1], lights=num_lights,
                    textures=tex.width.shape[0], texels=tex.texels.shape[0],
                    img_h=img_h, img_w=img_w, tab_h=tab_h, tab_w=tab_w,
                    has_env=int(env is not None),
                    has_textures=int(tex.texels.shape[0] > 1))
        self.ints = [int(ints[k]) for k in TABLE_INTS] + column_map(
            attrs.shade_cols)
        pick = 1.0 / num_lights
        floats = dict(lights_f=num_lights, inv_lights=scalar_divisor(
                          num_lights),
                      pick=pick, inv_pick=scalar_divisor(pick),
                      img_wm1=img_w - 1, img_hm1=img_h - 1, tab_w_f=tab_w,
                      tab_h_f=tab_h,
                      inv_tab_w=scalar_divisor(tab_w) if tab_w else 0.0,
                      inv_tab_h=scalar_divisor(tab_h) if tab_h else 0.0)
        self.floats = [float(np.float32(floats[k])) for k in TABLE_FLOATS]


_TABLES = {}


def tables_for(scene) -> SceneTables:
    """The SceneTables of `scene`, made at first use and dropped when the
    scene is collected."""
    key = id(scene)
    t = _TABLES.get(key)
    if t is None:
        t = _TABLES[key] = SceneTables(scene)
        weakref.finalize(scene, _TABLES.pop, key, None)
    return t


# --------------------------------------------------------------------------
# The CUDA kernels
# --------------------------------------------------------------------------

LIB = NativeLib("pt_shade", "pt_shade.cu", headers=("shading.cuh",))

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(LIB.build())
        fn = lib.imba_pt_shade
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn = lib.imba_pt_shade_finish
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int,
                                                ctypes.c_void_p]
        fn = lib.imba_pt_shade_resources
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
        _lib = lib
    return _lib


def _column(x, dtype, shape, what):
    if x.device.type != "cuda" or x.dtype != dtype or tuple(
            x.shape) != shape:
        raise ValueError(f"pt_shade: {what} must be a CUDA {dtype} tensor of "
                         f"shape {shape}, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    return x.contiguous()


def _carry_inputs(c, hit):
    """The carry and hit columns as the kernel reads them, checked."""
    lanes = c["active"].shape[0]
    f, i32 = torch.float32, torch.int32
    v3, v1 = (lanes, 3), (lanes,)
    kinds = dict(org=(f, v3), d=(f, v3), tmin=(f, v1), throughput=(f, v3),
                 radiance=(f, v3), active=(torch.bool, v1), depth=(i32, v1),
                 last_pdf=(f, v1), last_specular=(torch.bool, v1),
                 state=(torch.int64, v1))
    cols = [_column(c[k], *kinds[k], k) for k in CARRY_IN]
    cols += [_column(getattr(hit, k), i32 if k == "prim_id" else f, v1,
                     f"hit.{k}") for k in HIT_IN]
    return lanes, cols


def pt_shade_cuda(scene, c, hit, *, has_bump: bool, max_len: int):
    """Launch pt_shade_kernel on CUDA tensors (raises on anything else):
    pt_shade_plain's outputs, computed a lane a thread."""
    lanes, cols = _carry_inputs(c, hit)
    n_rays = _column(c["n_rays"], torch.int64, (), "n_rays")
    lib = _library()
    tables = tables_for(scene)
    nxt = {k: torch.empty_like(v) for k, v in zip(CARRY_IN, cols)}
    nxt["n_rays"] = n_rays.clone()
    vec, lane = nxt["org"], nxt["tmin"]
    shadow = ShadowRay(torch.empty_like(vec), torch.empty_like(vec),
                       torch.empty_like(lane), torch.empty_like(lane),
                       torch.empty_like(nxt["active"]))
    contrib = torch.empty_like(vec)
    ptrs = ([x.data_ptr() for x in cols] + tables.ptrs
            + [nxt[k].data_ptr() for k in CARRY_IN]
            + [nxt["n_rays"].data_ptr()] + [x.data_ptr() for x in shadow]
            + [contrib.data_ptr()])
    ints = tables.ints + [lanes, int(has_bump), int(max_len)]
    p_arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    i_arr = (ctypes.c_int * len(ints))(*ints)
    f_arr = (ctypes.c_float * len(tables.floats))(*tables.floats)
    stream = torch.cuda.current_stream(cols[0].device).cuda_stream
    err = lib.imba_pt_shade(p_arr, len(ptrs), i_arr, len(ints), f_arr,
                            len(tables.floats), stream)
    if err != 0:
        raise RuntimeError(f"pt_shade kernel launch failed: CUDA error {err}")
    LAUNCHES["pt_shade"] += 1
    return nxt, shadow, contrib


def pt_shade_finish_cuda(radiance, contrib, shadow_ok, occluded, n_rays):
    """Launch pt_shade_finish_kernel on CUDA tensors (raises on anything
    else)."""
    lanes = radiance.shape[0]
    radiance = _column(radiance, torch.float32, (lanes, 3), "radiance")
    contrib = _column(contrib, torch.float32, (lanes, 3), "contrib")
    shadow_ok = _column(shadow_ok, torch.bool, (lanes,), "shadow_ok")
    occluded = _column(occluded, torch.bool, (lanes,), "occluded")
    n_rays = _column(n_rays, torch.int64, (), "n_rays")
    lib = _library()
    out, count = torch.empty_like(radiance), n_rays.clone()
    stream = torch.cuda.current_stream(radiance.device).cuda_stream
    err = lib.imba_pt_shade_finish(
        radiance.data_ptr(), contrib.data_ptr(), shadow_ok.data_ptr(),
        occluded.data_ptr(), out.data_ptr(), count.data_ptr(), lanes, stream)
    if err != 0:
        raise RuntimeError(f"pt_shade_finish kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["pt_shade_finish"] += 1
    return out, count


def resources(finish: bool = False):
    """Registers, shared memory, spills and resident blocks an SM of
    pt_shade_kernel (or pt_shade_finish_kernel) (needs the card)."""
    return st._resources(_library().imba_pt_shade_resources, int(finish))


# --------------------------------------------------------------------------
# Dispatch
# --------------------------------------------------------------------------

def pt_shade(scene, c, hit, *, has_bump: bool, max_len: int):
    """The bounce's shading: the kernel on CUDA tensors, the plain version
    on CPU tensors.  Returns (next carry, ShadowRay, contrib)."""
    dev = c["active"].device
    if dev.type == "cuda":
        return pt_shade_cuda(scene, c, hit, has_bump=has_bump,
                             max_len=max_len)
    if dev.type == "cpu":
        return pt_shade_plain(scene, c, hit, has_bump=has_bump,
                              max_len=max_len)
    raise ValueError(f"unsupported device {dev}")


def pt_shade_finish(radiance, contrib, shadow_ok, occluded, n_rays):
    """The NEE add and the shadow-ray count: the kernel on CUDA tensors,
    the plain version on CPU tensors.  Returns (radiance, n_rays)."""
    if radiance.device.type == "cuda":
        return pt_shade_finish_cuda(radiance, contrib, shadow_ok, occluded,
                                    n_rays)
    if radiance.device.type == "cpu":
        return pt_shade_finish_plain(radiance, contrib, shadow_ok, occluded,
                                     n_rays)
    raise ValueError(f"unsupported device {radiance.device}")
