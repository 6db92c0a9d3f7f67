"""The VCM family's bounce shading (imbatracer_torch/ops/vcm_shade.py) on
the CPU.

* A light band against JAX: the port's `_light_pass` (light_start,
  closest hit, the plain light_shade, any hit, the plain light_finish, the
  band's one append and one splat) and JAX's `_light_pass`
  (imbatracer_tpu/render/integrators/vcm.py, its exact traversal,
  max_steps=0) on the same band, for vcm, bpt and lt, on the five scenes
  of torch_shade_cases.SCENES and on a band half dead on entry (the
  cornell with a dark copy of its light: the paths picking it start
  dead).  JAX's closest hit is replaced by the
  port's hits, bounce by bounce (its `fori_loop` run as a Python loop in
  that module alone, so each bounce takes its own hits).  The film, the
  collected vertex rows and their count are compared.
* A camera bounce against JAX: the port's `_camera_bounce` against JAX's
  `_camera_body_fn(...)` body on the same carry, made from a numpy seed,
  at bounce 0 and at mixed depths (bounce 2), with a light cache from a
  light pass, for vcm, bpt, ppm and pt, num_connections 1 and 3, and a
  technique subset.  JAX's closest hit is replaced by the port's; the
  merge of both sides is replaced by a recorder, and the recorded query
  columns are compared (the merge itself: tests/test_torch_merge.py).
* The same on bands dead on entry and half dying at the miss or emitter
  test (what the camera kernel finishes in its first phase), and the
  shadow rows of lanes dead on entry: DEAD_SHADOW, the carry kept.  A
  light bounce on light bands all and half dead on entry: a lane that
  does not go on writes DEAD_LIGHT's rows and keeps its carry, a live
  lane's outputs are those it has beside live neighbours.
* Tolerance, as tests/test_torch_shade.py's: RNG state, flags, counts and
  pixel ids equal; floats within 1e-5 * max(1, |x|) on all lanes but at
  most 1% of them, those within 1e-3.
* The binding's argument lists against the enums of csrc/vcm_shade.cu,
  its dead-row constants against DEAD_SHADOW and DEAD_LIGHT, and CPU
  tensors never build the kernels' library.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imbatracer_tpu.render import lights as jlights
from imbatracer_tpu.render.camera import make_camera as jcamera
from imbatracer_tpu.render.integrators import vcm as jvcm
from imbatracer_tpu.render.light_cache import LightVertexCache as JCache
from imbatracer_tpu.render.traverse import Hit as JHit
from imbatracer_tpu.scene import procedural as jproc
from imbatracer_torch import libbuild
from imbatracer_torch.convert import scene_from_numpy, scene_to_numpy
from imbatracer_torch.core import rng as trng
from imbatracer_torch.ops import shade as sh
from imbatracer_torch.ops import vcm_shade as vs
from imbatracer_torch.render import light_cache as tlc
from imbatracer_torch.render import materials as mat_mod
from imbatracer_torch.render import traverse as tt
from imbatracer_torch.render.camera import make_camera as tcamera
from imbatracer_torch.render.integrators import vcm as tvcm
from imbatracer_torch.render.surface import make_interaction
from torch_shade_cases import (SCENES, SMALL_STILL_LIFE, carry_arrays,
                               dying_lanes, light_rows, with_delta_lights)
from torch_threads import cap_torch_threads

cap_torch_threads()

REL = 1e-5
LOBE_SHARE, LOBE_REL = 0.01, 1e-3
W = 24                 # square: the port's pixel area is JAX's 1
LPC, MAX_LEN, FRAME, RADIUS = 192, 4, 3, 0.05
LANES = 256
INT_COLS = (14, 21, 22)   # mat_id, path_length, path_id of a packed row


def _close(a, b, name):
    """|a - b| <= REL * max(1, |b|) on every lane but at most LOBE_SHARE
    of them, which stay within LOBE_REL * max(1, |b|)
    (tests/test_torch_shade.py's bound).  Equal values, infinities
    included, and NaN against NaN agree (a dead lane's partial weights
    carry the miss distance's square)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    same = (a == b) | (np.isnan(a) & np.isnan(b))
    with np.errstate(invalid="ignore"):
        err = np.where(same, 0.0, np.abs(a - b) / np.maximum(1.0, np.abs(b)))
    err = np.where(np.isnan(err), np.inf, err)
    err = err.reshape(err.shape[0], -1).max(axis=1)
    assert (err > REL).mean() <= LOBE_SHARE, (name, np.nonzero(err > REL))
    assert err.max() <= LOBE_REL, (name, err.max())


def _jax_scene(name):
    if name == "cornell":
        return jproc.make_cornell_scene()
    if name == "specular":
        return jproc.make_cornell_scene(mirror_box=True, glass_sphere=True)
    if name == "still_life":
        return jproc.make_still_life_like(**SMALL_STILL_LIFE)
    if name == "bumped":
        return jproc.make_bumped_scene()
    js, meta = jproc.make_cornell_scene()
    if name == "half_dark":
        rows = light_rows(js.lights)
        dark = [dict(r, intensity=np.zeros(3, np.float32)) for r in rows]
        return dataclasses.replace(
            js, lights=jlights.build_light_table(rows + dark)), meta
    return with_delta_lights(js, jlights.build_light_table), meta


# The light band's scenes: the shade cases and the cornell with a dark
# copy of its light appended, whose paths past the first half (the
# uniform split of the path index over the lights) pick the dark light and
# start dead.
LIGHT_SCENES = SCENES + ("half_dark",)


@pytest.fixture(scope="module")
def scenes():
    """name -> (JAX scene, the port's scene from the same arrays, meta)."""
    out = {}
    for name in LIGHT_SCENES:
        js, meta = _jax_scene(name)
        out[name] = (js, scene_from_numpy(scene_to_numpy(js), "cpu"), meta)
    return out


def _cams(meta):
    args = (meta.cam_pos, meta.cam_dir, meta.cam_up, W, W, 60.0)
    return jcamera(*args), tcamera(*args, device="cpu")


def _constants(algo):
    frame = torch.tensor(FRAME, dtype=torch.int64)
    base = torch.tensor(RADIUS, dtype=torch.float32)
    pm_radius, eta_vc, eta_vm = tvcm._mis_constants(frame, base, LPC, algo)
    return frame, base, pm_radius, eta_vc, eta_vm


class _PyLoopJax:
    """`jax` as the JAX vcm module sees it, its fori_loop a Python loop, so
    a replaced closest hit can return each bounce's own hits."""

    class _Lax:
        def __getattr__(self, k):
            return getattr(jax.lax, k)

        @staticmethod
        def fori_loop(lo, hi, body, init):
            c = init
            for i in range(lo, hi):
                c = body(i, c)
            return c

    lax = _Lax()

    def __getattr__(self, k):
        return getattr(jax, k)


def _recorded_hits(monkeypatch, module):
    """Record the hits of `module.closest_hit` (the port's)."""
    hits = []

    def closest_hit(*a, **k):
        hits.append(tt.closest_hit(*a, **k))
        return hits[-1]
    monkeypatch.setattr(module, "closest_hit", closest_hit)
    return hits


def _replay_hits(monkeypatch, hits):
    """JAX's closest hit returns the port's `hits` in order."""
    it = iter(hits)
    monkeypatch.setattr(jvcm, "closest_hit", lambda *a, **k: JHit(
        *(jnp.asarray(x.numpy()) for x in next(it))))


def _port_light_pass(ts, meta, cam, algo, collect, monkeypatch=None,
                     **kw):
    frame, _, _, eta_vc, eta_vm = _constants(algo)
    hits = (_recorded_hits(monkeypatch, tvcm) if monkeypatch is not None
            else None)
    film = tvcm._light_pass(
        ts, cam, frame, eta_vc, eta_vm, collect, algo=algo,
        num_pixels=W * W, light_path_count=LPC, max_len=MAX_LEN,
        alpha_fn=tvcm.alpha_fn_for(ts) if meta.has_masks else None,
        has_bump=meta.has_bump, **kw)
    return film, hits


@pytest.mark.parametrize("algo", ["vcm", "bpt", "lt"])
@pytest.mark.parametrize("name", LIGHT_SCENES)
def test_light_pass_matches_jax(name, algo, scenes, monkeypatch):
    js, ts, meta = scenes[name]
    jcam, tcam = _cams(meta)
    if name == "half_dark":
        frame, _, _, eta_vc, _ = _constants(algo)
        start = vs.light_start_plain(ts, frame, eta_vc, lanes=LPC,
                                     light_path_count=LPC)
        assert not start["active"][LPC // 2:].any()
        assert start["active"][:LPC // 2].all()
    collect = None if algo == "lt" else tlc.empty_collect(LPC * MAX_LEN,
                                                          "cpu")
    before = dict(vs.LAUNCHES)
    film, hits = _port_light_pass(ts, meta, tcam, algo, collect, monkeypatch)
    assert len(hits) == MAX_LEN
    assert vs.LAUNCHES["light_start_plain"] == before["light_start_plain"] + 1
    assert (vs.LAUNCHES["light_shade_plain"]
            == before["light_shade_plain"] + MAX_LEN)
    assert (vs.LAUNCHES["light_finish_plain"]
            == before["light_finish_plain"] + MAX_LEN)

    frame, base, pm_radius, eta_vc, eta_vm = (
        jnp.asarray(x.numpy()) for x in _constants(algo))
    _replay_hits(monkeypatch, hits)
    monkeypatch.setattr(jvcm, "jax", _PyLoopJax())
    jfilm, jcache = jvcm._light_pass(
        js, jcam, frame.astype(jnp.uint32), pm_radius, base, eta_vc, eta_vm,
        algo=algo, num_pixels=W * W, light_path_count=LPC, max_len=MAX_LEN,
        cache_capacity=LPC * MAX_LEN, has_masks=meta.has_masks,
        has_bump=meta.has_bump,
        alpha_fn=jvcm.alpha_fn_for(js) if meta.has_masks else None,
        max_steps=0)
    jfilm = np.asarray(jfilm)
    _close(film.numpy(), jfilm, "film")
    if algo != "lt":
        assert jfilm.sum() > 0.0
    if collect is None:
        return
    count = int(collect.count)
    assert count == int(jcache.count) and count > 0
    got = collect.rec[:count].numpy()
    want = np.asarray(jcache.packed())[:count]
    ints = list(INT_COLS)
    np.testing.assert_array_equal(got[:, ints].view(np.int32),
                                  want[:, ints].view(np.int32))
    floats = [k for k in range(tlc.REC_W) if k not in INT_COLS]
    _close(got[:, floats], want[:, floats], "vertex rows")


_CACHES = {}


def _light_cache(ts, meta, algo):
    """The working cache of one light pass of `algo` (the port's, plain),
    made once a scene."""
    key = (id(ts), algo)
    if key not in _CACHES:
        _, tcam = _cams(meta)
        collect = tlc.empty_collect(LPC * MAX_LEN, "cpu")
        _port_light_pass(ts, meta, tcam, algo, collect)
        _CACHES[key] = tlc.select_shallowest(
            collect.cache(), tvcm.auto_cache_capacity(LPC, MAX_LEN))
    return _CACHES[key]


def _camera_carry(meta, seed, mixed):
    """A camera carry as numpy arrays: carry_arrays' rays, throughput,
    radiance, activity and RNG words, with partial MIS weights (bounce 0:
    d_vc = d_vm = 0)."""
    a = carry_arrays(meta, LANES, seed=seed, mixed=mixed)
    rs = np.random.RandomState(seed + 100)
    a = {k: v for k, v in a.items()
         if k not in ("depth", "last_pdf", "last_specular")}
    a["d_vcm"] = rs.uniform(0.5, 50.0, LANES).astype(np.float32)
    zero = np.zeros(LANES, np.float32)
    a["d_vc"] = rs.uniform(0.0, 2.0, LANES).astype(np.float32) if mixed \
        else zero
    a["d_vm"] = rs.uniform(0.0, 3.0, LANES).astype(np.float32) if mixed \
        else zero
    return a


QUERY_COLS = ("pos", "normal", "gn", "w_out", "d_vcm", "d_vm", "active",
              "throughput", "kind", "kd", "ks", "ns")


def _query_cols(q):
    """The merge query's columns by name (either side)."""
    host = lambda x: np.asarray(x.numpy() if torch.is_tensor(x) else x)
    p = q["params"]
    cols = {k: host(q[k]) for k in QUERY_COLS[:8]}
    cols.update({k: host(p[k]) for k in ("kind", "kd", "ks", "ns")})
    return cols


CAMERA_CASES = [
    ("vcm", 1, None), ("vcm", 3, None), ("bpt", 1, None), ("bpt", 3, None),
    ("ppm", 1, None), ("pt", 1, None),
    ("vcm", 3, ("light_hit", "connect", "merge")),
    ("bpt", 1, ("next_event", "cam_connect"))]


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("algo,conns,techniques", CAMERA_CASES)
@pytest.mark.parametrize("name", SCENES)
def test_camera_bounce_matches_jax(name, algo, conns, techniques, mixed,
                                   scenes, monkeypatch):
    _, _, meta = scenes[name]
    _camera_bounce_vs_jax(
        scenes, monkeypatch, name, algo, conns,
        techniques or tvcm.TECHNIQUES, 2 if mixed else 0,
        _camera_carry(meta, SCENES.index(name) + 10 * mixed, mixed))


def _tri_light(ts):
    """(p0, p1, p2, normal) of the port's scene's first triangle light."""
    lt = ts.lights
    k = int(torch.nonzero(lt.kind == 0)[0, 0])
    return tuple(x[k].numpy() for x in (lt.p0, lt.p1, lt.p2, lt.normal))


def _dead_band(ts, meta, band, seed):
    """A mixed camera carry whose lanes are all dead on entry, or whose
    half die at the bounce's miss or emitter test (dying_lanes)."""
    arrays = _camera_carry(meta, seed, True)
    if band == "all_dead":
        arrays["active"][:] = False
        return arrays
    return dying_lanes(arrays, _tri_light(ts), ts.bsphere.center.numpy(),
                       float(ts.bsphere.radius), seed)


@pytest.mark.parametrize("algo,conns", [("vcm", 3), ("bpt", 1)])
@pytest.mark.parametrize("name", ["cornell", "still_life"])
@pytest.mark.parametrize("band", ["all_dead", "half_dead"])
def test_camera_bounce_on_dead_bands_matches_jax(band, name, algo, conns,
                                                 scenes, monkeypatch):
    """The plain camera bounce against JAX's camera body on a band dead
    on entry and on one whose half dies at the miss or emitter test (the
    lanes the camera kernel finishes in its first phase): the next carry,
    its radiance after the shadow sets and the merge query."""
    _, ts, meta = scenes[name]
    arrays = _dead_band(ts, meta, band, 41 + SCENES.index(name))
    if band == "half_dead":
        hit = tt.closest_hit(ts.bvh, torch.as_tensor(arrays["org"]),
                             torch.as_tensor(arrays["d"]),
                             torch.as_tensor(arrays["tmin"]), tvcm.BIG,
                             alpha_fn=tvcm.alpha_fn_for(ts)
                             if meta.has_masks else None,
                             active=torch.as_tensor(arrays["active"]))
        isect = make_interaction(ts, hit, torch.as_tensor(arrays["org"]),
                                 torch.as_tensor(arrays["d"]))
        dies = (hit.prim_id < 0) | (isect.light_id >= 0)
        assert float(dies.double().mean()) >= 0.45
    _camera_bounce_vs_jax(scenes, monkeypatch, name, algo, conns,
                          tvcm.TECHNIQUES, 2, arrays,
                          lit=band == "half_dead")


def _camera_bounce_vs_jax(scenes, monkeypatch, name, algo, conns, techniques,
                          i, arrays, lit=True):
    """The port's _camera_bounce (its plain shading) against JAX's
    _camera_body_fn body at bounce i on the carry `arrays`, JAX's closest
    hit and both merges replaced (module docstring); with `lit`, some
    lane's radiance must have grown."""
    js, ts, meta = scenes[name]
    cache = _light_cache(ts, meta, algo) if algo in ("vcm", "bpt") else None
    _, base, pm_radius, eta_vc, eta_vm = _constants(algo)
    alpha = tvcm.alpha_fn_for(ts) if meta.has_masks else None

    hits = _recorded_hits(monkeypatch, tvcm)
    merges = []

    def record_merge(grid, isect, throughput, d_vcm, d_vm, active, radiance,
                     *a, **k):
        merges.append(dict(isect._asdict(), throughput=throughput,
                           d_vcm=d_vcm, d_vm=d_vm, active=active))
        return radiance
    monkeypatch.setattr(tvcm, "_vertex_merging", record_merge)
    c = {k: torch.as_tensor(v) for k, v in arrays.items() if k != "state"}
    c["state"] = torch.as_tensor(arrays["state"].astype(np.int64))
    c["n_rays"] = torch.zeros((), dtype=torch.int64)
    before = dict(vs.LAUNCHES)
    got = tvcm._camera_bounce(
        ts, c, i, cache_count=None if cache is None else cache.count,
        cache_rec=None if cache is None else cache.packed(), grid=None,
        pm_radius=pm_radius, base_radius=base, mis_eta_vc=eta_vc,
        mis_eta_vm=eta_vm, algo=algo, max_len=MAX_LEN,
        light_path_count=LPC, num_connections=conns, has_bump=meta.has_bump,
        alpha_fn=alpha, techniques=techniques, mat_kinds=ts.mat_kinds)
    sets = vs.shadow_sets(algo, techniques, conns)
    assert (vs.LAUNCHES["camera_shade_plain"]
            == before["camera_shade_plain"] + 1)
    assert (vs.LAUNCHES["camera_finish_plain"]
            == before["camera_finish_plain"] + int(sets > 0))
    merge = algo in ("vcm", "ppm") and "merge" in techniques
    assert len(merges) == int(merge)

    jmerges = []

    def jrecord_merge(scene, cache, cache_rec, grid, isect, throughput,
                      d_vcm, d_vm, active, radiance, *a, **k):
        jmerges.append(dict(pos=isect.pos, normal=isect.normal, gn=isect.gn,
                            w_out=isect.w_out, params=isect.params,
                            throughput=throughput, d_vcm=d_vcm, d_vm=d_vm,
                            active=active))
        return radiance
    monkeypatch.setattr(jvcm, "_vertex_merging", jrecord_merge)
    _replay_hits(monkeypatch, hits)
    jcache = None if cache is None else JCache(**{
        f: jnp.asarray(getattr(cache, f).numpy())
        for f in ("pos", "w_out", "normal", "gn", "uv", "mat_id",
                  "throughput", "d_vc", "d_vcm", "d_vm", "path_length",
                  "path_id", "count")})
    j = lambda x: jnp.asarray(x.numpy())
    body = jvcm._camera_body_fn(
        js, jcache, None, j(pm_radius), j(base), j(eta_vc), j(eta_vm),
        algo=algo, max_len=MAX_LEN, light_path_count=LPC,
        num_connections=conns, num_knn=0, table_size=0, max_per_cell=0,
        has_bump=meta.has_bump,
        alpha_fn=jvcm.alpha_fn_for(js) if meta.has_masks else None,
        max_steps=0, techniques=techniques, mat_kinds=ts.mat_kinds)
    want = body(i, {k: jnp.asarray(v) for k, v in arrays.items()})
    want = {k: np.asarray(v) for k, v in want.items()}

    assert set(got) - {"n_rays"} == set(want)
    np.testing.assert_array_equal(
        got["state"].numpy() & 0xFFFFFFFF,
        want["state"].astype(np.int64) & 0xFFFFFFFF)
    np.testing.assert_array_equal(got["active"].numpy(), want["active"])
    for k in set(want) - {"state", "active"}:
        _close(got[k].numpy(), want[k], k)
    assert int(got["n_rays"]) >= int(arrays["active"].sum())
    if merge:
        a, b = _query_cols(merges[0]), _query_cols(jmerges[0])
        for k in ("active", "kind"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for k in set(a) - {"active", "kind"}:
            _close(a[k], b[k], f"merge {k}")
    # The bounce did work: light arrived where the techniques allow it.
    if lit and algo != "ppm" and techniques == tvcm.TECHNIQUES:
        assert (got["radiance"].numpy() > arrays["radiance"]).any()


@pytest.mark.parametrize("algo,conns", [("vcm", 3), ("bpt", 1), ("ppm", 1),
                                        ("pt", 1)])
def test_dead_lanes_write_the_dead_shadow_rows(algo, conns, scenes):
    """camera_shade_plain on a band whose half is dead on entry: a dead
    lane's shadow rows hold DEAD_SHADOW (no ray, no light), its merge
    query is off, and its next carry is its carry kept -- inactive, no
    ray, its throughput and radiance, tmin from its hit, its RNG word past
    the body's draws (NEE's 3, one a connection, the bounce's 4).  The
    camera kernel returns early on such a lane and writes the same
    (tests/test_torch_kernel_cuda.py)."""
    _, ts, meta = scenes["cornell"]
    cache = _light_cache(ts, meta, algo) if algo in ("vcm", "bpt") else None
    arrays = _camera_carry(meta, 23, True)
    arrays["active"][::2] = False
    c = {k: torch.as_tensor(v) for k, v in arrays.items() if k != "state"}
    c["state"] = torch.as_tensor(arrays["state"].astype(np.int64))
    hit = tt.closest_hit(ts.bvh, c["org"], c["d"], c["tmin"], tvcm.BIG,
                         active=c["active"], sort=True)
    _, base, _, eta_vc, eta_vm = _constants(algo)
    nxt, sets, q = vs.camera_shade_plain(
        ts, c, hit, 2, cache_count=None if cache is None else cache.count,
        cache_rec=None if cache is None else cache.packed(),
        base_radius=base, mis_eta_vc=eta_vc, mis_eta_vm=eta_vm, algo=algo,
        max_len=MAX_LEN, light_path_count=LPC, num_connections=conns,
        has_bump=False, techniques=tvcm.TECHNIQUES)
    dead = ~c["active"]
    n_sets = vs.shadow_sets(algo, tvcm.TECHNIQUES, conns)
    if n_sets:
        rows = dead.repeat(n_sets)
        for field, value in zip(vs.ShadowSets._fields, vs.DEAD_SHADOW):
            assert (getattr(sets, field)[rows] == value).all(), field
        assert sets.ok[~rows].any()
    else:
        assert sets is None
    assert not q.active[dead].any() and not nxt["active"][dead].any()
    assert (nxt["org"][dead] == 0).all() and (nxt["d"][dead] == 0).all()
    for k in ("throughput", "radiance"):
        np.testing.assert_array_equal(nxt[k][dead].numpy(),
                                      c[k][dead].numpy(), err_msg=k)
    np.testing.assert_array_equal(nxt["tmin"][dead].numpy(),
                                  (hit.t * 1e-4)[dead].numpy())
    draws = ((0 if algo == "ppm" else 3)
             + (conns if algo in ("vcm", "bpt") else 0) + 4)
    state, _ = trng.next_floats(c["state"], draws)
    np.testing.assert_array_equal(nxt["state"][dead].numpy(),
                                  state[dead].numpy())


@pytest.mark.parametrize("algo", ["vcm", "lt", "ppm"])
@pytest.mark.parametrize("band", ["all_dead", "half_dead"])
def test_light_shade_on_dead_bands(band, algo, scenes):
    """light_shade_plain at light bounce 1 of the specular cornell's band
    with all of its lanes, or every other one, dead on entry: a lane that
    does not go on past the hit test (dead on entry, a miss, a grazing
    hit or an emitter) writes DEAD_LIGHT's rows and keeps its carry --
    inactive, no ray, its throughput and partial weights as they came,
    tmin from its hit, its RNG word past the bounce's 4 draws; a live
    lane's rows, connection, shadow ray and next carry are bit for bit
    those it has in the same band with every lane alive.  The light
    kernel finishes such a lane in its first phase and writes the same
    (tests/test_torch_kernel_cuda.py)."""
    _, ts, meta = scenes["specular"]
    _, cam = _cams(meta)
    frame, _, _, eta_vc, eta_vm = _constants(algo)
    kw = dict(mis_eta_vc=eta_vc, mis_eta_vm=eta_vm, algo=algo,
              light_path_count=LPC, max_len=MAX_LEN, has_bump=False,
              pixel_area=tvcm.pixel_area(cam))
    use_cache, use_cc = algo != "lt", algo != "ppm"

    def closest(c):
        return tt.closest_hit(ts.bvh, c["org"], c["d"], c["tmin"], tvcm.BIG,
                              active=c["active"], sort=True)

    def shade(c, hit, i):
        rows = vs.light_rows(LPC, 1, use_cache, use_cc, "cpu")
        nxt, shadow = vs.light_shade_plain(ts, cam, c, closest(c) if hit
                                           is None else hit, i, rows, **kw)
        return nxt, shadow, rows

    c = vs.light_start_plain(ts, frame, eta_vc, lanes=LPC,
                             light_path_count=LPC)
    c, _, _ = shade(c, None, 0)
    hit = closest(c)
    dying = dict(c, active=c["active"].clone())
    dying["active"][::1 if band == "all_dead" else 2] = False
    nxt, shadow, rows = shade(dying, hit, 1)
    ref_nxt, ref_shadow, ref_rows = shade(c, hit, 1)

    isect = make_interaction(ts, hit, c["org"], c["d"])
    cos_o = torch.abs(isect.w_out.mul(isect.normal).sum(-1))
    live = (dying["active"] & (hit.prim_id >= 0) & (cos_o > 0.0)
            & (isect.light_id < 0))
    dead = ~live
    assert live.any() == (band == "half_dead")
    assert (dead & c["active"] & (hit.prim_id >= 0)).any() or band == (
        "all_dead")
    outs = {}
    if use_cache:
        outs.update(rec=(rows.rec, ref_rows.rec),
                    store=(rows.store, ref_rows.store))
    if use_cc:
        outs.update(cc=(rows.cc, ref_rows.cc),
                    pixel=(rows.pixel, ref_rows.pixel))
        outs.update({k: (getattr(shadow, k), getattr(ref_shadow, k))
                     for k in sh.ShadowRay._fields})
    else:
        assert shadow is None
    for k, (x, y) in outs.items():
        assert (x[dead] == getattr(vs.DEAD_LIGHT, k)).all(), k
        np.testing.assert_array_equal(x[live].numpy(), y[live].numpy(),
                                      err_msg=k)
    assert not nxt["active"][dead].any()
    assert (nxt["org"][dead] == 0).all() and (nxt["d"][dead] == 0).all()
    for k in ("throughput", "d_vc", "d_vcm", "d_vm"):
        np.testing.assert_array_equal(nxt[k][dead].numpy(),
                                      dying[k][dead].numpy(), err_msg=k)
    np.testing.assert_array_equal(nxt["tmin"][dead].numpy(),
                                  (hit.t * 1e-4)[dead].numpy())
    state, _ = trng.next_floats(dying["state"], 4)
    np.testing.assert_array_equal(nxt["state"].numpy(), state.numpy())
    for k, v in nxt.items():
        np.testing.assert_array_equal(v[live].numpy(),
                                      ref_nxt[k][live].numpy(), err_msg=k)


def test_camera_finish_adds_the_sets_in_order(scenes):
    """camera_shade then camera_finish: each set's contrib is added exactly
    where its ray was cast and not occluded, in set order, and the cast
    rays are counted; the plain light finish keeps a row where its ray
    was cast and not occluded."""
    _, ts, meta = scenes["cornell"]
    cache = _light_cache(ts, meta, "vcm")
    arrays = _camera_carry(meta, 7, True)
    c = {k: torch.as_tensor(v) for k, v in arrays.items() if k != "state"}
    c["state"] = torch.as_tensor(arrays["state"].astype(np.int64))
    c["n_rays"] = torch.zeros((), dtype=torch.int64)
    _, base, _, eta_vc, eta_vm = _constants("vcm")
    hit = tt.closest_hit(ts.bvh, c["org"], c["d"], c["tmin"], tvcm.BIG,
                         active=c["active"], sort=True)
    nxt, shadow, q = vs.camera_shade(
        ts, c, hit, 1, cache_count=cache.count, cache_rec=cache.packed(),
        base_radius=base, mis_eta_vc=eta_vc, mis_eta_vm=eta_vm, algo="vcm",
        max_len=MAX_LEN, light_path_count=LPC, num_connections=3,
        has_bump=False, techniques=tvcm.TECHNIQUES)
    assert int(nxt["n_rays"]) == int(c["active"].sum())
    assert shadow.ok.shape == (4 * LANES,) and q.pos.shape == (LANES, 3)
    occ = torch.zeros_like(shadow.ok)
    occ[::3] = True
    rad, n = vs.camera_finish(nxt["radiance"], shadow.contrib, shadow.ok,
                              occ, nxt["n_rays"])
    want = nxt["radiance"].clone()
    for k in range(4):
        sl = slice(k * LANES, (k + 1) * LANES)
        lit = shadow.ok[sl] & ~occ[sl]
        want = want + torch.where(lit[:, None], shadow.contrib[sl], 0.0)
    np.testing.assert_array_equal(rad.numpy(), want.numpy())
    assert int(n) == int(nxt["n_rays"]) + int(shadow.ok.sum())
    assert (shadow.ok & ~occ).any() and (shadow.ok & occ).any()

    contrib = torch.rand(LANES, 3)
    pixel = torch.arange(LANES, dtype=torch.int32)
    ok = torch.rand(LANES) < 0.7
    occ = torch.rand(LANES) < 0.4
    keep = ok & ~occ
    c0, p0 = contrib.clone(), pixel.clone()
    vs.light_finish(contrib, pixel, ok, occ)
    np.testing.assert_array_equal(contrib.numpy(),
                                  torch.where(keep[:, None], c0, 0.0).numpy())
    np.testing.assert_array_equal(pixel.numpy(),
                                  torch.where(keep, p0, -1).numpy())


def test_light_start_pads_past_the_band_end(scenes):
    """Lanes at or past path_end are dead from the start; the others are
    the unpadded band's, and the light pick splits the global path index
    over the lights."""
    _, ts, _ = scenes["delta_lights"]
    _, _, _, eta_vc, _ = _constants("vcm")
    kw = dict(lanes=64, light_path_count=LPC)
    full = vs.light_start(ts, FRAME, eta_vc, path_start=32, **kw)
    cut = vs.light_start(ts, FRAME, eta_vc,
                         path_start=torch.tensor(32, dtype=torch.int32),
                         path_end=torch.tensor(80, dtype=torch.int32), **kw)
    assert not cut["active"][48:].any() and full["active"][48:].any()
    for k in full:
        if k != "active":
            np.testing.assert_array_equal(full[k].numpy(), cut[k].numpy(),
                                          err_msg=k)
    np.testing.assert_array_equal(full["path_id"].numpy(),
                                  np.arange(32, 96))
    # Four lights, 192 paths: a different emitter every 48 paths, so the
    # band mixes the triangle light and the point light.
    assert set(full["finite"].tolist()) == {True}
    assert len(set(full["d_vc"].numpy()[full["active"].numpy()] == 0.0)) == 2


def _jax_light_head(js, frame, eta_vc, lanes, start, lpc):
    """The carry JAX's `_light_pass` builds before its loop (vcm.py
    :147-174, with its own rng, sample_emit and mis_pow), for `lanes`
    paths from `start` of `lpc`."""
    num_lights = js.lights.kind.shape[0]
    pick = 1.0 / num_lights
    path_id = start + jnp.arange(lanes, dtype=jnp.int32)
    state = jvcm.rng_mod.seed(path_id, frame, jnp.uint32(0x1157A9))
    light_idx = (path_id * num_lights) // lpc
    state, (u1, u2, u3, u4) = jvcm.rng_mod.next_floats(state, 4)
    es = jvcm.light_mod.sample_emit(js.lights, light_idx, u1, u2, u3, u4,
                                    js.bsphere, js.env, kinds=js.light_kinds)
    d_vc = jnp.where(es.is_delta, 0.0, jvcm.mis_pow(
        es.cos_out / jnp.maximum(es.pdf_emit_w * pick, 1e-20)))
    return dict(
        org=es.pos, d=es.dir, throughput=es.radiance / pick,
        active=(es.pdf_emit_w > 0.0) & jnp.any(es.radiance != 0.0, axis=-1),
        finite=es.is_finite, d_vc=d_vc, d_vm=d_vc * eta_vc,
        d_vcm=jvcm.mis_pow(es.pdf_direct_a / jnp.maximum(es.pdf_emit_w,
                                                         1e-20)),
        state=state, path_id=path_id)


# (scene, light kind or a pair of lights the band straddles, lanes): a
# band of each light kind, and one across two lights of other kinds at a
# ragged lane count.
LIGHT_HEADS = [("cornell", 0, 100), ("delta_lights", 1, 100),
               ("delta_lights", 3, 100), ("delta_lights", 2, 100),
               ("still_life", 4, 100), ("delta_lights", (1, 2), 77),
               ("still_life", (1, 2), 131)]


@pytest.mark.parametrize("name,kind,lanes", LIGHT_HEADS,
                         ids=["tri", "point", "spot", "dir", "env",
                              "tri_point", "tri_env"])
def test_light_start_matches_jax_head(name, kind, lanes, scenes):
    """light_start_plain (the kernel's plain version) against the head
    of JAX's `_light_pass` on a band of one light kind, or straddling two
    lights: the integer columns, the flags and the RNG state equal, the
    floats within REL."""
    js, ts, _ = scenes[name]
    kinds = ts.lights.kind.tolist()
    lpc = 1 << 12
    num = len(kinds)
    if isinstance(kind, tuple):
        j = kind[1]
        assert kinds[kind[0]] != kinds[j] and j == kind[0] + 1
        start = -(-j * lpc // num) - lanes // 2
    else:
        j = kinds.index(kind)
        start = -(-j * lpc // num)
        assert -(-(j + 1) * lpc // num) - start >= lanes
    _, _, _, eta_vc, _ = _constants("vcm")
    got = vs.light_start_plain(ts, torch.tensor(FRAME), eta_vc, lanes=lanes,
                               light_path_count=lpc, path_start=start)
    want = _jax_light_head(js, jnp.uint32(FRAME), float(eta_vc), lanes,
                           start, lpc)
    for k in ("active", "finite", "path_id"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(
        got["state"].numpy(),
        np.asarray(want["state"]).astype(np.int64), err_msg="state")
    for k in ("org", "d", "throughput", "d_vc", "d_vcm", "d_vm"):
        _close(got[k].numpy(), np.asarray(want[k]), k)
    np.testing.assert_array_equal(got["tmin"].numpy(), np.float32(1e-3))
    picked = set((got["path_id"] * num // lpc).tolist())
    assert picked == ({j - 1, j} if isinstance(kind, tuple) else {j})
    assert got["active"].any()


def _enum(src, name):
    body = re.search(r"enum %s \{(.*?)\};" % name, src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    return [w.split("=")[0].strip() for w in body.replace("\n", " ").split(",")
            if w.strip()]


RENAME = {"THROUGHPUT": "THR", "RADIANCE": "RAD", "N_RAYS": "NRAYS",
          "HIT_PRIM_ID": "HIT_PRIM"}


def _enum_name(k):
    for pre in ("O_", "S_", "Q_", ""):
        if k.upper().startswith(pre) and k.upper()[len(pre):] in RENAME:
            return f"P_{pre}{RENAME[k.upper()[len(pre):]]}"
    return f"P_{RENAME.get(k.upper(), k.upper())}"


def test_binding_matches_the_kernel_source():
    """The binding's argument lists line up with enum Ptr, Int and Flt of
    csrc/vcm_shade.cu name by name, and the algorithm and technique
    enums with ALGOS and TECHNIQUES."""
    with open(f"{libbuild.CSRC}/vcm_shade.cu") as fh:
        src = fh.read()
    assert _enum(src, "Ptr") == [_enum_name(k) for k in vs.PTRS] + [
        "NUM_PTRS"]
    assert _enum(src, "Int") == (
        [f"I_{k.upper()}" for k in sh.TABLE_INTS] + ["I_COLMAP"]
        + [f"I_{k.upper()}" for k in vs.CALL_INTS] + ["NUM_INTS"])
    assert re.search(r"kShadeColumns = %d;" % sh.SHADE_COLUMNS, src)
    assert _enum(src, "Flt") == (
        ["F_LIGHTS", "F_INV_LIGHTS", "F_PICK", "F_INV_PICK", "F_IMG_WM1",
         "F_IMG_HM1", "F_TAB_W", "F_TAB_H", "F_INV_TAB_W", "F_INV_TAB_H"]
        + [f"F_{k.upper()}" for k in vs.CALL_FLOATS] + ["NUM_FLOATS"])
    assert _enum(src, "Algo") == [f"ALGO_{a.upper()}" for a in vs.ALGOS]
    tech = dict(re.findall(r"T_(\w+) = (\d+)", src))
    assert [int(tech[t.upper()]) for t in vs.TECHNIQUES] == [
        1 << k for k in range(len(vs.TECHNIQUES))]
    assert _enum(src, "Which") == ["K_LIGHT_START", "K_LIGHT_SHADE",
                                   "K_CAMERA_SHADE", "NUM_SHADE"]
    assert [vs.WHICH[k] for k in ("light_start", "light_shade",
                                  "camera_shade")] == [0, 1, 2]
    # The camera kernel's dead-lane shadow row, the light kernel's
    # dead-lane rows and their kind bins.
    parse = lambda v: v == "true" if v in ("true", "false") else float(
        v.rstrip("f"))
    dead = {k.lower(): parse(v) for k, v in re.findall(
        r"constexpr (?:float|bool) kDead(?!Light)(\w+) = (\w+(?:\.\w+)?)",
        src)}
    assert dead == dict(zip(vs.ShadowSets._fields, vs.DEAD_SHADOW))
    dead = {k.lower(): parse(v) for k, v in re.findall(
        r"constexpr (?:float|bool|int) kDeadLight(\w+) = (-?\w+(?:\.\w+)?)",
        src)}
    assert dead == vs.DEAD_LIGHT._asdict()
    bins = int(re.search(r"kKindBins = (\d+);", src).group(1))
    assert bins > max(getattr(mat_mod, k) for k in dir(mat_mod)
                      if k.startswith("MAT_"))
    assert tvcm.ALGOS is vs.ALGOS and tvcm.TECHNIQUES is vs.TECHNIQUES


class _NoBuild:
    def build(self):
        raise AssertionError("the vcm shade kernels' library was built")


def test_cpu_tensors_never_build_the_library(scenes, monkeypatch):
    monkeypatch.setattr(vs, "LIB", _NoBuild())
    monkeypatch.setattr(vs, "_lib", None)
    monkeypatch.setattr(libbuild.NativeLib, "build", _NoBuild.build)
    _, ts, meta = scenes["still_life"]
    before = dict(vs.LAUNCHES)
    _, tcam = _cams(meta)
    film = tvcm.render_vcm_frame(ts, tcam, 1, RADIUS, algo="vcm", width=W,
                                 height=W, max_len=3, light_path_count=64,
                                 has_masks=meta.has_masks)
    assert film.shape == (W * W, 3) and float(film.sum()) > 0.0
    for k in vs.KERNELS:
        assert vs.LAUNCHES[k] == before[k], k
    assert vs.LAUNCHES["light_shade_plain"] == before["light_shade_plain"] + 3
    assert (vs.LAUNCHES["camera_shade_plain"]
            == before["camera_shade_plain"] + 3)
    with pytest.raises(AssertionError, match="built"):
        vs._library()


def test_unsupported_device_raises(scenes):
    _, ts, _ = scenes["cornell"]
    c = {"active": torch.zeros(8, dtype=torch.bool, device="meta")}
    with pytest.raises(ValueError, match="unsupported device"):
        vs.light_shade(ts, None, c, None, 0, None)
    with pytest.raises(ValueError, match="unsupported device"):
        vs.camera_shade(ts, c, None, 0)
    x = torch.zeros((8, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        vs.camera_finish(x, x, x[:, 0] > 0, x[:, 0] > 0, None)
    with pytest.raises(ValueError, match="unsupported device"):
        vs.light_finish(x, x[:, 0], x[:, 0] > 0, x[:, 0] > 0)
