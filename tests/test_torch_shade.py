"""The PT bounce's shading (imbatracer_torch/ops/shade.py) on the CPU.

* One bounce against JAX: the port's `_pt_bounce` (closest hit, the
  plain pt_shade, any hit, the plain pt_shade_finish) and JAX's
  `_pt_bounce` (imbatracer_tpu/render/integrators/pt.py, its exact
  traversal, max_steps=0, as tests/test_torch_pt.py renders with it) on
  the same carry, made from a numpy seed (tests/torch_shade_cases.py),
  at bounce 0 and at mixed depths, on the five scenes of
  torch_shade_cases.SCENES, JAX's closest hit replaced by the port's
  (the traversals may differ in the last ulp of u and v, and the bumped
  floor's normal, whose z is 0 give or take an ulp, picks its tangent
  frame by that sign).  Every output column is compared: the RNG state,
  active, depth, last_specular and the ray count equal; floats within
  1e-5 * max(1, |x|) (the bound chip_smoke.py holds the kernels to) on
  all lanes but at most 1% of them, those within 1e-3 (_close: a Phong
  lobe's power grows the last-ulp difference of XLA's and ATen's
  normals).
  The same on a band half dead on entry.
* Bands all dead on entry, half dead, or half dying at the miss and
  emitter tests: a lane that does not go on casts no shadow ray and
  keeps the plain select's carry, its RNG word past the bounce's 7
  draws; a live lane's outputs are those it has with every lane alive.
* The scene tables: the column map of pruned and full shade records,
  the host facts and float32 constants the kernel is given, and the
  argument lists of the binding against the enums of csrc/pt_shade.cu.
* On CPU tensors the shading runs the plain versions and never builds
  or loads the kernels' library.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imbatracer_tpu.render import lights as jlights
from imbatracer_tpu.render.integrators import pt as jpt
from imbatracer_tpu.render.traverse import Hit as JHit
from imbatracer_tpu.scene import procedural as jproc
from imbatracer_torch import libbuild
from imbatracer_torch.convert import scene_from_numpy, scene_to_numpy
from imbatracer_torch.ops import shade as sh
from imbatracer_torch.render import traverse as tt
from imbatracer_torch.render.integrators import pt as tpt
from imbatracer_torch.scene.types import shade_columns
from torch_shade_cases import (MAX_LEN, SCENES, SMALL_STILL_LIFE,
                               carry_arrays, dead_band, torch_carry,
                               with_delta_lights)
from torch_threads import cap_torch_threads

cap_torch_threads()

REL = 1e-5
LOBE_SHARE, LOBE_REL = 0.01, 1e-3
LANES = 384
EXACT = ("state", "active", "depth", "last_specular", "n_rays")


def _close(a, b, name):
    """|a - b| <= REL * max(1, |b|) on every lane but at most LOBE_SHARE
    of them, which stay within LOBE_REL * max(1, |b|).  max(1, |b|): a
    position or direction component near 0 comes out of a cancellation
    of terms of the vector's size.  The few lanes: a Phong or Blinn lobe
    raises a cosine to the power ns (up to 60 here), so the last-ulp
    difference between XLA's and ATen's interpolated normal grows to
    ~1e-5 relative in its pdf."""
    err = np.abs(a - b) / np.maximum(1.0, np.abs(b))
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
    return with_delta_lights(js, jlights.build_light_table), meta


@pytest.fixture(scope="module")
def scenes():
    """name -> (JAX scene, the port's scene from the same arrays, meta)."""
    out = {}
    for name in SCENES:
        js, meta = _jax_scene(name)
        out[name] = (js, scene_from_numpy(scene_to_numpy(js), "cpu"), meta)
    return out


def _jax_bounce(js, meta, arrays, hit, monkeypatch):
    """JAX's bounce on the carry, its closest hit replaced by `hit` (the
    port's, as numpy arrays)."""
    c = {k: jnp.asarray(v) for k, v in arrays.items()}
    c["n_rays"] = jnp.int32(0)
    alpha_fn = jpt.alpha_fn_for(js) if meta.has_masks else None
    monkeypatch.setattr(jpt, "closest_hit", lambda *a, **k: JHit(
        *(jnp.asarray(x) for x in hit)))
    out = jpt._pt_bounce(js, c, alpha_fn=alpha_fn, has_bump=meta.has_bump,
                         max_len=MAX_LEN, max_steps=0)
    return {k: np.asarray(v) for k, v in out.items()}


def _port_bounce(ts, meta, arrays, monkeypatch=None):
    """The port's bounce on the carry; with `monkeypatch`, also its closest
    hit as numpy arrays (t, prim_id, u, v)."""
    alpha_fn = tpt.alpha_fn_for(ts) if meta.has_masks else None
    hits = []
    if monkeypatch is not None:
        def closest_hit(*a, **k):
            hits.append(tt.closest_hit(*a, **k))
            return hits[-1]
        monkeypatch.setattr(tpt, "closest_hit", closest_hit)
    out = tpt._pt_bounce(ts, torch_carry(arrays, "cpu"), alpha_fn=alpha_fn,
                         has_bump=meta.has_bump, max_len=MAX_LEN)
    out = {k: v.numpy() for k, v in out.items()}
    return out if monkeypatch is None else (
        out, tuple(x.numpy() for x in hits[0]))


@pytest.mark.parametrize("mixed", [False, True, "half_dead"])
@pytest.mark.parametrize("name", SCENES)
def test_bounce_matches_jax(name, mixed, scenes, monkeypatch):
    """`mixed` False: the camera's bounce-0 carry; True: lanes at mixed
    depths; "half_dead": those with every other lane dead on entry."""
    js, ts, meta = scenes[name]
    half_dead = mixed == "half_dead"
    arrays = carry_arrays(meta, LANES, seed=SCENES.index(name) + 10 * (
        1 + half_dead if mixed else 0), mixed=bool(mixed))
    if half_dead:
        arrays["active"][::2] = False
    before = dict(sh.LAUNCHES)
    got, hit = _port_bounce(ts, meta, arrays, monkeypatch)
    assert sh.LAUNCHES["plain"] == before["plain"] + 1
    assert sh.LAUNCHES["finish_plain"] == before["finish_plain"] + 1
    want = _jax_bounce(js, meta, arrays, hit, monkeypatch)
    assert set(got) == set(want)
    for k in EXACT:
        np.testing.assert_array_equal(
            got[k].astype(np.int64) & 0xFFFFFFFF,
            want[k].astype(np.int64) & 0xFFFFFFFF, err_msg=k)
    for k in set(got) - set(EXACT):
        _close(got[k], want[k], k)
    # The bounce did work: lanes were shaded, some survive, light arrived.
    assert got["n_rays"] > arrays["active"].sum()
    assert got["active"].any() and (got["radiance"] > arrays["radiance"]
                                     ).any()


@pytest.mark.parametrize("name", ["cornell", "still_life"])
@pytest.mark.parametrize("band", ["all_dead", "half_dead", "emitters"])
def test_dead_lanes_keep_the_plain_select(band, name, scenes):
    """pt_shade_plain on a band all dead on entry, half dead, or half dying
    at the miss and emitter tests: a lane that does not go on past the
    hit test casts no shadow ray, and keeps the plain select's carry (inactive, org, d, tmin, throughput, depth,
    last_pdf and last_specular as they came, its radiance with the env or
    emitter term), its RNG word past the bounce's 7 draws; a live lane's
    outputs are bit for bit those it has in the same band with every
    lane alive.  The kernel writes the same
    (tests/test_torch_kernel_cuda.py)."""
    from imbatracer_torch.core import rng as trng
    from imbatracer_torch.render.surface import make_interaction

    _, ts, meta = scenes[name]
    arrays = dead_band(ts, meta, band, LANES, 61 + SCENES.index(name))
    c = torch_carry(arrays, "cpu")
    alive = dict(c, active=torch.ones_like(c["active"]))
    alpha_fn = tpt.alpha_fn_for(ts) if meta.has_masks else None
    hit = tt.closest_hit(ts.bvh, c["org"], c["d"], c["tmin"], tpt.BIG,
                         alpha_fn=alpha_fn, active=alive["active"],
                         sort=True)
    kw = dict(has_bump=meta.has_bump, max_len=MAX_LEN)
    nxt, shadow, contrib = sh.pt_shade_plain(ts, c, hit, **kw)
    ref_nxt, ref_shadow, ref_contrib = sh.pt_shade_plain(ts, alive, hit,
                                                         **kw)
    isect = make_interaction(ts, hit, c["org"], c["d"],
                             has_bump=meta.has_bump)
    live = c["active"] & (hit.prim_id >= 0) & (isect.light_id < 0)
    dead = ~live
    assert live.any() == (band != "all_dead")
    if band == "emitters":
        hit_light = c["active"] & (hit.prim_id >= 0) & (isect.light_id >= 0)
        assert hit_light.any() and (c["active"] & (hit.prim_id < 0)).any()
        assert (nxt["radiance"][hit_light] > c["radiance"][hit_light]).any()
    assert not shadow.ok[dead].any()
    outs = dict(zip(sh.ShadowRay._fields, shadow), contrib=contrib)
    for k, x in outs.items():
        np.testing.assert_array_equal(
            x[live].numpy(), dict(zip(sh.ShadowRay._fields, ref_shadow),
                                  contrib=ref_contrib)[k][live].numpy(),
            err_msg=k)
    assert not nxt["active"][dead].any()
    for k in ("org", "d", "tmin", "throughput", "depth", "last_pdf",
              "last_specular"):
        np.testing.assert_array_equal(nxt[k][dead].numpy(),
                                      c[k][dead].numpy(), err_msg=k)
    state, _ = trng.next_floats(c["state"], 7)
    np.testing.assert_array_equal(nxt["state"].numpy(), state.numpy())
    for k, v in nxt.items():
        if k != "n_rays":
            np.testing.assert_array_equal(v[live].numpy(),
                                          ref_nxt[k][live].numpy(),
                                          err_msg=k)
    assert int(nxt["n_rays"]) == int(c["active"].sum())


def test_delta_light_scene_covers_every_kind(scenes):
    _, ts, _ = scenes["delta_lights"]
    assert ts.light_kinds == (0, 1, 2, 3)
    assert sorted(set(ts.lights.kind.tolist())) == [0, 1, 2, 3]
    _, ts, meta = scenes["still_life"]
    assert ts.env is not None and meta.has_masks
    assert 4 in ts.light_kinds and ts.mat_kinds == (0, 1, 2, 3, 4, 5)


@pytest.mark.parametrize("kinds,textures,bump,masks", [
    ((), True, True, True),
    ((0,), False, False, False),
    ((0, 1, 2), False, False, False),
    ((0, 5), True, False, True),
    ((3, 4), True, True, False)])
def test_column_map_of_pruned_layouts(kinds, textures, bump, masks):
    cols = shade_columns(kinds, has_textures=textures, has_bump=bump,
                         has_masks=masks)
    pos = sh.column_map(cols)
    assert len(pos) == sh.SHADE_COLUMNS
    for c in range(sh.SHADE_COLUMNS):
        assert pos[c] == (cols.index(c) if c in cols else -1)
    # The blocks the kernel reads as runs stay runs.
    for start, width in ((0, 3), (3, 3), (6, 3), (9, 3), (12, 2), (14, 2),
                         (16, 2), (23, 3), (26, 3), (29, 3), (34, 3)):
        if pos[start] >= 0:
            assert pos[start:start + width] == list(
                range(pos[start], pos[start] + width))


def test_column_map_of_the_full_layout():
    assert sh.column_map(tuple(range(48))) == list(range(48))


@pytest.mark.parametrize("name", ["cornell", "still_life", "bumped",
                                  "delta_lights"])
def test_scene_tables(name, scenes):
    _, ts, meta = scenes[name]
    tab = sh.SceneTables(ts)
    ints = dict(zip(sh.TABLE_INTS, tab.ints))
    floats = dict(zip(sh.TABLE_FLOATS, tab.floats))
    num_lights = ts.lights.kind.shape[0]
    assert ints["rows"] == ts.attrs.shade_rec.shape[0]
    assert ints["cols"] == len(ts.attrs.shade_cols)
    assert ints["lights"] == num_lights
    assert ints["has_env"] == int(meta.has_env)
    assert ints["has_textures"] == int(ts.textures.texels.shape[0] > 1)
    assert tab.ints[len(sh.TABLE_INTS):] == sh.column_map(
        ts.attrs.shade_cols)
    assert (tab.ptrs[sh.TABLE_PTRS.index("env_img")] is None) == (
        ts.env is None)
    # The float32 constants torch derives from the host facts.
    assert floats["lights_f"] == num_lights
    assert floats["pick"] == np.float32(1.0 / num_lights)
    assert floats["inv_lights"] == np.float32(1.0 / num_lights)
    assert floats["inv_pick"] == np.float32(num_lights)
    if ts.env is not None:
        h, w = ts.env.pdf_table.shape
        assert (floats["tab_w_f"], floats["tab_h_f"]) == (w, h)
        assert floats["inv_tab_w"] == np.float32(1.0 / w)
        assert floats["img_wm1"] == ts.env.img.shape[1] - 1
    assert sh.tables_for(ts) is sh.tables_for(ts)


def _enum(src, name):
    body = re.search(r"enum %s \{(.*?)\};" % name, src, re.S).group(1)
    return [w.split("=")[0].strip() for w in body.replace("\n", " ").split(",")
            if w.strip()]


def test_binding_matches_the_kernel_source():
    """The binding's argument lists line up with enum Ptr, Int and Flt of
    csrc/pt_shade.cu, name by name."""
    with open(f"{libbuild.CSRC}/pt_shade.cu") as fh:
        src = fh.read()
    ptrs = _enum(src, "Ptr")
    want = ([f"P_{k}" for k in sh.CARRY_IN] + [f"P_HIT_{k}" for k in sh.HIT_IN]
            + [f"P_{k}" for k in sh.TABLE_PTRS]
            + [f"P_O_{k}" for k in sh.CARRY_IN] + ["P_O_N_RAYS"]
            + [f"P_S_{k}" for k in sh.ShadowRay._fields]
            + ["P_CONTRIB", "NUM_PTRS"])
    rename = {"P_THROUGHPUT": "P_THR", "P_O_THROUGHPUT": "P_O_THR",
              "P_RADIANCE": "P_RAD", "P_O_RADIANCE": "P_O_RAD",
              "P_LAST_SPECULAR": "P_LAST_SPEC",
              "P_O_LAST_SPECULAR": "P_O_LAST_SPEC",
              "P_HIT_PRIM_ID": "P_HIT_PRIM", "P_O_N_RAYS": "P_O_NRAYS"}
    assert ptrs == [rename.get(w.upper(), w.upper()) for w in want]
    ints = _enum(src, "Int")
    assert ints == ([f"I_{k.upper()}" for k in sh.TABLE_INTS]
                    + ["I_COLMAP", "I_LANES", "I_HAS_BUMP", "I_MAX_LEN",
                       "NUM_INTS"])
    assert re.search(r"kShadeColumns = %d;" % sh.SHADE_COLUMNS, src)
    assert _enum(src, "Flt") == (
        ["F_LIGHTS", "F_INV_LIGHTS", "F_PICK", "F_INV_PICK", "F_IMG_WM1",
         "F_IMG_HM1", "F_TAB_W", "F_TAB_H", "F_INV_TAB_W", "F_INV_TAB_H",
         "NUM_FLOATS"])
    assert len(sh.TABLE_FLOATS) == 10


class _Binding:
    """A ctypes.CDLL stand-in that records the functions bound."""

    def __init__(self, path):
        self.fns = {}

    def __getattr__(self, name):
        return self.fns.setdefault(name, type("Fn", (), {})())


def test_binding_argument_counts_match_the_c_entry_points(monkeypatch):
    """Each entry point _library binds takes as many arguments as its
    extern "C" definition in csrc/pt_shade.cu declares: the finish reads
    the carried count and writes a count of its own."""
    monkeypatch.setattr(sh.ctypes, "CDLL", _Binding)
    monkeypatch.setattr(sh, "LIB", type("Lib", (), {"build": lambda s: "x"})())
    monkeypatch.setattr(sh, "_lib", None)
    lib = sh._library()
    with open(f"{libbuild.CSRC}/pt_shade.cu") as fh:
        src = fh.read()
    assert set(lib.fns) == {"imba_pt_shade", "imba_pt_shade_finish",
                            "imba_pt_shade_resources"}
    for name, fn in lib.fns.items():
        params = re.search(r'extern "C" int %s\(([^)]*)\)' % name,
                           src).group(1)
        assert len(fn.argtypes) == len(params.split(",")), name
    params = re.search(r'extern "C" int imba_pt_shade_finish\(([^)]*)\)',
                       src).group(1)
    assert "count_in" in params and "count_out" in params


class _NoBuild:
    def build(self):
        raise AssertionError("the shade kernels' library was built")


def test_cpu_tensors_never_build_the_library(scenes, monkeypatch):
    monkeypatch.setattr(sh, "LIB", _NoBuild())
    monkeypatch.setattr(sh, "_lib", None)
    monkeypatch.setattr(libbuild.NativeLib, "build", _NoBuild.build)
    _, ts, meta = scenes["still_life"]
    before = dict(sh.LAUNCHES)
    arrays = carry_arrays(meta, 64, seed=3, mixed=True)
    out = _port_bounce(ts, meta, arrays)
    assert out["active"].shape == (64,)
    assert sh.LAUNCHES["pt_shade"] == before["pt_shade"]
    assert sh.LAUNCHES["pt_shade_finish"] == before["pt_shade_finish"]
    assert sh.LAUNCHES["plain"] == before["plain"] + 1
    with pytest.raises(AssertionError, match="built"):
        sh._library()


def test_shade_then_finish_is_the_bounce(scenes):
    """pt_shade and pt_shade_finish compose to the bounce: the finish adds
    contrib exactly where the shadow ray was cast and not occluded, and
    counts the shadow rays."""
    _, ts, meta = scenes["cornell"]
    c = torch_carry(carry_arrays(meta, 256, seed=5, mixed=True), "cpu")
    hit = tpt.closest_hit(ts.bvh, c["org"], c["d"], c["tmin"], tpt.BIG,
                          active=c["active"], sort=True)
    nxt, shadow, contrib = sh.pt_shade(ts, c, hit, has_bump=False,
                                       max_len=MAX_LEN)
    assert int(nxt["n_rays"]) == int(c["active"].sum())
    occ = torch.zeros_like(shadow.ok)
    occ[::2] = True
    rad, n = sh.pt_shade_finish(nxt["radiance"], contrib, shadow.ok, occ,
                                nxt["n_rays"])
    lit = (shadow.ok & ~occ).numpy()
    assert lit.any() and (~lit).any()
    np.testing.assert_array_equal(rad.numpy()[~lit],
                                  nxt["radiance"].numpy()[~lit])
    np.testing.assert_array_equal(
        rad.numpy()[lit], (nxt["radiance"] + contrib).numpy()[lit])
    assert int(n) == int(nxt["n_rays"]) + int(shadow.ok.sum())
    want = tpt._pt_bounce(ts, c, alpha_fn=None, has_bump=False,
                          max_len=MAX_LEN)
    np.testing.assert_array_equal(want["state"].numpy(),
                                  nxt["state"].numpy())


@pytest.mark.parametrize("lanes", [1, 3, 130, 1027])
@pytest.mark.parametrize("cast", ["none", "all", "some"])
def test_finish_matches_the_nee_add_expression(cast, lanes):
    """pt_shade_finish on CPU tensors (its plain version, the card kernel's
    yardstick) against the expression of the NEE add in JAX's
    `_pt_bounce` (imbatracer_tpu/render/integrators/pt.py:406-408:
    radiance plus contrib where the shadow ray was cast and not occluded,
    the shadow rays counted), copied into this test and run in jnp on the
    same inputs: the radiance bit for bit, signed zeros included, with no
    shadow ray cast, every one cast and some, at lane counts that are no
    multiple of 4 or of 128 (the kernel's four lanes a thread and its
    scalar tail).  The count is the carried int64 count, above 2^32, plus
    the int64 sum of the shadow flags; the band's part equals JAX's int32
    sum.  test_bounce_matches_jax holds the NEE add, inside the whole
    bounce, against JAX's `_pt_bounce` itself."""
    rs = np.random.RandomState(lanes + len(cast))
    rad = rs.randn(lanes, 3).astype(np.float32)
    rad[rs.rand(lanes) < 0.2] = -0.0
    con = rs.rand(lanes, 3).astype(np.float32)
    con[rs.rand(lanes) < 0.1] = -0.0
    ok = {"none": np.zeros(lanes, bool), "all": np.ones(lanes, bool),
          "some": rs.rand(lanes) < 0.5}[cast]
    occ = rs.rand(lanes) < 0.4
    n0 = (1 << 33) + 12345
    t = torch.from_numpy
    got, n = sh.pt_shade_finish(t(rad), t(con), t(ok), t(occ),
                                torch.tensor(n0, dtype=torch.int64))
    want = np.asarray(jnp.asarray(rad) + jnp.where(
        (jnp.asarray(ok) & ~jnp.asarray(occ))[..., None], jnp.asarray(con),
        0.0))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    assert n.dtype == torch.int64 and n.shape == ()
    assert int(n) == n0 + int(ok.sum(dtype=np.int64))
    assert int(n) - n0 == int(jnp.sum(jnp.asarray(ok).astype(jnp.int32)))
    if cast == "none":
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      (rad + np.float32(0.0)).view(np.uint32))


def test_unsupported_device_raises(scenes):
    _, ts, meta = scenes["cornell"]
    c = torch_carry(carry_arrays(meta, 8, seed=1, mixed=False), "meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sh.pt_shade(ts, c, None, has_bump=False, max_len=MAX_LEN)
    x = torch.zeros((8, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sh.pt_shade_finish(x, x, x[:, 0] > 0, x[:, 0] > 0,
                           torch.zeros((), device="meta"))
