"""The traversal dispatch glue of the port (imbatracer_torch.ops.dispatch:
the sort keys, the sorted ray rows, the khit and stream resolves; their
plain PyTorch versions on the CPU) against the JAX package's functions
they stand for: pallas_stream.sort_keys, _rays8t after the same
permutation (also at the ragged shapes of tests/torch_dispatch_cases.py), closest_hit_sorted / any_hit_sorted (the stream kernel in
interpret mode), and traverse.closest_hit's masked loops with the
mask-record alpha_fn of render/integrators/pt.py on the stacked masked
layers of tests/test_torch_masks.py (a flat BVH: the khit resolve; a
two-level one: the stream re-trace), and the port's alpha test
(alpha_fn_for's MaskTest) against JAX's.

Tolerances: keys, rows, alpha flags and occlusion flags equal bit for
bit; hit ids equal and t within 1e-5 relative, as
tests/test_torch_masks.py holds them (the packages round the hit test in
their own order); u and v within 1e-4 as tests/test_torch_traverse.py
holds them.  The kernels themselves are held against these plain
versions by tests/test_torch_kernel_cuda.py and chip_smoke.py on the
card.
"""

import re
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imbatracer_tpu.ops import pallas_stream as ps
from imbatracer_tpu.render import traverse as jtr
from imbatracer_tpu.render.integrators.pt import alpha_fn_for as jalpha_for
from imbatracer_tpu.scene import procedural as jproc
from imbatracer_torch import libbuild
from imbatracer_torch.convert import scene_from_numpy, scene_to_numpy
from imbatracer_torch.ops import dispatch as dp
from imbatracer_torch.ops import stream_traverse as st
from imbatracer_torch.render import traverse as tt
from imbatracer_torch.render.integrators.pt import alpha_fn_for
from imbatracer_torch.render.intersect import BIG
from imbatracer_torch.scene.textures import MaskTest, TextureAtlas
from test_torch_graphs import _two_level_layers
from test_torch_masks import _layers
from test_torch_traverse import _interp
from torch_dispatch_cases import (RAGGED_KEYS, RAGGED_ROWS, SELECT_CASES,
                                  select_case)
from torch_threads import cap_torch_threads

cap_torch_threads()


@pytest.fixture(scope="module")
def big():
    js, _ = jproc.make_big_scene(num_boxes=110, seed=9)   # ~1.3k tris
    return scene_from_numpy(scene_to_numpy(js), "cpu")


def _rays(n, seed, bvh):
    """Origins over the scene's bounds widened by half their span (some
    outside), unit directions with a zero component of either sign on
    every fifth lane, ~20% of lanes inactive, tmax in (0.5, 12)."""
    rs = np.random.RandomState(seed)
    lo, hi = bvh.bounds[:3].numpy(), bvh.bounds[3:].numpy()
    span = hi - lo
    org = rs.uniform(lo - 0.5 * span, hi + 0.5 * span, (n, 3))
    d = rs.randn(n, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[::5, rs.randint(3)] = 0.0
    d[::10, rs.randint(3)] = -0.0
    act = rs.rand(n) < 0.8
    tmax = rs.uniform(0.5, 12.0, n)
    return (org.astype(np.float32), d.astype(np.float32), act,
            tmax.astype(np.float32))


def _lanes_of(case, n, seed):
    """None, or a sorted subset of the n lanes (a round's slot map)."""
    if case == "all":
        return None
    rs = np.random.RandomState(seed)
    return np.sort(rs.choice(n, n // 2, replace=False)).astype(np.int64)


# --------------------------------------------------------------------------
# Keys and rows
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["all", "slots", "by_lane"])
def test_plain_keys_match_jax(big, case):
    """Recentring fused in, bounds from DeviceBvh.bounds; a slot map reads
    its lanes, and the active flags by slot or by lane."""
    n = 1000
    org, d, act, _ = _rays(n, 3, big.bvh)
    lanes = _lanes_of(case, n, 4)
    by_lane = case == "by_lane"
    sel = slice(None) if lanes is None else lanes
    s_act = act if lanes is None or by_lane else act[sel]
    got = dp.keys_plain(torch.from_numpy(org), torch.from_numpy(d),
                        torch.from_numpy(s_act), big.bvh.bounds,
                        big.bvh.center,
                        None if lanes is None else torch.from_numpy(lanes),
                        by_lane)
    jlo, jhi = ps._scene_bounds(jnp.asarray(big.bvh.sbox.numpy()))
    want = ps.sort_keys(jnp.asarray(org[sel] - big.bvh.center.numpy()),
                        jnp.asarray(d[sel]), jnp.asarray(act[sel]), jlo, jhi)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = np.asarray(want)
    assert (want[~act[sel]] == 2 ** 30).all()
    assert len(np.unique(want >> 24)) == 9       # 8 octants and the dead key


def _key_flags(flags, act):
    """The active flags of a RAGGED_KEYS case: act as it is ("mixed"),
    every one set or none, or None ("none": every slot active)."""
    if flags == "mixed":
        return act
    if flags == "none":
        return None
    return np.full_like(act, flags == "live")


@pytest.mark.parametrize("n,case,flags,recentre", RAGGED_KEYS)
def test_plain_keys_match_jax_at_ragged_shapes(big, n, case, flags,
                                               recentre):
    """keys_plain against JAX's sort_keys at the shapes and flags the
    keys kernel treats apart (tests/torch_dispatch_cases.py): lane counts
    on either side of a block, a slot map with its state by slot or by
    lane, the flags all set, none, some or absent, the origins recentred
    or not.  Every dead slot takes the dead key 2^30."""
    org, d, act, _ = _rays(n, 5 + n, big.bvh)
    lanes = None if case == "all" else np.sort(np.random.RandomState(
        n).choice(n, max(n // 2, 1), replace=False)).astype(np.int64)
    by_lane = case == "by_lane"
    sel = slice(None) if lanes is None else lanes
    flag = _key_flags(flags, act)
    s_flag = (flag if flag is None or lanes is None or by_lane
              else flag[sel])
    center = big.bvh.center if recentre else None
    got = dp.keys_plain(torch.from_numpy(org), torch.from_numpy(d),
                        None if s_flag is None else torch.from_numpy(s_flag),
                        big.bvh.bounds, center,
                        None if lanes is None else torch.from_numpy(lanes),
                        by_lane)
    live = (np.ones(n, bool) if flag is None else flag)[sel]
    o = org[sel] - (big.bvh.center.numpy() if recentre else 0.0)
    jlo, jhi = ps._scene_bounds(jnp.asarray(big.bvh.sbox.numpy()))
    want = np.asarray(ps.sort_keys(jnp.asarray(o), jnp.asarray(d[sel]),
                                   jnp.asarray(live), jlo, jhi))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[~live] == 2 ** 30).all() and (want[live] < 2 ** 30).all()
    assert (flags == "dead") == (not live.any())


@pytest.mark.parametrize("tcur", ["none", "tcur", "step"])
@pytest.mark.parametrize("case", ["all", "by_lane"])
@pytest.mark.parametrize("n", [256, 300])
def test_plain_rows_match_jax_rays8t(big, n, case, tcur):
    """(n_pad, 8) rows after the port's permutation against JAX's _rays8t
    of the permuted arrays, transposed: with and without padding and a
    slot map; tmin' = where(active, tcur, tmin), past tcur with `step`
    (JAX's re-trace body)."""
    org, d, act, tmax = _rays(n, 5, big.bvh)
    tmin = np.float32(1e-3)
    lanes = _lanes_of(case, n, 6)
    sel = np.arange(n) if lanes is None else lanes
    m = len(sel)
    rs = np.random.RandomState(7)
    tc = rs.uniform(0.0, 3.0, n).astype(np.float32)
    tc[::9] = 1e-5
    perm = torch.from_numpy(rs.permutation(m).astype(np.int64))
    center = big.bvh.center
    got = dp.rows_plain(
        torch.from_numpy(org), torch.from_numpy(d),
        st.full_lanes(float(tmin), n, "cpu"),
        st.full_lanes(torch.from_numpy(tmax), n, "cpu"), perm, m,
        active=torch.from_numpy(act), center=center,
        lanes=None if lanes is None else torch.from_numpy(lanes),
        tcur=None if tcur == "none" else torch.from_numpy(tc),
        step=tcur == "step", by_lane=True)
    lane = sel[perm.numpy()]
    lo = np.full(m, tmin, np.float32)
    a, t = jnp.asarray(act[lane]), jnp.asarray(tc[lane])
    if tcur != "none":
        c = t + 1e-3 * jnp.maximum(t, 1e-3) if tcur == "step" else t
        lo = jnp.where(a, c, lo)
    want, _ = ps._rays8t(jnp.asarray(org[lane] - center.numpy()),
                         jnp.asarray(d[lane]), lo, jnp.asarray(tmax[lane]),
                         a)
    assert got.shape == (m + (-m) % st.BLK, 8)
    # JAX pads to its own block (ps.BLK >= st.BLK) with the same dead rows.
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).T[:got.shape[0]])


@pytest.mark.parametrize("n,case,permuted,lims,tcur", RAGGED_ROWS)
def test_plain_rows_match_jax_at_ragged_shapes(big, n, case, permuted, lims,
                                               tcur):
    """rows_plain against JAX's _rays8t of the (permuted) lanes at the
    shapes the kernel's launch geometry meets (tests/
    torch_dispatch_cases.py): the row count around the
    rows a thread and a block, n_pad far above n, perm None, a slot map
    with its state by slot or by lane, tmin and tmax at a stride of 0 or
    1, tcur with and without `step`."""
    org, d, act, tmax = _rays(n, 11 + n, big.bvh)
    lanes = _lanes_of(case, n, 12 + n)
    by_lane = case != "slots"
    sel = np.arange(n) if lanes is None else lanes
    m = len(sel)
    rs = np.random.RandomState(13 + n)
    tmin = rs.uniform(0.0, 1e-2, n).astype(np.float32)
    tc = rs.uniform(0.0, 3.0, n).astype(np.float32)
    perm = rs.permutation(m).astype(np.int64) if permuted else None
    s_act = act if by_lane else act[sel]
    s_tc = tc if by_lane else tc[sel]
    stride0 = lims == "stride0"
    lo = st.full_lanes(1e-3 if stride0 else torch.from_numpy(tmin), n, "cpu")
    hi = st.full_lanes(7.5 if stride0 else torch.from_numpy(tmax), n, "cpu")
    if n > 1:                      # one lane's stride is 1 either way
        assert (lo.stride(0), hi.stride(0)) == ((0, 0) if stride0
                                                else (1, 1))
    got = dp.rows_plain(
        torch.from_numpy(org), torch.from_numpy(d), lo, hi,
        None if perm is None else torch.from_numpy(perm), m,
        active=torch.from_numpy(s_act), center=big.bvh.center,
        lanes=None if lanes is None else torch.from_numpy(lanes),
        tcur=None if tcur == "none" else torch.from_numpy(s_tc),
        step=tcur == "step", by_lane=by_lane)
    slot = np.arange(m) if perm is None else perm
    lane = sel[slot]
    state = lane if by_lane else slot
    a = jnp.asarray(s_act[state])
    base = (np.full(m, 1e-3, np.float32) if stride0 else tmin[lane])
    lo_j = jnp.asarray(base)
    if tcur != "none":
        t = jnp.asarray(s_tc[state])
        c = t + 1e-3 * jnp.maximum(t, 1e-3) if tcur == "step" else t
        lo_j = jnp.where(a, c, lo_j)
    hi_j = np.full(m, 7.5, np.float32) if stride0 else tmax[lane]
    want, _ = ps._rays8t(jnp.asarray(org[lane] - big.bvh.center.numpy()),
                         jnp.asarray(d[lane]), lo_j, jnp.asarray(hi_j), a)
    assert got.shape == (m + (-m) % st.BLK, 8)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).T[:got.shape[0]])


# --------------------------------------------------------------------------
# The resolves
# --------------------------------------------------------------------------

def _mask_record(layers):
    """The mask record and atlas of _layers' triangles: the floor (ids 0,
    1) unmasked, each layer quad textured with a 2 x 1 mask, black over
    world x < 0 (u < 1/2), white over x >= 0, as _layers' geometric test.
    Returns (torch MaskTest, JAX mask-record alpha_fn)."""
    f, half = (2, 1) if layers == 1 else (4, 2)
    quad = [((-half, half), (half, half), (half, -half)),
            ((-half, half), (half, -half), (-half, -half))]
    rec = np.zeros((2 + 2 * layers, 10), np.float32)
    bits = rec[:, 0:4].view(np.int32)
    bits[:, 0] = -1
    bits[:, 1:4] = (2, 1, 0)
    for k in range(layers):
        for j, tri in enumerate(quad):
            row = 2 + 2 * k + j
            bits[row, 0] = 0
            rec[row, 4:10] = [c for x, z in tri
                              for c in ((x + half) / (2 * half),
                                        (z + half) / (2 * half))]
    texels = np.asarray([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]], np.float32)
    atlas = TextureAtlas(texels=torch.from_numpy(texels),
                         offset=torch.zeros(1, dtype=torch.int32),
                         width=torch.full((1,), 2, dtype=torch.int32),
                         height=torch.ones(1, dtype=torch.int32))
    js = SimpleNamespace(attrs=SimpleNamespace(mask_rec=jnp.asarray(rec)),
                         textures=SimpleNamespace(texels=jnp.asarray(texels)))
    return MaskTest(torch.from_numpy(rec), atlas), jalpha_for(js)


def _stack(layers, n=96):
    top = layers + 2.0
    span = 0.9 if layers == 1 else 1.5
    x = np.linspace(-span, span, n, dtype=np.float32)
    org = np.stack([x, np.full(n, top, np.float32),
                    np.zeros(n, np.float32)], axis=1)
    d = np.tile(np.asarray([[0.0, -1.0, 0.0]], np.float32), (n, 1))
    d[::3, 0] = 0.05                                  # slanted rays
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    act = np.ones(n, bool)
    act[5::11] = False
    return x, top, org, d, act


def _hold_masked(got, want, act):
    np.testing.assert_array_equal(got.prim_id.numpy(),
                                  np.where(act, np.asarray(want.prim_id), -1))
    ok = act & (got.prim_id.numpy() >= 0)
    np.testing.assert_allclose(got.t.numpy()[ok], np.asarray(want.t)[ok],
                               rtol=1e-5)
    assert (got.t.numpy()[~act] == BIG).all()


@pytest.mark.parametrize("form", ["eager", "graph_ready"])
@pytest.mark.parametrize("layers", [1, 3, 4, 5, 8, 9])
def test_plain_khit_resolve_matches_jax(layers, form):
    """The flat khit re-trace (its resolve: the K hits' mask-record test,
    the first opaque one, exhausted lanes re-traced past the K-th) over 1
    to 9 masked layers, K = 4 saturated from 4 layers on, against JAX's
    masked closest hit with the mask-record alpha_fn; the see-through
    rays reach the floor, the others stop on the top layer."""
    jbvh, bvh, _, _ = _layers(layers)
    alpha, jalpha = _mask_record(layers)
    x, top, org, d, act = _stack(layers)
    ovf = torch.zeros((), dtype=torch.int32)
    before = dp.LAUNCHES["khit_resolve_plain"]
    got = tt.closest_hit(bvh, torch.from_numpy(org), torch.from_numpy(d),
                         0.0, BIG, alpha_fn=alpha,
                         active=torch.from_numpy(act),
                         overflow=ovf if form == "graph_ready" else None)
    rounds = layers // 4 + 1
    assert dp.LAUNCHES["khit_resolve_plain"] - before >= rounds
    want = jtr.closest_hit(jbvh, jnp.asarray(org), jnp.asarray(d), 0.0, BIG,
                           alpha_fn=jalpha)
    _hold_masked(got, want, act)
    vert = act & (d[:, 0] == 0.0)
    np.testing.assert_allclose(got.t.numpy()[vert],
                               np.where(x < 0.0, top, top - layers)[vert],
                               rtol=1e-5)
    assert int(ovf) == 0


def _sorted_call(fn, bvh, org, d, tmin, tmax, act):
    return _interp(lambda: fn(
        jnp.asarray(bvh.sbox.numpy()), jnp.asarray(bvh.tiles.numpy()),
        jnp.asarray(org - bvh.center.numpy()), jnp.asarray(d), tmin,
        jnp.asarray(tmax), active=jnp.asarray(act)))


@pytest.mark.parametrize("case", ["all", "by_lane"])
@pytest.mark.parametrize("mode", ["closest", "occlusion"])
def test_plain_stream_resolve_matches_jax(big, mode, case):
    """One sorted stream dispatch resolved into the lanes (all of them, or
    a round's slot map writing state by lane) against JAX's
    closest_hit_sorted / any_hit_sorted of the same lanes."""
    n = 2048
    org, d, act, tmax = _rays(n, 8, big.bvh)
    lanes = _lanes_of(case, n, 9)
    sel = np.arange(n) if lanes is None else lanes
    occl = mode == "occlusion"
    t = torch.from_numpy
    disp = dp.prepare(t(org), t(d), 1e-3, t(tmax) if occl else BIG,
                      t(act), bounds=big.bvh.bounds, center=big.bvh.center,
                      lanes=None if lanes is None else t(lanes),
                      by_lane=True)
    out = st.traverse(disp.rows, big.bvh.sbox, big.bvh.tiles, occl)
    before = dp.LAUNCHES["stream_resolve_plain"]
    if occl:
        flag = torch.zeros(n, dtype=torch.bool)
        dp.stream_resolve(disp, out, dp.OCCLUSION, flag=flag)
        want = _sorted_call(ps.any_hit_sorted, big.bvh, org[sel], d[sel],
                            1e-3, tmax[sel], act[sel])
        np.testing.assert_array_equal(flag.numpy()[sel], np.asarray(want))
        assert 0.0 < float(np.asarray(want).mean()) < 1.0
        assert not flag.numpy()[np.setdiff1d(np.arange(n), sel)].any()
    else:
        hit = tt._miss(n, "cpu")
        dp.stream_resolve(disp, out, dp.CLOSEST, hit=hit)
        want = _sorted_call(ps.closest_hit_sorted, big.bvh, org[sel], d[sel],
                            1e-3, np.full(len(sel), BIG, np.float32),
                            act[sel])
        pid, j_id = hit.prim_id.numpy()[sel], np.asarray(want.prim_id)
        tie = (pid != j_id) & (hit.t.numpy()[sel] == np.asarray(want.t))
        assert ((pid == j_id) | tie).all() and (pid >= 0).sum() > 50
        m = (pid >= 0) & (pid == j_id)
        for k, tol in (("t", dict(rtol=1e-5, atol=1e-6)),
                       ("u", dict(rtol=0, atol=1e-4)),
                       ("v", dict(rtol=0, atol=1e-4))):
            np.testing.assert_allclose(getattr(hit, k).numpy()[sel][m],
                                       np.asarray(getattr(want, k))[m],
                                       **tol)
        assert (hit.t.numpy()[sel][pid < 0] == BIG).all()
    assert dp.LAUNCHES["stream_resolve_plain"] == before + 1


@pytest.mark.parametrize("form", ["eager", "graph_ready"])
@pytest.mark.parametrize("layers", [1, 5])
def test_plain_stream_retrace_matches_jax(layers, form):
    """The two-level one-layer re-trace (the stream resolve's re-trace
    mode: select by the lane's flag, the mask-record test, the flag set
    again) over the stacked layers, closest hit and occlusion, against
    JAX's masked traversal of the same triangles."""
    jbvh, _, _, _ = _layers(layers)
    bvh = _two_level_layers(layers)
    alpha, jalpha = _mask_record(layers)
    x, top, org, d, act = _stack(layers)
    ovf = torch.zeros((), dtype=torch.int32) if form == "graph_ready" else None
    t = torch.from_numpy
    before = dp.LAUNCHES["stream_resolve_plain"]
    got = tt.closest_hit(bvh, t(org), t(d), 0.0, BIG, alpha_fn=alpha,
                         active=t(act), sort=True, overflow=ovf)
    assert dp.LAUNCHES["stream_resolve_plain"] - before >= layers + 1
    want = jtr.closest_hit(jbvh, jnp.asarray(org), jnp.asarray(d), 0.0, BIG,
                           alpha_fn=jalpha)
    _hold_masked(got, want, act)
    tmax = np.full(len(x), top - 0.5, np.float32)
    occ = tt.any_hit(bvh, t(org), t(d), 0.0, t(tmax), alpha_fn=alpha,
                     active=t(act), sort=True, overflow=ovf)
    jocc = jtr.any_hit(jbvh, jnp.asarray(org), jnp.asarray(d), 0.0,
                       jnp.asarray(tmax), alpha_fn=jalpha)
    np.testing.assert_array_equal(occ.numpy(), act & np.asarray(jocc))
    assert ovf is None or int(ovf) == 0


# --------------------------------------------------------------------------
# The alpha test, the bounds, the binding
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["masked", "still_life"])
def test_mask_test_matches_jax(name):
    """alpha_fn_for's MaskTest (what the resolve kernels read: its record
    and texels) against JAX's mask-record alpha_fn, bools equal."""
    js, _ = (jproc.make_masked_scene() if name == "masked" else
             jproc.make_still_life_like(num_objects=40, num_cards=16))
    ts = scene_from_numpy(scene_to_numpy(js), "cpu")
    alpha = alpha_fn_for(ts)
    assert isinstance(alpha, MaskTest)
    assert alpha.mask_rec is ts.attrs.mask_rec
    assert alpha.textures.texels is ts.textures.texels
    rs = np.random.RandomState(12)
    n = 8192
    prim = rs.randint(0, int(js.attrs.mask_rec.shape[0]), n).astype(np.int32)
    u = rs.uniform(0.0, 1.0, n).astype(np.float32)
    v = (rs.uniform(0.0, 1.0, n) * (1.0 - u)).astype(np.float32)
    want = np.asarray(jalpha_for(js)(jnp.asarray(prim), jnp.asarray(u),
                                     jnp.asarray(v)))
    got = alpha(torch.from_numpy(prim), torch.from_numpy(u),
                torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.0 < want.mean() < 1.0


def test_bvh_bounds_made_once(big):
    """DeviceBvh.bounds: the super-chunk boxes' bounds, made with the
    BVH, not a dataclass field (so not moved, stored or compared), made
    anew by .to()."""
    lo, hi = st.scene_bounds(big.bvh.sbox)
    np.testing.assert_array_equal(big.bvh.bounds.numpy(),
                                  torch.cat([lo, hi]).numpy())
    import dataclasses
    assert "bounds" not in {f.name for f in dataclasses.fields(big.bvh)}
    moved = big.bvh.to("cpu")
    assert moved.bounds is not big.bvh.bounds
    np.testing.assert_array_equal(moved.bounds.numpy(),
                                  big.bvh.bounds.numpy())


def test_binding_matches_the_kernel_enums():
    """ops/dispatch.py's pointer and int order against csrc/dispatch.cu's
    enums, and the plain route never building the library."""
    with open(f"{libbuild.CSRC}/dispatch.cu") as fh:
        src = fh.read()
    body = re.search(r"enum RayPtr \{([^}]*)\}", src).group(1)
    names = [w.strip() for w in body.replace("\n", " ").split(",")]
    assert names[-1] == "NUM_RAY_PTRS"
    assert [w[2:].lower() for w in names[:-1]] == list(dp.RAY_PTRS)
    modes = re.search(r"enum \{ (MODE_[^}]*)\}", src).group(1)
    assert [m.strip() for m in modes.split(",")] == [
        "MODE_CLOSEST", "MODE_OCCLUSION", "MODE_RETRACE"]
    assert (dp.CLOSEST, dp.OCCLUSION, dp.RETRACE) == (0, 1, 2)


def test_cpu_tensors_never_build_the_kernels(big, monkeypatch):
    def refuse():
        raise AssertionError("the dispatch library was built for CPU "
                             "tensors")

    monkeypatch.setattr(dp, "_library", refuse)
    jbvh, bvh, _, _ = _layers(5)
    alpha, _ = _mask_record(5)
    _, _, org, d, act = _stack(5)
    t = torch.from_numpy
    for ovf in (None, torch.zeros((), dtype=torch.int32)):
        tt.closest_hit(bvh, t(org), t(d), 0.0, BIG, alpha_fn=alpha,
                       active=t(act), overflow=ovf)
        tt.any_hit(_two_level_layers(5), t(org), t(d), 0.0, 3.0,
                   alpha_fn=alpha, active=t(act), sort=True, overflow=ovf)
    org, d, act, tmax = _rays(512, 1, big.bvh)
    tt.closest_hit(big.bvh, t(org), t(d), 0.0, BIG, active=t(act), sort=True)
    tt.any_hit(big.bvh, t(org), t(d), 0.0, t(tmax), active=t(act))


# --------------------------------------------------------------------------
# The graph-ready re-trace's slot state, merge and finish
# --------------------------------------------------------------------------

def _composite_slots(need, slots, hit, tcur):
    """The slot gather and state as the torch composite of the graph
    routes computed them before dispatch.slot_gather: (idx, valid,
    dropped, need flags, tcur, hit)."""
    idx = torch.nonzero_static(need, size=slots, fill_value=0)[:, 0]
    count = need.sum()
    valid = torch.arange(slots) < count
    return (idx, valid, torch.clamp(count - slots, min=0), valid.clone(),
            None if tcur is None else tcur[idx],
            tt.Hit(*(x[idx] for x in hit)))


def _composite_merge(idx, valid, hit, sub):
    num_r = hit.t.shape[0]
    to = torch.where(valid, idx, num_r)
    out = []
    for h, s in zip(hit, sub):
        row = torch.cat([h, h[:1]])
        row[to] = s
        out.append(row[:num_r])
    return tt.Hit(*out)


def _composite_finish(counts, at, overflow, act, need, dropped, unresolved,
                      rounds):
    """The device counts (`at`: key -> slot) and the overflow as the graph
    routes' graphs.count calls and _finish added them."""
    def count(key, n):
        c = counts[at[key]]
        n = n.to(counts.dtype)
        c.copy_(torch.maximum(c, n) if key.startswith("max_") else c + n)

    count("empty", ~act.any())
    count("max_rounds", rounds)
    count("max_lanes", need.sum())
    left = unresolved.sum()
    count("dropped", dropped)
    count("capped", left)
    overflow.add_((dropped + left).to(overflow.dtype))


@pytest.mark.parametrize("two_level", [False, True])
@pytest.mark.parametrize("case", ["empty", "within", "capped", "past"])
def test_plain_slots_match_the_composite(case, two_level):
    """dispatch.slot_gather / slot_merge / slot_finish's plain versions
    against the torch composite they replace, bit for bit, on seeded need
    masks over 2048 lanes at the flat and two-level slot shares: no lane
    active, the lanes in need within the slots, some of them left
    unresolved at the cap, and more lanes in need than slots (dropped):
    the slot state, the merged hit, the overflow and the device counts."""
    n = 2048
    slots = tt.retrace_slots(n, two_level)
    density = {"empty": 0.0, "within": 0.6 * slots / n,
               "capped": 0.6 * slots / n, "past": 1.5 * slots / n}[case]
    rs = np.random.RandomState(len(case) + 10 * two_level)
    t = torch.from_numpy
    act = t(rs.rand(n) < (0.8 if density else 0.0))
    need = act & t(rs.rand(n) < min(density / 0.8, 1.0))
    hit = tt.Hit(t(rs.uniform(0, 9, n).astype(np.float32)),
                 t(rs.randint(-1, 500, n).astype(np.int32)),
                 t(rs.rand(n).astype(np.float32)),
                 t(rs.rand(n).astype(np.float32)))
    tcur = None if two_level else t(rs.uniform(0, 9, n).astype(np.float32))
    s = tt.gather_slots(need, slots, hit, tcur)
    idx, valid, dropped, flags, s_tcur, s_hit = _composite_slots(
        need, slots, hit, tcur)
    for a, b in ((s.idx, idx), (s.valid, valid), (s.need, flags),
                 (s.dropped, dropped), *zip(s.hit, s_hit)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert (s.tcur is None) == two_level
    if not two_level:
        np.testing.assert_array_equal(s.tcur.numpy().view(np.uint32),
                                      s_tcur.numpy().view(np.uint32))
    assert int(s.dropped) == (int(need.sum()) - slots if case == "past"
                              else 0)
    sub = tt.Hit(t(rs.uniform(0, 9, slots).astype(np.float32)),
                 t(rs.randint(-1, 500, slots).astype(np.int32)),
                 t(rs.rand(slots).astype(np.float32)),
                 t(rs.rand(slots).astype(np.float32)))
    merged = dp.slot_merge(s._replace(hit=sub), hit)
    for a, b in zip(merged, _composite_merge(idx, valid, hit, sub)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    unresolved = valid & (t(rs.rand(slots) < 0.3) if case == "capped"
                          else torch.zeros(slots, dtype=torch.bool))
    rounds = torch.tensor(7 if case == "capped" else 2, dtype=torch.int32)
    at = {k: 2 + i for i, k in enumerate(dp.FINISH_KEYS)}
    counts0 = t(rs.randint(0, 50, 8).astype(np.int32))
    got, want = counts0.clone(), counts0.clone()
    dp.slot_finish(got[0], act, s._replace(need=unresolved), rounds,
                   (got, [at[k] for k in dp.FINISH_KEYS],
                    [k.startswith("max_") for k in dp.FINISH_KEYS]))
    _composite_finish(want, at, want[0], act, need, dropped, unresolved,
                      rounds)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    ovf = torch.zeros((), dtype=torch.int32)
    dp.slot_finish(ovf, act, s._replace(need=unresolved), rounds)
    assert int(ovf) == int(dropped) + int(unresolved.sum())
    assert int(got[at["empty"]] - counts0[at["empty"]]) == (case == "empty")


@pytest.mark.parametrize("two_level", [False, True])
@pytest.mark.parametrize("case", list(SELECT_CASES))
def test_plain_slot_selection_matches_the_composite_and_jax(case,
                                                           two_level):
    """dispatch.slot_gather_plain, which selects the slots from the need
    flags, against the torch composite the graph routes ran before it
    (nonzero_static, the sum of the flags, the gathers) and against JAX's
    static-size selection of the same lanes (jnp.nonzero with a size and
    a fill value, jnp.sum, the carry's values at those lanes): every
    output bit for bit, the count and the dropped lanes included, with no
    lane in need, every lane, as many as the slots, more (dropped), only
    the last lane, and lanes that fill no whole word or tile of the
    kernel."""
    need, slots, hit, tcur = select_case(
        case, 8192, len(case), lambda n: tt.retrace_slots(n, two_level),
        not two_level)
    t = torch.from_numpy
    s = dp.slot_gather_plain(t(need), slots, tt.Hit(*map(t, hit)),
                             None if tcur is None else t(tcur))
    idx, valid, dropped, flags, c_tcur, c_hit = _composite_slots(
        t(need), slots, tt.Hit(*map(t, hit)),
        None if tcur is None else t(tcur))
    j_idx = np.asarray(jnp.nonzero(jnp.asarray(need), size=slots,
                                   fill_value=0)[0])
    j_count = int(jnp.sum(jnp.asarray(need), dtype=jnp.int32))
    j_valid = np.arange(slots) < j_count
    want = {"idx": (idx, j_idx), "valid": (valid, j_valid),
            "need": (flags, j_valid),
            "dropped": (dropped, max(j_count - slots, 0)),
            "count": (need.sum(), j_count)}
    got = {"idx": s.idx, "valid": s.valid, "need": s.need,
           "dropped": s.dropped, "count": s.count}
    for k, (comp, jax_) in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(comp), k)
        np.testing.assert_array_equal(got[k].numpy(), jax_, k)
    assert s.idx.dtype == torch.int64 and s.count.dtype == torch.int32
    assert s.dropped.dtype == torch.int32
    for a, b, c in zip(s.hit, c_hit, hit):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_array_equal(
            a.numpy(), np.asarray(jnp.take(jnp.asarray(c), j_idx)))
    assert (s.tcur is None) == two_level
    if not two_level:
        np.testing.assert_array_equal(s.tcur.numpy().view(np.uint32),
                                      c_tcur.numpy().view(np.uint32))
        np.testing.assert_array_equal(
            s.tcur.numpy(), np.asarray(jnp.take(jnp.asarray(tcur), j_idx)))
    lanes = {"none": 0, "all": len(need), "last": 1}.get(case)
    if lanes is not None:
        assert int(s.count) == lanes
    if case == "equal":
        assert int(s.count) == slots and bool(s.valid.all())
    if case == "past":
        assert int(s.dropped) == 77
    if case == "last":
        assert int(s.idx[0]) == len(need) - 1 and int(s.valid.sum()) == 1


@pytest.mark.parametrize("rounds", [1, 2, 5, tt.KHIT_MAX_ROUNDS])
def test_finish_folds_the_loop_counts(rounds):
    """slot_finish_plain with the counts a run of the loop's body ticks
    ((slot, n) pairs, graphs.while_loop's deltas) equals the loop adding
    them to the device counts each run and slot_finish without them, bit
    for bit, at 1 round (no run), 2, 5 and the khit cap; past MAX_DELTAS
    pairs, pairs without the device counts or a pair at a maximum's slot,
    it raises."""
    rs = np.random.RandomState(rounds)
    n, slots = 2048, 64
    t = torch.from_numpy
    act = t(rs.rand(n) < 0.5)
    s = dp.slot_gather_plain(torch.arange(n) < 40, slots,
                             tt.Hit(*(torch.zeros(n) for _ in range(4))))
    s = s._replace(need=s.valid & t(rs.rand(slots) < 0.3))
    at = {k: 9 + i for i, k in enumerate(dp.FINISH_KEYS)}
    where = ([at[k] for k in dp.FINISH_KEYS],
             [k.startswith("max_") for k in dp.FINISH_KEYS])
    deltas = [(1, 1), (2, 1), (4, 3), (7, 1), (8, 2)]
    counts0 = t(rs.randint(0, 50, 16).astype(np.int32))
    r = torch.tensor(rounds, dtype=torch.int32)
    got, want = counts0.clone(), counts0.clone()
    dp.slot_finish_plain(got[0], act, s, r, (got,) + where, deltas)
    for _ in range(rounds - 1):                 # the body's adds a run
        for slot, k in deltas:
            want[slot].add_(k)
    dp.slot_finish_plain(want[0], act, s, r, (want,) + where)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    for slot, k in deltas:
        assert int(got[slot] - counts0[slot]) == k * (rounds - 1)
    with pytest.raises(ValueError, match="per-run counts"):
        dp.slot_finish(got[0], act, s, r, (got,) + where,
                       [(1, 1)] * (dp.MAX_DELTAS + 1))
    with pytest.raises(ValueError, match="per-run counts"):
        dp.slot_finish(torch.zeros((), dtype=torch.int32), act, s, r, None,
                       deltas)
    with pytest.raises(ValueError, match="maximum's slot"):
        dp.slot_finish(got[0], act, s, r, (got,) + where,
                       [(at["max_rounds"], 1)])


def test_slot_binding_matches_the_kernel():
    """FINISH_KEYS has the finish kernel's count of keys, in the order of
    its values, and names MASK_STATS entries; MAX_DELTAS is the kernel's
    most per-run counts."""
    with open(f"{libbuild.CSRC}/dispatch.cu") as fh:
        src = fh.read()
    n = re.search(r"constexpr int kFinishKeys = (\d+);", src).group(1)
    assert int(n) == len(dp.FINISH_KEYS)
    vals = re.search(r"vals\[kFinishKeys\] = \{([^}]*)\}", src).group(1)
    assert [v.strip() for v in vals.split(",")] == [
        "live == 0", "*rounds", "*count", "*dropped", "left"]
    assert set(dp.FINISH_KEYS) <= set(tt.MASK_STATS)
    n = re.search(r"constexpr int kMaxDeltas = (\d+);", src).group(1)
    assert int(n) == dp.MAX_DELTAS
