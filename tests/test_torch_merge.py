"""The port's photon merge (imbatracer_torch.ops.merge: the photon grid,
the query preparation and the plain version of the CUDA merge kernel)
against the JAX package's Pallas merge kernel, run in interpret mode as
tests/test_pallas_merge.py runs it, on the same numpy-seeded inputs.

Tolerances: the photon grid is equal bit for bit (keys, tiles, bbox,
inverse cell size, r^2).  Per-query contributions agree within
|port - jax| <= 1e-4 * max(|jax|, 1e-6 * max|jax|) per channel: the two
sum the same non-negative terms in another order (the Pallas kernel per
256-photon tile, the port in ascending photon index), and pow rounds
differently in XLA and ATen.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imbatracer_tpu.ops import pallas_merge as jmerge
from imbatracer_tpu.render import materials as jmat
from imbatracer_torch.ops import merge as tmerge
from imbatracer_torch.render import materials as tmat
from torch_threads import cap_torch_threads

cap_torch_threads()


def _unit(rs, n):
    v = rs.randn(n, 3)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _photons(rs, num_p, spread=1.0):
    return dict(pos=(spread * rs.rand(num_p, 3)).astype(np.float32),
                valid=rs.rand(num_p) > 0.1, w_in=_unit(rs, num_p),
                tp=rs.rand(num_p, 3).astype(np.float32),
                d_vcm=rs.rand(num_p).astype(np.float32),
                d_vm=rs.rand(num_p).astype(np.float32))


def _queries(rs, num_q, kinds, pos=None):
    n = _unit(rs, num_q)
    gn = n + 0.1 * rs.randn(num_q, 3)
    gn = (gn / np.linalg.norm(gn, axis=-1, keepdims=True)).astype(np.float32)
    return dict(
        pos=rs.rand(num_q, 3).astype(np.float32) if pos is None else pos,
        n=n, gn=gn, w_out=_unit(rs, num_q),
        kind=rs.choice(kinds, num_q).astype(np.int32),
        kd=rs.rand(num_q, 3).astype(np.float32),
        ks=rs.rand(num_q, 3).astype(np.float32),
        ns=(1.0 + rs.rand(num_q) * 30.0).astype(np.float32),
        d_vcm=(rs.rand(num_q) * 2.0).astype(np.float32),
        d_vm=(rs.rand(num_q) * 2.0).astype(np.float32),
        active=rs.rand(num_q) > 0.15)


def _params(q, xp):
    num_q = q["kind"].shape[0]
    arr = (lambda a: jnp.asarray(a)) if xp is jnp else torch.from_numpy
    full = lambda shape, v, dt: arr(np.full(shape, v, dt))
    return dict(kind=arr(q["kind"]), kd=arr(q["kd"]), ks=arr(q["ks"]),
                tf=full((num_q, 3), 0.0, np.float32),
                ns=arr(q["ns"]), ior=full((num_q,), 1.5, np.float32),
                emit=full((num_q, 3), 0.0, np.float32),
                kd_tex=full((num_q,), -1, np.int32),
                bump_tex=full((num_q,), -1, np.int32),
                mask_tex=full((num_q,), -1, np.int32))


def _grids(ph, radius):
    j = jmerge.build_merge_grid(
        jnp.asarray(ph["pos"]), jnp.asarray(ph["valid"]), jnp.float32(radius),
        jnp.asarray(ph["w_in"]), jnp.asarray(ph["tp"]),
        jnp.asarray(ph["d_vcm"]), jnp.asarray(ph["d_vm"]))
    t = torch.from_numpy
    p = tmerge.build_merge_grid(
        t(ph["pos"]), t(ph["valid"]), torch.tensor(radius, dtype=torch.float32),
        t(ph["w_in"]), t(ph["tp"]), t(ph["d_vcm"]), t(ph["d_vm"]))
    return j, p


def _jax_contrib(jgrid, q, eta_vc, kinds, ppm):
    a = jnp.asarray
    old = jmerge.INTERPRET
    jmerge.INTERPRET = True
    try:
        out = jmerge.merge_contrib(
            jgrid, a(q["pos"]), a(q["n"]), a(q["gn"]), a(q["w_out"]),
            jmat.MatParams(_params(q, jnp)), a(q["d_vcm"]), a(q["d_vm"]),
            a(q["active"]), jnp.float32(eta_vc), kinds=kinds, ppm=ppm)
    finally:
        jmerge.INTERPRET = old
    return np.asarray(out)


def _port_contrib(grid, q, eta_vc, kinds, ppm):
    t = torch.from_numpy
    return tmerge.merge_contrib(
        grid, t(q["pos"]), t(q["n"]), t(q["gn"]), t(q["w_out"]),
        tmat.MatParams(_params(q, torch)), t(q["d_vcm"]), t(q["d_vm"]),
        t(q["active"]), eta_vc, kinds=kinds, ppm=ppm).numpy()


def _assert_agree(port, ref):
    assert port.shape == ref.shape
    floor = 1e-6 * np.abs(ref).max()
    assert (np.abs(port - ref) <= 1e-4 * np.maximum(np.abs(ref), floor)).all()
    assert np.abs(ref).sum() > 0.0      # the join really finds photons


@pytest.mark.parametrize("radius,spread", [(0.07, 1.0), (0.0008, 1.0),
                                           (0.2, 0.01)])
def test_build_merge_grid_bit_equal(radius, spread):
    ph = _photons(np.random.RandomState(3), 900, spread)
    j, p = _grids(ph, radius)
    for name in ("tiles", "keys", "bbox_min", "inv_cell", "radius_sqr"):
        a, b = getattr(p, name).numpy(), np.asarray(getattr(j, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32),
                                      err_msg=name)
    assert p.tiles.shape == (4, tmerge.PREC_ROWS, tmerge.PT)


@pytest.mark.parametrize("kinds,ppm", [((0,), False), ((0, 3, 4, 5), False),
                                       ((0,), True), ((0, 3, 4, 5), True)])
def test_merge_contrib_matches_pallas(kinds, ppm):
    rs = np.random.RandomState(42)
    ph = _photons(rs, 700)
    q = _queries(rs, 400, kinds)
    jgrid, grid = _grids(ph, 0.07)
    _assert_agree(_port_contrib(grid, q, 0.3, kinds, ppm),
                  _jax_contrib(jgrid, q, 0.3, kinds, ppm))


def test_merge_clamp_dedup_matches_pallas():
    """Queries at the photon bbox corner, where clamped combos collapse
    (the -2 dedup): no photon counted twice."""
    rs = np.random.RandomState(7)
    ph = _photons(rs, 64, spread=0.01)
    ph["valid"][:] = True
    q = _queries(rs, 32, (0,), pos=(0.01 * rs.rand(32, 3)).astype(np.float32))
    q["active"][:] = True
    jgrid, grid = _grids(ph, 0.2)
    _assert_agree(_port_contrib(grid, q, 0.5, (0,), False),
                  _jax_contrib(jgrid, q, 0.5, (0,), False))


def test_merge_tiny_radius_matches_pallas():
    """A radius far below the scene size: the cell grows to fit 256^3."""
    rs = np.random.RandomState(12)
    ph = _photons(rs, 600)
    qpos = ph["pos"][rs.randint(0, 600, 300)] + 0.0005 * rs.randn(300, 3)
    q = _queries(rs, 300, (0,), pos=qpos.astype(np.float32))
    jgrid, grid = _grids(ph, 0.0008)
    _assert_agree(_port_contrib(grid, q, 0.2, (0,), False),
                  _jax_contrib(jgrid, q, 0.2, (0,), False))


def test_plain_merge_matches_brute_force():
    """The plain version against an O(Q * P) walk over every photon
    through the port's own materials module (eval_bsdf / pdf_bsdf), and
    its work tallies against a direct count."""
    rs = np.random.RandomState(9)
    ph = _photons(rs, 500)
    q = _queries(rs, 300, (0, 1, 3, 4, 5))
    _, grid = _grids(ph, 0.1)
    got = _port_contrib(grid, q, 0.4, (0, 1, 3, 4, 5), False)

    t = torch.from_numpy
    params = tmat.MatParams(_params(q, torch))
    n, gn, wo = t(q["n"]), t(q["gn"]), t(q["w_out"])
    want = torch.zeros((300, 3))
    r2 = np.float32(0.1) * np.float32(0.1)
    for i in np.nonzero(ph["valid"])[0]:
        wi = t(ph["w_in"][i]).expand(300, 3)
        f = tmat.eval_bsdf(params, n, gn, wo, wi)
        pdf_dir = tmat.pdf_bsdf(params, n, gn, wo, wi)
        pdf_rev = tmat.pdf_bsdf(params, n, gn, wi, wo)
        d2 = torch.sum((t(ph["pos"][i]) - t(q["pos"])) ** 2, dim=-1)
        ok = (t(q["active"]) & (d2 <= float(r2)) & (pdf_dir > 0)
              & (pdf_rev > 0) & torch.any(f != 0, dim=-1))
        w = 1.0 / (float(ph["d_vcm"][i]) * 0.4 + float(ph["d_vm"][i]) * pdf_dir
                   + 1.0 + t(q["d_vcm"]) * 0.4 + t(q["d_vm"]) * pdf_rev)
        epan = torch.clamp(1.0 - d2 / float(r2), min=0.0)
        want += torch.where(ok[:, None], t(ph["tp"][i]) * f
                            * (w * epan)[:, None], 0.0)
    want = want.numpy()
    assert np.abs(want).sum() > 0.0
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    # Mirror queries (kind 1) and inactive ones sum nothing.
    assert (got[(q["kind"] == 1) | ~q["active"]] == 0.0).all()

    qrec, _ = tmerge.prepare_queries(
        grid, t(q["pos"]), n, gn, wo, params, t(q["d_vcm"]), t(q["d_vm"]),
        t(q["active"]))
    work = torch.zeros(len(tmerge.WORK_SLOTS), dtype=torch.int64)
    before = tmerge.LAUNCHES["plain"]
    tmerge.merge_plain(qrec, grid, tmerge.scalars(grid, 0.4), (0, 1, 3, 4, 5),
                       False, work=work, pair_batch=997)
    assert tmerge.LAUNCHES["plain"] == before + 1
    w = dict(zip(tmerge.WORK_SLOTS, work.tolist()))
    lo, hi = tmerge.photon_ranges(qrec, grid.keys,
                                  tmerge.kind_mask((0, 1, 3, 4, 5)))
    assert w["examined"] == int((hi - lo).sum()) > w["in_radius"] > 0
    # Every query with a non-zero sum accepted at least one pair.
    assert w["accepted"] >= int((got != 0).any(axis=1).sum()) > 0
    assert w["in_radius"] >= sum(w[k] for k in tmerge.WORK_SLOTS[2:6]) \
        >= w["accepted"]


def test_merge_rows_routes_by_device():
    rs = np.random.RandomState(4)
    ph = _photons(rs, 200)
    _, grid = _grids(ph, 0.1)
    qrec = torch.zeros((5, tmerge.QREC_W))
    scal = tmerge.scalars(grid, 0.1)
    before = dict(tmerge.LAUNCHES)
    out = tmerge.merge_rows(qrec, grid, scal, (0,), False)
    assert out.shape == (5, 8) and float(out.abs().sum()) == 0.0
    assert tmerge.LAUNCHES["plain"] == before["plain"] + 1
    assert tmerge.LAUNCHES["merge"] == before["merge"]
    with pytest.raises(ValueError):
        tmerge.merge_cuda(qrec, grid, scal, (0,), False)
