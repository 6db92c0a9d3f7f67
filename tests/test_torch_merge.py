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


@pytest.mark.parametrize("count", [0, 900, 437, -1],
                         ids=["none", "all", "some", "max_face"])
def test_grid_keys_from_a_position_column(count):
    """grid_keys_plain fed from a (P, 4) position column as the card's
    selection writes it (pos and a zero, zero past the count): keys
    (stably sorted and padded to whole tiles), bbox_min and inv_cell
    equal JAX's build_merge_grid of the photons bit for bit, with no
    photon valid, all, some, and (-1) half of them with a tenth on the
    box's maximum face."""
    rs = np.random.RandomState(17)
    pos = (2.0 * rs.rand(900, 3) - 0.5).astype(np.float32)
    if count < 0:
        count = 450
        pos[:45] = pos[:count].max(axis=0)
    valid = np.arange(900) < count
    col = np.zeros((900, 4), np.float32)
    col[:count, 0:3] = pos[:count]
    one = np.ones((900, 3), np.float32)
    for radius in (0.07, 1.5):
        j = jmerge.build_merge_grid(
            jnp.asarray(pos), jnp.asarray(valid), jnp.float32(radius),
            jnp.asarray(one), jnp.asarray(one), jnp.asarray(one[:, 0]),
            jnp.asarray(one[:, 0]))
        key, bbox_min, inv_cell = tmerge.grid_keys_plain(
            torch.from_numpy(col)[:, 0:3], torch.from_numpy(valid),
            torch.tensor(radius, dtype=torch.float32))
        pad = torch.full((-900 % tmerge.PT,), tmerge.PAD_KEY,
                         dtype=torch.int32)
        keys = torch.cat([torch.sort(key, stable=True)[0], pad])
        for name, a in (("keys", keys), ("bbox_min", bbox_min),
                        ("inv_cell", inv_cell)):
            b = np.array(getattr(j, name))
            assert a.numpy().dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                          b.view(np.uint32), err_msg=name)


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


# Words of a query row that the port copies from its inputs or computes
# from integers (pos, normal, gn, d_vcm, d_vm, kind, kd, ks, ns, the combo
# keys, active, the zero pad): equal to JAX's bit for bit.  The local frame
# (3:9) and the four projections (15:19) are products and sums, which XLA
# on the CPU may contract into FMAs: within ROW_ATOL (the inputs are unit
# vectors, |a| = 1 / (1 + |n_z|) <= 1, so every term is at most 1).
EXACT_WORDS = [*range(0, 3), *range(9, 15), *range(19, 40)]
ROUNDED_WORDS = [*range(3, 9), *range(15, 19)]
ROW_ATOL = 2e-6


def _jax_sorted_rows(monkeypatch, jgrid, q):
    """JAX merge_contrib's sorted query rows qrec_s (its first Q rows) and
    its inv_perm, recorded by wrapping _merge_call for the call (the
    Pallas kernel in interpret mode): the wrapper keeps qrec_s and writes
    each sorted row's index into column 0 of the kernel's output, which
    merge_contrib returns as out[inv_perm, 0:3]."""
    seen = {}
    real = jmerge._merge_call

    def spy(qrec_s, *args):
        seen["qrec_s"] = np.asarray(qrec_s)
        out = real(qrec_s, *args)
        return out.at[:, 0].set(jnp.arange(out.shape[0], dtype=jnp.float32))

    monkeypatch.setattr(jmerge, "_merge_call", spy)
    monkeypatch.setattr(jmerge, "INTERPRET", True)
    a = jnp.asarray
    out = jmerge.merge_contrib(
        jgrid, a(q["pos"]), a(q["n"]), a(q["gn"]), a(q["w_out"]),
        jmat.MatParams(_params(q, jnp)), a(q["d_vcm"]), a(q["d_vm"]),
        a(q["active"]), jnp.float32(0.3), kinds=(0,), ppm=False)
    num_q = q["pos"].shape[0]
    return seen["qrec_s"][:num_q], np.asarray(out)[:, 0].astype(np.int64)


PREP_CASES = {
    "q127": (127, "some"), "q128": (128, "some"), "q129": (129, "some"),
    "none_active": (129, "none"), "corner": (96, "corner")}


@pytest.mark.parametrize("case", list(PREP_CASES))
def test_prepare_queries_matches_jax_sorted_rows(monkeypatch, case):
    """prepare_queries' rows and permutation, and inverse_plain of the
    permutation, against the rows and inv_perm of JAX's merge_contrib:
    ragged Q around BLKQ, no query active, and queries at the box corner
    where the clamped combos collapse (keys -2)."""
    num_q, mode = PREP_CASES[case]
    rs = np.random.RandomState(31 + num_q)
    ph = _photons(rs, 300, spread=0.01 if mode == "corner" else 1.0)
    pos = (0.01 * rs.rand(num_q, 3)).astype(np.float32) \
        if mode == "corner" else None
    q = _queries(rs, num_q, (0,), pos=pos)
    if mode == "none":
        q["active"][:] = False
    if mode == "corner":
        ph["valid"][:] = True
        q["active"][:] = True
    jgrid, grid = _grids(ph, 0.2 if mode == "corner" else 0.07)
    want, want_inv = _jax_sorted_rows(monkeypatch, jgrid, q)
    t = torch.from_numpy
    qrec, perm = tmerge.prepare_queries(
        grid, t(q["pos"]), t(q["n"]), t(q["gn"]), t(q["w_out"]),
        tmat.MatParams(_params(q, torch)), t(q["d_vcm"]), t(q["d_vm"]),
        t(q["active"]))
    inv = tmerge.inverse_plain(perm)
    assert inv.dtype == torch.int32
    np.testing.assert_array_equal(inv.numpy(), want_inv)
    np.testing.assert_array_equal(perm.numpy(), np.argsort(want_inv))
    got = qrec.numpy()
    assert got.shape == want.shape == (num_q, tmerge.QREC_W)
    np.testing.assert_array_equal(got[:, EXACT_WORDS].view(np.uint32),
                                  want[:, EXACT_WORDS].view(np.uint32))
    np.testing.assert_allclose(got[:, ROUNDED_WORDS], want[:, ROUNDED_WORDS],
                               rtol=0, atol=ROW_ATOL)
    assert not got[:, 34:].any()
    keys = got[:, 29:33]
    if mode == "none":
        assert (keys == tmerge.INVALID).all() and not got[:, 33].any()
    if mode == "corner":
        assert (keys[:, 1:] == tmerge.INVALID).any()
    sort_key = tmerge.sort_keys_plain(grid, t(q["pos"]), t(q["active"]))
    assert torch.equal(sort_key[perm], torch.sort(sort_key, stable=True)[0])


def test_preparation_wrappers_refuse_cpu_tensors(monkeypatch):
    """The preparation's CUDA wrappers check their inputs before they
    build or launch anything: CPU tensors, a wrong dtype or shape raise."""
    def refuse():
        raise AssertionError("the merge library was built for CPU tensors")

    monkeypatch.setattr(tmerge, "_library", refuse)
    rs = np.random.RandomState(5)
    _, grid = _grids(_photons(rs, 100), 0.1)
    q = _queries(rs, 10, (0,))
    t = torch.from_numpy
    args = (grid, t(q["pos"]), t(q["n"]), t(q["gn"]), t(q["w_out"]),
            tmat.MatParams(_params(q, torch)), t(q["d_vcm"]), t(q["d_vm"]),
            t(q["active"]))
    with pytest.raises(ValueError):
        tmerge.prep_inputs(*args)
    with pytest.raises(ValueError):
        tmerge.prepare_cuda(*args)
    perm = torch.arange(10)
    with pytest.raises(ValueError):
        tmerge.inverse_cuda(perm)
    with pytest.raises(TypeError):
        tmerge.inverse_cuda(perm.to(torch.int32))
    with pytest.raises(ValueError):
        tmerge.inverse_cuda(perm.reshape(2, 5))
