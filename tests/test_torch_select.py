"""The VCM frame's middle in the port (imbatracer_torch.ops.select: the
collect selection's sort keys and gather; ops/merge.py: the photon
grid's keys and tiles; their plain PyTorch versions on the CPU) against
the JAX package's jitted select_shallowest, canonicalize and
build_merge_grid, bit for bit.

Cases: fewer valid rows than the working capacity, as many, more (the
selection cuts), none, and a capacity at or above the cache's (the
canonical order alone); each with 32-bit sort keys (the frame's bounds
on path ids and lengths) and with 64-bit ones (no bounds).  The frame's
route from a CollectCache (its rows and the count its check reads)
gives the rows of select_shallowest over collect.cache() and the grid
that build_merge_grid gives of the selected cache's columns.  The
kernels themselves are held against these plain versions by
tests/test_torch_kernel_cuda.py and chip_smoke.py on the card.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imbatracer_tpu.ops import pallas_merge as jmerge
from imbatracer_tpu.render import light_cache as jlc
from imbatracer_torch import libbuild
from imbatracer_torch.ops import merge as tmerge
from imbatracer_torch.ops import select as tsel
from imbatracer_torch.render import light_cache as tlc
from imbatracer_torch.render.integrators import vcm as tvcm
from torch_threads import cap_torch_threads

cap_torch_threads()

NUM_C = 600              # the collect cache's rows
PATHS, MAX_LEN = 300, 6  # path ids < PATHS, lengths 2 .. MAX_LEN + 1
BOUNDS = tvcm.key_bounds(PATHS, MAX_LEN)


def _rows(rs, n):
    """n packed rows as the light pass stages them, with unique (path_id,
    path_length) pairs in a shuffled order and a zero pad column."""
    rows = rs.randn(n, tlc.REC_W).astype(np.float32)
    pairs = rs.permutation(PATHS * MAX_LEN)[:n]
    rows[:, 14] = rs.randint(0, 9, n).astype(np.int32).view(np.float32)
    rows[:, 21] = (pairs % MAX_LEN + 2).astype(np.int32).view(np.float32)
    rows[:, 22] = (pairs // MAX_LEN).astype(np.int32).view(np.float32)
    rows[:, 23] = 0.0
    return rows


def _caches(n, seed=0):
    """The same n valid rows in a JAX and a port cache of NUM_C rows."""
    rows = _rows(np.random.RandomState(seed), n)
    j = jlc.append_packed(jlc.empty_cache(NUM_C), jnp.ones(n, bool),
                          jnp.asarray(rows))
    return j, tlc.from_rows(torch.from_numpy(rows), NUM_C)


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype.itemsize == 4 else x


def _assert_rows(port, j):
    """The port cache's packed rows and count bit-equal to the JAX
    cache's."""
    assert int(port.count) == int(j.count)
    a, b = port.packed().numpy(), np.asarray(j.packed())
    assert a.shape == b.shape
    np.testing.assert_array_equal(_bits(a), _bits(b))


def _assert_grid(port, ref):
    for name in ("tiles", "keys", "bbox_min", "inv_cell", "radius_sqr"):
        a, b = np.asarray(getattr(port, name)), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)


def _assert_column(cache):
    """The plain gather's (rows, 4) position column: the kept rows' pos
    and a zero, zero past the count."""
    kept = int(cache.count)
    col = cache.pos4.numpy()
    assert col.shape == (cache.capacity, tsel.POS_W)
    np.testing.assert_array_equal(_bits(col[:kept, 0:3]),
                                  _bits(cache.packed().numpy()[:kept, 0:3]))
    assert not col[:, 3].any() and not col[kept:].any()


def _jax_grid(cache, radius):
    valid = jnp.arange(cache.capacity) < cache.count
    return jmerge.build_merge_grid(cache.pos, valid, jnp.float32(radius),
                                   cache.w_out, cache.throughput,
                                   cache.d_vcm, cache.d_vm)


@pytest.mark.parametrize("bounds", [BOUNDS, {}], ids=["keys32", "keys64"])
@pytest.mark.parametrize("n,cap", [(250, 400), (400, 400), (550, 400),
                                   (0, 400), (550, NUM_C), (320, 900)],
                         ids=["fewer", "equal", "cut", "empty",
                              "canonical", "canonical_above"])
def test_plain_selection_and_grid_match_jax(n, cap, bounds):
    """select_shallowest (count from the host or read), and the photon
    grid of the kept rows, against JAX's select_shallowest and
    build_merge_grid bit for bit."""
    j, t = _caches(n, seed=n + cap)
    jsel = jlc.select_shallowest(j, cap)
    for count in (n, None):
        got = tlc.select_shallowest(t, cap, count=count, **bounds)
        _assert_rows(got, jsel)
        assert got.box is None                 # the plain gather's
        _assert_column(got)
    _assert_grid(tvcm.photon_grid(got, 0.07), _jax_grid(jsel, 0.07))
    if cap >= NUM_C:
        _assert_rows(tlc.canonicalize(t), jlc.canonicalize(j))


@pytest.mark.parametrize("n,cap,face", [(0, 400, False), (400, 400, False),
                                        (550, 400, False), (250, 400, False),
                                        (250, 400, True)],
                         ids=["count_0", "count_rows", "cut_to_rows",
                              "count_below_rows", "max_face"])
def test_grid_keys_from_the_column_match_jax(n, cap, face):
    """grid_keys_plain fed from the selection's position column: its
    keys (after the stable sort, padded to whole tiles), bbox_min and
    inv_cell equal JAX's build_merge_grid of the selected cache bit for
    bit, with no photon, every row a photon, fewer photons than rows,
    and (`face`) a tenth of the photons on the box's maximum face, where
    the cell of the maximum coordinate is clamped."""
    rows = _rows(np.random.RandomState(20 + n + face), n)
    if face:
        rows[: n // 10, 0:3] = rows[:, 0:3].max(axis=0)
    j = jlc.append_packed(jlc.empty_cache(NUM_C), jnp.ones(n, bool),
                          jnp.asarray(rows))
    t = tlc.from_rows(torch.from_numpy(rows), NUM_C)
    got = tlc.select_shallowest(t, cap, count=n, **BOUNDS)
    _assert_column(got)
    for radius in (0.07, 2.0):
        ref = _jax_grid(jlc.select_shallowest(j, cap), radius)
        valid = torch.arange(cap) < got.count
        key, bbox_min, inv_cell = tmerge.grid_keys_plain(
            got.pos4[:, 0:3], valid, torch.tensor(radius))
        pad = torch.full((-cap % tmerge.PT,), tmerge.PAD_KEY,
                         dtype=torch.int32)
        keys = torch.cat([torch.sort(key, stable=True)[0], pad])
        for name, a in (("keys", keys), ("bbox_min", bbox_min),
                        ("inv_cell", inv_cell)):
            b = np.array(getattr(ref, name))
            assert a.numpy().dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(_bits(a.numpy()), _bits(b),
                                          err_msg=name)


def test_key_width_follows_the_bounds():
    """32-bit keys exactly when both keys fit in 31 bits, and both widths
    order the valid rows alike."""
    assert tsel.key_bits(2 ** 11, 2 ** 20) == 20
    assert tsel.key_bits(2 ** 11 + 1, 2 ** 20) is None
    assert tsel.key_bits(10, 1 << 20) == 20 and tsel.key_bits(10, 2) == 1
    assert tsel.key_bits(None, 8) is None and tsel.key_bits(8, None) is None
    rec = torch.from_numpy(_rows(np.random.RandomState(5), 500))
    for mode, (major, minor) in ((tsel.SHALLOW, (MAX_LEN + 2, PATHS)),
                                 (tsel.CANONICAL, (PATHS, MAX_LEN + 2))):
        bits = tsel.key_bits(major, minor)
        k32 = tsel.select_keys_plain(rec, 500, None, mode, bits)
        k64 = tsel.select_keys_plain(rec, 500, None, mode, None)
        assert k32.dtype == torch.int32 and k64.dtype == torch.int64
        assert torch.equal(torch.sort(k32, stable=True)[1],
                           torch.sort(k64, stable=True)[1])
    # A path count past the 32-bit room: the frame's keys are 64-bit.
    assert tsel.key_bits(10, 1 << 28) is None


@pytest.mark.parametrize("ordered", [False, True], ids=["first_n", "order"])
@pytest.mark.parametrize("mode", [tsel.SHALLOW, tsel.CANONICAL],
                         ids=["shallow", "canonical"])
@pytest.mark.parametrize("wide", [False, True], ids=["keys32", "keys64"])
def test_keys_from_the_columns_equal_the_rows(mode, wide, ordered):
    """The sort keys from the (C, 2) int32 key columns (stride 2) equal
    those from the packed rows' columns 21-22 (stride 24), bit for bit, in
    both modes and widths, over the first n rows and through an order."""
    rs = np.random.RandomState(11 + mode + 2 * wide + 4 * ordered)
    rec = torch.from_numpy(_rows(rs, NUM_C))
    cols = tsel.key_pairs(rec)
    assert cols.shape == (NUM_C, 2) and cols.stride() == (tlc.REC_W, 1)
    keys = cols.contiguous()
    assert tsel.key_pairs(keys) is keys and keys.stride() == (2, 1)
    major, minor = ((MAX_LEN + 2, PATHS) if mode == tsel.SHALLOW
                    else (PATHS, MAX_LEN + 2))
    bits = None if wide else tsel.key_bits(major, minor)
    n = 450
    order = (torch.from_numpy(rs.permutation(NUM_C)[:n]).long() if ordered
             else None)
    a = tsel.select_keys(keys, n, order, mode, bits)
    b = tsel.select_keys(rec, n, order, mode, bits)
    assert a.dtype == (torch.int64 if wide else torch.int32)
    assert a.shape == (n,) and torch.equal(a, b)


def test_rows_past_the_kept_ones_are_zero():
    """Rows of the source past its count are not copied: the output's
    rows past the kept count are zero (the gather of a zeroed cache's
    invalid rows, as the frame's collect buffer has them)."""
    j, _ = _caches(250, seed=7)
    rec = torch.from_numpy(np.random.RandomState(8).randn(
        NUM_C, tlc.REC_W).astype(np.float32))
    rec[:250] = torch.from_numpy(np.array(j.packed())[:250])
    t = tlc.LightVertexCache(rec, torch.tensor(250, dtype=torch.int32))
    for cap in (400, NUM_C):
        got = tlc.select_shallowest(t, cap, count=250, **BOUNDS)
        _assert_rows(got, jlc.select_shallowest(j, cap))
        assert not got.packed()[250:].any()


def test_frame_route_from_the_collect_cache():
    """The frame's middle from a CollectCache: the count from check(), 32-
    bit keys from the frame's bounds, the grid of the selected rows --
    the rows of select_shallowest(collect.cache(), cap) with a host read
    and 64-bit keys, the grid build_merge_grid gives of its contiguous
    columns, and JAX's."""
    rs = np.random.RandomState(9)
    collect = tlc.empty_collect(NUM_C, "cpu")
    rows = _rows(rs, 900)
    valid = rs.rand(900) < 0.6
    collect.append(torch.from_numpy(valid[:450]),
                   torch.from_numpy(rows[:450]))
    collect.append(torch.from_numpy(valid[450:]),
                   torch.from_numpy(rows[450:]))
    count = collect.check()
    assert count == int(valid.sum()) > 400
    got = tlc.select_shallowest(collect.cache(), 400, count=count, **BOUNDS)
    ref = tlc.select_shallowest(collect.cache(), 400)
    assert torch.equal(got.packed(), ref.packed())
    j = jlc.append_packed(jlc.empty_cache(NUM_C), jnp.asarray(valid),
                          jnp.asarray(rows))
    _assert_rows(got, jlc.select_shallowest(j, 400))
    radius = torch.tensor(0.05)
    grid = tvcm.photon_grid(got, radius)
    valid_rows = torch.arange(400) < got.count
    today = tmerge.build_merge_grid(
        got.pos.contiguous(), valid_rows, radius, got.w_out.contiguous(),
        got.throughput.contiguous(), got.d_vcm.contiguous(),
        got.d_vm.contiguous())
    _assert_grid(grid, today)
    _assert_grid(grid, _jax_grid(jlc.select_shallowest(j, 400), 0.05))


def test_box_floats_decodes_the_kernel_bits():
    """box_floats undoes select.cu's order-preserving bits (the min slots
    complemented, zero = no photon) as box_plain gives the box."""
    vals = np.array([-3.5, 0.0, 2.25, 7.0, -0.0, 1e-20], np.float32)
    u = vals.view(np.uint32).astype(np.uint64)
    enc = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    enc[:3] = ~enc[:3] & 0xFFFFFFFF
    box = torch.from_numpy(enc.astype(np.uint32).view(np.int32))
    got = tsel.box_floats(box).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), vals.view(np.uint32))
    empty = tsel.box_floats(torch.zeros(6, dtype=torch.int32))
    assert torch.equal(empty, tsel.box_plain(torch.zeros(4, 24), 0))


def test_binding_matches_the_kernels():
    """The row layout, key modes and grid constants of csrc/select.cu and
    csrc/grid_build.cu are the Python side's, and the key columns that
    csrc/light_tail.cu writes are the columns the keys read from a row."""
    def consts(name):
        with open(f"{libbuild.CSRC}/{name}") as fh:
            return {k: int(v) for k, v in re.findall(
                r"constexpr int (k\w+) = ([0-9]+)", fh.read())}
    sel, tail = consts("select.cu"), consts("light_tail.cu")
    assert (sel["kRecW"], tail["kColLength"], tail["kColId"]) == (
        tsel.REC_W, tsel.COL_LENGTH, tsel.COL_ID) == (tlc.REC_W, 21, 22)
    assert (sel["kShallow"], sel["kCanonical"]) == (tsel.SHALLOW,
                                                    tsel.CANONICAL)
    grid = consts("grid_build.cu")
    assert (grid["kRecW"], grid["kGrid"], grid["kPT"], grid["kRows"]) == (
        tmerge.REC_W, tmerge.GRID, tmerge.PT, tmerge.PREC_ROWS)
    with open(f"{libbuild.CSRC}/grid_build.cu") as fh:
        src = fh.read()
    assert "kPadKey = 1 << 25;" in src and tmerge.PAD_KEY == 1 << 25
    # The position column: (rows, 4) float4 words, written by the gather
    # and read by the grid's keys.
    assert tsel.POS_W == tmerge.POS_W == 4
    assert "grid_keys_kernel(const float4* pos," in src
    with open(f"{libbuild.CSRC}/select.cu") as fh:
        assert "unsigned* box, float4* pos)" in fh.read()


def test_cpu_tensors_never_build_the_kernels(monkeypatch):
    def refuse():
        raise AssertionError("a middle kernel library was built for CPU "
                             "tensors")

    monkeypatch.setattr(tsel, "_library", refuse)
    monkeypatch.setattr(tmerge, "_grid_library", refuse)
    before = dict(tsel.LAUNCHES)
    _, t = _caches(500, seed=3)
    cache = tlc.select_shallowest(t, 400, count=500, **BOUNDS)
    tvcm.photon_grid(cache, 0.07)
    assert tsel.LAUNCHES["select_keys_plain"] == before[
        "select_keys_plain"] + 2
    assert tsel.LAUNCHES["select_gather_plain"] == before[
        "select_gather_plain"] + 1
    assert tsel.LAUNCHES["select_keys"] == before["select_keys"]
