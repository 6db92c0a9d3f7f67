"""The light band's tail of the port (imbatracer_torch.ops.light_tail: the
collect append and the camera splat; their plain PyTorch versions on
the CPU) against the JAX package's functions they stand for:
light_cache.append_packed (the drop-mode scatter after the cache's rows)
and film.splat (segment_sum with a trash segment).

Tolerances: the appended rows and the count equal bit for bit, `lost`
the rows JAX drops; the splat's film within 1e-6 relative (the packages
sum a pixel's few contributions in their own order).  The kernels
themselves are held against these plain versions by
tests/test_torch_kernel_cuda.py and chip_smoke.py on the card.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imbatracer_tpu.render import film as jfilm
from imbatracer_tpu.render import light_cache as jlc
from imbatracer_torch import libbuild
from imbatracer_torch.ops import light_tail as lt
from imbatracer_torch.render import film as tfilm
from imbatracer_torch.render import light_cache as tlc
from torch_threads import cap_torch_threads

cap_torch_threads()


def _rows(rs, n):
    """A packed (n, 24) batch as the light pass stages it: int columns,
    the pad column 0."""
    rows = rs.randn(n, tlc.REC_W).astype(np.float32)
    for c in (14, 21, 22):
        rows[:, c] = rs.randint(0, 1 << 20, n).astype(np.int32).view(
            np.float32)
    rows[:, 23] = 0.0
    return rows


@pytest.mark.parametrize("case", ["empty", "partial", "overflow", "full",
                                  "none_valid"])
def test_plain_append_matches_jax(case):
    """count0 rows appended first (all valid), then a band of 1000 rows
    with a seeded valid mask: the port's rec[:C] and count bit-equal to
    JAX's cache, `lost` the rows JAX dropped past its capacity, and
    CollectCache.check raising exactly then."""
    cap, count0, share = {"empty": (3000, 0, 0.4),
                          "partial": (2000, 300, 0.4),
                          "overflow": (1000, 900, 0.4),
                          "full": (700, 700, 0.4),
                          "none_valid": (500, 20, 0.0)}[case]
    rs = np.random.RandomState(len(case))
    first, band = _rows(rs, max(count0, 1)), _rows(rs, 1000)
    valid = rs.rand(1000) < share
    j = jlc.empty_cache(cap)
    collect = tlc.empty_collect(cap, "cpu")
    if count0:
        j = jlc.append_packed(j, jnp.ones(count0, bool), jnp.asarray(first))
        collect.append(torch.ones(count0, dtype=torch.bool),
                       torch.from_numpy(first))
    j = jlc.append_packed(j, jnp.asarray(valid), jnp.asarray(band))
    before = lt.LAUNCHES["collect_append_plain"]
    collect.append(torch.from_numpy(valid), torch.from_numpy(band))
    assert lt.LAUNCHES["collect_append_plain"] == before + 1
    np.testing.assert_array_equal(
        collect.rec[:cap].numpy().view(np.uint32),
        np.asarray(j.packed()).view(np.uint32))
    assert int(collect.count) == int(j.count) == min(count0 + valid.sum(),
                                                     cap)
    lost = max(count0 + int(valid.sum()) - cap, 0)
    assert int(collect.lost) == lost
    if lost:
        with pytest.raises(RuntimeError, match="overflow"):
            collect.check()
    else:
        collect.check()


@pytest.mark.parametrize("case", ["empty", "partial", "overflow", "full",
                                  "none_valid"])
def test_plain_append_key_columns_match_jax(case):
    """The cases of test_plain_append_matches_jax: the port's key columns
    [:C] equal JAX's path_length and path_id columns slot for slot, bit
    for bit (the slots no row reached zero in both), and equal the
    appended rows' own columns 21-22."""
    cap, count0, share = {"empty": (3000, 0, 0.4),
                          "partial": (2000, 300, 0.4),
                          "overflow": (1000, 900, 0.4),
                          "full": (700, 700, 0.4),
                          "none_valid": (500, 20, 0.0)}[case]
    rs = np.random.RandomState(len(case) + 50)
    first, band = _rows(rs, max(count0, 1)), _rows(rs, 1000)
    valid = rs.rand(1000) < share
    j = jlc.empty_cache(cap)
    collect = tlc.empty_collect(cap, "cpu")
    assert collect.keys.shape == (cap + 1, 2)
    assert collect.keys.dtype == torch.int32
    if count0:
        j = jlc.append_packed(j, jnp.ones(count0, bool), jnp.asarray(first))
        collect.append(torch.ones(count0, dtype=torch.bool),
                       torch.from_numpy(first))
    j = jlc.append_packed(j, jnp.asarray(valid), jnp.asarray(band))
    collect.append(torch.from_numpy(valid), torch.from_numpy(band))
    keys = collect.keys[:cap].numpy()
    np.testing.assert_array_equal(keys[:, 0], np.asarray(j.path_length))
    np.testing.assert_array_equal(keys[:, 1], np.asarray(j.path_id))
    rows = collect.rec[:cap].numpy().view(np.int32)
    np.testing.assert_array_equal(keys, rows[:, 21:23])
    cache = collect.cache()
    assert cache.keys.shape == (cap, 2)
    assert cache.keys.data_ptr() == collect.keys.data_ptr()


@pytest.mark.parametrize("num_pixels,n", [(4096, 6000), (300, 200)])
def test_plain_splat_matches_jax(num_pixels, n):
    """A band's camera connections, about a third without a pixel: the
    port's fresh film within 1e-6 relative of JAX's segment sum."""
    rs = np.random.RandomState(n)
    contrib = rs.uniform(0.0, 2.0, (n, 3)).astype(np.float32)
    pixel = np.where(rs.rand(n) < 0.35, -1,
                     rs.randint(0, num_pixels, n)).astype(np.int32)
    want = np.asarray(jfilm.splat(jnp.asarray(contrib), jnp.asarray(pixel),
                                  num_pixels))
    before = lt.LAUNCHES["splat_plain"]
    got = tfilm.splat(torch.from_numpy(contrib), torch.from_numpy(pixel),
                      num_pixels)
    assert lt.LAUNCHES["splat_plain"] == before + 1
    assert got.shape == (num_pixels, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_binding_matches_the_kernel():
    """The row width the kernel copies (csrc/light_tail.cu kRecW) is the
    cache's, and the most staged rows the wrapper takes are the kernel's
    status words' tiles (kMaxTiles) of csrc/lookback.cuh's kTile rows."""
    def consts(name):
        with open(f"{libbuild.CSRC}/{name}") as fh:
            return {k: int(v) for k, v in re.findall(
                r"constexpr int (k\w+) = ([0-9]+)", fh.read())}
    tail, tile = consts("light_tail.cu"), consts("lookback.cuh")
    assert tail["kRecW"] == lt.REC_W == tlc.REC_W
    assert tail["kMaxTiles"] * tile["kThreads"] * tile["kFlags"] == (
        lt.APPEND_MAX_ROWS)


def test_cpu_tensors_never_build_the_kernels(monkeypatch):
    def refuse():
        raise AssertionError("the light_tail library was built for CPU "
                             "tensors")

    monkeypatch.setattr(lt, "_library", refuse)
    rs = np.random.RandomState(0)
    collect = tlc.empty_collect(100, "cpu")
    collect.append(torch.from_numpy(rs.rand(64) < 0.5),
                   torch.from_numpy(_rows(rs, 64)))
    tfilm.splat(torch.ones(64, 3), torch.arange(64, dtype=torch.int32), 80)
