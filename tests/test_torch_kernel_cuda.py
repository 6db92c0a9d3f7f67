"""The CUDA kernels (the traversal kernels csrc/stream_traverse.cu, its
instanced variant included, csrc/khit_traverse.cu and
csrc/pairs_kernel.cu, and the photon-merge kernel csrc/merge_kernel.cu)
against their plain PyTorch versions on the same inputs.  Needs an
NVIDIA GPU and nvcc: the kernels have no CPU or interpret mode, so every
test here is marked `cuda` and skips without a card.  This file imports no jax, so it also runs on
a machine without it:

    python -m pytest --noconftest -q tests/test_torch_kernel_cuda.py

Tolerances: the kernels are built with --fmad=false and round every
product and sum in the plain version's order, so t/u/v are expected bit
for bit; the tests allow 1e-5 relative.  Ids are equal except where the
two hits have bit-equal t; any-hit flags may differ on 1 ray in 4096.
The k-nearest t vectors must be equal.  Merge sums agree within 1e-4
relative (only powf and torch.pow round differently), with equal counted
work.
"""

from functools import partial

import numpy as np
import pytest
import torch

from imbatracer_torch.ops import khit as kh
from imbatracer_torch.ops import stream_traverse as st
from imbatracer_torch.render import traverse as tt
from imbatracer_torch.render.intersect import BIG
from imbatracer_torch.scene.procedural import (make_big_scene,
                                               make_leaf_scene)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the traversal kernel has no CPU "
                    "or interpret mode")
    return torch.device("cuda")


def _rays(n, seed, scene, occl):
    rs = np.random.RandomState(seed)
    org = rs.uniform((-30, 1, -30), (30, 10, 30), (n, 3)).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    act = torch.from_numpy(rs.rand(n) < 0.8)
    tmax = torch.from_numpy(rs.uniform(0.5, 12.0, n).astype(np.float32))
    org = torch.from_numpy(org) - scene.bvh.center
    rays, _ = st.rays8(org, torch.from_numpy(d), 1e-3,
                       tmax if occl else BIG, act)
    return rays


@pytest.mark.cuda
@pytest.mark.parametrize("occl", [False, True])
def test_cuda_kernel_matches_plain(cuda_device, occl):
    scene, _ = make_big_scene(110, seed=9, device="cpu")   # S = 2
    rays = _rays(4096, 7, scene, occl)
    gpu = scene.to(cuda_device)
    key = "any_hit" if occl else "closest_hit"
    before = st.LAUNCHES[key]
    k = st.traverse(rays.to(cuda_device), gpu.bvh.sbox, gpu.bvh.tiles, occl)
    assert st.LAUNCHES[key] == before + 1
    p = st.traverse_plain(rays, scene.bvh.sbox, scene.bvh.tiles, occl)
    k = k.cpu()
    if occl:
        assert int((k[:, 0] != p[:, 0]).sum()) <= 1
        assert 0.0 < float(p[:, 0].mean()) < 1.0
        return
    tie = (k[:, 3] != p[:, 3]) & (k[:, 0] == p[:, 0])
    assert bool(((k[:, 3] == p[:, 3]) | tie).all())
    same = k[:, 3] == p[:, 3]
    assert int((p[:, 3] >= 0).sum()) > 100
    torch.testing.assert_close(k[same, :3], p[same, :3], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.cuda
def test_cuda_traversal_api_and_input_checks(cuda_device):
    scene, _ = make_big_scene(110, seed=9, device="cpu")
    gpu = scene.to(cuda_device)
    rs = np.random.RandomState(3)
    org = torch.from_numpy(rs.uniform(-20, 20, (1000, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(
        torch.from_numpy(rs.randn(1000, 3).astype(np.float32)), dim=1)
    for sort in (False, True):
        hc = tt.closest_hit(scene.bvh, org, d, 0.0, BIG, sort=sort)
        hg = tt.closest_hit(gpu.bvh, org.to(cuda_device), d.to(cuda_device),
                            0.0, BIG, sort=sort)
        assert torch.equal(hc.prim_id, hg.prim_id.cpu())
        torch.testing.assert_close(hc.t, hg.t.cpu(), rtol=1e-5, atol=1e-6)
    bad = torch.zeros((100, 8), device=cuda_device)       # not a BLK multiple
    with pytest.raises(ValueError):
        st.traverse_cuda(bad, gpu.bvh.sbox, gpu.bvh.tiles, False)
    with pytest.raises(TypeError):
        st.traverse_cuda(torch.zeros((128, 8), dtype=torch.float64,
                                     device=cuda_device),
                         gpu.bvh.sbox, gpu.bvh.tiles, False)


@pytest.mark.cuda
@pytest.mark.parametrize("bounded", [False, True])
def test_cuda_khit_matches_plain(cuda_device, bounded):
    scene, _ = make_leaf_scene(300, seed=2, device="cpu")
    rays = _rays(4096, 11, scene, bounded)
    gpu = scene.to(cuda_device)
    before = kh.LAUNCHES["khit"]
    k = kh.khit(rays.to(cuda_device), gpu.bvh.sbox, gpu.bvh.tiles).cpu()
    assert kh.LAUNCHES["khit"] == before + 1
    p5 = kh.khit_plain(rays, scene.bvh.sbox, scene.bvh.tiles, k=kh.K + 1)
    p = p5[:, :8 * kh.K]
    assert torch.equal(k[:, 0::8], p[:, 0::8])
    kid, pid = k[:, 3::8], p[:, 3::8]
    # Ties include one between the K-th hit and the (K+1)-th.
    t5, id5 = p5[:, 0::8], p5[:, 3::8]
    tie = torch.zeros_like(kid, dtype=torch.bool)
    for a in range(kh.K):
        for b in range(kh.K + 1):
            if a != b:
                tie[:, a] |= (t5[:, a] == t5[:, b]) & (id5[:, b] >= 0)
    assert bool(((kid == pid) | tie).all())
    same = (kid == pid) & (pid >= 0)
    for f in (1, 2):
        torch.testing.assert_close(k[:, f::8][same], p[:, f::8][same],
                                   rtol=1e-5, atol=1e-5)
    assert int((pid[:, 0] >= 0).sum()) > 100


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["closest", "any", "khit"])
def test_cuda_counting_launch(cuda_device, kind):
    """The counting instantiation returns the kernel's rows, and its
    tallies are consistent: every entered chunk tests its 16 slots (a
    closest or khit walk), and the walk tests no more triangles than the
    plain version's walk without early exit enters."""
    scene, _ = make_leaf_scene(300, seed=2, device="cpu")
    rays = _rays(4096, 11, scene, kind == "any")
    gpu = scene.to(cuda_device)
    rg, sbox, tiles = rays.to(cuda_device), gpu.bvh.sbox, gpu.bvh.tiles
    launch = (partial(kh.khit_cuda, rg, sbox, tiles) if kind == "khit" else
              partial(st.traverse_cuda, rg, sbox, tiles, kind == "any"))
    lists = st.superchunk_candidates(rg, sbox)
    work = torch.zeros(len(st.WORK_SLOTS), dtype=torch.int64,
                       device=cuda_device)
    assert torch.equal(launch(lists=lists, work=work), launch(lists=lists))
    w = dict(zip(st.WORK_SLOTS, work.cpu().tolist()))
    mt = sum(w[k] for k in st.WORK_SLOTS[1:])
    cbox = st.cbox_rows(scene.bvh.tiles)
    live = (rays[:, 7] >= 0.0).nonzero(as_tuple=True)[0]
    plain_mt = st.CHUNK * sum(
        int(rr.shape[0])
        for r1, s1 in st._ray_superchunks(live, rays, scene.bvh.sbox)
        for rr, _, _ in st._pair_triangles(r1, s1, rays, cbox, None))
    assert w["mt_hit"] > 100 and w["slab"] > 0
    assert 0 < mt <= plain_mt
    if kind != "any":
        assert mt % st.CHUNK == 0


@pytest.mark.cuda
def test_cuda_masked_traversal_matches_cpu(cuda_device):
    from imbatracer_torch.render.integrators.pt import alpha_fn_for

    scene, _ = make_leaf_scene(300, seed=2, device="cpu")
    gpu = scene.to(cuda_device)
    rs = np.random.RandomState(4)
    org = torch.from_numpy(rs.uniform((-20, 1, -20), (20, 12, 20),
                                      (3000, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(
        torch.from_numpy(rs.randn(3000, 3).astype(np.float32)), dim=1)
    hc = tt.closest_hit(scene.bvh, org, d, 0.0, BIG,
                        alpha_fn=alpha_fn_for(scene))
    before = dict(kh.LAUNCHES)
    hg = tt.closest_hit(gpu.bvh, org.to(cuda_device), d.to(cuda_device), 0.0,
                        BIG, alpha_fn=alpha_fn_for(gpu))
    assert kh.LAUNCHES["khit"] > before["khit"]
    assert kh.LAUNCHES["plain"] == before["plain"]
    assert torch.equal(hc.t, hg.t.cpu())
    tie = (hc.prim_id != hg.prim_id.cpu())
    assert int(tie.sum()) <= 2


@pytest.mark.cuda
def test_cuda_khit_input_checks(cuda_device):
    scene, _ = make_leaf_scene(300, seed=2, device=cuda_device)
    with pytest.raises(ValueError):
        kh.khit_cuda(torch.zeros((100, 8), device=cuda_device),
                     scene.bvh.sbox, scene.bvh.tiles)
    with pytest.raises(TypeError):
        kh.khit_cuda(torch.zeros((128, 8), dtype=torch.float64,
                                 device=cuda_device),
                     scene.bvh.sbox, scene.bvh.tiles)


# --------------------------------------------------------------------------
# The photon-merge kernel (csrc/merge_kernel.cu)
# --------------------------------------------------------------------------

def _merge_case(seed, num_p=3000, num_q=2000, kinds=(0, 3, 4, 5),
                radius=0.07):
    """A photon grid and sorted query rows from a numpy seed."""
    from imbatracer_torch.ops import merge as mg

    rs = np.random.RandomState(seed)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))

    def unit(n):
        v = rs.randn(n, 3)
        return f32(v / np.linalg.norm(v, axis=1, keepdims=True))

    grid = mg.build_merge_grid(
        f32(rs.rand(num_p, 3)), torch.from_numpy(rs.rand(num_p) > 0.1),
        radius, unit(num_p), f32(rs.rand(num_p, 3)), f32(rs.rand(num_p)),
        f32(rs.rand(num_p)))
    n = unit(num_q)
    gn = torch.nn.functional.normalize(n + 0.1 * unit(num_q), dim=1)
    params = dict(kind=torch.from_numpy(rs.choice(kinds, num_q).astype(
        np.int32)), kd=f32(rs.rand(num_q, 3)), ks=f32(rs.rand(num_q, 3)),
        ns=f32(1.0 + rs.rand(num_q) * 30.0))
    qrec, _ = mg.prepare_queries(
        grid, f32(rs.rand(num_q, 3)), n, gn, unit(num_q), params,
        f32(rs.rand(num_q) * 2), f32(rs.rand(num_q) * 2),
        torch.from_numpy(rs.rand(num_q) > 0.15))
    return grid, qrec, mg.scalars(grid, 0.3)


@pytest.mark.cuda
@pytest.mark.parametrize("kinds,ppm", [((0,), False), ((0, 3, 4, 5), False),
                                       ((0, 3, 4, 5), True)])
def test_cuda_merge_matches_plain(cuda_device, kinds, ppm):
    """Per-query sums within 1e-4 relative (the two round alike but for
    powf against torch.pow), and the counting launch returns the
    kernel's rows with the plain version's tallies."""
    from imbatracer_torch.ops import merge as mg

    grid, qrec, scal = _merge_case(5, kinds=kinds)
    ggrid, gq, gs = grid.to(cuda_device), qrec.to(cuda_device), scal.to(
        cuda_device)
    before = mg.LAUNCHES["merge"]
    k = mg.merge_rows(gq, ggrid, gs, kinds, ppm)
    assert mg.LAUNCHES["merge"] == before + 1
    pw = torch.zeros(len(mg.WORK_SLOTS), dtype=torch.int64)
    p = mg.merge_plain(qrec, grid, scal, kinds, ppm, work=pw)
    kw = torch.zeros(len(mg.WORK_SLOTS), dtype=torch.int64,
                     device=cuda_device)
    assert torch.equal(mg.merge_cuda(gq, ggrid, gs, kinds, ppm, work=kw), k)
    k = k.cpu()
    scale = torch.clamp(p[:, :3].abs(), min=1e-6 * float(p[:, :3].abs().max()))
    assert float(((k[:, :3] - p[:, :3]).abs() / scale).max()) <= 1e-4
    assert torch.equal(k[:, 3:], torch.zeros_like(k[:, 3:]))
    assert float(p[:, :3].sum()) > 0.0
    assert torch.equal(kw.cpu(), pw)


@pytest.mark.cuda
def test_cuda_merge_input_checks(cuda_device):
    from imbatracer_torch.ops import merge as mg

    grid, qrec, scal = _merge_case(6, num_p=300, num_q=100)
    g = grid.to(cuda_device)
    with pytest.raises(ValueError):
        mg.merge_cuda(qrec, g, scal.to(cuda_device), (0,), False)   # on CPU
    with pytest.raises(ValueError):
        mg.merge_cuda(qrec[:, :20].contiguous().to(cuda_device), g,
                      scal.to(cuda_device), (0,), False)
    with pytest.raises(TypeError):
        mg.merge_cuda(qrec.double().to(cuda_device), g,
                      scal.to(cuda_device), (0,), False)


# --------------------------------------------------------------------------
# Two-level instancing (the stream kernel's INST variant) and the pair
# queue (csrc/pairs_kernel.cu)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def instanced_scene(tmp_path_factory):
    from imbatracer_torch.scene.build import build_scene
    from imbatracer_torch.scene.generate import write_instanced_scene

    path = write_instanced_scene(str(tmp_path_factory.mktemp("inst")))
    scene, _ = build_scene(path, device="cpu")
    assert scene.bvh.two_level
    return scene


def _inst_rays(n, seed, occl):
    rs = np.random.RandomState(seed)
    org = torch.from_numpy(rs.uniform((-8, 0, -8), (8, 4, 8),
                                      (n, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(
        torch.from_numpy(rs.randn(n, 3).astype(np.float32)), dim=1)
    act = torch.from_numpy(rs.rand(n) < 0.8)
    tmax = torch.from_numpy(rs.uniform(0.5, 6.0, n).astype(np.float32))
    rays, _ = st.rays8(org, d, 1e-3, tmax if occl else BIG, act)
    return rays


def _hold_rows(k, p, occl):
    """Kernel rows against plain rows: flags within 1 ray, ids equal
    except at bit-equal t, t/u/v within 1e-5 relative."""
    k = k.cpu()
    if occl:
        assert int((k[:, 0] != p[:, 0]).sum()) <= 1
        assert 0.0 < float(p[:, 0].mean()) < 1.0
        return
    tie = (k[:, 3] != p[:, 3]) & (k[:, 0] == p[:, 0])
    assert bool(((k[:, 3] == p[:, 3]) | tie).all())
    same = k[:, 3] == p[:, 3]
    assert int((p[:, 3] >= 0).sum()) > 100
    torch.testing.assert_close(k[same, :4], p[same, :4], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("occl", [False, True])
def test_cuda_instanced_kernel_matches_plain(cuda_device, instanced_scene,
                                             occl):
    scene = instanced_scene
    rays = _inst_rays(4096, 3, occl)
    gpu = scene.to(cuda_device)
    key = st.launch_key(occl, gpu.bvh.inst)
    before = st.LAUNCHES[key]
    k = st.traverse(rays.to(cuda_device), gpu.bvh.sbox, gpu.bvh.tiles, occl,
                    gpu.bvh.inst)
    assert st.LAUNCHES[key] == before + 1
    p = st.traverse_plain(rays, scene.bvh.sbox, scene.bvh.tiles, occl,
                          scene.bvh.inst)
    _hold_rows(k, p, occl)
    work = torch.zeros(len(st.WORK_SLOTS), dtype=torch.int64,
                       device=cuda_device)
    rg = rays.to(cuda_device)
    lists = st.superchunk_candidates(rg, gpu.bvh.sbox)
    args = (rg, gpu.bvh.sbox, gpu.bvh.tiles, occl)
    assert torch.equal(
        st.traverse_cuda(*args, lists=lists, work=work, inst=gpu.bvh.inst),
        st.traverse_cuda(*args, lists=lists, inst=gpu.bvh.inst))
    assert int(work[-1]) > 0
    with pytest.raises(ValueError):                       # tiles rows != S
        st.traverse_cuda(rg, gpu.bvh.sbox, gpu.bvh.tiles, occl)


@pytest.mark.cuda
@pytest.mark.parametrize("instanced", [False, True])
@pytest.mark.parametrize("occl", [False, True])
def test_cuda_pairs_kernel_matches_plain(cuda_device, instanced_scene,
                                         instanced, occl):
    """The pair kernel against its plain version on one queue, and the
    whole pairs route on the card against the stream route's plain
    version (S > K_MAX on both scenes, so the fallback runs)."""
    from imbatracer_torch.ops import pairs as pm

    if instanced:
        scene, rays = instanced_scene, _inst_rays(4096, 5, occl)
    else:
        scene, _ = make_big_scene(700, seed=9, device="cpu")      # S = 12
        rays = _rays(4096, 5, scene, occl)
    assert scene.bvh.sbox.shape[0] > pm.K_MAX
    gpu = scene.to(cuda_device)
    inst, ginst = scene.bvh.inst, gpu.bvh.inst
    idx, _, _, _ = pm.ray_candidates(rays, scene.bvh.sbox)
    qrows, sc, _ = pm.build_queue(idx, rays, scene.bvh.sbox.shape[0])
    key = st.launch_key(occl, inst)
    before = pm.LAUNCHES[key]
    k = pm.pairs(qrows.to(cuda_device), sc.to(cuda_device), gpu.bvh.tiles,
                 occl, ginst)
    assert pm.LAUNCHES[key] == before + 1
    p = pm.pairs_plain(qrows, sc, scene.bvh.tiles, occl, inst)
    if occl:
        assert int((k.cpu()[:, 0] != p[:, 0]).sum()) <= 1
    else:
        _hold_rows(k, p, occl)
    work = torch.zeros(len(st.WORK_SLOTS), dtype=torch.int64,
                       device=cuda_device)
    gq, gsc = qrows.to(cuda_device), sc.to(cuda_device)
    assert torch.equal(pm.pairs_cuda(gq, gsc, gpu.bvh.tiles, occl, ginst,
                                     work=work),
                       pm.pairs_cuda(gq, gsc, gpu.bvh.tiles, occl, ginst))

    route = pm.pair_rows(rays.to(cuda_device), gpu.bvh.sbox, gpu.bvh.tiles,
                         occl, ginst)
    plain = st.traverse_plain(rays, scene.bvh.sbox, scene.bvh.tiles, occl,
                              inst)
    _hold_rows(route, plain, occl)
