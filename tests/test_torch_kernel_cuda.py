"""The CUDA kernels (the traversal kernels csrc/stream_traverse.cu, its
instanced variant included, and csrc/khit_traverse.cu, also above the
16,384 super-chunks a shared-memory candidate list holds, and over a
packing that references a triangle from several leaves; the pair
route's kernels csrc/pairs_kernel.cu; the photon-merge gather and its
query preparation csrc/merge_kernel.cu) against their plain PyTorch
versions on the same inputs.  Needs an
NVIDIA GPU and nvcc: the kernels have no CPU or interpret mode, so every
test here is marked `cuda` and skips without a card.  This file imports no jax, so it also runs on
a machine without it:

    python -m pytest --noconftest -q tests/test_torch_kernel_cuda.py

Tolerances: the kernels are built with --fmad=false and round every
product and sum in the plain version's order, so t/u/v are expected bit
for bit; the tests allow 1e-5 relative.  Ids are equal except where the
two hits have bit-equal t; any-hit flags may differ on 1 ray in 4096.
The k-nearest t vectors must be equal.  The kernels' candidate stage
must equal superchunk_candidates exactly: counts, and lists and keys up
to each block's count bit for bit (a key of -0 counts as +0), and so must
the pair route's per-ray candidates (ray_candidates: idx, count and
mindrop equal, entry t as bits).  The card's pair queue holds the lanes
of build_queue, run by run as sets, and segment_table's rows.  Merge sums
agree within 1e-4 relative (only powf and torch.pow round differently),
with equal counted work; the card's query rows equal prepare_queries' bit
for bit.
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
from torch_threads import cap_torch_threads

cap_torch_threads()


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


def _split_build_tiles(packing):
    """Stream tiles of long thin triangles (tests/test_sbvh.py's class)
    whose packing references triangles more than once: a split build at
    a reference budget of 3.0, or a binned build with every triangle
    referenced twice.  Returns (v0, sbox, tiles, center)."""
    from imbatracer_torch.accel.builder import build_bvh, triangle_bboxes
    from imbatracer_torch.accel.flatten import thread_bvh
    from imbatracer_torch.accel.native import build_sbvh_native

    rs = np.random.RandomState(0)
    n = 3000
    base = rs.rand(n, 3).astype(np.float32) * 10
    d1 = 3.0 + rs.randn(n, 3).astype(np.float32) * 0.05
    v = np.stack([base, base + d1,
                  base + rs.randn(n, 3).astype(np.float32) * 0.05], axis=1)
    v0, v1, v2 = v[:, 0], v[:, 1], v[:, 2]
    if packing == "split":
        nodes = build_sbvh_native(v, ref_budget=3.0)
    else:
        nodes = build_bvh(*triangle_bboxes(*(np.concatenate([x, x])
                                             for x in (v0, v1, v2))))
        nodes.prim_ids = nodes.prim_ids % n
    p = thread_bvh(nodes, v0, v1, v2)
    assert (p.tri_id >= 0).sum() > n
    sbox, tiles, center = st.pack_stream_tiles(p.tri_v0, p.tri_e1, p.tri_e2,
                                               p.tri_id)
    return v, torch.from_numpy(sbox), torch.from_numpy(tiles), \
        torch.from_numpy(center)


@pytest.mark.cuda
@pytest.mark.parametrize("packing", ["split", "doubled"])
def test_cuda_khit_drops_duplicate_references(cuda_device, packing):
    """khit over a packing that references triangles more than once: no
    row repeats an id, and the rows equal khit_plain's (t bit for bit,
    ids up to ties)."""
    v, sbox, tiles, center = _split_build_tiles(packing)
    rs = np.random.RandomState(4)
    r = 4096
    org = torch.from_numpy((rs.rand(r, 3) * 14 - 2).astype(np.float32))
    tri = v[rs.randint(0, v.shape[0], r)]
    aim = (rs.dirichlet((1, 1, 1), r)[:, :, None] * tri).sum(1)
    d = torch.nn.functional.normalize(
        torch.from_numpy(aim.astype(np.float32)) - org, dim=1)
    rays, _ = st.rays8(org - center, d, 0.0, BIG, None)
    k = kh.khit_cuda(rays.to(cuda_device), sbox.to(cuda_device),
                     tiles.to(cuda_device)).cpu()
    p5 = kh.khit_plain(rays, sbox, tiles, k=kh.K + 1)
    p = p5[:, :8 * kh.K]
    kid, pid = k[:, 3::8], p[:, 3::8]
    for a in range(kh.K):
        for b in range(a):
            assert not bool(((kid[:, a] >= 0) & (kid[:, a] == kid[:, b]))
                            .any())
    assert torch.equal(k[:, 0::8], p[:, 0::8])
    t5, id5 = p5[:, 0::8], p5[:, 3::8]
    tie = torch.zeros_like(kid, dtype=torch.bool)
    for a in range(kh.K):
        for b in range(kh.K + 1):
            if a != b:
                tie[:, a] |= (t5[:, a] == t5[:, b]) & (id5[:, b] >= 0)
    assert bool(((kid == pid) | tie).all())
    assert int((pid[:, 1] >= 0).sum()) > 500


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["closest", "any", "khit"])
def test_cuda_counting_launch(cuda_device, kind):
    """The counting instantiation returns the kernel's rows, and its
    tallies follow the count rule: the candidate stage tests each group
    box of 8 super-chunks once per ray (inactive lanes included) and the
    boxes of a group whose box a lane of the ray's warp enters; the walk's
    slab tests are super-chunk boxes and non-padding chunk boxes only,
    every chunk a thread enters is re-tested against its current bound
    before its triangles, and each one entered tests its 16 slots (a
    closest or khit walk); the walk tests no more triangles than the
    plain version's walk over the non-padding chunks without early exit
    enters."""
    scene, _ = make_leaf_scene(300, seed=2, device="cpu")
    rays = _rays(4096, 11, scene, kind == "any")
    gpu = scene.to(cuda_device)
    rg, sbox, tiles = rays.to(cuda_device), gpu.bvh.sbox, gpu.bvh.tiles
    launch = (partial(kh.khit_cuda, rg, sbox, tiles) if kind == "khit" else
              partial(st.traverse_cuda, rg, sbox, tiles, kind == "any"))
    work = torch.zeros(len(st.WORK_SLOTS), dtype=torch.int64,
                       device=cuda_device)
    assert torch.equal(launch(work=work), launch())
    w = dict(zip(st.WORK_SLOTS, work.cpu().tolist()))
    mt = sum(w[k] for k in st.WORK_SLOTS[1:7])
    num_s = scene.bvh.sbox.shape[0]
    groups = -(-num_s // 8)
    assert (rays.shape[0] * groups <= w["cand_slab"]
            <= rays.shape[0] * (groups + num_s))
    cbox = st.cbox_rows(scene.bvh.tiles)
    padding = cbox[..., 0] > cbox[..., 3]                    # (S, 64)
    live = (rays[:, 7] >= 0.0).nonzero(as_tuple=True)[0]
    plain_mt = 0
    pairs = 0
    for r1, s1 in st._ray_superchunks(live, rays, scene.bvh.sbox):
        pairs += int(r1.shape[0])
        for rr, ss, slot in st._pair_triangles(r1, s1, rays, cbox, None):
            keep = ~padding[ss, slot[:, 0] // st.CHUNK]
            plain_mt += st.CHUNK * int(keep.sum())
    # At most one super-chunk test per live ray and list entry, and the
    # non-padding chunks of each (ray, super-chunk) pair the plain walk
    # visits.
    chunks = int((~padding).sum(dim=1).max())
    assert 0 < w["slab"] <= live.shape[0] * num_s + pairs * chunks
    assert w["mt_hit"] > 100 and w["retest"] > 0
    assert 0 < mt <= plain_mt
    if kind != "any":
        assert mt % st.CHUNK == 0
        assert w["retest"] >= mt // st.CHUNK


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["big", "instanced", "inactive", "wide"])
def test_cuda_candidate_stage_matches_plain(cuda_device, instanced_scene,
                                            case):
    """The kernels' candidate stage (launched alone) against its plain
    version: counts, lists and keys.  `inactive`: every lane of the first
    blocks has tmax = -1; `wide`: 4,000 random boxes, whose list needs
    more than 48 KB of shared memory."""
    if case == "instanced":
        sbox = instanced_scene.bvh.sbox
        rays = _inst_rays(4096, 8, False)
    elif case == "wide":
        rs = np.random.RandomState(4)
        lo = rs.uniform(-30, 30, (4000, 3)).astype(np.float32)
        hi = lo + rs.uniform(0.1, 4.0, (4000, 3)).astype(np.float32)
        sbox = torch.from_numpy(np.concatenate(
            [lo, hi, np.zeros((4000, 2), np.float32)], 1))
        assert st.block_smem_bytes(4000) > 48 * 1024
        scene, _ = make_big_scene(110, seed=9, device="cpu")
        rays = _rays(4096, 8, scene, True)
    else:
        scene, _ = make_big_scene(700, seed=9, device="cpu")
        sbox = scene.bvh.sbox
        rays = _rays(4096, 8, scene, True)
        if case == "inactive":
            rays[:512, 7] = -1.0
    rg, sg = rays.to(cuda_device), sbox.to(cuda_device)
    before = st.LAUNCHES["candidates"]
    got = st.block_candidates(rg, sg)
    assert st.LAUNCHES["candidates"] == before + 1
    ref = st.superchunk_candidates(rays, sbox)
    assert st.candidate_mismatches(tuple(x.cpu() for x in got), ref) == \
        (0, 0, 0)
    assert int(ref[2].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["closest", "short", "any", "khit"])
def test_cuda_staging_batches_and_early_exit(cuda_device, kind):
    """Kernel against plain on unsorted rays through make_big_scene(700),
    whose 128-ray blocks enter more chunks of one super-chunk than
    several staging batches hold; `short` and `any` rays stop early
    (tmax of 0.5-12, any hit at the first hit)."""
    scene, _ = make_big_scene(700, seed=9, device="cpu")
    rays = _rays(4096, 13, scene, kind in ("short", "any"))
    sbox, tiles = scene.bvh.sbox, scene.bvh.tiles
    # The union of entered chunks per (block, super-chunk).
    cbox = st.cbox_rows(tiles)
    tn, tf = st._slab(cbox[None, :, :, 0:3], cbox[None, :, :, 3:6],
                      rays[:, None, None, 0:3],
                      st._safe_inv(rays[:, None, None, 4:7]))
    enter = ((tn <= tf) & (tf >= rays[:, 3, None, None])
             & (tn <= rays[:, 7, None, None]) & (rays[:, 7, None, None] >= 0)
             & ~(cbox[None, ..., 0] > cbox[None, ..., 3]))
    union = enter.view(-1, st.BLK, *enter.shape[1:]).any(dim=1).sum(dim=-1)
    assert int(union.max()) > 2 * 8                     # three batches
    gpu = scene.to(cuda_device)
    rg = rays.to(cuda_device)
    if kind == "khit":
        k = kh.khit_cuda(rg, gpu.bvh.sbox, gpu.bvh.tiles).cpu()
        p = kh.khit_plain(rays, sbox, tiles)
        assert torch.equal(k[:, 0::8], p[:, 0::8])
        return
    occl = kind == "any"
    k = st.traverse_cuda(rg, gpu.bvh.sbox, gpu.bvh.tiles, occl)
    _hold_rows(k, st.traverse_plain(rays, sbox, tiles, occl), occl)


@pytest.mark.cuda
def test_cuda_wide_list_launches(cuda_device):
    """A traversal launch whose candidate list needs more than 48 KB of
    shared memory (S = 4,000 boxes over tiles of padding only): every ray
    misses, and no chunk is entered."""
    rs = np.random.RandomState(6)
    num_s = 4000
    lo = torch.from_numpy(rs.uniform(-30, 30, (num_s, 3)).astype(np.float32))
    sbox = torch.cat([lo, lo + 2.0, torch.zeros(num_s, 2)], 1)
    tiles = torch.zeros((num_s, st.TILE_ROWS, st.TRI_ROWS))
    tiles[:, 4, :] = -1.0
    for r, v in zip((6, 7, 14, 15, 22, 23), (1e30,) * 3 + (-1e30,) * 3):
        tiles[:, r, :st.SUPER] = v
    scene, _ = make_big_scene(110, seed=9, device="cpu")
    rays = _rays(4096, 2, scene, False).to(cuda_device)
    work = torch.zeros(len(st.WORK_SLOTS), dtype=torch.int64,
                       device=cuda_device)
    out = st.traverse_cuda(rays, sbox.to(cuda_device), tiles.to(cuda_device),
                           False, work=work).cpu()
    assert bool((out[:, 3] == -1.0).all())
    assert torch.equal(out[:, 0], rays[:, 7].cpu())
    w = dict(zip(st.WORK_SLOTS, work.cpu().tolist()))
    assert st.resources(False, False, num_s)["dynamic_smem"] == \
        st.block_smem_bytes(num_s)
    assert w["cand_slab"] >= rays.shape[0] * (num_s // 8)
    assert w["slab"] > 0 and w["retest"] == 0 and w["mt_empty"] == 0


@pytest.fixture(scope="module")
def card_grid_bvhs():
    """chip_smoke.card_grid's 17,161 cards, above the 16,384 super-chunks a
    shared-memory list holds: its two-level BVH (one tile, one super-chunk
    an instance) and a flat BVH of one super-chunk a card (1.7 GB of
    tiles), both on the card."""
    import chip_smoke
    from imbatracer_torch.accel.device import DeviceBvh
    from imbatracer_torch.accel.instancing import build_two_level

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mesh, insts = chip_smoke.card_grid()
    tl = build_two_level([mesh], insts)
    two = DeviceBvh.from_two_level(tl.sbox, tl.tiles, tl.tile_idx,
                                   tl.inst_of, tl.itab, device="cuda")
    flat = chip_smoke.wide_flat_bvh(mesh, insts, "cuda")
    return two, flat


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["instanced", "flat", "khit", "candidates"])
def test_cuda_kernels_beyond_the_list_cap(cuda_device, card_grid_bvhs, kind):
    """Above MAX_SUPER the candidate lists go through a global buffer (a
    list launch, then the walk): the stream kernel (instanced and flat),
    khit and the candidate stage alone equal their plain versions, run on
    the card's tensors."""
    import chip_smoke

    two, (sbox, tiles) = card_grid_bvhs
    num_s = sbox.shape[0]
    assert num_s > st.MAX_SUPER and st.list_scratch_bytes(4096, num_s) > 0
    closest = chip_smoke.card_grid_rays(4096, 3).to(cuda_device)
    anyr = chip_smoke.card_grid_rays(4096, 3, bounded=True).to(cuda_device)
    if kind == "candidates":
        got = st.candidates_cuda(anyr, sbox)
        ref = st.superchunk_candidates(anyr, sbox)
        assert st.candidate_mismatches(got, ref) == (0, 0, 0)
        assert int(ref[2].sum()) > 0
        return
    if kind == "khit":
        k = kh.khit_cuda(closest, sbox, tiles)
        p = kh.khit_plain(closest, sbox, tiles)
        assert torch.equal(k[:, 0::8], p[:, 0::8])
        assert int((p[:, 3] >= 0).sum()) > 100
        return
    bvh_sbox, bvh_tiles, inst = ((two.sbox, two.tiles, two.inst)
                                 if kind == "instanced" else
                                 (sbox, tiles, None))
    for rays, occl in ((closest, False), (anyr, True)):
        work = torch.zeros(len(st.WORK_SLOTS), dtype=torch.int64,
                           device=cuda_device)
        k = st.traverse_cuda(rays, bvh_sbox, bvh_tiles, occl, work=work,
                             inst=inst)
        assert torch.equal(k, st.traverse_cuda(rays, bvh_sbox, bvh_tiles,
                                               occl, inst=inst))
        assert int(work[st.WORK_SLOTS.index("cand_slab")]) >= \
            rays.shape[0] * (num_s // 8)
        _hold_rows(k, st.traverse_plain(rays, bvh_sbox, bvh_tiles, occl,
                                        inst).cpu(), occl)


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
    args = (rg, gpu.bvh.sbox, gpu.bvh.tiles, occl)
    assert torch.equal(
        st.traverse_cuda(*args, work=work, inst=gpu.bvh.inst),
        st.traverse_cuda(*args, inst=gpu.bvh.inst))
    assert int(work[st.WORK_SLOTS.index("mt_hit")]) > 0
    with pytest.raises(ValueError):                       # tiles rows != S
        st.traverse_cuda(rg, gpu.bvh.sbox, gpu.bvh.tiles, occl)


def _pair_case(instanced_scene, instanced, occl, seed):
    """(scene on the CPU, rays (4096, 8)) of the pair tests: the instanced
    scene or make_big_scene(700) (S = 12), both above K_MAX."""
    from imbatracer_torch.ops import pairs as pm

    if instanced:
        scene, rays = instanced_scene, _inst_rays(4096, seed, occl)
    else:
        scene, _ = make_big_scene(700, seed=9, device="cpu")
        rays = _rays(4096, seed, scene, occl)
    assert scene.bvh.sbox.shape[0] > pm.K_MAX
    return scene, rays


@pytest.mark.cuda
@pytest.mark.parametrize("instanced", [False, True])
@pytest.mark.parametrize("occl", [False, True])
def test_cuda_pair_candidates_and_queue_match_plain(cuda_device,
                                                    instanced_scene,
                                                    instanced, occl):
    """The candidates kernel against ray_candidates (idx, count, mindrop
    equal, entry t as bits with -0 read as +0), and the card's queue
    against build_queue: each super-chunk's run holds the same pair
    slots, the counts are build_queue's, and the segment table is
    segment_table's.  k_max is 2, so that many rays saturate."""
    from imbatracer_torch.ops import pairs as pm

    scene, rays = _pair_case(instanced_scene, instanced, occl, 4)
    num_s = scene.bvh.sbox.shape[0]
    rg, sg = rays.to(cuda_device), scene.bvh.sbox.to(cuda_device)
    before = pm.LAUNCHES["candidates"]
    idx, ent, count, mindrop, hist, rank = pm.candidates_cuda(rg, sg, 2)
    assert pm.LAUNCHES["candidates"] == before + 1
    ridx, rent, rcount, rmin = pm.ray_candidates(rays, scene.bvh.sbox, 2)
    assert torch.equal(idx.cpu(), ridx)
    assert torch.equal(count.cpu(), rcount)
    assert torch.equal(mindrop.cpu(), rmin)
    assert torch.equal((ent.cpu() + 0.0).view(torch.int32),
                       (rent + 0.0).view(torch.int32))
    assert int((rcount > 2).sum()) > 0

    order, seg, nseg = pm.queue_cuda(idx, rank, hist)
    _, rsc, rorder = pm.build_queue(ridx, rays, num_s)
    total = int((ridx >= 0).sum())
    assert torch.equal(hist.cpu().long(),
                       torch.bincount(ridx[ridx >= 0].long(),
                                      minlength=num_s))
    got = order[:total].cpu().long()
    assert torch.equal(ridx.view(-1)[got].long(), rsc[:total].long())
    key = ridx.view(-1)[got].long() * ridx.numel() + got
    assert torch.equal(got[torch.sort(key)[1]], rorder[:total])
    tab = pm.segment_table(hist.cpu())
    assert int(nseg) == tab.shape[0]
    assert torch.equal(seg[:tab.shape[0]].cpu(), tab)


@pytest.mark.cuda
@pytest.mark.parametrize("instanced", [False, True])
@pytest.mark.parametrize("occl", [False, True])
def test_cuda_pairs_kernel_matches_plain(cuda_device, instanced_scene,
                                         instanced, occl):
    """The pair kernel against its plain version on the card's queue, the
    resolve kernel against resolve on the kernel's lanes, and the whole
    pairs route on the card against the stream route's plain version, at
    k_max 2 and K_MAX (S > K_MAX on both scenes; at 2 the fallback
    runs)."""
    from imbatracer_torch.ops import pairs as pm

    scene, rays = _pair_case(instanced_scene, instanced, occl, 5)
    gpu = scene.to(cuda_device)
    inst, ginst = scene.bvh.inst, gpu.bvh.inst
    rg = rays.to(cuda_device)
    sbox, tiles = gpu.bvh.sbox, gpu.bvh.tiles
    idx, _, count, mindrop, hist, rank = pm.candidates_cuda(rg, sbox, 2)
    k = idx.shape[1]
    order, seg, nseg = pm.queue_cuda(idx, rank, hist)
    key = st.launch_key(occl, inst)
    before = pm.LAUNCHES[key]
    lanes = pm.pairs_cuda(rg, sbox, tiles, order, seg, nseg, k, occl, ginst)
    assert pm.LAUNCHES[key] == before + 1
    total = int(hist.sum())
    slots = order[:total].long()
    rows = rg[slots // k].clone()
    p = pm.pairs_plain(rows.cpu(), idx.view(-1)[slots].cpu(),
                       scene.bvh.tiles, occl, inst)
    if occl:
        assert int((lanes[slots].cpu()[:, 0] != p[:, 0]).sum()) <= 1
    else:
        _hold_rows(lanes[slots], p, occl)
    work = torch.zeros(len(st.WORK_SLOTS), dtype=torch.int64,
                       device=cuda_device)
    again = pm.pairs_cuda(rg, sbox, tiles, order, seg, nseg, k, occl, ginst,
                          work=work)
    assert torch.equal(again[slots], lanes[slots])
    assert int(work[st.WORK_SLOTS.index("mt_hit")]) > 0

    out, _, sat, nsat = pm.resolve_cuda(rg, lanes, count, mindrop, k, occl)
    want, want_sat = pm.resolve(rg, lanes, count, mindrop, k, occl)
    assert torch.equal(out, want) and torch.equal(sat, want_sat)
    assert int(nsat) == int(want_sat.sum()) > 0

    plain = st.traverse_plain(rays, scene.bvh.sbox, scene.bvh.tiles, occl,
                              inst)
    for k_max in (2, pm.K_MAX):
        _hold_rows(pm.pair_rows(rg, sbox, tiles, occl, ginst, k_max), plain,
                   occl)


@pytest.mark.cuda
@pytest.mark.parametrize("kinds", [(0,), (0, 3, 4, 5)])
def test_cuda_merge_preparation_matches_plain(cuda_device, kinds):
    """The query preparation kernels against prepare_queries: rows and
    permutation bit for bit; and merge_contrib on the card (preparation,
    the gather writing each caller's row) against the CPU's, within the
    gather's 1e-4."""
    from imbatracer_torch.ops import merge as mg

    rs = np.random.RandomState(8)
    num_p, num_q = 3000, 2000
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))

    def unit(n):
        v = rs.randn(n, 3)
        return f32(v / np.linalg.norm(v, axis=1, keepdims=True))

    grid = mg.build_merge_grid(
        f32(rs.rand(num_p, 3)), torch.from_numpy(rs.rand(num_p) > 0.1), 0.07,
        unit(num_p), f32(rs.rand(num_p, 3)), f32(rs.rand(num_p)),
        f32(rs.rand(num_p)))
    n = unit(num_q)
    args = dict(
        qpos=f32(rs.rand(num_q, 3) * 1.2 - 0.1), normal=n,
        gn=torch.nn.functional.normalize(n + 0.1 * unit(num_q), dim=1),
        w_out=unit(num_q),
        params=dict(kind=torch.from_numpy(rs.choice(kinds, num_q).astype(
            np.int32)), kd=f32(rs.rand(num_q, 3)), ks=f32(rs.rand(num_q, 3)),
            ns=f32(1.0 + rs.rand(num_q) * 30.0)),
        d_vcm=f32(rs.rand(num_q) * 2), d_vm=f32(rs.rand(num_q) * 2),
        active=torch.from_numpy(rs.rand(num_q) > 0.15))
    on = lambda x: ({k: v.to(cuda_device) for k, v in x.items()}
                    if isinstance(x, dict) else x.to(cuda_device))
    gargs = {k: on(v) for k, v in args.items()}
    ggrid = grid.to(cuda_device)
    before = mg.LAUNCHES["prep"]
    qrec, perm = mg.prepare_cuda(ggrid, **gargs)
    assert mg.LAUNCHES["prep"] == before + 1
    want, wperm = mg.prepare_queries(grid, **args)
    assert torch.equal(perm.cpu(), wperm)
    assert torch.equal(qrec.cpu().view(torch.int32), want.view(torch.int32))
    got = mg.merge_contrib(ggrid, **gargs, mis_eta_vc=0.3, kinds=kinds,
                           ppm=False).cpu()
    ref = mg.merge_contrib(grid, **args, mis_eta_vc=0.3, kinds=kinds,
                           ppm=False)
    scale = torch.clamp(ref.abs(), min=1e-6 * float(ref.abs().max()))
    assert float(((got - ref).abs() / scale).max()) <= 1e-4
    assert float(ref.sum()) > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["closest", "any", "khit"])
def test_cuda_dead_blocks_return_early(cuda_device, kind):
    """A 128-ray block with no live lane writes its miss rows and builds
    no candidate list: the rows equal the plain version's, and the
    counting launch's candidate-stage slab tests are those of the live
    blocks alone (the rays of an all-live launch of those blocks)."""
    scene, _ = make_leaf_scene(300, seed=2, device="cpu")
    rays = _rays(4096, 11, scene, kind == "any")
    rays[: 16 * st.BLK, 7] = -1.0                 # blocks 0-15 dead
    rays[20 * st.BLK: 24 * st.BLK, 7] = -1.0      # and 20-23
    gpu = scene.to(cuda_device)
    sbox, tiles = gpu.bvh.sbox, gpu.bvh.tiles

    def launch(r, work=None):
        if kind == "khit":
            return kh.khit_cuda(r, sbox, tiles, work=work)
        return st.traverse_cuda(r, sbox, tiles, kind == "any", work=work)

    rg = rays.to(cuda_device)
    got = launch(rg).cpu()
    if kind == "khit":
        want = kh.khit_plain(rays, scene.bvh.sbox, scene.bvh.tiles)
        assert torch.equal(got[:, 0::8], want[:, 0::8])
    else:
        _hold_rows(got.to(cuda_device), st.traverse_plain(
            rays, scene.bvh.sbox, scene.bvh.tiles, kind == "any"),
            kind == "any")
    live = torch.cat([rg[16 * st.BLK: 20 * st.BLK], rg[24 * st.BLK:]])
    tallies = []
    for r in (rg, live):
        work = torch.zeros(len(st.WORK_SLOTS), dtype=torch.int64,
                           device=cuda_device)
        launch(r, work)
        tallies.append(dict(zip(st.WORK_SLOTS, work.cpu().tolist())))
    assert tallies[0] == tallies[1]
    dead = torch.full_like(rg, 0.0)
    dead[:, 7] = -1.0
    work = torch.zeros(len(st.WORK_SLOTS), dtype=torch.int64,
                       device=cuda_device)
    out = launch(dead, work)
    assert int(work.sum()) == 0
    col, miss = (0, 0.0) if kind == "any" else (3, -1.0)
    assert bool((out[:, col] == miss).all())


def _pt_films(scene, cam, size, graph, frames=(0, 1), **kw):
    from imbatracer_torch.render.integrators.pt import render_pt_frame

    out = []
    for f in frames:
        film, n = render_pt_frame(scene, cam, f, *size, with_stats=True,
                                  graph=graph, **kw)
        out.append((film, int(n)))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_cuda_graph_films_equal_eager(cuda_device, masked):
    """PT at 64x64 (cornell) and 64x48 (the masked scene), spp 4, on the
    default route (CUDA graphs) and graph=False: films equal bit for bit,
    traced rays equal; the default route captured one bounce and replayed
    it once a band-bounce; replays add the capture's launches and the
    device counts the re-trace's rounds, so a graphed frame counts the
    stream launches the eager frame makes, and on the masked scene its
    khit rounds plus one first round for each empty dispatch."""
    from imbatracer_torch.render import graphs
    from imbatracer_torch.render.camera import make_camera
    from imbatracer_torch.render.integrators import pt
    from imbatracer_torch.scene.procedural import (make_cornell_scene,
                                                   make_masked_scene)

    scene, meta = (make_masked_scene if masked else make_cornell_scene)(
        device=cuda_device)
    size = (64, 48) if masked else (64, 64)
    cam = make_camera(meta.cam_pos, meta.cam_dir, meta.cam_up, *size, 60.0,
                      device=cuda_device)
    kw = dict(spp=4, max_len=6, has_masks=meta.has_masks)
    assert pt.use_graphs(cuda_device, scene.bvh)
    graphs.reset_stats()
    eager = _pt_films(scene, cam, size, False, **kw)
    graphed = _pt_films(scene, cam, size, None, **kw)
    for (ef, en), (gf, gn) in zip(eager, graphed):
        assert torch.equal(ef, gf) and en == gn
    assert graphs.GRAPH_STATS["captures"] == 1
    assert graphs.GRAPH_STATS["reruns"] == 0

    def counted(graph):
        st.reset_launches()
        kh.reset_launches()
        for k in tt.MASK_STATS:
            tt.MASK_STATS[k] = 0
        stats = {}
        pt.render_pt_frame(scene, cam, 2, *size, stats=stats, graph=graph,
                           **kw)
        torch.cuda.synchronize()
        return (dict(st.LAUNCHES), dict(kh.LAUNCHES), dict(tt.MASK_STATS),
                stats)

    replays = graphs.GRAPH_STATS["replays"]
    g_st, g_kh, g_mask, stats = counted(None)
    assert graphs.GRAPH_STATS["replays"] - replays == stats["band_bounces"]
    e_st, e_kh, e_mask, _ = counted(False)
    if masked:
        # The rounds the eager loop ran, plus one first round for each
        # empty dispatch; the rounds past the first from the device.
        empty = g_mask["empty"]
        assert g_kh["khit"] == e_kh["khit"] + empty
        assert g_mask["rounds"] == e_mask["rounds"] + empty
        for k in ("dispatches", "empty", "max_rounds", "max_lanes"):
            assert g_mask[k] == e_mask[k], k
    else:
        assert g_st == e_st
        assert st.LAUNCHES["closest_hit"] == stats["band_bounces"]


@pytest.mark.cuda
@pytest.mark.parametrize("nested", [False, True])
def test_cuda_while_loop_runs_while_its_flag_is_set(cuda_device, nested):
    """graphs.while_loop captured as a WHILE conditional node: a replay
    runs the body (which allocates temporaries) as often as its device
    flag asks, nested loops too, and counts each pass in the device
    counts; with the flag false at the start the state stays bit for bit
    as it was.  No host read between passes: the flag lives on the card."""
    from imbatracer_torch.render import graphs

    sg = graphs.SceneGraphs(cuda_device)
    state = {"x": torch.arange(8.0, device=cuda_device),
             "y": torch.zeros(8, device=cuda_device)}
    for k in ("left", "inner", "k"):
        state[k] = torch.zeros((), dtype=torch.int32, device=cuda_device)

    def step(s_, overflow):
        def inner():
            s_["y"].copy_(s_["y"] + 1.0)
            s_["k"].add_(1)

        def body():
            tt.MASK_STATS["rounds"] += 1
            s_["x"].copy_(s_["x"] * 2.0)
            s_["left"].sub_(1)
            if nested:
                s_["k"].zero_()
                graphs.while_loop(lambda: s_["k"] < s_["inner"], inner)

        graphs.while_loop(lambda: s_["left"] > 0, body)

    g = sg.phase("loop", step, state)
    slot = graphs._slot(tt.MASK_STATS, "rounds")
    for left, inner in ((0, 2), (3, 2), (0, 0), (5, 3), (1, 0)):
        before = {k: v.clone() for k, v in state.items()}
        state["left"].fill_(left)
        state["inner"].fill_(inner)
        sg.counts.zero_()
        g.replay()
        torch.cuda.synchronize()
        assert int(sg.counts[slot]) == left
        assert torch.equal(state["x"], before["x"] * 2.0 ** left)
        assert torch.equal(state["y"],
                           before["y"] + (left * inner if nested else 0))
        if left == 0:
            for k in ("x", "y", "k"):
                assert torch.equal(state[k], before[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("algo,masked", [("vcm", False), ("vcm", True),
                                         ("bpt", True), ("lt", False)])
def test_cuda_vcm_graph_films_equal_eager(cuda_device, algo, masked):
    """The VCM family at 64x64 with 1,000 light paths in bands of 384
    (the last padded) and camera bands of 1,500 pixels (compacted on the
    card), on the default route (captured light bands and camera phases)
    and graph=False: film means within 1e-6 relative and >= 99.9% of
    pixels within 1e-5 relative (the light splat adds with atomics),
    traced rays equal, no rerun; a graphed frame counts the eager
    frame's merge launches."""
    from imbatracer_torch.ops import merge as mg
    from imbatracer_torch.render import graphs
    from imbatracer_torch.render.camera import make_camera
    from imbatracer_torch.render.integrators import vcm
    from imbatracer_torch.scene.procedural import (make_cornell_scene,
                                                   make_masked_scene)

    scene, meta = (make_masked_scene if masked else make_cornell_scene)(
        device=cuda_device)
    cam = make_camera(meta.cam_pos, meta.cam_dir, meta.cam_up, 64, 64, 60.0,
                      device=cuda_device)
    kinds = tuple(sorted(set(scene.materials.kind.tolist())))
    assert vcm.use_vcm_graphs(cuda_device, scene.bvh, False)

    def frame(f, graph):
        mg.reset_launches()
        route = {}
        film = vcm.render_vcm_frame(
            scene, cam, f, 0.05, algo=algo, width=64, height=64, max_len=6,
            light_path_count=1000, has_masks=meta.has_masks,
            mat_kinds=kinds, light_band=384, camera_band=1500,
            stats={"route": route}, graph=graph)
        torch.cuda.synchronize()
        return film.double(), int(route.get("camera_rays", 0)), dict(
            mg.LAUNCHES)

    graphs.reset_stats()
    frame(0, None)                                # captures
    for f in (1, 2):
        (ef, en, el), (gf, gn, gl) = frame(f, False), frame(f, None)
        assert float(ef.mean()) > 0.0
        assert abs(float(gf.mean() - ef.mean())) <= 1e-6 * float(ef.mean())
        rel = ((gf - ef).abs() / ef.abs().clamp(min=1e-3)).amax(dim=1)
        assert float((rel <= 1e-5).double().mean()) >= 0.999
        assert gn == en and gl == el
    assert graphs.GRAPH_STATS["reruns"] == 0
    assert graphs.GRAPH_STATS["replays"] > 0
