"""The CUDA kernels (the traversal kernels csrc/stream_traverse.cu, its
instanced variant included, and csrc/khit_traverse.cu, also above the
16,384 super-chunks a shared-memory candidate list holds, and over a
packing that references a triangle from several leaves; the pair
route's kernels csrc/pairs_kernel.cu; the photon-merge gather and its
query preparation csrc/merge_kernel.cu; the PT bounce's shading
csrc/pt_shade.cu; the VCM family's bounce shading csrc/vcm_shade.cu; the
dispatch glue and the re-trace's slot kernels csrc/dispatch.cu; the
light band's collect append and splat csrc/light_tail.cu; the frame's
middle: the collect selection csrc/select.cu and the photon grid's build
csrc/grid_build.cu) against their plain PyTorch versions on the same
inputs.  Needs an
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
for bit.  The shade kernels' flags, RNG state and counts equal the plain
versions', their float columns within 1e-5 * max(1, |x|) on >= 99.9% of
the lanes (bit for bit expected: they round each op as torch does).
The slot kernels, the collect append, the middle's kernels and the
light bounce on dead bands are bit-equal to their plain versions; the splat adds with atomics, as index_add_ does, so a film
agrees within the rounding of its sums' order.
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
from torch_dispatch_cases import (RAGGED_KEYS, RAGGED_ROWS, SELECT_CASES,
                                  select_case)
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
    before = {k: mg.LAUNCHES[k] for k in mg.PREP_KERNELS}
    qrec, perm = mg.prepare_cuda(ggrid, **gargs)
    assert all(mg.LAUNCHES[k] == before[k] + 1 for k in mg.PREP_KERNELS)
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


def _prep_queries(num_q, flags, seed):
    """prepare_queries' arguments (CPU tensors) of `num_q` seeded queries
    over the unit box, with no query active, all, or a seeded 85%."""
    rs = np.random.RandomState(seed)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))

    def unit(n):
        v = rs.randn(n, 3)
        return f32(v / np.linalg.norm(v, axis=1, keepdims=True))

    n = unit(num_q)
    active = {"none": np.zeros(num_q, bool), "all": np.ones(num_q, bool),
              "seeded": rs.rand(num_q) > 0.15}[flags]
    return dict(
        qpos=f32(rs.rand(num_q, 3) * 1.2 - 0.1), normal=n,
        gn=torch.nn.functional.normalize(n + 0.1 * unit(num_q), dim=1),
        w_out=unit(num_q),
        params=dict(kind=torch.from_numpy(rs.choice((0, 3, 4, 5), num_q)
                                          .astype(np.int32)),
                    kd=f32(rs.rand(num_q, 3)), ks=f32(rs.rand(num_q, 3)),
                    ns=f32(1.0 + rs.rand(num_q) * 30.0)),
        d_vcm=f32(rs.rand(num_q) * 2), d_vm=f32(rs.rand(num_q) * 2),
        active=torch.from_numpy(active))


def _prep_grid(seed):
    from imbatracer_torch.ops import merge as mg

    rs = np.random.RandomState(seed)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    return mg.build_merge_grid(
        f32(rs.rand(3000, 3)), torch.from_numpy(rs.rand(3000) > 0.1), 0.02,
        f32(rs.rand(3000, 3)), f32(rs.rand(3000, 3)), f32(rs.rand(3000)),
        f32(rs.rand(3000)))


@pytest.mark.cuda
@pytest.mark.parametrize("flags", ["none", "all", "seeded"])
@pytest.mark.parametrize("num_q", [1, 127, 128, 129, 262144, 262145])
def test_cuda_merge_preparation_in_a_replayed_graph(cuda_device, num_q,
                                                    flags):
    """prepare_cuda at ragged sizes around the kernels' blocks (128
    queries a block) and at a full band, with no query active,
    all and some: each launch bit-equal to its plain version (sort keys,
    inverse, rows), and the whole preparation captured in one CUDA graph
    whose three replays each rewrite the rows and permutation (poisoned
    before each) bit-equal to prepare_queries'."""
    from imbatracer_torch.ops import merge as mg

    grid = _prep_grid(11)
    args = _prep_queries(num_q, flags, num_q)
    want, wperm = mg.prepare_queries(grid, **args)
    on = lambda x: ({k: v.to(cuda_device) for k, v in x.items()}
                    if isinstance(x, dict) else x.to(cuda_device))
    gargs = {k: on(v) for k, v in args.items()}
    ggrid = grid.to(cuda_device)
    pin = mg.prep_inputs(ggrid, **gargs)
    keys = mg.sort_keys_cuda(pin)
    assert torch.equal(keys.cpu(), mg.sort_keys_plain(grid, args["qpos"],
                                                      args["active"]))
    inv = mg.inverse_cuda(wperm.to(cuda_device))
    assert torch.equal(inv.cpu(), mg.inverse_plain(wperm))
    rows = mg.query_rows_cuda(pin, inv)
    assert torch.equal(rows.cpu().view(torch.int32), want.view(torch.int32))
    mg.prepare_cuda(ggrid, **gargs)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        qrec, perm = mg.prepare_cuda(ggrid, **gargs)
    for _ in range(3):
        qrec.fill_(float("nan"))
        perm.fill_(-1)
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(perm.cpu(), wperm)
        assert torch.equal(qrec.cpu().view(torch.int32),
                           want.view(torch.int32))


@pytest.mark.cuda
def test_cuda_merge_preparation_input_checks(cuda_device):
    """The preparation's wrappers raise before launching on a permutation
    or inverse of the wrong dtype, shape or device."""
    from imbatracer_torch.ops import merge as mg

    grid = _prep_grid(12).to(cuda_device)
    args = _prep_queries(100, "seeded", 3)
    pin = mg.prep_inputs(grid, **{k: (
        {j: w.to(cuda_device) for j, w in v.items()} if isinstance(v, dict)
        else v.to(cuda_device)) for k, v in args.items()})
    perm = torch.arange(100, device=cuda_device)
    inv = mg.inverse_cuda(perm)
    assert inv.dtype == torch.int32 and torch.equal(
        inv, perm.to(torch.int32))
    with pytest.raises(TypeError):
        mg.inverse_cuda(perm.to(torch.int32))
    with pytest.raises(ValueError):
        mg.inverse_cuda(perm.reshape(4, 25))
    with pytest.raises(ValueError):
        mg.inverse_cuda(perm.cpu())
    with pytest.raises(ValueError):
        mg.inverse_cuda(perm[::2])
    with pytest.raises(TypeError):
        mg.query_rows_cuda(pin, inv.long())
    with pytest.raises(ValueError):
        mg.query_rows_cuda(pin, inv[:99])
    with pytest.raises(ValueError):
        mg.query_rows_cuda(pin, inv.cpu())


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


# --------------------------------------------------------------------------
# The PT bounce's shading (csrc/pt_shade.cu)
# --------------------------------------------------------------------------

def _shade_columns(nxt, shadow, contrib):
    cols = dict(nxt)
    cols.update({f"shadow.{k}": getattr(shadow, k) for k in shadow._fields})
    cols["contrib"] = contrib
    return cols


def _hold_shade_column(name, k, p):
    """Flags and the RNG state equal on every lane; a float column within
    1e-5 * max(1, |x|) (NaN equal to NaN) on >= 99.9% of its lanes; the
    kernel rounds every op as the plain version's torch ops do, so the
    columns are expected bit for bit."""
    assert k.shape == p.shape and k.dtype == p.dtype, name
    if k.dtype != torch.float32:
        assert torch.equal(k, p), name
        return
    k, p = k.reshape(k.shape[0], -1), p.reshape(p.shape[0], -1)
    same = (k == p) | (torch.isnan(k) & torch.isnan(p))
    near = (k - p).abs() <= 1e-5 * p.abs().clamp(min=1.0)
    assert float((same | near).all(dim=1).double().mean()) >= 0.999, name


@pytest.mark.cuda
@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("name", ["cornell", "specular", "still_life",
                                  "bumped", "delta_lights"])
def test_cuda_pt_shade_matches_plain(cuda_device, name, mixed):
    """pt_shade_cuda and pt_shade_finish_cuda against their plain
    versions on the card, column by column, on the five scenes of
    tests/torch_shade_cases.py, at bounce 0 and on a mixed-depth carry;
    each kernel launches once and counts its lanes on the card."""
    from imbatracer_torch.ops import shade as sh
    from imbatracer_torch.render.integrators import pt
    from torch_shade_cases import (MAX_LEN, SCENES, carry_arrays,
                                   port_scene, torch_carry)

    scene, meta = port_scene(name, cuda_device)
    arrays = carry_arrays(meta, 4096, seed=SCENES.index(name) + 10 * mixed,
                          mixed=mixed)
    c = torch_carry(arrays, cuda_device)
    alpha_fn = pt.alpha_fn_for(scene) if meta.has_masks else None
    hit = tt.closest_hit(scene.bvh, c["org"], c["d"], c["tmin"], BIG,
                         alpha_fn=alpha_fn, active=c["active"], sort=True)
    kw = dict(has_bump=meta.has_bump, max_len=MAX_LEN)
    sh.reset_launches()
    got = sh.pt_shade_cuda(scene, c, hit, **kw)
    want = sh.pt_shade_plain(scene, c, hit, **kw)
    assert sh.LAUNCHES["pt_shade"] == 1 and sh.LAUNCHES["plain"] == 1
    kcols, pcols = _shade_columns(*got), _shade_columns(*want)
    assert set(kcols) == set(pcols)
    for k in pcols:
        _hold_shade_column(k, kcols[k], pcols[k])
    assert int(kcols["n_rays"]) == int(c["active"].sum())
    shadow = want[1]
    occ = tt.any_hit(scene.bvh, shadow.pos, shadow.dir, shadow.tmin,
                     shadow.tmax, alpha_fn=alpha_fn, active=shadow.ok,
                     sort=True)
    args = (want[0]["radiance"], want[2], shadow.ok, occ, want[0]["n_rays"])
    (kr, kn), (pr, pn) = sh.pt_shade_finish_cuda(*args), \
        sh.pt_shade_finish_plain(*args)
    assert torch.equal(kr, pr) and int(kn) == int(pn)
    assert int(kn) == int(c["active"].sum()) + int(shadow.ok.sum())
    assert sh.LAUNCHES["pt_shade_finish"] == 1


@pytest.mark.cuda
def test_cuda_pt_shade_input_checks(cuda_device):
    """The wrappers raise on tensors off the card or of another type; an
    empty carry launches nothing and returns empty columns."""
    from imbatracer_torch.ops import shade as sh
    from torch_shade_cases import carry_arrays, port_scene, torch_carry

    scene, meta = port_scene("cornell", cuda_device)
    c = torch_carry(carry_arrays(meta, 256, seed=1, mixed=True), cuda_device)
    hit = tt.closest_hit(scene.bvh, c["org"], c["d"], c["tmin"], BIG,
                         active=c["active"], sort=True)
    bad = dict(c, depth=c["depth"].long())
    with pytest.raises(ValueError, match="depth"):
        sh.pt_shade_cuda(scene, bad, hit, has_bump=False, max_len=4)
    with pytest.raises(ValueError, match="hit.t"):
        sh.pt_shade_cuda(scene, c, hit._replace(t=hit.t.cpu()),
                         has_bump=False, max_len=4)
    empty = {k: v[:0] if v.dim() else v for k, v in c.items()}
    ehit = type(hit)(*(x[:0] for x in hit))
    nxt, shadow, contrib = sh.pt_shade_cuda(scene, empty, ehit,
                                            has_bump=False, max_len=4)
    assert contrib.shape == (0, 3) and int(nxt["n_rays"]) == 0


def _finish_inputs(lanes, seed, dev, base):
    """Seeded inputs of pt_shade_finish over `lanes` lanes on the card:
    radiance (signed zeros among them), contrib, the shadow rays' cast
    and occluded flags (about half each) and a carried count near 2^40;
    `base` "unaligned": the float arrays 4 bytes and the flags 1 byte past
    an aligned start (the kernel's scalar route)."""
    rs = np.random.RandomState(seed)
    rad = rs.randn(lanes, 3).astype(np.float32)
    rad[rs.rand(lanes) < 0.1] = -0.0
    con = rs.rand(lanes, 3).astype(np.float32)
    ok = rs.rand(lanes) < 0.5
    occ = rs.rand(lanes) < 0.5
    t = lambda a: torch.from_numpy(a).to(dev)
    args = [t(rad), t(con), t(ok), t(occ)]
    if base == "unaligned":
        args = [_unaligned(x) for x in args]
        assert args[0].data_ptr() % 16 and args[2].data_ptr() % 4
    n0 = torch.tensor((1 << 40) - 1000 + seed, dtype=torch.int64, device=dev)
    return (*args, n0)


@pytest.mark.cuda
@pytest.mark.parametrize("base", ["aligned", "unaligned"])
@pytest.mark.parametrize("lanes", [1, 3, 127, 129, 262143, 262144, 266277])
def test_cuda_pt_shade_finish_at_ragged_lanes(cuda_device, lanes, base):
    """pt_shade_finish_kernel against pt_shade_finish_plain bit for bit:
    the radiance (four lanes a thread in 16-byte words, a scalar tail past
    the last whole four, the scalar route from an unaligned base) and the
    count (the carried count near 2^40 plus the shadow rays, counted a
    block and met in one word), at lane counts on either side of 4, a
    block and the band, and past the grid's most threads; one launch, the
    carried count left as it was."""
    from imbatracer_torch.ops import shade as sh

    args = _finish_inputs(lanes, lanes % 97, cuda_device, base)
    n0 = args[-1].clone()
    sh.reset_launches()
    kr, kn = sh.pt_shade_finish_cuda(*args)
    pr, pn = sh.pt_shade_finish_plain(*args)
    assert sh.LAUNCHES["pt_shade_finish"] == 1
    assert torch.equal(kr.view(torch.int32), pr.view(torch.int32))
    assert kn.dtype == torch.int64 and int(kn) == int(pn)
    assert int(kn) == int(n0) + int(args[2].sum())
    assert torch.equal(args[-1], n0)


@pytest.mark.cuda
def test_cuda_pt_shade_finish_in_a_replayed_graph(cuda_device):
    """Three finishes chained in one CUDA graph (each adds to the count the
    last one wrote), the graph replayed five times after new inputs are
    copied in: every replay's radiance and count equal the plain
    version's chain, so the word the blocks meet in is zero again after
    each launch."""
    from imbatracer_torch.ops import shade as sh

    lanes = 262144 + 5
    state = dict(zip(("rad", "con", "ok", "occ", "n"),
                     _finish_inputs(lanes, 3, cuda_device, "aligned")))

    def chain(fn, st):
        rad, n = st["rad"], st["n"]
        for _ in range(3):
            rad, n = fn(rad, st["con"], st["ok"], st["occ"], n)
        return rad, n

    chain(sh.pt_shade_finish_cuda, state)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = chain(sh.pt_shade_finish_cuda, state)
    for seed in range(5):
        new = _finish_inputs(lanes, 40 + seed, cuda_device, "aligned")
        for k, v in zip(("rad", "con", "ok", "occ", "n"), new):
            state[k].copy_(v)
        g.replay()
        want = chain(sh.pt_shade_finish_plain, state)
        torch.cuda.synchronize()
        assert torch.equal(out[0].view(torch.int32),
                           want[0].view(torch.int32))
        assert int(out[1]) == int(want[1])


def _unaligned(x):
    """x copied into a view one element past the start of its storage, so
    that its rows are not 16-byte aligned."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cornell", "specular", "still_life"])
@pytest.mark.parametrize("band", ["all_dead", "half_dead", "emitters",
                                  "mixed", "all_live", "unaligned"])
def test_cuda_pt_shade_kernel_on_dead_bands(cuda_device, band, name):
    """pt_shade_kernel against pt_shade_plain bit for bit on every output
    column and lane of a 3,001-lane band (not a whole number of blocks:
    its last warps past the band): all lanes dead on entry, every other
    one, half dying at the miss and emitter tests, a mixed-depth carry
    (warps of mixed material kinds and of live and dead lanes; the still
    life holds all six kinds), the camera's bounce-0 carry with every
    lane alive, and the mixed carry read through views 4 bytes off
    16-byte alignment.  One launch each."""
    from imbatracer_torch.ops import shade as sh
    from imbatracer_torch.render.integrators import pt
    from torch_shade_cases import (MAX_LEN, SCENES, carry_arrays, dead_band,
                                   port_scene, torch_carry)

    scene, meta = port_scene(name, cuda_device)
    lanes, seed = 3001, 71 + SCENES.index(name)
    if band in ("all_dead", "half_dead", "emitters"):
        arrays = dead_band(scene, meta, band, lanes, seed)
    else:
        arrays = carry_arrays(meta, lanes, seed=seed,
                              mixed=band != "all_live")
    c = torch_carry(arrays, cuda_device)
    alpha_fn = pt.alpha_fn_for(scene) if meta.has_masks else None
    hit = tt.closest_hit(scene.bvh, c["org"], c["d"], c["tmin"], BIG,
                         alpha_fn=alpha_fn,
                         active=torch.ones_like(c["active"]), sort=True)
    if band == "unaligned":
        c = {k: _unaligned(v) if v.dim() else v for k, v in c.items()}
        hit = type(hit)(*(_unaligned(x) for x in hit))
        assert c["org"].data_ptr() % 16 and hit.t.data_ptr() % 16
    kw = dict(has_bump=meta.has_bump, max_len=MAX_LEN)
    sh.reset_launches()
    got = _shade_columns(*sh.pt_shade_cuda(scene, c, hit, **kw))
    want = _shade_columns(*sh.pt_shade_plain(scene, c, hit, **kw))
    assert sh.LAUNCHES["pt_shade"] == 1
    assert set(got) == set(want)
    for k in want:
        _same_bits(k, got[k], want[k])
    if band == "all_dead":
        assert not got["active"].any() and not got["shadow.ok"].any()
    else:
        assert got["shadow.ok"].any() and got["active"].any()


# --------------------------------------------------------------------------
# The VCM family's bounce shading (csrc/vcm_shade.cu)
# --------------------------------------------------------------------------

VCM_LPC, VCM_MAX_LEN, VCM_SIZE = 4096, 5, 64


def _vcm_inputs(scene, meta, dev, algo="vcm"):
    """(camera, FrameInputs of frame 2) of a 64x64 frame."""
    from imbatracer_torch.render.camera import make_camera
    from imbatracer_torch.render.integrators import vcm

    cam = make_camera(meta.cam_pos, meta.cam_dir, meta.cam_up, VCM_SIZE,
                      VCM_SIZE, 60.0, device=dev)
    (frame, base, _, _, pm_radius, eta_vc, eta_vm) = vcm.frame_constants(
        cam, 2, 0.05, algo=algo, num_pixels=VCM_SIZE ** 2,
        light_path_count=VCM_LPC, max_len=VCM_MAX_LEN)
    return cam, vcm.FrameInputs(cam, frame, base, pm_radius, eta_vc, eta_vm)


def _vcm_cache(scene, meta, cam, fi):
    """`fi` with the working cache of a light pass (through the
    kernels)."""
    from imbatracer_torch.render import light_cache
    from imbatracer_torch.render.integrators import pt, vcm

    collect = light_cache.empty_collect(VCM_LPC * VCM_MAX_LEN, cam.pos.device)
    vcm._light_pass(scene, cam, fi.frame, fi.mis_eta_vc, fi.mis_eta_vm,
                    collect, algo="vcm", num_pixels=VCM_SIZE ** 2,
                    light_path_count=VCM_LPC, max_len=VCM_MAX_LEN,
                    alpha_fn=pt.alpha_fn_for(scene) if meta.has_masks
                    else None, has_bump=meta.has_bump)
    cache = light_cache.select_shallowest(
        collect.cache(), vcm.auto_cache_capacity(VCM_LPC, VCM_MAX_LEN))
    return vcm.working_cache(fi, cache, None, None, ())


def _hold_vcm_columns(k, p):
    """Every column pair of two dicts held as _hold_shade_column holds
    them."""
    assert set(k) == set(p)
    for name in p:
        _hold_shade_column(name, k[name], p[name])


@pytest.mark.cuda
@pytest.mark.parametrize("bounce", [0, 2])
@pytest.mark.parametrize("name", ["cornell", "specular", "still_life",
                                  "bumped", "delta_lights"])
def test_cuda_vcm_shade_light_kernels_match_plain(cuda_device, name, bounce):
    """The light band's start (padded, its band end a pointer), a light
    bounce and its connection finish: vcm_light_start_kernel,
    vcm_light_shade_kernel and the light entry of vcm_finish_kernel
    against their plain versions on the card, column by column, on the
    five scenes of tests/torch_shade_cases.py; each launches once."""
    from imbatracer_torch.ops import vcm_shade as vs
    from imbatracer_torch.render.integrators import pt, vcm
    from torch_shade_cases import port_scene

    scene, meta = port_scene(name, cuda_device)
    cam, fi = _vcm_inputs(scene, meta, cuda_device)
    lanes = 3000
    start = torch.tensor(500, dtype=torch.int32, device=cuda_device)
    kw = dict(lanes=lanes, light_path_count=VCM_LPC, path_start=start,
              path_end=start + lanes - 200)
    vs.reset_launches()
    c = vs.light_start_cuda(scene, fi.frame, fi.mis_eta_vc, **kw)
    _hold_vcm_columns(c, vs.light_start_plain(scene, fi.frame,
                                              fi.mis_eta_vc, **kw))
    assert not c["active"][-200:].any() and c["active"].any()
    alpha_fn = pt.alpha_fn_for(scene) if meta.has_masks else None
    skw = dict(mis_eta_vc=fi.mis_eta_vc, mis_eta_vm=fi.mis_eta_vm,
               algo="vcm", light_path_count=VCM_LPC, max_len=VCM_MAX_LEN,
               has_bump=meta.has_bump, pixel_area=vcm.pixel_area(cam))
    for i in range(bounce + 1):
        hit = tt.closest_hit(scene.bvh, c["org"], c["d"], c["tmin"], BIG,
                             alpha_fn=alpha_fn, active=c["active"],
                             sort=True)
        rk = vs.light_rows(lanes, 1, True, True, cuda_device)
        rp = vs.light_rows(lanes, 1, True, True, cuda_device)
        k_nxt, k_sh = vs.light_shade_cuda(scene, cam, c, hit, i, rk, **skw)
        p_nxt, p_sh = vs.light_shade_plain(scene, cam, c, hit, i, rp, **skw)
        _hold_vcm_columns(k_nxt, p_nxt)
        _hold_vcm_columns(_shade_columns({}, k_sh, rk.cc),
                          _shade_columns({}, p_sh, rp.cc))
        _hold_vcm_columns(dict(rk._asdict()), dict(rp._asdict()))
        c = k_nxt
    occ = tt.any_hit(scene.bvh, p_sh.pos, p_sh.dir, p_sh.tmin, p_sh.tmax,
                     alpha_fn=alpha_fn, active=p_sh.ok, sort=True)
    fk, fp = (rp.cc.clone(), rp.pixel.clone()), (rp.cc.clone(),
                                                 rp.pixel.clone())
    vs.light_finish_cuda(*fk, p_sh.ok, occ)
    vs.light_finish_plain(*fp, p_sh.ok, occ)
    assert torch.equal(fk[0], fp[0]) and torch.equal(fk[1], fp[1])
    assert vs.LAUNCHES["light_start"] == 1
    assert vs.LAUNCHES["light_shade"] == bounce + 1
    assert vs.LAUNCHES["light_finish"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("algo,conns,mixed", [
    ("vcm", 1, False), ("vcm", 3, True), ("bpt", 2, True), ("ppm", 1, True),
    ("pt", 1, False)])
@pytest.mark.parametrize("name", ["cornell", "specular", "still_life",
                                  "bumped", "delta_lights"])
def test_cuda_vcm_shade_camera_kernels_match_plain(cuda_device, name, algo,
                                                   conns, mixed):
    """A camera bounce and its shadow sets' finish:
    vcm_camera_shade_kernel and the camera entry of vcm_finish_kernel
    against their plain versions on the card, with the working cache of a
    light pass, at bounce 0 (the camera's rays) and at bounce 2 (a carry
    at mixed depths from torch_shade_cases.carry_arrays); each launches
    once and counts its rays on the card."""
    from imbatracer_torch.ops import vcm_shade as vs
    from imbatracer_torch.render.integrators import pt, vcm
    from torch_shade_cases import carry_arrays, port_scene, torch_carry

    scene, meta = port_scene(name, cuda_device)
    cam, fi = _vcm_inputs(scene, meta, cuda_device, algo)
    fi = _vcm_cache(scene, meta, cam, fi)
    if mixed:
        c = torch_carry(carry_arrays(meta, 4096, seed=7, mixed=True),
                        cuda_device)
        g = torch.Generator().manual_seed(3)
        for k, hi in (("d_vc", 2.0), ("d_vcm", 50.0), ("d_vm", 3.0)):
            c[k] = (torch.rand(4096, generator=g) * hi).to(cuda_device)
        c = {k: c[k] for k in vs.CAMERA_CARRY + ("n_rays",)}
    else:
        c = vcm._camera_carry(cam, fi.frame, width=VCM_SIZE, height=VCM_SIZE,
                              spp=1, light_path_count=VCM_LPC, start_pixel=0,
                              band_pixels=VCM_SIZE ** 2)
        c["n_rays"] = torch.zeros((), dtype=torch.int64, device=cuda_device)
    i = 2 if mixed else 0
    alpha_fn = pt.alpha_fn_for(scene) if meta.has_masks else None
    hit = tt.closest_hit(scene.bvh, c["org"], c["d"], c["tmin"], BIG,
                         alpha_fn=alpha_fn, active=c["active"], sort=True)
    kw = dict(cache_count=fi.cache_count, cache_rec=fi.cache_rec,
              base_radius=fi.base_radius, mis_eta_vc=fi.mis_eta_vc,
              mis_eta_vm=fi.mis_eta_vm, algo=algo, max_len=VCM_MAX_LEN,
              light_path_count=VCM_LPC, num_connections=conns,
              has_bump=meta.has_bump, techniques=vs.TECHNIQUES)
    vs.reset_launches()
    k_nxt, k_sh, k_q = vs.camera_shade_cuda(scene, c, hit, i, **kw)
    p_nxt, p_sh, p_q = vs.camera_shade_plain(scene, c, hit, i, **kw)
    _hold_vcm_columns(k_nxt, p_nxt)
    assert int(k_nxt["n_rays"]) == int(c["active"].sum())
    kq, pq = k_q._asdict(), p_q._asdict()
    for n in ("kind", "kd", "ks", "ns"):
        kq[n], pq[n] = kq["params"][n], pq["params"][n]
    del kq["params"], pq["params"]
    _hold_vcm_columns(kq, pq)
    sets = vs.shadow_sets(algo, vs.TECHNIQUES, conns)
    if not sets:
        assert k_sh is None and p_sh is None
        return
    _hold_vcm_columns(k_sh._asdict(), p_sh._asdict())
    assert k_sh.ok.shape == (sets * c["active"].shape[0],)
    occ = tt.any_hit(scene.bvh, p_sh.pos, p_sh.dir, p_sh.tmin, p_sh.tmax,
                     alpha_fn=alpha_fn, active=p_sh.ok, sort=True)
    args = (p_nxt["radiance"], p_sh.contrib, p_sh.ok, occ, p_nxt["n_rays"])
    (kr, kn), (pr, pn) = vs.camera_finish_cuda(*args), \
        vs.camera_finish_plain(*args)
    assert torch.equal(kr, pr) and int(kn) == int(pn)
    assert vs.LAUNCHES["camera_shade"] == vs.LAUNCHES["camera_finish"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("algo,conns", [("vcm", 3), ("bpt", 2)])
@pytest.mark.parametrize("name", ["cornell", "still_life"])
@pytest.mark.parametrize("band", ["all_dead", "half_dead"])
def test_cuda_vcm_camera_kernel_on_dead_bands(cuda_device, band, name, algo,
                                              conns):
    """vcm_camera_shade_kernel against camera_shade_plain, at the column
    gates of test_cuda_vcm_shade_camera_kernels_match_plain, on a band
    dead on entry (every lane finished in the kernel's first phase) and on
    one whose half dies at the miss or emitter test
    (torch_shade_cases.dying_lanes: alive on entry, carried into the
    second phase); a dead lane's shadow rows hold DEAD_SHADOW.  One
    launch each."""
    from imbatracer_torch.ops import vcm_shade as vs
    from imbatracer_torch.render.integrators import pt
    from torch_shade_cases import (carry_arrays, dying_lanes, port_scene,
                                   torch_carry)

    scene, meta = port_scene(name, cuda_device)
    cam, fi = _vcm_inputs(scene, meta, cuda_device, algo)
    fi = _vcm_cache(scene, meta, cam, fi)
    arrays = carry_arrays(meta, 4096, seed=17, mixed=True)
    if band == "all_dead":
        arrays["active"][:] = False
    else:
        lt = scene.lights
        k = int(torch.nonzero(lt.kind == 0)[0, 0])
        tri = tuple(x[k].cpu().numpy() for x in (lt.p0, lt.p1, lt.p2,
                                                 lt.normal))
        arrays = dying_lanes(arrays, tri, scene.bsphere.center.cpu().numpy(),
                             float(scene.bsphere.radius), 19)
    c = torch_carry(arrays, cuda_device)
    g = torch.Generator().manual_seed(5)
    for key, hi in (("d_vc", 2.0), ("d_vcm", 50.0), ("d_vm", 3.0)):
        c[key] = (torch.rand(4096, generator=g) * hi).to(cuda_device)
    c = {key: c[key] for key in vs.CAMERA_CARRY + ("n_rays",)}
    alpha_fn = pt.alpha_fn_for(scene) if meta.has_masks else None
    hit = tt.closest_hit(scene.bvh, c["org"], c["d"], c["tmin"], BIG,
                         alpha_fn=alpha_fn, active=c["active"], sort=True)
    kw = dict(cache_count=fi.cache_count, cache_rec=fi.cache_rec,
              base_radius=fi.base_radius, mis_eta_vc=fi.mis_eta_vc,
              mis_eta_vm=fi.mis_eta_vm, algo=algo, max_len=VCM_MAX_LEN,
              light_path_count=VCM_LPC, num_connections=conns,
              has_bump=meta.has_bump, techniques=vs.TECHNIQUES)
    vs.reset_launches()
    k_nxt, k_sh, k_q = vs.camera_shade_cuda(scene, c, hit, 2, **kw)
    p_nxt, p_sh, p_q = vs.camera_shade_plain(scene, c, hit, 2, **kw)
    _hold_vcm_columns(k_nxt, p_nxt)
    _hold_vcm_columns(k_sh._asdict(), p_sh._asdict())
    if k_q is not None:
        kq, pq = k_q._asdict(), p_q._asdict()
        for n in ("kind", "kd", "ks", "ns"):
            kq[n], pq[n] = kq["params"][n], pq["params"][n]
        del kq["params"], pq["params"]
        _hold_vcm_columns(kq, pq)
    dead = (~c["active"]).repeat(vs.shadow_sets(algo, vs.TECHNIQUES, conns))
    for field, value in zip(vs.ShadowSets._fields, vs.DEAD_SHADOW):
        assert (getattr(k_sh, field)[dead] == value).all(), field
    assert int(k_nxt["n_rays"]) == int(c["active"].sum())
    if band == "half_dead":
        assert k_sh.ok.any()
    else:
        assert not k_nxt["active"].any() and not k_sh.ok.any()
    assert vs.LAUNCHES["camera_shade"] == 1


def _same_bits(name, k, p):
    """k and p equal bit for bit (float NaN against NaN)."""
    assert k.shape == p.shape and k.dtype == p.dtype, name
    if k.dtype != torch.float32:
        assert torch.equal(k, p), name
        return
    same = (k.view(torch.int32) == p.view(torch.int32)) | (
        torch.isnan(k) & torch.isnan(p))
    assert bool(same.all()), (name, int((~same).sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cornell", "specular", "still_life"])
@pytest.mark.parametrize("band", ["all_dead", "half_dead", "live",
                                  "all_live"])
def test_cuda_vcm_light_kernel_on_dead_bands(cuda_device, band, name):
    """vcm_light_shade_kernel against light_shade_plain bit for bit on
    every output column and lane, at light bounce 1 of a 3,001-lane band
    (not a whole number of blocks): all lanes dead on entry (every lane
    finished in the kernel's first phase), every other one, and the band
    as it comes (its lanes of mixed material kinds, on the specular
    cornell and the still life, in the second phase); and at bounce 0,
    where the lanes are alive on entry but those whose emitter sample
    carries no light.  A lane that does not go on writes DEAD_LIGHT's
    rows.  One launch each."""
    from imbatracer_torch.ops import shade as sh
    from imbatracer_torch.ops import vcm_shade as vs
    from imbatracer_torch.render.integrators import pt, vcm
    from torch_shade_cases import port_scene

    scene, meta = port_scene(name, cuda_device)
    cam, fi = _vcm_inputs(scene, meta, cuda_device)
    lanes = 3001
    alpha_fn = pt.alpha_fn_for(scene) if meta.has_masks else None
    skw = dict(mis_eta_vc=fi.mis_eta_vc, mis_eta_vm=fi.mis_eta_vm,
               algo="vcm", light_path_count=VCM_LPC, max_len=VCM_MAX_LEN,
               has_bump=meta.has_bump, pixel_area=vcm.pixel_area(cam))
    closest = lambda c: tt.closest_hit(scene.bvh, c["org"], c["d"],
                                       c["tmin"], BIG, alpha_fn=alpha_fn,
                                       active=c["active"], sort=True)
    c = vs.light_start(scene, fi.frame, fi.mis_eta_vc, lanes=lanes,
                       light_path_count=VCM_LPC, path_start=100)
    bounce = 0 if band == "all_live" else 1
    if bounce:
        c, _ = vs.light_shade(scene, cam, c, closest(c), 0, vs.light_rows(
            lanes, 1, True, True, cuda_device), **skw)
    else:
        assert float(c["active"].double().mean()) >= 0.9
    if band in ("all_dead", "half_dead"):
        c["active"] = c["active"].clone()
        c["active"][::1 if band == "all_dead" else 2] = False
    hit = closest(c)
    rk = vs.light_rows(lanes, 1, True, True, cuda_device)
    rp = vs.light_rows(lanes, 1, True, True, cuda_device)
    vs.reset_launches()
    k_nxt, k_sh = vs.light_shade_cuda(scene, cam, c, hit, bounce, rk, **skw)
    p_nxt, p_sh = vs.light_shade_plain(scene, cam, c, hit, bounce, rp,
                                       **skw)
    for n in p_nxt:
        _same_bits(n, k_nxt[n], p_nxt[n])
    for n in sh.ShadowRay._fields:
        _same_bits(f"shadow.{n}", getattr(k_sh, n), getattr(p_sh, n))
    for n in vs.LightRows._fields:
        _same_bits(f"rows.{n}", getattr(rk, n), getattr(rp, n))
    assert vs.LAUNCHES["light_shade"] == 1
    if band == "all_dead":
        assert not k_nxt["active"].any() and not k_sh.ok.any()
        assert bool((rk.pixel == vs.DEAD_LIGHT.pixel).all())
    else:
        assert k_sh.ok.any() and rk.store.any()


def _seeded_hit(rs, t, n):
    """A Hit of n lanes drawn from `rs`, each field put on the card by
    `t`."""
    return tt.Hit(t(rs.uniform(0, 9, n).astype(np.float32)),
                  t(rs.randint(-1, 500, n).astype(np.int32)),
                  t(rs.rand(n).astype(np.float32)),
                  t(rs.rand(n).astype(np.float32)))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "unaligned", "no_slots",
                                  "no_counts", "wide"])
def test_cuda_slot_finish_folds_the_loop_counts(cuda_device, case):
    """slot_finish_kernel, a grid over the SMs, against slot_finish_plain
    bit for bit (the counts and the merged hit) with the counts a run of
    the loop's body ticks: flags of
    a length that is no multiple of 16 (3,001 lanes, 129 slots), flags
    that start off a 16-byte boundary, no slot, no device counts (the
    overflow alone) and 2^20 lanes (more blocks than the card has SMs).
    The word its blocks meet in is left zero for the next launch: two
    launches in a row agree too."""
    from imbatracer_torch.ops import dispatch as dp

    rs = np.random.RandomState(len(case))
    num_r, slots = {"wide": (1 << 20, 4096), "no_slots": (3001, 0)}.get(
        case, (3001, 129))
    t = lambda a: torch.from_numpy(a).to(cuda_device)
    off = 1 if case == "unaligned" else 0
    act = t(rs.rand(num_r + off) < 0.01)[off:]
    need = t(rs.rand(slots + 3 * off) < 0.4)[3 * off:]
    if case == "unaligned":
        assert act.data_ptr() % 16 and need.data_ptr() % 16
    idx = t(rs.permutation(num_r)[:slots].astype(np.int64))
    sub, hit = _seeded_hit(rs, t, slots), _seeded_hit(rs, t, num_r)
    s = dp.Slots(idx, need, need, None, sub,
                 torch.tensor(slots + 7, dtype=torch.int32,
                              device=cuda_device),
                 torch.tensor(7, dtype=torch.int32, device=cuda_device))
    rounds = torch.tensor(4, dtype=torch.int32, device=cuda_device)
    at = {k: 9 + i for i, k in enumerate(dp.FINISH_KEYS)}
    where = ([at[k] for k in dp.FINISH_KEYS],
             [k.startswith("max_") for k in dp.FINISH_KEYS])
    deltas = [(1, 1), (2, 1), (4, 3), (7, 1), (8, 2)]
    counts0 = t(rs.randint(0, 50, 16).astype(np.int32))
    ck, cp = counts0.clone(), counts0.clone()
    dp.reset_launches()
    for _ in range(2):
        if case == "no_counts":
            got = dp.slot_finish(ck[0], act, s, rounds, hit=hit)
            want = dp.slot_finish_plain(cp[0], act, s, rounds, hit=hit)
        else:
            got = dp.slot_finish(ck[0], act, s, rounds, (ck,) + where,
                                 deltas, hit=hit)
            want = dp.slot_finish_plain(cp[0], act, s, rounds,
                                        (cp,) + where, deltas, hit=hit)
        assert torch.equal(ck, cp)
        for x, y in zip(got, want):
            assert torch.equal(x, y)
    assert int(ck[0] - counts0[0]) == 2 * (7 + int(need.sum()))
    assert dp.LAUNCHES["slot_finish"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "unaligned", "no_slots",
                                  "no_counts", "wide"])
def test_cuda_fused_finish_merges_the_hits(cuda_device, case):
    """slot_finish_kernel with the dispatch's hit, one launch, against
    slot_finish_plain then slot_merge_plain bit for bit, in the cases of
    test_cuda_slot_finish_folds_the_loop_counts: 3,001 lanes and 129
    slots (no multiple of 16 or of a block), flags that start off a
    16-byte boundary, no slot, no device counts, and 2^20 lanes with
    4,096 slots (more blocks than the card has SMs); the valid slots at
    random and holding distinct lanes at random, seeded slot hits.  The
    merged hit is written in place and the overflow and counts are as
    without the merge; two launches in a row agree too (the word the
    blocks meet in is left zero)."""
    from imbatracer_torch.ops import dispatch as dp

    rs = np.random.RandomState(10 + len(case))
    num_r, slots = {"wide": (1 << 20, 4096), "no_slots": (3001, 0)}.get(
        case, (3001, 129))
    t = lambda a: torch.from_numpy(a).to(cuda_device)
    off = 1 if case == "unaligned" else 0
    act = t(rs.rand(num_r + off) < 0.01)[off:]
    valid = t(rs.rand(slots + 5 * off) < 0.7)[5 * off:]
    need = valid & t(rs.rand(slots) < 0.4)
    if case == "unaligned":
        assert act.data_ptr() % 16 and valid.data_ptr() % 16
    idx = t(rs.permutation(num_r)[:slots].astype(np.int64))
    sub, hit = _seeded_hit(rs, t, slots), _seeded_hit(rs, t, num_r)
    s = dp.Slots(idx, valid, need, None, sub,
                 torch.tensor(slots + 7, dtype=torch.int32,
                              device=cuda_device),
                 torch.tensor(7, dtype=torch.int32, device=cuda_device))
    rounds = torch.tensor(4, dtype=torch.int32, device=cuda_device)
    at = {k: 9 + i for i, k in enumerate(dp.FINISH_KEYS)}
    counts = None if case == "no_counts" else (
        [at[k] for k in dp.FINISH_KEYS],
        [k.startswith("max_") for k in dp.FINISH_KEYS])
    deltas = [] if counts is None else [(1, 1), (2, 1), (4, 3), (7, 1),
                                        (8, 2)]
    counts0 = t(rs.randint(0, 50, 16).astype(np.int32))
    ck, cp = counts0.clone(), counts0.clone()
    dp.reset_launches()
    for _ in range(2):
        own = tt.Hit(*(x.clone() for x in hit))
        got = dp.slot_finish(ck[0], act, s, rounds,
                             None if counts is None else (ck,) + counts,
                             deltas, hit=own)
        assert all(x is y for x, y in zip(got, own))
        dp.slot_finish_plain(cp[0], act, s, rounds,
                             None if counts is None else (cp,) + counts,
                             deltas)
        want = dp.slot_merge_plain(s, hit)
        assert torch.equal(ck, cp)
        for x, y in zip(got, want):
            assert torch.equal(x, y)
    merged = int(valid.sum())
    if merged:
        lanes = idx[valid]
        assert torch.equal(got.t[lanes], sub.t[valid])
    assert dp.LAUNCHES["slot_finish"] == 2
    assert dp.LAUNCHES["slot_merge"] == 0


@pytest.mark.cuda
def test_cuda_vcm_shade_graphs_follow_the_frame(cuda_device):
    """The light and camera graphs read the frame number, the MIS
    constants, the working cache and the camera through pointers: frames
    3 and 8 of a graphed vcm frame captured at frame 0, the camera moved
    between them, equal the eager frames (means within 1e-6 relative,
    >= 99.9% of pixels within 1e-5), and the two frames differ; the
    kernels launched in both routes, no plain version."""
    import dataclasses

    from imbatracer_torch.ops import vcm_shade as vs
    from imbatracer_torch.render import graphs
    from imbatracer_torch.render.camera import make_camera
    from imbatracer_torch.render.integrators import vcm
    from torch_shade_cases import port_scene

    scene, meta = port_scene("still_life", cuda_device)
    kinds = tuple(sorted(set(scene.materials.kind.tolist())))

    def frame(f, cam, graph):
        vs.reset_launches()
        film = vcm.render_vcm_frame(
            scene, cam, f, 0.05, algo="vcm", width=VCM_SIZE,
            height=VCM_SIZE, max_len=VCM_MAX_LEN, light_path_count=1000,
            has_masks=meta.has_masks, has_bump=meta.has_bump,
            mat_kinds=kinds, light_band=384, camera_band=1500, graph=graph)
        torch.cuda.synchronize()
        assert all(vs.LAUNCHES[k] for k in vs.KERNELS)
        assert not any(vs.LAUNCHES[k] for k in vs.PLAIN_KEYS)
        return film.double()

    cam0 = make_camera(meta.cam_pos, meta.cam_dir, meta.cam_up, VCM_SIZE,
                       VCM_SIZE, 60.0, device=cuda_device)
    moved = dataclasses.replace(cam0, pos=cam0.pos + torch.tensor(
        [0.02, -0.01, 0.03], device=cuda_device))
    graphs.reset_stats()
    frame(0, cam0, None)                               # captures
    films = []
    for f, cam in ((3, cam0), (8, moved)):
        ef, gf = frame(f, cam, False), frame(f, cam, None)
        assert float(ef.mean()) > 0.0
        assert abs(float(gf.mean() - ef.mean())) <= 1e-6 * float(ef.mean())
        rel = ((gf - ef).abs() / ef.abs().clamp(min=1e-3)).amax(dim=1)
        assert float((rel <= 1e-5).double().mean()) >= 0.999
        films.append(gf)
    assert not torch.equal(films[0], films[1])
    assert graphs.GRAPH_STATS["reruns"] == 0
    assert graphs.GRAPH_STATS["replays"] > 0


@pytest.mark.cuda
def test_cuda_vcm_shade_input_checks(cuda_device):
    """The wrappers raise on tensors off the card or of another type."""
    from imbatracer_torch.ops import vcm_shade as vs
    from torch_shade_cases import port_scene

    scene, meta = port_scene("cornell", cuda_device)
    cam, fi = _vcm_inputs(scene, meta, cuda_device)
    c = vs.light_start_cuda(scene, fi.frame, fi.mis_eta_vc, lanes=256,
                            light_path_count=VCM_LPC)
    hit = tt.closest_hit(scene.bvh, c["org"], c["d"], c["tmin"], BIG,
                         active=c["active"], sort=True)
    rows = vs.light_rows(256, 1, True, True, cuda_device)
    kw = dict(mis_eta_vc=fi.mis_eta_vc, mis_eta_vm=fi.mis_eta_vm,
              algo="vcm", light_path_count=VCM_LPC, max_len=4,
              has_bump=False, pixel_area=1.0)
    with pytest.raises(ValueError, match="path_id"):
        vs.light_shade_cuda(scene, cam, dict(c, path_id=c["path_id"].long()),
                            hit, 0, rows, **kw)
    with pytest.raises(ValueError, match="hit.t"):
        vs.light_shade_cuda(scene, cam, c, hit._replace(t=hit.t.cpu()), 0,
                            rows, **kw)
    with pytest.raises(ValueError, match="radiance"):
        vs.camera_finish_cuda(rows.cc.cpu(), rows.cc, rows.store, rows.store,
                              None)


# --------------------------------------------------------------------------
# The traversal dispatch glue (csrc/dispatch.cu)
# --------------------------------------------------------------------------

def _layer_scene(layers, two_level, dev):
    """tests/test_torch_masks.py's stacked layers (an opaque floor at y =
    0, `layers` quads above it) with a mask record that makes each quad
    transparent over world x < 0: (bvh, MaskTest) on `dev`."""
    from imbatracer_torch.accel.builder import build_bvh, triangle_bboxes
    from imbatracer_torch.accel.device import DeviceBvh
    from imbatracer_torch.accel.flatten import thread_bvh
    from imbatracer_torch.accel.instancing import build_two_level
    from imbatracer_torch.scene.textures import MaskTest, TextureAtlas

    f, half = 4, 2
    tris = [((-f, 0, f), (f, 0, f), (f, 0, -f)),
            ((-f, 0, f), (f, 0, -f), (-f, 0, -f))]
    rec = np.zeros((2 + 2 * layers, 10), np.float32)
    bits = rec[:, 0:4].view(np.int32)
    bits[:] = (-1, 2, 1, 0)
    for k in range(layers):
        y = 1.0 + k
        for j, tri in enumerate((((-half, half), (half, half), (half, -half)),
                                 ((-half, half), (half, -half),
                                  (-half, -half)))):
            tris.append(tuple((x, y, z) for x, z in tri))
            bits[2 + 2 * k + j, 0] = 0
            rec[2 + 2 * k + j, 4:10] = [
                c for x, z in tri for c in ((x + half) / (2 * half),
                                            (z + half) / (2 * half))]
    v = [np.asarray([t[i] for t in tris], np.float32) for i in range(3)]
    if two_level:
        tl = build_two_level([tuple(v)], [dict(mesh_idx=0, matrix=np.eye(4),
                                               face_base=0)])
        bvh = DeviceBvh.from_two_level(tl.sbox, tl.tiles, tl.tile_idx,
                                       tl.inst_of, tl.itab, device=dev)
    else:
        jt = thread_bvh(build_bvh(*triangle_bboxes(*v)), *v)
        bvh = DeviceBvh.from_packed(jt.tri_v0, jt.tri_e1, jt.tri_e2,
                                    jt.tri_id, device=dev)
    atlas = TextureAtlas(
        texels=torch.tensor([[0.0] * 3, [1.0] * 3], device=dev),
        offset=torch.zeros(1, dtype=torch.int32, device=dev),
        width=torch.full((1,), 2, dtype=torch.int32, device=dev),
        height=torch.ones(1, dtype=torch.int32, device=dev))
    return bvh, MaskTest(torch.from_numpy(rec).to(dev), atlas)


def _layer_rays(layers, n, seed, dev):
    rs = np.random.RandomState(seed)
    org = np.stack([rs.uniform(-1.5, 1.5, n), np.full(n, layers + 2.0),
                    rs.uniform(-1.5, 1.5, n)], axis=1)
    d = np.tile([0.0, -1.0, 0.0], (n, 1)) + rs.uniform(-0.05, 0.05, (n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=dev)
    return t(org), t(d), t(rs.rand(n) < 0.9, torch.bool)


def _bounce_rays(scene, meta, dev, size=96):
    """The rays of a PT frame's second bounce: (org, d, active)."""
    from imbatracer_torch.render.camera import make_camera
    from imbatracer_torch.render.integrators import pt

    cam = make_camera(meta.cam_pos, meta.cam_dir, meta.cam_up, size, size,
                      60.0, device=dev)
    org, d, state, _ = pt.camera_rays(cam, size, size, 1, 3)
    c = pt._trace(scene, pt._init_carry(org, d, state), 1,
                  alpha_fn=pt.alpha_fn_for(scene) if meta.has_masks
                  else None, has_bump=meta.has_bump, max_len=8)
    return c["org"], c["d"], c["active"]


def _dispatch_case(case, dev, tmp_path_factory):
    """(bvh, org, d, active, tmax, MaskTest or None) of a card test."""
    from imbatracer_torch.render.integrators import pt
    from imbatracer_torch.scene.procedural import make_still_life_like

    if case in ("layers", "layers_two_level"):
        bvh, alpha = _layer_scene(9, case == "layers_two_level", dev)
        org, d, act = _layer_rays(9, 3000, 1, dev)
        return bvh, org, d, act, 7.5, alpha
    if case == "instanced":
        from imbatracer_torch.scene.build import build_scene
        from imbatracer_torch.scene.generate import write_instanced_scene

        path = write_instanced_scene(str(tmp_path_factory.mktemp("dinst")))
        scene, meta = build_scene(path, device=dev)
    else:
        scene, meta = make_still_life_like(num_objects=300, num_cards=60,
                                           device=dev)
    org, d, act = _bounce_rays(scene, meta, dev)
    if case == "random":
        rs = np.random.RandomState(5)
        lo, hi = scene.bvh.bounds[:3].cpu().numpy(), \
            scene.bvh.bounds[3:].cpu().numpy()
        org = torch.from_numpy(rs.uniform(lo, hi, org.shape).astype(
            np.float32)).to(dev)
        d = torch.nn.functional.normalize(torch.from_numpy(
            rs.randn(*d.shape).astype(np.float32)).to(dev), dim=1)
        act = torch.from_numpy(rs.rand(org.shape[0]) < 0.8).to(dev)
    tmax = torch.from_numpy(np.random.RandomState(6).uniform(
        0.1, 5.0, org.shape[0]).astype(np.float32)).to(dev)
    return (scene.bvh, org, d, act, tmax,
            pt.alpha_fn_for(scene) if meta.has_masks else None)


def _random_hit(n, seed, dev, prims=50):
    """A Hit of n lanes with ids in [-1, prims)."""
    rs = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(a).to(dev)
    return tt.Hit(t=t(rs.uniform(0, 9, n).astype(np.float32)),
                  prim_id=t(rs.randint(-1, prims, n).astype(np.int32)),
                  u=t(rs.rand(n).astype(np.float32)),
                  v=t(rs.rand(n).astype(np.float32)))


def _both(kernel, plain, state, *args, **kw):
    """Run a resolve's kernel and plain version on copies of `state` (a
    dict of tensors, Hits included) and require equal bits."""
    def copy(s):
        return {k: (tt.Hit(*(x.clone() for x in v)) if isinstance(v, tt.Hit)
                    else v.clone()) for k, v in s.items()}

    a, b = copy(state), copy(state)
    kernel(*args, **a, **kw)
    plain(*args, **b, **kw)
    for k in state:
        for x, y in zip(*((s[k],) if torch.is_tensor(s[k]) else s[k]
                          for s in (a, b))):
            assert torch.equal(x, y), k


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "still_life", "instanced",
                                  "layers", "layers_two_level"])
def test_cuda_dispatch_kernels_match_plain(cuda_device, tmp_path_factory,
                                           case):
    """The four dispatch kernels against their plain versions, bit for
    bit, on random lanes and on the still life's and the instanced
    scene's bounce rays (and 9 stacked masked layers, flat and
    two-level): keys and rows over every lane and over a slot map with
    state by slot and by lane, tmin' from tcur, past tcur or tmin; the
    khit resolve (flat BVHs) and the stream resolve's three modes on the
    traversal's sorted rows, each alpha test by the mask record and by
    flags."""
    from imbatracer_torch.ops import dispatch as dp

    bvh, org, d, act, tmax, alpha = _dispatch_case(case, cuda_device,
                                                   tmp_path_factory)
    dev, n = org.device, org.shape[0]
    rs = np.random.RandomState(n)
    lanes = torch.from_numpy(np.sort(rs.choice(n, n // 3, replace=False))
                             ).to(dev)
    tc = torch.from_numpy(rs.uniform(1e-5, 2.0, n).astype(np.float32)).to(dev)
    lo, hi = st.full_lanes(1e-3, n, dev), st.full_lanes(tmax, n, dev)
    flags = (None if alpha is None else lambda p, u, v: alpha(p, u, v))
    stand_in = (lambda p, u, v: (p % 3) != 0)
    tests = ([(alpha, "khit_resolve", "stream_resolve")] if alpha else []) + [
        (flags or stand_in, "khit_resolve_flags", "stream_resolve_flags")]
    dp.reset_launches()
    for ln, by_lane in ((None, False), (lanes, False), (lanes, True)):
        m = n if ln is None else ln.shape[0]
        size = n if ln is None or by_lane else m
        sub = (lambda x: x) if size == n else (lambda x: x[ln])
        a, t = sub(act), sub(tc)
        keys = dp.keys_cuda(org, d, a, bvh.bounds, bvh.center, ln, by_lane)
        assert torch.equal(keys, dp.keys_plain(org, d, a, bvh.bounds,
                                               bvh.center, ln, by_lane))
        perm = torch.sort(keys, stable=True)[1]
        for tcur, step in ((None, False), (t, False), (t, True)):
            kw = dict(active=a, center=bvh.center, lanes=ln, tcur=tcur,
                      step=step, by_lane=by_lane)
            assert torch.equal(dp.rows_cuda(org, d, lo, hi, perm, m, **kw),
                               dp.rows_plain(org, d, lo, hi, perm, m, **kw))
        disp = dp.prepare(org, d, 1e-3, tmax, a, bounds=bvh.bounds,
                          center=bvh.center, lanes=ln, by_lane=by_lane)
        out = st.traverse(disp.rows, bvh.sbox, bvh.tiles, False, bvh.inst)
        hit = _random_hit(size, 7, dev, 50 if alpha is None
                          else alpha.mask_rec.shape[0])
        _both(dp.stream_resolve_cuda, dp.stream_resolve_plain,
              dict(hit=hit), disp, out, dp.CLOSEST)
        flag = torch.zeros(size, dtype=torch.bool, device=dev)
        for fn, kkey, skey in tests:
            for select in (False, True):
                before = dp.LAUNCHES[skey]
                _both(dp.stream_resolve_cuda, dp.stream_resolve_plain,
                      dict(hit=hit, flag=flag), disp, out, dp.RETRACE,
                      retrace_in=a, select=select, alpha_fn=fn)
                assert dp.LAUNCHES[skey] == before + 1
            if not bvh.two_level:
                kout = kh.khit(disp.rows, bvh.sbox, bvh.tiles)
                for need_out in (None, flag):
                    state = dict(need_in=a.clone(), tcur=t.clone(), hit=hit)
                    if need_out is not None:
                        state["need_out"] = need_out
                    kern = _need_out_default(dp.khit_resolve_cuda)
                    plain = _need_out_default(dp.khit_resolve_plain)
                    before = dp.LAUNCHES[kkey]
                    _both(kern, plain, state, disp, kout, alpha_fn=fn)
                    assert dp.LAUNCHES[kkey] == before + 1
        occ = st.traverse(disp.rows, bvh.sbox, bvh.tiles, True, bvh.inst)
        _both(dp.stream_resolve_cuda, dp.stream_resolve_plain,
              dict(flag=flag), disp, occ, dp.OCCLUSION)
    assert dp.LAUNCHES["dispatch_keys"] == 6          # three here, three
    assert dp.LAUNCHES["dispatch_rows"] == 12         # in prepare()


@pytest.mark.cuda
@pytest.mark.parametrize("n,case,flags,recentre", RAGGED_KEYS)
def test_cuda_dispatch_keys_at_ragged_shapes(cuda_device, n, case, flags,
                                             recentre):
    """dispatch_keys_kernel bit-equal to keys_plain at the shapes and
    flags it treats apart (tests/torch_dispatch_cases.py: lane counts
    around a block, slot maps with state by slot or by lane, the flags all
    set, none, some or absent, recentred or not), with the lane arrays
    read through views 4 bytes off 16-byte alignment.  One launch each."""
    from imbatracer_torch.ops import dispatch as dp

    rs = np.random.RandomState(n)
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt,
                                                    device=cuda_device)
    d = rs.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[::7, rs.randint(3)] = -0.0
    org, d = _unaligned(t(rs.uniform(-3.0, 3.0, (n, 3)))), _unaligned(t(d))
    lanes = None if case == "all" else t(np.sort(rs.choice(
        n, max(n // 2, 1), replace=False)), torch.int64)
    by_lane = case == "by_lane"
    size = n if lanes is None or by_lane else lanes.shape[0]
    act = {"live": np.ones(size, bool), "dead": np.zeros(size, bool),
           "mixed": rs.rand(size) < 0.6, "none": None}[flags]
    act = None if act is None else t(act, torch.bool)
    bounds = t([-2.5, -2.0, -3.0, 2.0, 2.5, 1.5])
    center = t([0.25, -0.5, 0.125]) if recentre else None
    dp.reset_launches()
    got = dp.keys_cuda(org, d, act, bounds, center, lanes, by_lane)
    assert dp.LAUNCHES["dispatch_keys"] == 1
    want = dp.keys_plain(org, d, act, bounds, center, lanes, by_lane)
    assert torch.equal(got, want)
    assert bool((got == 2 ** 30).all()) == (flags == "dead")


@pytest.mark.cuda
@pytest.mark.parametrize("n,case,permuted,lims,tcur", RAGGED_ROWS)
def test_cuda_dispatch_rows_at_ragged_shapes(cuda_device, n, case, permuted,
                                             lims, tcur):
    """dispatch_rows_kernel bit-equal to rows_plain at the shapes its
    launch geometry meets (tests/torch_dispatch_cases.py: rows around the
    rows a thread and a block, n_pad far above n, perm None, slot maps
    with state by slot or by lane, stride-0 tmin and tmax, tcur with and
    without step), padding rows included.  One launch each."""
    from imbatracer_torch.ops import dispatch as dp

    rs = np.random.RandomState(n)
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt,
                                                    device=cuda_device)
    d = rs.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    org, d = t(rs.uniform(-3.0, 3.0, (n, 3))), t(d)
    lanes = None if case == "all" else t(np.sort(rs.choice(
        n, max(n // 2, 1), replace=False)), torch.int64)
    m = n if lanes is None else lanes.shape[0]
    by_lane = case != "slots"
    size = n if by_lane else m
    stride0 = lims == "stride0"
    lo = st.full_lanes(1e-3 if stride0 else t(rs.uniform(0.0, 1e-2, n)), n,
                       cuda_device)
    hi = st.full_lanes(7.5 if stride0 else t(rs.uniform(0.5, 12.0, n)), n,
                       cuda_device)
    kw = dict(active=t(rs.rand(size) < 0.8, torch.bool),
              center=t(rs.uniform(-1.0, 1.0, 3)), lanes=lanes,
              tcur=None if tcur == "none" else t(rs.uniform(0.0, 3.0, size)),
              step=tcur == "step", by_lane=by_lane)
    perm = t(rs.permutation(m), torch.int64) if permuted else None
    dp.reset_launches()
    got = dp.rows_cuda(org, d, lo, hi, perm, m, **kw)
    want = dp.rows_plain(org, d, lo, hi, perm, m, **kw)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (m + (-m) % st.BLK, 8)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert dp.LAUNCHES["dispatch_rows"] == 1


def _need_out_default(fn):
    """A khit resolve that writes its need flags in place unless given
    need_out."""
    def call(disp, out, need_in, tcur, hit, alpha_fn, need_out=None):
        fn(disp, out, need_in, need_in if need_out is None else need_out,
           tcur, hit, alpha_fn)
    return call


@pytest.mark.cuda
@pytest.mark.parametrize("two_level", [False, True])
def test_cuda_dispatch_graphs_follow_their_inputs(cuda_device, two_level,
                                                  monkeypatch):
    """The graph-ready masked closest hit and occlusion over 9 stacked
    masked layers captured once (the khit resolve, or the stream
    re-trace, inside the WHILE node's body) and replayed after its rays,
    active flags and tmax change: equal bit for bit to the eager route on
    the card, the resolves launched inside the loop's body (its device
    counts), no overflow (every lane a slot: half of them see through)."""
    from imbatracer_torch.ops import dispatch as dp
    from imbatracer_torch.render import graphs

    monkeypatch.setattr(tt, "RETRACE_SLOT_DIV" if two_level
                        else "KHIT_SLOT_DIV", 1)

    bvh, alpha = _layer_scene(9, two_level, cuda_device)
    org, d, act = _layer_rays(9, 2048, 0, cuda_device)
    state = dict(org=org.clone(), d=d.clone(), act=act.clone(),
                 tmax=torch.full_like(org[:, 0], 7.5),
                 t=torch.empty_like(org[:, 0]),
                 id=torch.empty_like(act, dtype=torch.int32),
                 occ=torch.empty_like(act))

    def step(s, overflow):
        h = tt.closest_hit(bvh, s["org"], s["d"], 0.0, BIG, alpha_fn=alpha,
                           active=s["act"], sort=True, overflow=overflow)
        s["t"].copy_(h.t)
        s["id"].copy_(h.prim_id)
        s["occ"].copy_(tt.any_hit(bvh, s["org"], s["d"], 0.0, s["tmax"],
                                  alpha_fn=alpha, active=s["act"], sort=True,
                                  overflow=overflow))

    sg = graphs.SceneGraphs(cuda_device)
    g = sg.phase("masked", step, state)
    key = "stream_resolve" if two_level else "khit_resolve"
    slot = graphs._slot(dp.LAUNCHES, key)
    for seed in (1, 2, 3):
        org, d, act = _layer_rays(9, 2048, seed, cuda_device)
        tmax = torch.full_like(org[:, 0], 2.0 + seed)
        for k, v in (("org", org), ("d", d), ("act", act), ("tmax", tmax)):
            state[k].copy_(v)
        sg.counts.zero_()
        g.replay()
        torch.cuda.synchronize()
        assert int(sg.overflow) == 0 and int(sg.counts[slot]) > 0
        want = tt.closest_hit(bvh, org, d, 0.0, BIG, alpha_fn=alpha,
                              active=act, sort=True)
        assert torch.equal(state["t"], want.t)
        assert torch.equal(state["id"], want.prim_id)
        see = act & (org[:, 0] < -0.7)
        assert bool((want.prim_id[see] < 2).all())       # the floor
        assert torch.equal(state["occ"], tt.any_hit(
            bvh, org, d, 0.0, tmax, alpha_fn=alpha, active=act, sort=True))


@pytest.mark.cuda
def test_cuda_dispatch_input_checks(cuda_device):
    """The wrappers raise on tensors off the card or of another type."""
    from imbatracer_torch.ops import dispatch as dp

    bvh, alpha = _layer_scene(2, False, cuda_device)
    org, d, act = _layer_rays(2, 256, 0, cuda_device)
    with pytest.raises(ValueError):
        dp.keys_cuda(org.cpu(), d, act, bvh.bounds)
    with pytest.raises(ValueError):
        dp.keys_cuda(org, d, act.int(), bvh.bounds)
    lo = st.full_lanes(0.0, 256, cuda_device)
    perm = torch.arange(256, device=cuda_device)
    with pytest.raises(ValueError):
        dp.rows_cuda(org, d, lo, lo, perm.int(), 256)
    with pytest.raises(ValueError):
        dp.rows_cuda(org, d, lo, lo, perm, 256, tcur=lo.double())
    disp = dp.prepare(org, d, 0.0, BIG, act, bounds=bvh.bounds)
    rows = st.traverse(disp.rows, bvh.sbox, bvh.tiles, False)
    hit = _random_hit(256, 0, cuda_device)
    with pytest.raises(ValueError):
        dp.khit_resolve_cuda(disp, rows, act, act, lo.clone(), hit, alpha)
    with pytest.raises(ValueError):
        dp.stream_resolve_cuda(disp, rows, dp.CLOSEST, hit=tt.Hit(
            hit.t, hit.prim_id.long(), hit.u, hit.v))


# --------------------------------------------------------------------------
# The light band's tail (csrc/light_tail.cu) and the re-trace's slot
# kernels (csrc/dispatch.cu)
# --------------------------------------------------------------------------

def _staged_rows(n, seed, dev, share=0.3):
    """A band's staged rows: (valid (n,), rows (n, 24), contrib (n, 3),
    pixel (n,) with -1 on about a third)."""
    rs = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(a).to(dev)
    return (t(rs.rand(n) < share), t(rs.randn(n, 24).astype(np.float32)),
            t(rs.uniform(0.0, 2.0, (n, 3)).astype(np.float32)),
            t(np.where(rs.rand(n) < 0.35, -1,
                       rs.randint(0, 500, n)).astype(np.int32)))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["empty", "partial", "overflow", "full",
                                  "none_valid"])
def test_cuda_light_tail_append_matches_plain(cuda_device, case):
    """collect_append_cuda against collect_append_plain from the same
    seeded buffer: rec[:C], count and lost bit-equal, the rows that do
    not fit counted in lost, CollectCache.check raising exactly then, and
    row C (the plain version's trash row) never written by the kernel."""
    from imbatracer_torch.ops import light_tail as lt
    from imbatracer_torch.render.light_cache import CollectCache

    valid, rows, _, _ = _staged_rows(5000, 1, cuda_device,
                                     0.0 if case == "none_valid" else 0.3)
    nvalid = int(valid.sum())
    cap, count0 = {"empty": (8000, 0), "partial": (8000, 3000),
                   "overflow": (2000, 1000), "full": (1500, 1500),
                   "none_valid": (100, 40)}[case]
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    rec0 = torch.randn((cap + 1, 24), generator=gen, device=cuda_device)

    def state():
        return CollectCache(rec0.clone(), torch.full(
            (), count0, dtype=torch.int32, device=cuda_device),
            torch.zeros((), dtype=torch.int32, device=cuda_device),
            torch.zeros((cap + 1, 2), dtype=torch.int32, device=cuda_device))

    a, b = state(), state()
    before = lt.LAUNCHES["collect_append"]
    lt.collect_append(a.rec, a.count, a.lost, valid, rows, a.keys)
    assert lt.LAUNCHES["collect_append"] == before + 1
    lt.collect_append_plain(b.rec, b.count, b.lost, valid, rows, b.keys)
    assert torch.equal(a.rec[:cap], b.rec[:cap])
    assert torch.equal(a.rec[cap], rec0[cap])
    assert int(a.count) == int(b.count) == min(count0 + nvalid, cap)
    lost = max(count0 + nvalid - cap, 0)
    assert int(a.lost) == int(b.lost) == lost
    if lost:
        with pytest.raises(RuntimeError, match="overflow"):
            a.check()
    else:
        a.check()


@pytest.mark.cuda
def test_cuda_light_tail_splat_matches_plain(cuda_device):
    """splat_cuda against splat_plain: a fresh film, the rows without a
    pixel dropped.  Both add ~260 contributions a pixel with atomics, in
    orders of their own, so a pixel may differ by a few hundred float32
    roundings: within 1e-4 relative, the film's sum within 1e-5."""
    from imbatracer_torch.ops import light_tail as lt

    _, _, contrib, pixel = _staged_rows(200_000, 2, cuda_device)
    k = lt.splat(contrib, pixel, 500)
    p = lt.splat_plain(contrib, pixel, 500)
    assert k.shape == (500, 3)
    np.testing.assert_allclose(k.cpu().numpy(), p.cpu().numpy(), rtol=1e-4)
    np.testing.assert_allclose(float(k.double().sum()), float(
        contrib[pixel >= 0].double().sum()), rtol=1e-5)
    assert float(lt.splat(contrib, torch.full_like(pixel, -1), 500).abs()
                 .max()) == 0.0


@pytest.mark.cuda
def test_cuda_light_tail_follows_the_light_pass(cuda_device, monkeypatch):
    """A light pass on the card through the kernels against the same pass
    with the plain versions in their place: the collect cache's rows and
    count bit-equal, its film within rounding."""
    from imbatracer_torch.ops import light_tail as lt
    from imbatracer_torch.render import light_cache
    from imbatracer_torch.render.integrators import pt, vcm
    from imbatracer_torch.scene.procedural import make_still_life_like

    scene, meta = make_still_life_like(num_objects=40, num_cards=16,
                                       device=cuda_device)
    cam, fi = _vcm_inputs(scene, meta, cuda_device)

    def run():
        collect = light_cache.empty_collect(VCM_LPC * VCM_MAX_LEN,
                                            cuda_device)
        film = vcm._light_pass(
            scene, cam, fi.frame, fi.mis_eta_vc, fi.mis_eta_vm, collect,
            algo="vcm", num_pixels=VCM_SIZE ** 2, light_path_count=VCM_LPC,
            max_len=VCM_MAX_LEN, alpha_fn=pt.alpha_fn_for(scene),
            has_bump=meta.has_bump)
        return collect, film

    lt.reset_launches()
    ck, fk = run()
    assert lt.LAUNCHES["collect_append"] == lt.LAUNCHES["splat"] == 1
    monkeypatch.setattr(lt, "collect_append_cuda", lt.collect_append_plain)
    monkeypatch.setattr(lt, "splat_cuda", lt.splat_plain)
    cp, fp = run()
    assert int(ck.count) == int(cp.count) > 0 and int(ck.lost) == 0
    assert torch.equal(ck.rec[:-1], cp.rec[:-1])
    # Both splats add with atomics: a pixel's few sums within rounding.
    fp = fp.cpu().numpy()
    np.testing.assert_allclose(fk.cpu().numpy(), fp, rtol=1e-5,
                               atol=1e-6 * float(np.abs(fp).max()))


@pytest.mark.cuda
def test_cuda_light_tail_input_checks(cuda_device):
    """The wrappers raise on tensors off the card, of another type or
    shape."""
    from imbatracer_torch.ops import light_tail as lt

    valid, rows, contrib, pixel = _staged_rows(64, 3, cuda_device)
    rec = torch.zeros((101, 24), device=cuda_device)
    keys = torch.zeros((101, 2), dtype=torch.int32, device=cuda_device)
    count = torch.zeros((), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        lt.collect_append_cuda(rec, count, count.clone(), valid.cpu(), rows,
                               keys)
    with pytest.raises(ValueError):
        lt.collect_append_cuda(rec, count.long(), count.clone(), valid, rows,
                               keys)
    with pytest.raises(ValueError):
        lt.collect_append_cuda(rec, count, count.clone(), valid, rows[:, :20],
                               keys)
    with pytest.raises(ValueError):
        lt.splat_cuda(contrib, pixel.long(), 500)
    with pytest.raises(ValueError):
        lt.splat_cuda(contrib.double(), pixel, 500)


def _append_state(cap, count0, dev, seed=3):
    """A seeded collect cache of cap + 1 rows holding count0 rows, with its
    key columns: a factory of equal copies."""
    from imbatracer_torch.render.light_cache import CollectCache

    gen = torch.Generator(device=dev).manual_seed(seed)
    rec0 = torch.randn((cap + 1, 24), generator=gen, device=dev)
    keys0 = torch.randint(0, 1 << 20, (cap + 1, 2), generator=gen,
                          device=dev, dtype=torch.int32)
    c0 = torch.full((), count0, dtype=torch.int32, device=dev)
    return lambda: CollectCache(rec0.clone(), c0.clone(),
                                torch.zeros_like(c0), keys0.clone())


def _same_append(a, b, cap):
    """Two collect caches' rec[:C], keys[:C], count and lost bit-equal."""
    assert _bit_equal(a.rec[:cap], b.rec[:cap])
    assert torch.equal(a.keys[:cap], b.keys[:cap])
    assert int(a.count) == int(b.count) and int(a.lost) == int(b.lost)


def _staged_valid(n, share, seed, dev, unaligned=False):
    """(valid (n,), rows (n, 24)): ~share of the rows valid (0 and 1
    exact), from a flag array one byte past an aligned base with
    `unaligned`; int columns 21-22 as the light pass stages them."""
    rs = np.random.RandomState(seed)
    valid = torch.from_numpy(rs.rand(n) < share).to(dev)
    if unaligned:
        buf = torch.zeros(n + 1, dtype=torch.bool, device=dev)
        buf[1:] = valid
        valid = buf[1:]
    rows = torch.from_numpy(rs.randn(n, 24).astype(np.float32)).to(dev)
    ints = torch.from_numpy(rs.randint(0, 1 << 20, (n, 2)).astype(
        np.int32)).to(dev)
    rows.view(torch.int32)[:, 21:23] = ints
    return valid, rows


@pytest.mark.cuda
@pytest.mark.parametrize("share", [0.0, 0.31, 1.0])
@pytest.mark.parametrize("n", [1, 15, 16, 4095, 4096, 4097, 2097152,
                               2097153])
def test_cuda_collect_append_one_pass_matches_plain(cuda_device, n, share):
    """The one-pass append against collect_append_plain from the same
    seeded cache with a carried count: rec[:C], keys[:C], count and lost
    bit-equal, one launch, row C of the rows and the keys untouched."""
    from imbatracer_torch.ops import light_tail as lt

    valid, rows = _staged_valid(n, share, n, cuda_device)
    cap, count0 = n + 1000, 37
    state = _append_state(cap, count0, cuda_device)
    a, b = state(), state()
    before = lt.LAUNCHES["collect_append"]
    a.append(valid, rows)
    assert lt.LAUNCHES["collect_append"] == before + 1
    lt.collect_append_plain(b.rec, b.count, b.lost, valid, rows, b.keys)
    torch.cuda.synchronize()
    _same_append(a, b, cap)
    fresh = state()
    assert _bit_equal(a.rec[cap], fresh.rec[cap])
    assert torch.equal(a.keys[cap], fresh.keys[cap])
    assert int(a.count) == count0 + int(valid.sum()) and int(a.lost) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [15, 4097, 2097153])
def test_cuda_collect_append_from_an_unaligned_flag_base(cuda_device, n):
    """Flags one byte past an aligned base (the scalar flag path): the
    append equals the plain version bit for bit."""
    from imbatracer_torch.ops import light_tail as lt

    valid, rows = _staged_valid(n, 0.31, n + 1, cuda_device, unaligned=True)
    assert valid.data_ptr() % 16
    cap = n + 50
    state = _append_state(cap, 5, cuda_device)
    a, b = state(), state()
    lt.collect_append_cuda(a.rec, a.count, a.lost, valid, rows, a.keys)
    lt.collect_append_plain(b.rec, b.count, b.lost, valid, rows, b.keys)
    torch.cuda.synchronize()
    _same_append(a, b, cap)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["inside_a_tile", "exactly_full",
                                  "carried_near_full", "already_full"])
def test_cuda_collect_append_overflow(cuda_device, case):
    """Rows past the capacity: cut inside a tile, filling it exactly, a
    carried count 3 below it, and a full cache: the kernel writes only the
    rows that fit, lost counts the others, all bit-equal to the plain
    version."""
    from imbatracer_torch.ops import light_tail as lt

    n = 3 * 4096 + 100
    valid, rows = _staged_valid(n, 0.31, 9, cuda_device)
    nvalid = int(valid.sum())
    cap, count0 = {"inside_a_tile": (2000, 700),
                   "exactly_full": (nvalid + 500, 500),
                   "carried_near_full": (nvalid + 500, nvalid + 497),
                   "already_full": (900, 900)}[case]
    state = _append_state(cap, count0, cuda_device)
    a, b = state(), state()
    lt.collect_append_cuda(a.rec, a.count, a.lost, valid, rows, a.keys)
    lt.collect_append_plain(b.rec, b.count, b.lost, valid, rows, b.keys)
    torch.cuda.synchronize()
    _same_append(a, b, cap)
    assert int(a.count) == min(count0 + nvalid, cap)
    assert int(a.lost) == max(count0 + nvalid - cap, 0)


@pytest.mark.cuda
def test_cuda_collect_append_replayed_in_a_graph(cuda_device):
    """The append captured in a CUDA graph and replayed three times, each
    onto the count the last left, then two eager appends in sequence:
    every result equals the plain version's bit for bit, so the status
    words, the ticket and the done count are back at 0 after each
    launch."""
    from imbatracer_torch.ops import light_tail as lt

    n = 2 * 4096 + 333
    valid, rows = _staged_valid(n, 0.31, 4, cuda_device)
    nvalid = int(valid.sum())
    cap = 4 * nvalid + 10
    state = _append_state(cap, 0, cuda_device)
    a, b = state(), state()
    lt.collect_append_cuda(a.rec, a.count, a.lost, valid, rows, a.keys)
    torch.cuda.synchronize()
    a = state()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        lt.collect_append_cuda(a.rec, a.count, a.lost, valid, rows, a.keys)
    for _ in range(3):
        g.replay()
        lt.collect_append_plain(b.rec, b.count, b.lost, valid, rows, b.keys)
        torch.cuda.synchronize()
        _same_append(a, b, cap)
    for _ in range(2):
        lt.collect_append_cuda(a.rec, a.count, a.lost, valid, rows, a.keys)
        lt.collect_append_plain(b.rec, b.count, b.lost, valid, rows, b.keys)
    torch.cuda.synchronize()
    _same_append(a, b, cap)
    assert int(a.count) == cap and int(a.lost) == 5 * nvalid - cap


@pytest.mark.cuda
def test_cuda_collect_append_key_and_size_checks(cuda_device):
    """The append's wrapper raises on key columns of another type or
    shape, and on more staged rows than its status words cover."""
    from imbatracer_torch.ops import light_tail as lt

    valid, rows = _staged_valid(64, 0.5, 1, cuda_device)
    c = _append_state(100, 0, cuda_device)()
    with pytest.raises(ValueError):
        lt.collect_append_cuda(c.rec, c.count, c.lost, valid, rows,
                               c.keys.long())
    with pytest.raises(ValueError):
        lt.collect_append_cuda(c.rec, c.count, c.lost, valid, rows,
                               c.keys[:-1])
    n = lt.APPEND_MAX_ROWS + 1
    big = torch.empty((n, 24), device=cuda_device)
    with pytest.raises(ValueError, match="at most"):
        lt.collect_append_cuda(c.rec, c.count, c.lost, torch.zeros(
            n, dtype=torch.bool, device=cuda_device), big, c.keys)


def _slot_case(case, dev):
    """(active, need, slots, hit, tcur) of a slot test over 3000 lanes."""
    rs = np.random.RandomState(len(case))
    n = 3000
    t = lambda a: torch.from_numpy(a).to(dev)
    density, slots, with_tcur = {"empty": (0.0, 128, True),
                                 "within": (0.03, 128, True),
                                 "past": (0.1, 128, True),
                                 "two_level": (0.2, 750, False),
                                 "two_level_past": (0.3, 750, False)}[case]
    act = rs.rand(n) < (0.8 if density else 0.0)
    need = act & (rs.rand(n) < density / 0.8)
    hit = tt.Hit(t(rs.uniform(0, 9, n).astype(np.float32)),
                 t(rs.randint(-1, 500, n).astype(np.int32)),
                 t(rs.rand(n).astype(np.float32)),
                 t(rs.rand(n).astype(np.float32)))
    tcur = t(rs.uniform(0, 9, n).astype(np.float32)) if with_tcur else None
    return t(act), t(need), slots, hit, tcur


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["empty", "within", "past", "two_level",
                                  "two_level_past"])
def test_cuda_slot_kernels_match_plain(cuda_device, case):
    """slot_gather and slot_finish against their plain versions bit for
    bit: the slots selected from the need flags, their state, the count
    and the dropped lanes; then the finish, one launch, against
    slot_finish_plain and slot_merge_plain: seeded slot hits merged into a
    copy of the lanes' hits in place, the overflow (slot 0 of a seeded
    counts vector) and the device counts of FINISH_KEYS with a seeded
    share of the slots left unresolved."""
    from imbatracer_torch.ops import dispatch as dp

    act, need, slots, hit, tcur = _slot_case(case, cuda_device)
    count = need.sum(dtype=torch.int32)
    dp.reset_launches()
    k = dp.slot_gather(need, slots, hit, tcur)
    p = dp.slot_gather_plain(need, slots, hit, tcur)
    for x, y in zip(k[:4] + tuple(k.hit) + k[5:],
                    p[:4] + tuple(p.hit) + p[5:]):
        assert (x is None and y is None) or torch.equal(x, y)
    assert int(k.dropped) == max(int(count) - slots, 0)
    rs = np.random.RandomState(7)
    sub = tt.Hit(*(torch.from_numpy(a).to(cuda_device) for a in (
        rs.uniform(0, 9, slots).astype(np.float32),
        rs.randint(-1, 500, slots).astype(np.int32),
        rs.rand(slots).astype(np.float32),
        rs.rand(slots).astype(np.float32))))
    s = k._replace(hit=sub)
    left = s._replace(need=k.valid & torch.from_numpy(
        rs.rand(slots) < 0.5).to(cuda_device))
    rounds = torch.tensor(5, dtype=torch.int32, device=cuda_device)
    counts0 = torch.from_numpy(rs.randint(0, 100, 9).astype(np.int32)).to(
        cuda_device)
    where = (list(range(3, 3 + len(dp.FINISH_KEYS))),
             [key.startswith("max_") for key in dp.FINISH_KEYS])
    for with_counts in (True, False):
        ck, cp = counts0.clone(), counts0.clone()
        own = tt.Hit(*(x.clone() for x in hit))
        got = dp.slot_finish(ck[0], act, left, rounds,
                             (ck,) + where if with_counts else None,
                             hit=own)
        assert all(x is y for x, y in zip(got, own))    # in place
        want = dp.slot_finish_plain(cp[0], act, left, rounds,
                                    (cp,) + where if with_counts else None,
                                    hit=hit)
        assert torch.equal(ck, cp)
        for x, y in zip(got, want):
            assert torch.equal(x, y)
    assert int(ck[0]) == int(counts0[0]) + int(k.dropped) + int(
        left.need.sum())
    assert dp.LAUNCHES["slot_gather"] == 1
    assert dp.LAUNCHES["slot_finish"] == 2
    assert dp.LAUNCHES["slot_merge"] == 0               # in the finish
    # The plain versions ran only where this test called them.
    assert dp.LAUNCHES["slot_gather_plain"] == 1
    assert dp.LAUNCHES["slot_merge_plain"] == 2
    assert dp.LAUNCHES["slot_finish_plain"] == 2


def _selection(case, two_level, seed, dev):
    """A selection case on a 262,144-lane band, at the band's flat
    (1,024) or two-level (65,536) slots, as CUDA tensors."""
    need, slots, hit, tcur = select_case(
        case, 1 << 18, seed, lambda n: tt.retrace_slots(n, two_level),
        not two_level)
    t = lambda a: torch.from_numpy(a).to(dev)
    return (t(need), slots, tt.Hit(*map(t, hit)),
            None if tcur is None else t(tcur))


def _same_slots(k, p):
    """Every output of two slot selections bit for bit."""
    for x, y in zip(k[:4] + tuple(k.hit) + k[5:],
                    p[:4] + tuple(p.hit) + p[5:]):
        assert (x is None and y is None) or torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("two_level", [False, True])
@pytest.mark.parametrize("case", list(SELECT_CASES))
def test_cuda_slot_selection_matches_plain(cuda_device, case, two_level):
    """slot_gather_kernel, which selects the slots from the need flags in
    one launch, against its plain version (nonzero_static, the sum, the
    gathers) bit for bit, at 1,024 and 65,536 slots of a 262,144-lane
    band: no lane in need, every lane, as many as the slots, more
    (dropped), only the last lane, and 266,277 lanes, no multiple of the
    kernel's words or tiles; then again, as its status words must be
    back at 0 after each launch."""
    from imbatracer_torch.ops import dispatch as dp

    need, slots, hit, tcur = _selection(case, two_level, len(case),
                                        cuda_device)
    if case != "ragged":
        assert slots == (65536 if two_level else 1024)
    p = dp.slot_gather_plain(need, slots, hit, tcur)
    for _ in range(3):
        k = dp.slot_gather_cuda(need, slots, hit, tcur)
        torch.cuda.synchronize()
        _same_slots(k, p)
    assert int(k.count) == int(need.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("two_level", [False, True])
def test_cuda_slot_selection_in_a_replayed_graph(cuda_device, two_level):
    """The selection captured in a CUDA graph and replayed over new need
    flags, hits and tcur each time (every case in turn, eager launches in
    between): each replay equals the plain version bit for bit, so the
    status words, the ticket and the done count are back at 0 after every
    launch, in a graph or not."""
    from imbatracer_torch.ops import dispatch as dp

    need, slots, hit, tcur = _selection("past", two_level, 1, cuda_device)
    static = (need.clone(), tt.Hit(*(x.clone() for x in hit)),
              None if tcur is None else tcur.clone())
    dp.slot_gather_cuda(*static[:1], slots, *static[1:])      # built
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = dp.slot_gather_cuda(static[0], slots, static[1], static[2])
    for seed, case in enumerate(list(SELECT_CASES) * 2):
        if case == "ragged":
            continue                          # another band's lanes
        need, _, hit, tcur = _selection(case, two_level, seed, cuda_device)
        static[0].copy_(need)
        for x, y in zip(static[1], hit):
            x.copy_(y)
        if tcur is not None:
            static[2].copy_(tcur)
        g.replay()
        between = dp.slot_gather_cuda(need, slots, hit, tcur)
        torch.cuda.synchronize()
        p = dp.slot_gather_plain(need, slots, hit, tcur)
        _same_slots(out, p)
        _same_slots(between, p)


@pytest.mark.cuda
@pytest.mark.parametrize("nested", [False, True])
def test_cuda_loop_test_runs_the_host_loops_rounds(cuda_device, nested):
    """graphs.while_loop over a LoopTest captured as a WHILE node whose
    flag kernel tests the slots' need flags and the cap and counts the
    rounds, alone and nested in a loop on a flag: a replay runs the body
    as often as the same step run on the host (the plain test), and
    leaves the round counter, the flags and the state where it does, for
    flags that clear a pass at a time (one a slot shifted out each pass),
    none set, and more passes than the cap allows."""
    from imbatracer_torch.render import graphs

    cap, n = 6, 4096 + 37

    def make(dev):
        z = lambda dt: torch.zeros((), dtype=dt, device=dev)
        return {"pattern": torch.zeros(n, dtype=torch.bool, device=dev),
                "need": torch.zeros(n, dtype=torch.bool, device=dev),
                "rounds": z(torch.int32), "left": z(torch.int32),
                "x": z(torch.float32) + 1.0}

    def step(s_, overflow):
        def inner():
            s_["need"].copy_(s_["pattern"])
            test = graphs.LoopTest(s_["need"],
                                   s_["pattern"].sum(dtype=torch.int32),
                                   s_["rounds"], cap)

            def body():
                s_["x"].copy_(s_["x"] * 2.0)
                shifted = torch.zeros_like(s_["need"])
                shifted[:-1] = s_["need"][1:]
                s_["need"].copy_(shifted)

            assert graphs.while_loop(test, body) == ()

        def outer():
            inner()
            s_["left"].sub_(1)

        if nested:
            graphs.while_loop(lambda: s_["left"] > 0, outer)
        else:
            inner()

    sg = graphs.SceneGraphs(cuda_device)
    state = make(cuda_device)
    g = sg.phase("loop_test", step, state)
    for flags, left in (((), 2), ((0,), 1), ((3, 100), 3), ((n - 1,), 2),
                        ((2,), 0), ((4,), 2)):
        host = make("cpu")
        for s_ in (state, host):
            s_["pattern"].zero_()
            s_["need"].zero_()
            s_["pattern"][list(flags)] = True
            s_["left"].fill_(left)
            s_["x"].fill_(1.0)
            s_["rounds"].fill_(-7)
        g.replay()
        step(host, None)
        torch.cuda.synchronize()
        for k, v in host.items():
            assert torch.equal(state[k].cpu(), v), (flags, left, k)
        passes = min(max(flags) + 1, cap - 1) if flags else 0
        runs = (left if nested else 1)
        assert float(state["x"]) == 2.0 ** (passes * runs)


@pytest.mark.cuda
@pytest.mark.parametrize("two_level", [False, True])
def test_cuda_slot_counts_follow_the_replay(cuda_device, two_level,
                                            monkeypatch):
    """A captured masked closest hit over 9 stacked masked layers, replayed
    with some lanes active and with none: the slot kernels' device counts
    (the most rounds and lanes carried past the first, the empty
    dispatches, dropped and capped) equal the eager route's host counts,
    and the overflow counter stays 0."""
    from imbatracer_torch.render import graphs

    monkeypatch.setattr(tt, "RETRACE_SLOT_DIV" if two_level
                        else "KHIT_SLOT_DIV", 1)
    bvh, alpha = _layer_scene(9, two_level, cuda_device)
    org, d, act = _layer_rays(9, 1024, 0, cuda_device)
    state = dict(org=org.clone(), d=d.clone(), act=act.clone(),
                 t=torch.empty_like(org[:, 0]))

    def step(s, overflow):
        s["t"].copy_(tt.closest_hit(bvh, s["org"], s["d"], 0.0, BIG,
                                    alpha_fn=alpha, active=s["act"],
                                    sort=True, overflow=overflow).t)

    sg = graphs.SceneGraphs(cuda_device)
    g = sg.phase("slots", step, state)
    keys = ("max_rounds", "max_lanes", "empty", "dropped", "capped")
    for none in (False, True):
        a = torch.zeros_like(act) if none else act
        state["act"].copy_(a)
        for k in tt.MASK_STATS:
            monkeypatch.setitem(tt.MASK_STATS, k, 0)
        want = tt.closest_hit(bvh, org, d, 0.0, BIG, alpha_fn=alpha,
                              active=a, sort=True)
        eager = {k: tt.MASK_STATS[k] for k in keys}
        for k in tt.MASK_STATS:
            tt.MASK_STATS[k] = 0
        sg.counts.zero_()
        g.replay()
        values = sg.counts.tolist()
        assert values[0] == 0
        graphs.add_device_counts(values)
        got = {k: tt.MASK_STATS[k] for k in keys}
        if none:       # the graph's first round ran: one round, no lane
            eager["max_rounds"] = 1
        assert got == eager
        assert torch.equal(state["t"], want.t)


@pytest.mark.cuda
@pytest.mark.parametrize("two_level", [False, True])
def test_cuda_retrace_loop_is_logged(cuda_device, two_level, monkeypatch):
    """A captured masked closest hit over 9 stacked masked layers runs
    its re-trace's WHILE loop past its first round; each replay logs the
    loop once, its exit stamp not before its entry's, its rounds the
    eager dispatch's, and its body's traversal launches (body_counts)
    one a round past the first."""
    from imbatracer_torch.render import graphs

    monkeypatch.setattr(tt, "RETRACE_SLOT_DIV" if two_level
                        else "KHIT_SLOT_DIV", 1)
    bvh, alpha = _layer_scene(9, two_level, cuda_device)
    org, d, act = _layer_rays(9, 1024, 0, cuda_device)
    state = dict(t=torch.empty_like(org[:, 0]))

    def step(s, overflow):
        s["t"].copy_(tt.closest_hit(bvh, org, d, 0.0, BIG, alpha_fn=alpha,
                                    active=act, sort=True,
                                    overflow=overflow).t)

    rounds0 = tt.MASK_STATS["max_rounds"]
    tt.MASK_STATS["max_rounds"] = 0
    try:
        tt.closest_hit(bvh, org, d, 0.0, BIG, alpha_fn=alpha, active=act,
                       sort=True)
        want = tt.MASK_STATS["max_rounds"]
    finally:
        tt.MASK_STATS["max_rounds"] = max(rounds0, tt.MASK_STATS["max_rounds"])
    assert want >= 2
    sg = graphs.SceneGraphs(cuda_device)
    g = sg.phase("logged", step, state)
    sg.drain_loops()
    for _ in range(2):
        sg.counts.zero_()
        g.replay()
        records, lost = sg.drain_loops()
        assert lost == 0 and len(records) == 1
        t0, t1, rounds, _ = records[0]
        assert 0 < t0 <= t1 and rounds == want
        assert int(sg.counts[0]) == 0
        walks = {k: n for k, n in graphs.body_counts(records).items()
                 if k[0] in ("khit", "stream_traverse") and n}
        assert sum(walks.values()) == want - 1, walks


@pytest.mark.cuda
def test_cuda_slot_input_checks(cuda_device):
    """The slot wrappers raise on tensors off the card or of another
    type."""
    from imbatracer_torch.ops import dispatch as dp

    act, need, slots, hit, tcur = _slot_case("within", cuda_device)
    count = need.sum(dtype=torch.int32)
    with pytest.raises(ValueError):
        dp.slot_gather_cuda(need.int(), slots, hit, tcur)
    with pytest.raises(ValueError):
        dp.slot_gather_cuda(need[:-1], slots, hit, tcur)
    with pytest.raises(ValueError):
        dp.slot_gather_cuda(need, slots, hit, tcur.cpu())
    with pytest.raises(ValueError):
        dp.slot_gather_cuda(need, -1, hit, tcur)
    s = dp.slot_gather_cuda(need, slots, hit, tcur)
    with pytest.raises(ValueError):
        dp.slot_finish_cuda(count.clone(), act, s, count.clone(),
                            hit=tt.Hit(hit.t, hit.prim_id.long(), hit.u,
                                       hit.v))
    with pytest.raises(ValueError):
        dp.slot_finish_cuda(count.clone(), act, s, count.clone(),
                            hit=tt.Hit(*(x[:-1] for x in hit)))
    with pytest.raises(ValueError):
        dp.slot_finish_cuda(torch.zeros((), dtype=torch.int64,
                                        device=cuda_device), act, s,
                            count.clone(), hit=hit)


def _select_rows(n, num_c, seed, dev, paths=1 << 14, max_len=8):
    """A (num_c, 24) collect buffer whose first n rows hold unique
    (path_id, path_length) pairs in a shuffled order, the rows after them
    noise (the kernels must not read them)."""
    rs = np.random.RandomState(seed)
    rec = rs.randn(num_c, 24).astype(np.float32)
    pairs = rs.permutation(paths * max_len)[:n]
    rec[:n, 21] = (pairs % max_len + 2).astype(np.int32).view(np.float32)
    rec[:n, 22] = (pairs // max_len).astype(np.int32).view(np.float32)
    return torch.from_numpy(rec).to(dev), dict(paths=paths,
                                               lengths=max_len + 2)


def _bit_equal(a, b):
    a, b = a.contiguous(), b.contiguous()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("keys", ["keys32", "keys64"])
@pytest.mark.parametrize("n,cap", [(3000, 5000), (5000, 5000), (7000, 5000),
                                   (0, 5000), (7000, 8000), (6000, 9000)],
                         ids=["fewer", "equal", "cut", "empty", "canonical",
                              "canonical_above"])
def test_cuda_select_kernels_match_plain(cuda_device, n, cap, keys):
    """The selection's keys (both modes) and gather against their plain
    versions on the same CUDA tensors, every element bit-equal; the
    gather's box against the kept rows' min and max; the whole selection
    against the plain route on the CPU."""
    from imbatracer_torch.ops import select as sel

    rec, bounds = _select_rows(n, 8000, n + cap, cuda_device)
    if keys == "keys64":
        bounds = {}
    b1 = sel.key_bits(bounds.get("lengths"), bounds.get("paths"))
    b2 = sel.key_bits(bounds.get("paths"), bounds.get("lengths"))
    assert (b1 is None) == (b2 is None) == (keys == "keys64")
    order1 = None
    kept = n
    if cap < 8000:
        k = sel.select_keys_cuda(rec, n, None, sel.SHALLOW, b1)
        assert _bit_equal(k, sel.select_keys_plain(rec, n, None, sel.SHALLOW,
                                                   b1))
        order1 = torch.sort(k, stable=True)[1][:cap]
        kept = min(n, cap)
    k2 = sel.select_keys_cuda(rec, kept, order1, sel.CANONICAL, b2)
    assert _bit_equal(k2, sel.select_keys_plain(rec, kept, order1,
                                                sel.CANONICAL, b2))
    order2 = torch.sort(k2, stable=True)[1]
    rows = min(cap, 8000)
    out, box, pos4 = sel.select_gather_cuda(rec, order1, order2, rows)
    ref, none, ref_pos4 = sel.select_gather_plain(rec, order1, order2, rows)
    assert none is None and _bit_equal(out, ref)
    assert _bit_equal(pos4, ref_pos4)
    assert not out[kept:].any() and not pos4[kept:].any()
    assert torch.equal(sel.box_floats(box), sel.box_plain(ref, kept))
    got, _, got_pos4 = sel.select_rows(rec, n, cap, **bounds)
    want, _, want_pos4 = sel.select_rows(rec.cpu(), n, cap, **bounds)
    assert _bit_equal(got.cpu(), want) and _bit_equal(got_pos4.cpu(),
                                                      want_pos4)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4097, 7000])
@pytest.mark.parametrize("ordered", [False, True], ids=["first_n", "order"])
@pytest.mark.parametrize("keys", ["keys32", "keys64"])
@pytest.mark.parametrize("mode", ["shallow", "canonical"])
def test_cuda_select_keys_at_both_strides(cuda_device, mode, keys, ordered,
                                          n):
    """select_keys_cuda from the key columns (stride 2, as the collect
    append writes them) and from the packed rows (stride 24) against
    select_keys_plain, bit for bit, over the first n rows (n odd or even)
    and through an order."""
    from imbatracer_torch.ops import select as sel

    rec, bounds = _select_rows(n, 8000, n + len(mode), cuda_device)
    cols = sel.key_pairs(rec).contiguous()
    assert cols.stride() == (2, 1) and sel.key_pairs(rec).stride(0) == 24
    m = sel.SHALLOW if mode == "shallow" else sel.CANONICAL
    bits = None
    if keys == "keys32":
        major, minor = (bounds["lengths"], bounds["paths"])
        bits = sel.key_bits(*((major, minor) if m == sel.SHALLOW
                              else (minor, major)))
        assert bits is not None
    order = None
    if ordered:
        g = torch.Generator(device=cuda_device).manual_seed(n)
        order = torch.randperm(n, generator=g, device=cuda_device)
    want = sel.select_keys_plain(rec, n, order, m, bits)
    for src in (cols, rec):
        got = sel.select_keys_cuda(src, n, order, m, bits)
        assert _bit_equal(got, want)
    assert _bit_equal(sel.select_keys_plain(cols, n, order, m, bits), want)


def _grid_case(case, dev):
    """(working cache (with the card's box), radius): P rows, `count` of
    them valid, from the selection's kernels."""
    from imbatracer_torch.render import light_cache

    n, cap, spread, radius = {"partial": (3000, 5000, 4.0, 0.02),
                              "full": (7000, 5000, 4.0, 0.02),
                              "empty": (0, 5000, 4.0, 0.02),
                              "tight": (4000, 4099, 0.01, 0.3),
                              "fine": (4000, 4096, 40.0, 1e-4)}[case]
    rec, bounds = _select_rows(n, 8000, 11, dev)
    rec[:, 0:3] *= spread
    cache = light_cache.select_shallowest(
        light_cache.LightVertexCache(rec, torch.tensor(
            n, dtype=torch.int32, device=dev)), cap, count=n, **bounds)
    return cache, torch.tensor(radius, dtype=torch.float32, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["partial", "full", "empty", "tight",
                                  "fine"])
def test_cuda_grid_kernels_match_plain(cuda_device, case):
    """The grid's keys and tiles kernels against their plain versions on
    the same CUDA tensors, every element bit-equal (keys, bbox_min,
    inv_cell, tiles, padded keys), and photon_grid against
    build_merge_grid on the card."""
    from imbatracer_torch.ops import merge as mg

    cache, radius = _grid_case(case, cuda_device)
    rec, count = cache.rec, cache.count
    valid = torch.arange(rec.shape[0], device=cuda_device) < count
    key, bmin, inv, r2 = mg.grid_keys_cuda(cache.pos4, count, cache.box,
                                           radius)
    pkey, pbmin, pinv = mg.grid_keys_plain(cache.pos4[:, 0:3], valid, radius)
    assert _bit_equal(key, pkey) and _bit_equal(bmin, pbmin)
    assert _bit_equal(inv, pinv) and _bit_equal(r2, radius * radius)
    ks, order = torch.sort(key, stable=True)
    tiles, keys = mg.grid_tiles_cuda(rec, count, ks, order)
    ptiles, pkeys = mg.grid_tiles_plain(ks, order, cache.pos, valid,
                                        cache.w_out, cache.throughput,
                                        cache.d_vcm, cache.d_vm)
    assert _bit_equal(tiles, ptiles) and _bit_equal(keys, pkeys)
    got = mg.photon_grid(rec, count, radius, cache.box, cache.pos4)
    want = mg.build_merge_grid(cache.pos, valid, radius, cache.w_out,
                               cache.throughput, cache.d_vcm, cache.d_vm)
    for name in ("tiles", "keys", "bbox_min", "inv_cell", "radius_sqr"):
        assert _bit_equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.cuda
def test_cuda_middle_follows_the_light_pass(cuda_device):
    """A light pass on the card, then the frame's middle through the
    kernels (select_shallowest with the frame's count and bounds,
    photon_grid) against the plain versions on the same collect buffer:
    the working cache's rows and count and every grid field bit-equal,
    each kernel launched."""
    from imbatracer_torch.ops import merge as mg
    from imbatracer_torch.ops import select as sel
    from imbatracer_torch.render import light_cache
    from imbatracer_torch.render.integrators import pt, vcm
    from imbatracer_torch.scene.procedural import make_still_life_like

    scene, meta = make_still_life_like(num_objects=40, num_cards=16,
                                       device=cuda_device)
    cam, fi = _vcm_inputs(scene, meta, cuda_device)
    collect = light_cache.empty_collect(VCM_LPC * VCM_MAX_LEN, cuda_device)
    vcm._light_pass(scene, cam, fi.frame, fi.mis_eta_vc, fi.mis_eta_vm,
                    collect, algo="vcm", num_pixels=VCM_SIZE ** 2,
                    light_path_count=VCM_LPC, max_len=VCM_MAX_LEN,
                    alpha_fn=pt.alpha_fn_for(scene), has_bump=meta.has_bump)
    count = collect.check()
    cap = vcm.auto_cache_capacity(VCM_LPC, VCM_MAX_LEN)
    sel.reset_launches()
    mg.reset_launches()
    cache = light_cache.select_shallowest(
        collect.cache(), cap, count=count,
        **vcm.key_bounds(VCM_LPC, VCM_MAX_LEN))
    grid = vcm.photon_grid(cache, fi.pm_radius)
    assert sel.LAUNCHES["select_keys"] == 2 and sel.LAUNCHES[
        "select_gather"] == 1
    assert mg.LAUNCHES["grid_keys"] == mg.LAUNCHES["grid_tiles"] == 1
    assert not any(sel.LAUNCHES[k] for k in sel.PLAIN_KEYS)
    plain = light_cache.select_shallowest(
        light_cache.LightVertexCache(collect.rec[:-1].cpu(),
                                     collect.count.cpu()), cap)
    assert int(cache.count) == int(plain.count) == min(count, cap) > 0
    assert _bit_equal(cache.packed().cpu(), plain.packed())
    valid = torch.arange(cap, device=cuda_device) < cache.count
    want = mg.build_merge_grid(cache.pos, valid, fi.pm_radius, cache.w_out,
                               cache.throughput, cache.d_vcm, cache.d_vm)
    for name in ("tiles", "keys", "bbox_min", "inv_cell", "radius_sqr"):
        assert _bit_equal(getattr(grid, name), getattr(want, name)), name


@pytest.mark.cuda
def test_cuda_middle_input_checks(cuda_device):
    """The wrappers raise on tensors off the card, of another type or
    shape, and the card's grid without the selection's box."""
    from imbatracer_torch.ops import merge as mg
    from imbatracer_torch.ops import select as sel

    rec, _ = _select_rows(100, 200, 1, cuda_device)
    order = torch.arange(50, device=cuda_device)
    count = torch.tensor(100, dtype=torch.int32, device=cuda_device)
    radius = torch.tensor(0.1, device=cuda_device)
    with pytest.raises(ValueError):
        sel.select_keys_cuda(rec.cpu(), 100, None, sel.SHALLOW, None)
    with pytest.raises(ValueError):
        sel.select_keys_cuda(rec[:, :20].contiguous(), 100, None,
                             sel.SHALLOW, None)
    with pytest.raises(ValueError):
        sel.select_keys_cuda(rec, 100, order, sel.CANONICAL, None)
    with pytest.raises(ValueError):
        sel.select_gather_cuda(rec, None, order.int(), 100)
    with pytest.raises(ValueError):
        sel.select_gather_cuda(rec, None, order, 10)
    pos4 = torch.zeros((200, 4), device=cuda_device)
    box = torch.zeros(6, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        mg.photon_grid(rec, count, radius, None, pos4)
    with pytest.raises(ValueError):
        mg.photon_grid(rec, count, radius, box, None)
    with pytest.raises(ValueError):
        mg.grid_keys_cuda(rec, count, box, radius)
    with pytest.raises(ValueError):
        mg.grid_keys_cuda(pos4.view(-1)[1:797].view(199, 4), count, box,
                          radius)
    with pytest.raises(TypeError):
        mg.grid_keys_cuda(pos4, count.long(), box, radius)


@pytest.mark.cuda
@pytest.mark.parametrize("n,cap", [(0, 4099), (5000, 4099), (3001, 4099),
                                   (1, 1), (300, 257)],
                         ids=["kept_0", "kept_rows", "ragged", "one_row",
                              "ragged_small"])
def test_cuda_gather_column_feeds_the_keys(cuda_device, n, cap):
    """The gather's position column and the grid's keys read from it,
    against their plain versions bit for bit, at row counts that are not
    a multiple of the blocks (the gather's 256 words, the keys' 256
    photons), with no kept row and every row kept: the column is the
    rows' pos and a zero, zero past the kept rows, and the keys, bbox_min,
    inv_cell and radius_sqr equal grid_keys_plain's fed from it and from
    the rows."""
    from imbatracer_torch.ops import merge as mg
    from imbatracer_torch.ops import select as sel

    rec, bounds = _select_rows(n, 8000, 3 * n + cap, cuda_device)
    rec[:, 0:3] *= 3.0
    b = sel.key_bits(bounds["paths"], bounds["lengths"])
    b1 = sel.key_bits(bounds["lengths"], bounds["paths"])
    k1 = sel.select_keys_cuda(rec, n, None, sel.SHALLOW, b1)
    order1 = torch.sort(k1, stable=True)[1][:cap]
    kept = min(n, cap)
    k2 = sel.select_keys_cuda(rec, kept, order1, sel.CANONICAL, b)
    order2 = torch.sort(k2, stable=True)[1]
    out, box, pos4 = sel.select_gather_cuda(rec, order1, order2, cap)
    ref, _, ref_pos4 = sel.select_gather_plain(rec, order1, order2, cap)
    assert pos4.shape == (cap, 4) and _bit_equal(pos4, ref_pos4)
    assert _bit_equal(pos4[:, 0:3], out[:, 0:3]) and not pos4[:, 3].any()
    assert not pos4[kept:].any()
    count = torch.tensor(kept, dtype=torch.int32, device=cuda_device)
    valid = torch.arange(cap, device=cuda_device) < count
    radius = torch.tensor(0.02, device=cuda_device)
    got = mg.grid_keys_cuda(pos4, count, box, radius)
    for pos in (ref_pos4[:, 0:3], ref[:, 0:3]):
        want = mg.grid_keys_plain(pos, valid, radius)
        for g, w in zip(got, want + (radius * radius,)):
            assert _bit_equal(g, w)


def _light_band(scene, kind, lanes, lpc):
    """The first path of a band of `lanes` paths of one light kind
    ("area", "env"), or of one straddling the last two lights ("mixed"):
    the light pick splits path ids uniformly over the lights."""
    from imbatracer_torch.render import lights as tl

    kinds = scene.lights.kind.tolist()
    num = len(kinds)
    if kind == "mixed":
        return -(-(num - 1) * lpc // num) - lanes // 2
    j = kinds.index(tl.LIGHT_ENV if kind == "env" else tl.LIGHT_TRI)
    first, last = -(-j * lpc // num), -(-(j + 1) * lpc // num)
    assert last - first >= lanes
    return first


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 127, 129, 3001, 70001])
@pytest.mark.parametrize("band", ["area", "env", "mixed", "empty"])
def test_cuda_light_start_on_seeded_bands(cuda_device, band, lanes):
    """vcm_light_start_kernel against light_start_plain at phase 4b's
    gates on bands of the still life's area light alone, its environment
    alone, one straddling two lights, and an empty one (every lane past
    the band's end), at lane counts that are not a multiple of the block
    or of the lanes a thread; the path start and end as pointers, as the
    graphed light band passes them."""
    from imbatracer_torch.ops import vcm_shade as vs
    from torch_shade_cases import port_scene

    scene, meta = port_scene("still_life", cuda_device)
    cam, fi = _vcm_inputs(scene, meta, cuda_device)
    lpc = 1 << 20
    first = _light_band(scene, "area" if band == "empty" else band, lanes,
                        lpc)
    start = torch.tensor(first, dtype=torch.int32, device=cuda_device)
    end = start + (0 if band == "empty" else lanes)
    kw = dict(lanes=lanes, light_path_count=lpc, path_start=start,
              path_end=end)
    vs.reset_launches()
    k = vs.light_start_cuda(scene, fi.frame, fi.mis_eta_vc, **kw)
    p = vs.light_start_plain(scene, fi.frame, fi.mis_eta_vc, **kw)
    _hold_vcm_columns(k, p)
    assert vs.LAUNCHES["light_start"] == 1
    assert bool(k["active"].any()) == (band != "empty")
    if band == "mixed" and lanes > 1:
        assert len(set(k["finite"].tolist())) == 2
