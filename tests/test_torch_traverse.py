"""Traversal of the port (imbatracer_torch.ops.stream_traverse, plain
PyTorch version on the CPU) against the JAX reference kernels run in
interpret mode -- the streaming kernel (pallas_stream) on a multi-super-
chunk scene and the VMEM kernel (pallas_vmem) on the cornell -- and
against a brute-force intersector.

Tolerances: hit ids equal except where the two hits have bit-equal t
(ties, resolved differently by design); t within 1e-5 relative or 1e-6
absolute (a t near 0 keeps the absolute rounding of its numerator); u, v
within 1e-4 absolute (barycentric numerators cancel, and XLA may contract
the feature-dot sums into FMAs where the port rounds every product);
occlusion flags equal.  The CUDA kernel itself is held against the plain
version by tests/test_torch_kernel_cuda.py and chip_smoke.py on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imbatracer_tpu.ops import pallas_stream as ps
from imbatracer_tpu.scene import procedural as jproc
from imbatracer_torch.convert import scene_from_numpy, scene_to_numpy
from imbatracer_torch.ops import stream_traverse as st
from imbatracer_torch.render import traverse as tt
from imbatracer_torch.render.intersect import BIG, brute_force_closest_hit
from torch_threads import cap_torch_threads

cap_torch_threads()


def _interp(fn):
    """Run fn with pallas_call in interpret mode (the CPU reference)."""
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def interp(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)

    pl.pallas_call = interp
    ps.pl.pallas_call = interp
    try:
        return fn()
    finally:
        pl.pallas_call = orig
        ps.pl.pallas_call = orig


def _rays(n, seed, lo, hi):
    rs = np.random.RandomState(seed)
    org = rs.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    act = rs.rand(n) < 0.8
    tmax = rs.uniform(0.5, 12.0, n).astype(np.float32)
    return org, d, act, tmax


def _assert_hits(t_hit, j_t, j_id, j_u, j_v):
    pid, t = t_hit.prim_id.numpy(), t_hit.t.numpy()
    j_t, j_id = np.asarray(j_t), np.asarray(j_id)
    tie = (pid != j_id) & (pid >= 0) & (j_id >= 0) & (t == j_t)
    assert ((pid == j_id) | tie).all()
    m = (pid >= 0) & (pid == j_id)
    assert m.sum() > 100
    np.testing.assert_allclose(t[m], j_t[m], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t_hit.u.numpy()[m], np.asarray(j_u)[m],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(t_hit.v.numpy()[m], np.asarray(j_v)[m],
                               rtol=0, atol=1e-4)
    assert (t[pid < 0] == BIG).all()


@pytest.fixture(scope="module")
def big():
    js, _ = jproc.make_big_scene(num_boxes=110, seed=9)   # ~1.3k tris
    ts = scene_from_numpy(scene_to_numpy(js), "cpu")
    assert ts.bvh.sbox.shape[0] > 1, "fixture must span super-chunks"
    return ts


def test_plain_matches_stream_kernel(big):
    org, d, act, tmax = _rays(1024, 1, (-30, 1, -30), (30, 10, 30))
    sbox, tiles, center = (jnp.asarray(x.numpy()) for x in
                           (big.bvh.sbox, big.bvh.tiles, big.bvh.center))
    jo = jnp.asarray(org) - center
    jh = _interp(lambda: ps.closest_hit_stream(
        sbox, tiles, jo, jnp.asarray(d), 0.0, ps.BIG,
        active=jnp.asarray(act)))
    th = tt.closest_hit(big.bvh, torch.from_numpy(org), torch.from_numpy(d),
                        0.0, BIG, active=torch.from_numpy(act))
    _assert_hits(th, jh.t, jh.prim_id, jh.u, jh.v)
    assert (th.prim_id.numpy()[~act] == -1).all()

    jocc = _interp(lambda: ps.any_hit_stream(
        sbox, tiles, jo, jnp.asarray(d), 0.0, jnp.asarray(tmax),
        active=jnp.asarray(act)))
    tocc = tt.any_hit(big.bvh, torch.from_numpy(org), torch.from_numpy(d),
                      0.0, torch.from_numpy(tmax),
                      active=torch.from_numpy(act))
    np.testing.assert_array_equal(tocc.numpy(), np.asarray(jocc))
    assert 0.0 < float(tocc.float().mean()) < 1.0


def test_plain_matches_vmem_kernel(monkeypatch):
    from imbatracer_tpu.ops import pallas_vmem as pv
    from imbatracer_tpu.render import traverse as jt

    monkeypatch.setenv("IMBA_BVH_MODE", "vmem")
    monkeypatch.setattr(pv, "INTERPRET", True)
    js, _ = jproc.make_cornell_scene()
    assert js.bvh.mode == "vmem"
    ts = scene_from_numpy(scene_to_numpy(js), "cpu")
    org, d, act, tmax = _rays(1024, 3, -0.8, 0.8)
    org[:, 1] += 1.0
    jh = jt.closest_hit(js.bvh, jnp.asarray(org), jnp.asarray(d), 0.0,
                        BIG, active=jnp.asarray(act))
    th = tt.closest_hit(ts.bvh, torch.from_numpy(org), torch.from_numpy(d),
                        0.0, BIG, active=torch.from_numpy(act))
    _assert_hits(th, jh.t, jh.prim_id, jh.u, jh.v)
    short = np.minimum(tmax, 0.7).astype(np.float32)
    jocc = jt.any_hit(js.bvh, jnp.asarray(org), jnp.asarray(d), 0.0,
                      jnp.asarray(short), active=jnp.asarray(act))
    tocc = tt.any_hit(ts.bvh, torch.from_numpy(org), torch.from_numpy(d),
                      0.0, torch.from_numpy(short),
                      active=torch.from_numpy(act))
    np.testing.assert_array_equal(tocc.numpy(), np.asarray(jocc))


def test_plain_matches_brute_force(big):
    org, d, _, _ = _rays(2048, 4, (-30, 1, -30), (30, 10, 30))
    bvh = big.bvh
    th = tt.closest_hit(bvh, torch.from_numpy(org), torch.from_numpy(d),
                        0.0, BIG)
    bt, bid, bu, bv = brute_force_closest_hit(
        torch.from_numpy(org), torch.from_numpy(d), bvh.tri_v0, bvh.tri_e1,
        bvh.tri_e2)
    # Brute force returns packed slots; map them to flat triangle ids.
    bid = torch.where(bid >= 0, bvh.tri_id[bid.clamp(min=0).long()], -1)
    _assert_hits(th, bt.numpy(), bid.numpy(), bu.numpy(), bv.numpy())


def test_sorted_dispatch_is_exact(big):
    org, d, act, tmax = _rays(1500, 5, (-30, 1, -30), (30, 10, 30))
    args = (big.bvh, torch.from_numpy(org), torch.from_numpy(d), 1e-3)
    kw = dict(active=torch.from_numpy(act))
    h0 = tt.closest_hit(*args, BIG, sort=False, **kw)
    h1 = tt.closest_hit(*args, BIG, sort=True, **kw)
    for a, b in zip(h0, h1):
        assert torch.equal(a, b)
    o0 = tt.any_hit(*args, torch.from_numpy(tmax), sort=False, **kw)
    o1 = tt.any_hit(*args, torch.from_numpy(tmax), sort=True, **kw)
    assert torch.equal(o0, o1)


@pytest.fixture(scope="module")
def instanced(tmp_path_factory):
    """The generated instanced scene's two-level BVH: world-space
    super-chunk boxes of overlapping instances, origins not recentred."""
    from imbatracer_torch.scene.build import build_scene
    from imbatracer_torch.scene.generate import write_instanced_scene

    path = write_instanced_scene(str(tmp_path_factory.mktemp("cand")))
    scene, _ = build_scene(path, quiet=True, device="cpu")
    assert scene.bvh.two_level and scene.bvh.sbox.shape[0] > 1
    return scene


@pytest.mark.parametrize("case", ["flat", "instanced", "inactive_block"])
def test_candidates_and_sort_keys_match_jax(big, instanced, case):
    """superchunk_candidates (the plain version of the CUDA kernels'
    candidate stage) against the JAX package's lists: on a flat BVH, on
    the world boxes of a two-level BVH, and with a whole ray block
    inactive (tmax = -1 on every lane, which still lists the boxes that
    contain a lane's origin, as JAX does)."""
    if case == "instanced":
        scene = instanced
        org, d, act, tmax = _rays(1024, 6, (-8, 0, -8), (8, 4, 8))
    else:
        scene = big
        org, d, act, tmax = _rays(1024, 6, (-30, 1, -30), (30, 10, 30))
    if case == "inactive_block":
        act[:ps.BLK] = False
    org = org - scene.bvh.center.numpy()
    rays, _ = st.rays8(torch.from_numpy(org), torch.from_numpy(d), 0.0,
                       torch.from_numpy(tmax), torch.from_numpy(act))
    jr, _ = ps._rays8t(jnp.asarray(org), jnp.asarray(d), 0.0,
                       jnp.asarray(tmax), jnp.asarray(act))
    np.testing.assert_array_equal(rays.numpy(), np.asarray(jr).T)
    sbox = scene.bvh.sbox
    before = st.LAUNCHES["candidates_plain"]
    slist, skey, scount = st.superchunk_candidates(rays, sbox, blk=ps.BLK)
    assert st.LAUNCHES["candidates_plain"] == before + 1
    assert int(scount.sum()) > 0
    if case == "inactive_block":
        assert bool((rays[:ps.BLK, 7] < 0.0).all())
    jl, jk, jc = ps.superchunk_candidates(jr, jnp.asarray(sbox.numpy()))
    np.testing.assert_array_equal(scount.numpy(), np.asarray(jc)[:, 0, 0])
    np.testing.assert_array_equal(skey.numpy(), np.asarray(jk)[:, 0])
    for b, n in enumerate(scount.numpy()):
        np.testing.assert_array_equal(slist.numpy()[b, :n],
                                      np.asarray(jl)[b, 0, :n])
    lo, hi = st.scene_bounds(sbox)
    key = st.sort_keys(torch.from_numpy(org), torch.from_numpy(d),
                       torch.from_numpy(act), lo, hi)
    jlo, jhi = ps._scene_bounds(jnp.asarray(sbox.numpy()))
    jkey = ps.sort_keys(jnp.asarray(org), jnp.asarray(d), jnp.asarray(act),
                        jlo, jhi)
    np.testing.assert_array_equal(key.numpy(), np.asarray(jkey))
    # On the CPU the stage's dispatch is the plain version, and the
    # comparison the CUDA tests and chip_smoke.py hold the card's stage
    # with counts each kind of difference.
    before = st.LAUNCHES["candidates_plain"]
    sl, sk, sc = st.block_candidates(rays, sbox)
    assert st.LAUNCHES["candidates_plain"] == before + 1
    assert st.candidate_mismatches((sl, sk, sc), (sl, sk, sc)) == (0, 0, 0)
    b = int(sc.argmax())
    worse = sk.clone()
    worse[b, 0] = -0.0 if worse[b, 0] == 0.0 else worse[b, 0] * 2.0
    swapped = sl.clone()
    swapped[b, 0] = -1
    fewer = sc.clone()
    fewer[b] -= 1
    assert st.candidate_mismatches((sl, worse, sc), (sl, sk, sc)) == (
        (0, 0, 0) if float(sk[b, 0]) == 0.0 else (0, 0, 1))
    assert st.candidate_mismatches((swapped, sk, sc),
                                   (sl, sk, sc)) == (0, 1, 0)
    assert st.candidate_mismatches((sl, sk, fewer), (sl, sk, sc)) == (1, 0, 0)


@pytest.mark.parametrize("wrapper", ["stream", "khit", "candidates"])
def test_candidate_capacity_check_raises_with_the_cap(wrapper):
    """Above the MAX_SUPER super-chunks a block's list holds in shared
    memory, the lists go through a global buffer of list_scratch_bytes, so
    the CUDA wrappers no longer raise for a large S: check_capacity
    accepts S = 20,000, and raises for a BVH with no super-chunk and for a
    global buffer larger than the card's memory, with the byte count in
    its message.  Checked with CPU tensors: the capacity check comes before
    the device check."""
    from imbatracer_torch.ops import khit as kh

    rays = torch.zeros((st.BLK, 8))
    sbox = torch.zeros((0, 8))
    tiles = torch.zeros((0, st.TILE_ROWS, st.TRI_ROWS))
    call = {"stream": lambda: st.traverse_cuda(rays, sbox, tiles, False),
            "khit": lambda: kh.khit_cuda(rays, sbox, tiles),
            "candidates": lambda: st.candidates_cuda(rays, sbox)}[wrapper]
    with pytest.raises(ValueError, match="no super-chunk"):
        call()
    st.check_capacity(20000)
    st.check_capacity(st.MAX_SUPER)
    with pytest.raises(ValueError, match="no super-chunk"):
        st.check_capacity(0)
    need = st.list_scratch_bytes(1 << 18, 20000)
    assert need == 2048 * 32768 * 8
    assert st.list_scratch_bytes(1 << 18, st.MAX_SUPER) == 0
    st.check_capacity(20000, 1 << 18, limit=need)
    with pytest.raises(ValueError, match="536,870,912 bytes"):
        st.check_capacity(20000, 1 << 18, limit=need - 1)
    assert st.block_smem_bytes(st.MAX_SUPER) <= 232448
    assert st.block_smem_bytes(st.MAX_SUPER + 1) == \
        st.block_smem_bytes(1) - 16
    assert st.block_smem_bytes(140) == 8 * 256 + st.block_smem_bytes(1) - 16
    assert st.block_smem_bytes(1) == st.block_smem_bytes(2)


def test_unported_routes_raise(big):
    """Masked traversal needs the scene's mask record: the JAX package's
    chained alpha lookup without it (IMBA_MASK_REC=0) is not ported."""
    from imbatracer_torch.render.integrators.pt import alpha_fn_for

    assert big.attrs.mask_rec is None
    with pytest.raises(NotImplementedError):
        alpha_fn_for(big)


def test_work_slots_match_kernel_header():
    """The counting launch's slots (stream_traverse.WORK_SLOTS) are those
    of csrc/traverse_common.cuh: slab tests, then one per Moller-Trumbore
    stage, in the header's enum order, then the candidate stage's slab
    tests and the chunk re-tests; chip_smoke.py costs each stage."""
    import os
    import re

    import chip_smoke
    from imbatracer_torch.libbuild import CSRC

    with open(os.path.join(CSRC, "traverse_common.cuh")) as fh:
        src = fh.read()
    stages = re.search(r"enum MtStage \{([^}]*)\}", src).group(1)
    stages = [s.strip() for s in stages.split(",")]
    assert stages[-1] == "kStages"
    num_mt = len(stages) - 1
    assert len(st.WORK_SLOTS) == 1 + num_mt + 2
    assert [s[3:] for s in st.WORK_SLOTS[1:1 + num_mt]] == [
        s[1:].lower() for s in stages[:-1]]
    assert "kCandSlot = 1 + kStages;" in src
    assert "kRetestSlot = kCandSlot + 1;" in src
    assert "kWorkSlots = kRetestSlot + 1;" in src
    assert st.WORK_SLOTS[1 + num_mt:] == ("cand_slab", "retest")
    assert len(chip_smoke.MT_STAGE_OPS) == num_mt
    # The wrapper's cap and shared-memory sizes mirror the header's.
    assert f"kMaxSuper = {st.MAX_SUPER};" in src
    assert f"kBlk = {st.BLK};" in src
