"""Mid-frame lane compaction of the port (render/integrators/pt.py: the
compacted PT frame and `_compact_carry`; vcm.py: the compacted camera
pass) against the banded route and against the JAX package's compacted
frames, on the CPU.

* `_compact_carry` against JAX's `pt._compact_carry` on one numpy-seeded
  carry: sorted columns, lane ids and live count exactly equal.
* Compacted against banded, in the port (BAND_RAYS patched to a few
  hundred lanes so that a frame has several bands): the cornell at 48²
  spp 1 and 24² spp 3 (max_len 5, depth 2), at 32² with max_len 4 and
  depth 3 (phase 2 nearly empty), and the masked scene.  Films within
  rtol 2e-4, atol 2e-5 (tests/test_compact.py's tolerance: the CPU's
  vectorised math may round a lane by its place in a tensor), traced
  rays equal.  The camera pass of vcm, bpt, ppm and vcm_pt likewise
  (cornell 32², max_len 4, depth 2, 256 light paths).
* Compacted port against compacted JAX (IMBA_PT_COMPACT=1 /
  IMBA_VCM_COMPACT=1 with its depth variable and BAND_RAYS patched, as
  tests/test_compact.py reaches that route), to the cross-framework
  tolerances of tests/test_torch_pt.py (PT: mean within 1e-3 relative,
  >= 98% of pixels within 1e-4 relative of max(|x|, 1e-3), rays within
  1%) and tests/test_torch_vcm.py (the family: >= 95% of pixels).
* The default rule: compaction on for a CUDA device with more than one
  band and max_len >= 2, off on the CPU and for one band; the engine's
  frame functions reach the integrators' rule with the scene's device.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imbatracer_tpu.ops import pallas_merge
from imbatracer_tpu.render.camera import make_camera as jcamera
from imbatracer_tpu.render.integrators import pt as jpt
from imbatracer_tpu.render.integrators import vcm as jvcm
from imbatracer_tpu.scene import procedural as jproc
from imbatracer_torch.convert import scene_from_numpy, scene_to_numpy
from imbatracer_torch.frontend.engine import make_frame_fn
from imbatracer_torch.frontend.renderer import RenderSettings
from imbatracer_torch.render.camera import make_camera as tcamera
from imbatracer_torch.render.integrators import pt as tpt
from imbatracer_torch.render.integrators import vcm as tvcm
from torch_threads import cap_torch_threads

cap_torch_threads()

RADIUS, LPC = 0.06, 256
# (scene, size, spp, band lanes, max_len, depth, frame)
PT_CASES = {
    "cornell_48_spp1": ("cornell", 48, 1, 512, 5, 2, 0),
    "cornell_24_spp3": ("cornell", 24, 3, 640, 5, 2, 0),
    "deep_checkpoint": ("cornell", 32, 1, 512, 4, 3, 0),
    "masked": ("masked", 32, 1, 256, 4, 2, 3),
}


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name, build in (("cornell", jproc.make_cornell_scene),
                        ("masked", jproc.make_masked_scene)):
        js, meta = build()
        out[name] = (js, scene_from_numpy(scene_to_numpy(js), "cpu"), meta)
    return out


def _cams(meta, size):
    args = (meta.cam_pos, meta.cam_dir, meta.cam_up, size, size, 60.0)
    return jcamera(*args), tcamera(*args, device="cpu")


def _port_pt(ts, meta, cam, case, monkeypatch, compact):
    _, size, spp, lanes, max_len, depth, frame = case
    monkeypatch.setattr(tpt, "BAND_RAYS", lanes)
    monkeypatch.setattr(tpt, "COMPACT_DEPTH", depth)
    stats = {}
    film, n = tpt.render_pt_frame(ts, cam, frame, size, size, spp=spp,
                                  max_len=max_len, has_masks=meta.has_masks,
                                  with_stats=True, compact=compact,
                                  stats=stats)
    return film.numpy(), int(n), stats


@pytest.mark.parametrize("live", [0.0, 0.3, 1.0])
def test_compact_carry_matches_jax(live):
    rs = np.random.RandomState(int(10 * live) + 5)
    n = 1000
    cols = dict(
        org=rs.randn(n, 3).astype(np.float32),
        d=rs.randn(n, 3).astype(np.float32),
        tmin=rs.rand(n).astype(np.float32),
        throughput=rs.rand(n, 3).astype(np.float32),
        radiance=rs.rand(n, 3).astype(np.float32),
        active=rs.rand(n) < live,
        depth=rs.randint(0, 5, n).astype(np.int32),
        last_pdf=rs.rand(n).astype(np.float32),
        last_specular=rs.rand(n) < 0.5,
        state=rs.randint(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32),
    )
    ids = rs.permutation(n).astype(np.int32)
    jc = {k: jnp.asarray(v) for k, v in cols.items()}
    tc = {k: torch.from_numpy(v.astype(np.int64) if k == "state" else v)
          for k, v in cols.items()}
    js, jids, jalive = jpt._compact_carry(jc, jnp.asarray(ids))
    ts, tids, talive = tpt._compact_carry(tc, torch.from_numpy(ids))
    assert talive.dim() == 0 and int(talive) == int(jalive)
    assert int(talive) == int(cols["active"].sum())
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    for k in cols:
        np.testing.assert_array_equal(
            ts[k].numpy(), np.asarray(js[k]).astype(ts[k].numpy().dtype),
            err_msg=k)


@pytest.mark.parametrize("case", list(PT_CASES))
def test_pt_compact_matches_banded(scenes, case, monkeypatch):
    c = PT_CASES[case]
    _, ts, meta = scenes[c[0]]
    _, cam = _cams(meta, c[1])
    a, na, sa = _port_pt(ts, meta, cam, c, monkeypatch, False)
    b, nb, sb = _port_pt(ts, meta, cam, c, monkeypatch, True)
    assert np.isfinite(b).all() and b.mean() > 0.0
    np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)
    assert na == nb
    # Several phase-1 bands, fewer phase-2 bands, fewer band-bounces.
    bands = -(-c[1] * c[1] * c[2] // c[3])
    assert bands > 1 and sa["band_bounces"] == bands * c[4]
    assert 0 < sb["alive"] < sb["lanes"] == c[1] * c[1] * c[2]
    assert sb["phase2_bands"] == -(-sb["alive"] // c[3]) < bands
    assert sb["band_bounces"] < sa["band_bounces"]


@pytest.mark.parametrize("case", ["cornell_48_spp1", "masked"])
def test_pt_compact_matches_jax(scenes, case, monkeypatch):
    c = PT_CASES[case]
    js, ts, meta = scenes[c[0]]
    jcam, cam = _cams(meta, c[1])
    _, size, spp, lanes, max_len, depth, frame = c
    monkeypatch.setenv("IMBA_PT_COMPACT", "1")
    monkeypatch.setenv("IMBA_PT_COMPACT_DEPTH", str(depth))
    monkeypatch.setattr(jpt, "BAND_RAYS", lanes)
    jf, jn = jpt.render_pt_frame(js, jcam, jnp.uint32(frame), size, size,
                                 spp=spp, max_len=max_len,
                                 has_masks=meta.has_masks, with_stats=True)
    tf, tn, _ = _port_pt(ts, meta, cam, c, monkeypatch, True)
    jf = np.asarray(jf)
    assert tf.shape == jf.shape and np.isfinite(tf).all()
    assert jf.mean() > 0.0
    assert abs(tf.mean() - jf.mean()) / jf.mean() <= 1e-3
    rel = np.abs(tf - jf) / np.maximum(np.abs(jf), 1e-3)
    assert (rel.max(axis=-1) <= 1e-4).mean() >= 0.98
    assert abs(tn - int(jn)) <= 1e-2 * int(jn)


VCM_W, VCM_MAX_LEN, VCM_BAND, VCM_DEPTH = 32, 4, 512, 2


def _port_vcm(ts, meta, algo, compact, monkeypatch):
    monkeypatch.setattr(tvcm, "VCM_COMPACT_DEPTH", VCM_DEPTH)
    _, cam = _cams(meta, VCM_W)
    route = {}
    film = tvcm.render_vcm_frame(
        ts, cam, 0, RADIUS, algo=algo, width=VCM_W, height=VCM_W,
        max_len=VCM_MAX_LEN, light_path_count=LPC, camera_band=VCM_BAND,
        mat_kinds=tuple(sorted(set(ts.materials.kind.tolist()))),
        compact=compact, stats={"route": route})
    return film.numpy(), route


@pytest.mark.parametrize("algo", ["vcm", "bpt", "ppm", "pt"])
def test_vcm_camera_compact_matches_banded(scenes, algo, monkeypatch):
    _, ts, meta = scenes["cornell"]
    a, sa = _port_vcm(ts, meta, algo, False, monkeypatch)
    b, sb = _port_vcm(ts, meta, algo, True, monkeypatch)
    assert np.isfinite(b).all() and b.mean() > 0.0
    np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)
    assert int(sa["camera_rays"]) == int(sb["camera_rays"])
    assert sa["band_bounces"] == 2 * VCM_MAX_LEN
    assert sb["lanes"] == VCM_W * VCM_W and sb["alive"] < sb["lanes"]
    assert sb["band_bounces"] == 2 * VCM_DEPTH + sb["phase2_bands"] * (
        VCM_MAX_LEN - VCM_DEPTH) < sa["band_bounces"]


@pytest.mark.parametrize("algo", ["vcm", "bpt", "ppm", "pt"])
def test_vcm_camera_compact_matches_jax(scenes, algo, monkeypatch):
    js, ts, meta = scenes["cornell"]
    jcam, _ = _cams(meta, VCM_W)
    monkeypatch.setenv("IMBA_VCM_COMPACT", "1")
    monkeypatch.setenv("IMBA_VCM_COMPACT_DEPTH", str(VCM_DEPTH))
    monkeypatch.setattr(jvcm, "BAND_RAYS", VCM_BAND)
    monkeypatch.setattr(pallas_merge, "INTERPRET", True)
    jf = np.asarray(jvcm.render_vcm_frame(
        js, jcam, jnp.uint32(0), jnp.float32(RADIUS), algo=algo,
        width=VCM_W, height=VCM_W, max_len=VCM_MAX_LEN,
        light_path_count=LPC, merge_kernel=True,
        mat_kinds=tuple(sorted(set(ts.materials.kind.tolist())))))
    tf, _ = _port_vcm(ts, meta, algo, True, monkeypatch)
    assert tf.shape == jf.shape and np.isfinite(tf).all()
    assert jf.mean() > 0.0
    assert abs(tf.mean() - jf.mean()) / jf.mean() <= 1e-3
    rel = np.abs(tf - jf) / np.maximum(np.abs(jf), 1e-3)
    assert (rel.max(axis=-1) <= 1e-4).mean() >= 0.95


@pytest.mark.parametrize("rule", [tpt.use_compact, tvcm.use_vcm_compact])
@pytest.mark.parametrize("device,bands,max_len,want", [
    (torch.device("cuda"), 8, 8, True), ("cuda", 2, 2, True),
    (torch.device("cuda", 0), 4, 10, True), (torch.device("cuda"), 1, 8,
                                             False),
    (torch.device("cuda"), 8, 1, False), (torch.device("cpu"), 8, 8, False),
    ("cpu", 1, 8, False)])
def test_default_rule(rule, device, bands, max_len, want):
    assert rule(device, bands, max_len) is want


@pytest.mark.parametrize("algo", ["pt", "vcm"])
def test_engine_reaches_the_rule(scenes, algo, monkeypatch):
    """make_frame_fn asks the integrators' rule with the scene's device
    (the CLI's and --interactive's frame functions are make_frame_fn's);
    on the CPU the rule keeps the banded route, and a rule that says yes
    gives the compacted one, with the banded film."""
    _, ts, meta = scenes["cornell"]
    monkeypatch.setattr(tpt, "BAND_RAYS", 128)
    mod, name = (tpt, "use_compact") if algo == "pt" else (
        tvcm, "use_vcm_compact")
    rule, asked, sorts, force = getattr(mod, name), [], [], [False]
    real_sort = tpt._compact_carry

    def spy(device, num_bands, max_len):
        asked.append((torch.device(device).type, rule(device, num_bands,
                                                      max_len)))
        return asked[-1][1] or force[0]

    def sort_spy(c, lane_id):
        sorts.append(lane_id.shape[0])
        return real_sort(c, lane_id)

    monkeypatch.setattr(mod, name, spy)
    monkeypatch.setattr(tpt, "_compact_carry", sort_spy)
    settings = RenderSettings(width=24, height=16, spp=1, max_path_len=3,
                              algorithm=algo, light_path_count=128)
    frame_fn, _ = make_frame_fn(ts, meta, settings)
    banded = frame_fn(1)
    assert asked and all(a == ("cpu", False) for a in asked) and not sorts
    force[0] = True
    compacted = frame_fn(1)
    assert sorts == [24 * 16]
    np.testing.assert_allclose(banded.numpy(), compacted.numpy(), rtol=2e-4,
                               atol=2e-5)
