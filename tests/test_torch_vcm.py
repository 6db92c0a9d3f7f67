"""The port's VCM family (imbatracer_torch.render.integrators.vcm) against
the JAX package's render_vcm_frame, and the family's own properties.

Both render the same scene arrays, camera, frame and base radius; the JAX
side routes merging through its Pallas merge kernel in interpret mode
(as tests/test_pallas_merge.py runs it) and is called directly, not
through engine.make_frame_fn, which shards over the test session's 8
virtual devices.  The RNG is bitwise equal, so the paths are the same;
last-ulp differences of transcendentals could flip a Russian-roulette
decision, so films are held statistically, as the PT slice holds its
frame: film mean within 1e-3 relative, and >= 95% of pixels within 1e-4
relative (of max(|value|, 1e-3)).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imbatracer_tpu.frontend import engine as jengine
from imbatracer_tpu.ops import pallas_merge
from imbatracer_tpu.render.camera import make_camera as jcamera
from imbatracer_tpu.render.integrators.vcm import render_vcm_frame as jrender
from imbatracer_tpu.scene import procedural as jproc
from imbatracer_torch.convert import scene_from_numpy, scene_to_numpy
from imbatracer_torch.frontend import engine as tengine
from imbatracer_torch.frontend.renderer import RenderSettings
from imbatracer_torch.ops import merge as tmerge
from imbatracer_torch.render import light_cache as tlc
from imbatracer_torch.render.camera import make_camera as tcamera
from imbatracer_torch.render.integrators import vcm as tvcm
from imbatracer_torch.scene.procedural import make_cornell_scene
from torch_threads import cap_torch_threads

cap_torch_threads()

W, MAX_LEN, LPC, RADIUS, FRAME = 24, 4, 256, 0.06, 2


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name, build in (("cornell", jproc.make_cornell_scene),
                        ("masked", jproc.make_masked_scene)):
        js, meta = build()
        out[name] = (js, scene_from_numpy(scene_to_numpy(js), "cpu"), meta)
    return out


def _kinds(scene):
    return tuple(sorted(set(scene.materials.kind.tolist())))


def _port_frame(ts, meta, algo, width=W, height=None, **kw):
    height = height or width
    cam = tcamera(meta.cam_pos, meta.cam_dir, meta.cam_up, width, height,
                  60.0, device="cpu")
    return tvcm.render_vcm_frame(
        ts, cam, FRAME, RADIUS, algo=algo, width=width, height=height,
        max_len=MAX_LEN, light_path_count=LPC, has_masks=meta.has_masks,
        mat_kinds=_kinds(ts), **kw).numpy()


def _jax_frame(js, ts, meta, algo, width=W, height=W):
    cam = jcamera(meta.cam_pos, meta.cam_dir, meta.cam_up, width, height,
                  60.0)
    old = pallas_merge.INTERPRET
    pallas_merge.INTERPRET = True
    try:
        return np.asarray(jrender(
            js, cam, jnp.uint32(FRAME), jnp.float32(RADIUS), algo=algo,
            width=width, height=height, max_len=MAX_LEN,
            light_path_count=LPC, has_masks=meta.has_masks,
            merge_kernel=True, mat_kinds=_kinds(ts)))
    finally:
        pallas_merge.INTERPRET = old


def _assert_films_agree(tf, jf):
    assert tf.shape == jf.shape and np.isfinite(tf).all()
    assert jf.mean() > 0.0
    assert abs(tf.mean() - jf.mean()) / jf.mean() <= 1e-3
    rel = np.abs(tf - jf) / np.maximum(np.abs(jf), 1e-3)
    assert (rel.max(axis=-1) <= 1e-4).mean() >= 0.95


@pytest.mark.parametrize("name,algo", [
    ("cornell", "vcm"), ("cornell", "bpt"), ("cornell", "ppm"),
    ("cornell", "lt"), ("cornell", "pt"), ("masked", "vcm")])
def test_frame_matches_jax(scenes, name, algo):
    js, ts, meta = scenes[name]
    tf = _port_frame(ts, meta, algo)
    assert tf.shape == (W * W, 3)
    _assert_films_agree(tf, _jax_frame(js, ts, meta, algo))


@pytest.mark.parametrize("algo", ["vcm", "bpt"])
def test_non_square_frame_matches_jax_at_unit_pixel_area(scenes, algo,
                                                         monkeypatch):
    """On a non-square image the port's camera pdf and importance divide
    by the pixel area w/h, where the JAX package takes it as 1.  With the
    area forced to 1, the rest of the template (light splats, MIS
    weights, merging, connections) is held against the reference there
    too, at the tolerances of the square frames."""
    js, ts, meta = scenes["cornell"]
    w, h = 24, 16
    monkeypatch.setattr(tvcm, "pixel_area", lambda cam: 1.0)
    _assert_films_agree(_port_frame(ts, meta, algo, width=w, height=h),
                        _jax_frame(js, ts, meta, algo, width=w, height=h))


@pytest.mark.parametrize("algo", ["vcm", "bpt"])
def test_technique_films_sum_to_full(scenes, algo):
    """The MIS debugger: each technique gated alone, RNG streams unchanged,
    and the technique films sum to the full film."""
    _, ts, meta = scenes["cornell"]
    full = _port_frame(ts, meta, algo, width=16)
    parts = {tech: _port_frame(ts, meta, algo, width=16, techniques=(tech,))
             for tech in tvcm.TECHNIQUES}
    np.testing.assert_allclose(sum(parts.values()), full, rtol=1e-4,
                               atol=1e-5)
    for tech in ("light_hit", "next_event", "cam_connect", "connect"):
        assert parts[tech].sum() > 0, tech
    assert (parts["merge"].sum() > 0) == (algo == "vcm")


def test_band_invariance(scenes):
    """Light and camera bands of 64 give the one-band frame: the collect
    cache plus select_shallowest keep the same vertices in the same
    order, and per-pixel estimates are keyed by global ids.  Only the
    light film's summation order changes (one splat per band)."""
    _, ts, meta = scenes["cornell"]
    one, banded = {}, {}
    a = _port_frame(ts, meta, "vcm", width=16, stats=one)
    b = _port_frame(ts, meta, "vcm", width=16, light_band=64, camera_band=64,
                    stats=banded)
    assert {k: int(v) for k, v in one.items()} == \
        {k: int(v) for k, v in banded.items()}
    assert int(one["collected"]) > int(one["cache"]) > 0   # selection binds
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-7)
    assert a.mean() > 0.0


def test_merge_queries_are_recorded_on_request(scenes):
    """stats["merge_queries"], a list, receives each camera band's
    bounce-1 merge arguments by name; merge_contrib takes them back."""
    _, ts, meta = scenes["cornell"]
    queries = []
    _port_frame(ts, meta, "vcm", width=16, camera_band=64,
                stats={"merge_queries": queries})
    assert len(queries) == 16 * 16 // 64
    for q in queries:
        assert q["qpos"].shape == (64, 3) and q["ppm"] is False
        assert tuple(tmerge.merge_contrib(**q).shape) == (64, 3)
    assert sum(int(q["active"].sum()) for q in queries) > 0


def test_light_tracing_divides_by_the_pixel_area(scenes):
    """A pixel is 1 wide and w/h tall on the image plane.  The JAX package
    takes its area as 1, so its light-tracing film is w/h times the
    port's on a non-square image (on square ones the two agree, above)."""
    js, ts, meta = scenes["cornell"]
    w, h = 24, 16
    jf = np.asarray(jrender(
        js, jcamera(meta.cam_pos, meta.cam_dir, meta.cam_up, w, h, 60.0),
        jnp.uint32(FRAME), jnp.float32(RADIUS), algo="lt", width=w, height=h,
        max_len=MAX_LEN, light_path_count=LPC))
    cam = tcamera(meta.cam_pos, meta.cam_dir, meta.cam_up, w, h, 60.0,
                  device="cpu")
    tf = tvcm.render_vcm_frame(ts, cam, FRAME, RADIUS, algo="lt", width=w,
                               height=h, max_len=MAX_LEN,
                               light_path_count=LPC).numpy()
    assert tvcm.pixel_area(cam) == w / h
    assert jf.sum() > 0.0
    np.testing.assert_allclose(tf * (w / h), jf, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("width,height", [(48, 27), (27, 48)])
def test_light_tracing_matches_pt_on_non_square_images(width, height):
    """Light tracing estimates everything but what the camera sees of the
    emitters directly; on the cornell (no mirrors or glass) that is PT
    less the directly seen emission (the template's PT, light-hit only,
    one bounce).  8 frames hold it to ~3% (measured); the area-1
    convention would be off by w/h = 1.78 or 0.56."""
    scene, meta = make_cornell_scene(device="cpu")
    settings = lambda algo: RenderSettings(width=width, height=height,
                                           max_path_len=6, algorithm=algo)
    pt = tengine.make_frame_fn(scene, meta, settings("pt"))[0]
    lt = tengine.make_frame_fn(scene, meta, settings("lt"))[0]
    cam = tengine.camera_for_scene(meta, settings("pt"), "cpu")
    frames = range(8)
    indirect = sum(float((pt(f) - tvcm.render_vcm_frame(
        scene, cam, f, 1.0, algo="pt", width=width, height=height,
        max_len=1, techniques=("light_hit",))).mean()) for f in frames)
    light = sum(float(lt(f).mean()) for f in frames)
    assert abs(light / indirect - 1.0) <= 0.1


def test_light_film_is_weighted_by_spp(scenes):
    """The one light pass a frame is weighted by spp, so that dividing by
    frames * spp leaves light tracing at full weight: LT at spp 4 is 4x
    LT at spp 1 bit for bit (a power of two scales exactly), and 4x the
    JAX package's spp-4 LT frame, which adds the light film once (the
    deliberate difference from the reference), at the square frames'
    tolerances."""
    js, ts, meta = scenes["cornell"]
    one = _port_frame(ts, meta, "lt")
    four = _port_frame(ts, meta, "lt", spp=4)
    assert one.sum() > 0.0
    np.testing.assert_array_equal(four, 4.0 * one)
    cam = jcamera(meta.cam_pos, meta.cam_dir, meta.cam_up, W, W, 60.0)
    jf = np.asarray(jrender(
        js, cam, jnp.uint32(FRAME), jnp.float32(RADIUS), algo="lt", width=W,
        height=W, spp=4, max_len=MAX_LEN, light_path_count=LPC))
    _assert_films_agree(four, 4.0 * jf)


@pytest.mark.parametrize("algo", ["bpt", "vcm"])
def test_spp4_family_matches_pt(algo):
    """At spp 4 BPT and VCM keep PT's film mean (5%) over the same frames
    of the cornell with boxes, 32x32, max_len 4, 1,024 light paths: their
    light splats are no longer divided by spp (BPT fell 21% below PT
    before)."""
    scene, meta = make_cornell_scene(with_boxes=True, device="cpu")
    means = {}
    for a in ("pt", algo):
        settings = RenderSettings(width=32, height=32, spp=4, max_path_len=4,
                                  algorithm=a, light_path_count=1024)
        frame_fn = tengine.make_frame_fn(scene, meta, settings)[0]
        means[a] = sum(float(frame_fn(f).mean()) for f in range(6))
    assert means["pt"] > 0.0
    assert abs(means[algo] / means["pt"] - 1.0) <= 0.05


def test_light_pass_raises_on_a_cache_too_small(scenes):
    _, ts, meta = scenes["cornell"]
    cam = tcamera(meta.cam_pos, meta.cam_dir, meta.cam_up, 16, 16, 60.0,
                  device="cpu")
    eta = torch.tensor(100.0)
    with pytest.raises(RuntimeError, match="overflow"):
        tvcm._light_pass(ts, cam, 0, 1.0 / eta, eta,
                         tlc.empty_cache(LPC // 4, "cpu"), algo="vcm",
                         num_pixels=256, light_path_count=LPC,
                         max_len=MAX_LEN, alpha_fn=None, has_bump=False)


def test_engine_runs_every_algorithm(scenes):
    js, _, jmeta = scenes["cornell"]
    scene, meta = make_cornell_scene(device="cpu")
    for algo in tengine.ALGORITHMS:
        settings = RenderSettings(width=16, height=12, max_path_len=3,
                                  algorithm=algo)
        frame_fn, cam = tengine.make_frame_fn(scene, meta, settings)
        film = frame_fn(1)
        assert film.shape == (16 * 12, 3), algo
        assert bool(film.isfinite().all()) and float(film.mean()) > 0.0, algo
    assert RenderSettings(width=64, height=64).resolved_light_path_count() \
        == 2048
    assert RenderSettings(width=1920, height=1080, algorithm="bpt") \
        .resolved_light_path_count() == 1 << 16
    assert RenderSettings(width=1920, height=1080, algorithm="vcm",
                          light_path_count=1 << 20) \
        .resolved_light_path_count() == 1 << 20

    # The base radius comes from estimate_pixel_size, as in the JAX engine.
    settings = RenderSettings(width=40, height=32)
    tcam = tengine.camera_for_scene(meta, settings, "cpu")
    jcam = jengine.camera_for_scene(jmeta, settings)
    np.testing.assert_allclose(tengine.estimate_pixel_size(scene, tcam, meta),
                               jengine.estimate_pixel_size(js, jcam, jmeta),
                               rtol=1e-6)
