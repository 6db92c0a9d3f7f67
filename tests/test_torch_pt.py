"""The port's progressive PT frame against the JAX reference, and the
frontend end to end.

render_pt_frame runs on the same scene arrays, camera and frame number in
both packages (JAX through its exact skip-link traversal, max_steps=0;
the port through the plain traversal).  The RNG is bitwise equal, so the
paths are the same; float differences of a few ulps in shading could
flip a Russian-roulette decision, so the films are held statistically:
mean relative difference <= 1e-3, >= 98% of pixels within 1e-4 relative
(of max(|value|, 1e-3)), and traced-ray counts within 1% (a glass
choice or a Russian-roulette draw decided by one ulp moves a few paths).
"""

import ast
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imbatracer_tpu.render.camera import make_camera as jcamera
from imbatracer_tpu.render.integrators.pt import render_pt_frame as jrender
from imbatracer_tpu.scene import procedural as jproc
from imbatracer_torch.convert import scene_from_numpy, scene_to_numpy
from imbatracer_torch.frontend.engine import make_frame_fn
from imbatracer_torch.frontend.renderer import (ProgressiveRenderer,
                                                RenderSettings)
from imbatracer_torch.render.camera import make_camera as tcamera
from imbatracer_torch.render.integrators.pt import render_pt_frame as trender
from imbatracer_torch.scene.procedural import make_cornell_scene

W, SPP, MAX_LEN = 32, 2, 4


@pytest.mark.parametrize("kw", [
    {}, dict(mirror_box=True, glass_sphere=True), dict(light="spot")])
def test_pt_frame_matches_jax(kw):
    js, meta = jproc.make_cornell_scene(**kw)
    ts = scene_from_numpy(scene_to_numpy(js), "cpu")
    cam = (meta.cam_pos, meta.cam_dir, meta.cam_up, W, W, 60.0)
    jf, jn = jrender(js, jcamera(*cam), jnp.uint32(3), W, W, spp=SPP,
                     max_len=MAX_LEN, with_stats=True, max_steps=0)
    tf, tn = trender(ts, tcamera(*cam, device="cpu"), 3, W, W, spp=SPP,
                     max_len=MAX_LEN, with_stats=True)
    jf, tf = np.asarray(jf), tf.numpy()
    assert tf.shape == (W * W, 3) and np.isfinite(tf).all()
    assert jf.mean() > 0.0
    assert abs(tf.mean() - jf.mean()) / jf.mean() <= 1e-3
    rel = np.abs(tf - jf) / np.maximum(np.abs(jf), 1e-3)
    assert (rel.max(axis=-1) <= 1e-4).mean() >= 0.98
    assert abs(int(tn) - int(jn)) <= 1e-2 * int(jn)


def test_frame_fn_and_progressive_renderer(tmp_path):
    scene, meta = make_cornell_scene(device="cpu")
    settings = RenderSettings(width=24, height=16, spp=1, max_path_len=3)
    frame_fn, cam = make_frame_fn(scene, meta, settings)
    assert cam.width == 24 and cam.height == 16
    renderer = ProgressiveRenderer(frame_fn, settings, "cpu")
    renderer.step()
    renderer.step()
    assert renderer.frames == 2
    film = renderer.raw()
    assert film.shape == (16, 24, 3) and np.isfinite(film).all()
    assert film.mean() > 0.0
    # The accumulator holds frame 0 + frame 1 exactly.
    want = (frame_fn(0) + frame_fn(1)).numpy().reshape(16, 24, 3)
    np.testing.assert_array_equal(film, want)
    img = renderer.image()
    assert img.min() >= 0.0 and img.max() <= 1.0
    renderer.save(str(tmp_path / "f.png"))
    assert (tmp_path / "f.png").read_bytes()[:4] == b"\x89PNG"
    renderer.reset()
    assert renderer.frames == 0 and float(renderer.accum.abs().sum()) == 0.0
    settings.max_samples = 2
    img = renderer.run()
    assert renderer.frames == 2 and img.shape == (16, 24, 3)
    np.testing.assert_array_equal(renderer.raw(), want)

    vcm_fn, _ = make_frame_fn(scene, meta, RenderSettings(
        width=8, height=8, max_path_len=2, algorithm="vcm"))
    assert vcm_fn(0).shape == (64, 3)
    with pytest.raises(ValueError):
        make_frame_fn(scene, meta, RenderSettings(algorithm="nope"))


def test_port_runs_without_jax():
    """The port imports torch and never jax or the JAX package: with jax,
    flax, PIL and imbatracer_tpu made unimportable, it builds the cornell
    and the masked scene and renders a 16x16 PT and VCM frame of each."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'PIL', 'imbatracer_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from imbatracer_torch.frontend.engine import make_frame_fn\n"
        "from imbatracer_torch.frontend.renderer import RenderSettings\n"
        "from imbatracer_torch.scene.procedural import (\n"
        "    make_cornell_scene, make_masked_scene)\n"
        "for build in (make_cornell_scene, make_masked_scene):\n"
        "    scene, meta = build(device='cpu')\n"
        "    for algo in ('pt', 'vcm'):\n"
        "        s = RenderSettings(width=16, height=16, spp=1,\n"
        "                           max_path_len=3, algorithm=algo)\n"
        "        film = make_frame_fn(scene, meta, s)[0](0)\n"
        "        assert film.shape == (256, 3)\n"
        "        assert bool(film.isfinite().all())\n"
        "        print('mean', float(film.mean()))\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=root, timeout=300)
    assert res.returncode == 0, res.stderr
    means = [float(ln.split()[-1]) for ln in res.stdout.splitlines()
             if ln.startswith("mean")]
    assert len(means) == 4 and min(means) > 0.0


def test_port_sources_import_no_jax():
    """No module of imbatracer_torch/, and not chip_smoke.py, imports jax,
    flax or any module of the JAX package, at any depth of the source
    (function-local imports included)."""
    banned = ("jax", "jaxlib", "flax", "imbatracer_tpu")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = [os.path.join(repo, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(repo, "imbatracer_torch")):
        paths += [os.path.join(dirpath, f) for f in files
                  if f.endswith(".py")]
    assert len(paths) > 30
    for path in paths:
        with open(path) as fh:
            tree = ast.parse(fh.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, (
                    os.path.relpath(path, repo), node.lineno, name)
