"""The port's command line (`python -m imbatracer_torch`) and the films it
renders from a generated `.scene`.

* In a subprocess with jax, flax, PIL and imbatracer_tpu made
  unimportable, `python -m imbatracer_torch <scene> <out.png> --device
  cpu -s 2` renders and writes the PNG.
* The parser has the JAX CLI's destinations and defaults (plus
  `--device`).
* `--sbvh` on a flat scene: a film equal to the binned build's to the
  tolerance below, and the cached build on a second run
  (`--interactive` is tested by tests/test_torch_interactive.py).
* PT and VCM films through the port's `make_frame_fn` on the generated
  scene, flattened and two-level, agree with the JAX package's frame
  renderers (`render_pt_frame`, `render_vcm_frame`, what its
  make_frame_fn calls per device; its sharding engine is not used) to
  the tolerance of tests/test_torch_pt.py: film mean within 1e-3
  relative, >= 98% of pixels within 1e-4 relative.  A square image, as
  the port's camera pdf divides by a pixel's w/h area where JAX takes 1.
* The two-level film agrees with the flattened film to the same bound.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from imbatracer_tpu.frontend import cli as jcli
from imbatracer_tpu.frontend import engine as jengine
from imbatracer_tpu.frontend import renderer as jren
from imbatracer_tpu.ops import pallas_merge
from imbatracer_tpu.render.integrators.pt import render_pt_frame as jpt
from imbatracer_tpu.render.integrators.vcm import render_vcm_frame as jvcm
from imbatracer_tpu.scene.build import build_scene as jbuild
from imbatracer_torch.frontend import cli as tcli
from imbatracer_torch.frontend.engine import make_frame_fn
from imbatracer_torch.frontend.renderer import RenderSettings
from imbatracer_torch.scene.build import build_scene
from imbatracer_torch.scene.generate import write_instanced_scene
from torch_jax_native import ensure_jax_native
from torch_threads import cap_torch_threads

cap_torch_threads()
ensure_jax_native()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = 20


@pytest.fixture(scope="module")
def scene_path(tmp_path_factory):
    return write_instanced_scene(str(tmp_path_factory.mktemp("cli")))


def test_cli_renders_without_jax(scene_path, tmp_path):
    out = tmp_path / "out.png"
    code = (
        "import runpy, sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'PIL', 'imbatracer_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"sys.argv = ['imbatracer_torch', {scene_path!r}, {str(out)!r},\n"
        "            '--device', 'cpu', '-s', '2', '-w', '24', '-h2', '16',\n"
        "            '-a', 'vcm', '--max-path-len', '3']\n"
        "runpy.run_module('imbatracer_torch', run_name='__main__')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert res.returncode == 0, res.stderr
    assert "Done after" in res.stdout and "2 samples" in res.stdout
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert "two-level instancing" in res.stderr


def test_parser_matches_jax():
    j = {a.dest: a for a in jcli.build_parser()._actions}
    t = {a.dest: a for a in tcli.build_parser()._actions}
    assert set(t) == set(j) | {"device"}
    for dest, a in j.items():
        b = t[dest]
        assert (b.option_strings, b.default, b.type, b.nargs) == \
            (a.option_strings, a.default, a.type, a.nargs), dest
        assert set(b.choices or ()) == set(a.choices or ()), dest
    assert t["device"].default == "cuda"
    args = tcli.build_parser().parse_args(["s.scene", "-c", "99"])
    assert tcli.settings_from_args(args).num_connections == 8
    assert jcli.settings_from_args(jcli.build_parser().parse_args(
        ["s.scene", "-c", "99"])) == jren.RenderSettings(num_connections=8)


@pytest.mark.parametrize("algo", ["pt", "vcm"])
def test_sbvh_flag(algo, tmp_path, monkeypatch, caplog):
    """`--sbvh` on a written flat scene (one instance of each mesh, packed
    close, so the split build duplicates a reference): the film over the
    split build equals the binned build's to the route tolerance
    (`_agree`); the CLI's first run builds and caches the split BVH, its
    second loads it and writes the same PNG."""
    monkeypatch.setenv("IMBATRACER_CACHE_DIR", str(tmp_path / "accel"))
    path = write_instanced_scene(
        str(tmp_path / "flat"), spread=2.0,
        counts=dict(ground=1, sphere=1, blob=1, crystal=1, card=1, panel=1))
    settings = RenderSettings(width=W, height=W, spp=1, max_path_len=4,
                              algorithm=algo)
    films = {}
    for spatial in (False, True):
        scene, meta = build_scene(path, quiet=True, device="cpu",
                                  spatial=spatial)
        assert not scene.bvh.two_level
        films[spatial] = make_frame_fn(scene, meta, settings)[0](3).numpy()
    assert int((scene.bvh.tri_id >= 0).sum()) > meta.num_tris
    _agree(films[True], films[False])

    monkeypatch.setenv("IMBATRACER_CACHE_DIR", str(tmp_path / "cli"))
    caplog.set_level("INFO", logger="imbatracer_torch")
    pngs = []
    for run, says in enumerate(("BVH (sbvh)", "BVH loaded from cache")):
        caplog.clear()
        out = tmp_path / f"{algo}{run}.png"
        assert tcli.main([path, str(out), "--sbvh", "-a", algo, "-s", "1",
                          "-w", str(W), "-h2", str(W), "--max-path-len",
                          "4", "--device", "cpu", "-q"]) == 0
        assert says in caplog.text
        pngs.append(out.read_bytes())
    assert pngs[0] == pngs[1]


def _jax_film(js, jm, algo):
    cam = jren.camera_for_scene(jm, jren.RenderSettings(width=W, height=W))
    if algo == "pt":
        return np.asarray(jpt(js, cam, jnp.uint32(3), W, W, spp=1, max_len=4,
                              has_masks=jm.has_masks, has_bump=jm.has_bump,
                              max_steps=0))
    radius = jengine.estimate_pixel_size(js, cam, jm) * 2.0
    kinds = tuple(sorted(set(np.asarray(js.materials.kind).tolist())))
    old = pallas_merge.INTERPRET
    pallas_merge.INTERPRET = True
    try:
        return np.asarray(jvcm(
            js, cam, jnp.uint32(3), jnp.float32(radius), algo="vcm", width=W,
            height=W, max_len=4, light_path_count=W * W // 2,
            has_masks=jm.has_masks, has_bump=jm.has_bump, merge_kernel=True,
            mat_kinds=kinds))
    finally:
        pallas_merge.INTERPRET = old


def _agree(a, b):
    assert a.shape == b.shape and np.isfinite(a).all() and b.mean() > 0.0
    assert abs(a.mean() - b.mean()) / b.mean() <= 1e-3
    rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-3)
    assert (rel.max(axis=-1) <= 1e-4).mean() >= 0.98


@pytest.mark.parametrize("algo", ["pt", "vcm"])
def test_films_match_jax(scene_path, algo, tmp_path, monkeypatch):
    monkeypatch.setenv("IMBATRACER_CACHE_DIR", str(tmp_path / "accel"))
    js, jm = jbuild(scene_path, quiet=True)
    jf = _jax_film(js, jm, algo)
    settings = RenderSettings(width=W, height=W, spp=1, max_path_len=4,
                              algorithm=algo)
    films = {}
    for flat in (True, False):
        scene, meta = build_scene(scene_path, quiet=True, device="cpu",
                                  force_flatten=flat)
        assert scene.bvh.two_level != flat
        films[flat] = make_frame_fn(scene, meta, settings)[0](3).numpy()
        _agree(films[flat], jf)
    _agree(films[False], films[True])
