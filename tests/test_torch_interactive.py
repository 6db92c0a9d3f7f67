"""The port's interactive preview (imbatracer_torch.frontend.interactive)
and the camera-as-argument frame function (engine.make_camera_frame_fn)
against the JAX package's.

* FirstPersonCamera: the moves and turns of tests/test_interactive.py
  give JAX's positions and directions within 1e-12, and its camera()
  the JAX camera's fields bit for bit (both round float64 to float32).
* ansi_preview: the same strings as JAX's, character for character.
* _read_keys: the same keys as JAX's from one byte stream (arrows mapped
  to ijkl, other CSI / SS3 sequences stripped).
* make_camera_frame_fn at the default camera gives make_frame_fn's films
  bit for bit (PT and VCM); at a moved camera its PT film equals JAX's
  render_pt_frame at JAX's moved camera (what JAX's make_camera_frame_fn
  calls on one device) to tests/test_torch_pt.py's tolerance: film mean
  within 1e-3 relative, >= 98% of pixels within 1e-4 relative.
* `--interactive` without a TTY raises SystemExit; under a
  pseudo-terminal on the CPU it draws half-block rows, restarts the spp
  count after a move, saves on `p` and exits 0 on `x`.
"""

import io
import os
import pty
import re
import select
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imbatracer_tpu.frontend import interactive as jint
from imbatracer_tpu.render.integrators.pt import render_pt_frame as jpt
from imbatracer_tpu.scene import procedural as jproc
from imbatracer_torch.convert import scene_from_numpy, scene_to_numpy
from imbatracer_torch.frontend import cli as tcli
from imbatracer_torch.frontend import interactive as tint
from imbatracer_torch.frontend.engine import (make_camera_frame_fn,
                                              make_frame_fn)
from imbatracer_torch.frontend.renderer import RenderSettings
from imbatracer_torch.scene.generate import write_instanced_scene
from torch_threads import cap_torch_threads

cap_torch_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _drive(cam):
    """tests/test_interactive.py's moves and turns, recorded."""
    out = []
    cam.move(0, 0, 1)
    cam.move(1, 0, 0)
    cam.move(0, 1, 0)
    out.append((cam.pos.copy(), cam.forward.copy()))
    cam.yaw(np.pi / 2)
    for _ in range(50):
        cam.yaw(0.3)
        cam.pitch(0.2)
        out.append((cam.pos.copy(), cam.forward.copy()))
    for _ in range(100):
        cam.pitch(0.3)
        cam.move(0.5, -0.2, 1.0)
        out.append((cam.pos.copy(), cam.forward.copy()))
    return out


def test_first_person_camera_matches_jax():
    args = ((0, 0, 0), (0, 0, -1), (0, 1, 0))
    tcam = tint.FirstPersonCamera(*args, speed=2.0)
    jcam = jint.FirstPersonCamera(*args, speed=2.0)
    for (tp, tf), (jp, jf) in zip(_drive(tcam), _drive(jcam)):
        np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-12)
        np.testing.assert_allclose(tf, jf, rtol=0, atol=1e-12)
    assert abs(np.dot(tcam.forward, tcam.up)) < 0.995
    tc, jc = tcam.camera(64, 32, 60.0), jcam.camera(64, 32, 60.0)
    assert (tc.width, tc.height) == (jc.width, jc.height) == (64, 32)
    assert tc.pos.device.type == "cpu"
    for k in ("pos", "forward", "right", "down", "img_plane_dist"):
        np.testing.assert_array_equal(getattr(tc, k).numpy(),
                                      np.asarray(getattr(jc, k)), err_msg=k)


def test_ansi_preview_matches_jax():
    img = np.zeros((32, 64, 3), np.float32)
    img[:16, :, 0] = 1.0
    img[16:, :, 2] = 1.0
    rnd = np.random.RandomState(3).rand(27, 45, 3).astype(np.float32)
    for im, cols, rows in ((img, 8, 4), (rnd, 20, 9), (rnd, 45, 14)):
        s = tint.ansi_preview(im, cols, rows)
        assert s == jint.ansi_preview(im, cols, rows)
        assert len(s.split("\n")) == rows and "▀" in s


def test_read_keys_matches_jax(monkeypatch):
    stream = b"w\x1b[Aj\x1b[15~s\x1bOPd\x1b[Dx"
    got = []
    for mod in (tint, jint):
        r, w = os.pipe()
        os.write(w, stream)
        with os.fdopen(r, "rb", buffering=0) as f:
            monkeypatch.setattr(sys, "stdin", f)
            got.append(mod._read_keys(0.0))
        os.close(w)
    assert got[0] == got[1] == "wijsdjx"


@pytest.fixture(scope="module")
def cornell():
    js, meta = jproc.make_cornell_scene()
    return js, scene_from_numpy(scene_to_numpy(js), "cpu"), meta


@pytest.mark.parametrize("algo", ["pt", "vcm"])
def test_camera_frame_fn_at_default_camera(cornell, algo):
    _, ts, meta = cornell
    settings = RenderSettings(width=16, height=16, max_path_len=3,
                              algorithm=algo)
    frame_fn, cam = make_frame_fn(ts, meta, settings)
    core, cam0 = make_camera_frame_fn(ts, meta, settings)
    for k in ("pos", "forward", "right", "down", "img_plane_dist"):
        assert torch.equal(getattr(cam, k), getattr(cam0, k))
    a, b = frame_fn(2).numpy(), core(2, cam0).numpy()
    assert a.mean() > 0.0
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_camera_frame_fn_at_moved_camera_matches_jax(cornell):
    js, ts, meta = cornell
    w = 24
    settings = RenderSettings(width=w, height=w, spp=2, max_path_len=4)
    core, cam0 = make_camera_frame_fn(ts, meta, settings)
    cams = []
    for mod in (tint, jint):
        c = mod.FirstPersonCamera(meta.cam_pos, meta.cam_dir, meta.cam_up,
                                  speed=0.3)
        c.move(0.5, 0.2, 1.0)
        c.yaw(0.15)
        c.pitch(-0.1)
        cams.append(c.camera(w, w, settings.fov))
    tf = core(3, cams[0]).numpy()
    jf = np.asarray(jpt(js, cams[1], jnp.uint32(3), w, w, spp=2, max_len=4,
                        has_masks=meta.has_masks, max_steps=0))
    assert not np.array_equal(tf, core(3, cam0).numpy())
    assert jf.mean() > 0.0 and np.isfinite(tf).all()
    assert abs(tf.mean() - jf.mean()) / jf.mean() <= 1e-3
    rel = np.abs(tf - jf) / np.maximum(np.abs(jf), 1e-3)
    assert (rel.max(axis=-1) <= 1e-4).mean() >= 0.98


@pytest.fixture(scope="module")
def scene_path(tmp_path_factory):
    return write_instanced_scene(str(tmp_path_factory.mktemp("inter")))


def test_interactive_without_a_tty_exits(scene_path, tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "stdin", io.StringIO())
    with pytest.raises(SystemExit, match="needs a TTY"):
        tcli.main([scene_path, str(tmp_path / "o.png"), "--interactive",
                   "--device", "cpu", "-w", "8", "-h2", "8"])
    assert not (tmp_path / "o.png").exists()


def test_interactive_under_a_pty(scene_path, tmp_path):
    """The CLI on a pseudo-terminal: redraws, a move that restarts the
    spp count, `p` saves, `x` saves and exits 0."""
    out = tmp_path / "o.png"
    master, slave = pty.openpty()
    env = dict(os.environ, PYTHONPATH=ROOT, COLUMNS="40", LINES="12",
               IMBATRACER_CACHE_DIR=str(tmp_path / "accel"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "imbatracer_torch", scene_path, str(out),
         "--interactive", "-a", "pt", "-w", "16", "-h2", "12",
         "--max-path-len", "3", "--device", "cpu"],
        stdin=slave, stdout=slave, stderr=slave, cwd=ROOT, env=env,
        close_fds=True)
    os.close(slave)
    buf = bytearray()

    def read_until(pred, limit):
        t_end = time.time() + limit
        while time.time() < t_end and not pred():
            r, _, _ = select.select([master], [], [], 0.2)
            if r:
                try:
                    buf.extend(os.read(master, 65536))
                except OSError:
                    break
        return pred()

    spp = lambda: [int(x) for x in re.findall(rb"(\d+) spp", bytes(buf))]
    try:
        assert read_until(lambda: max(spp(), default=0) >= 3, 90), bytes(buf)
        before = len(spp())
        os.write(master, b"w")
        assert read_until(lambda: any(
            b < a for a, b in zip(spp()[before - 1:], spp()[before:])), 60)
        os.write(master, b"j")
        os.write(master, b"p")
        assert read_until(lambda: out.exists(), 60)
        os.write(master, b"x")
        read_until(lambda: proc.poll() is not None, 60)
        assert proc.wait(timeout=30) == 0, bytes(buf)[-2000:]
    finally:
        if proc.poll() is None:
            proc.kill()
        os.close(master)
    assert "▀".encode() in buf
    assert out.read_bytes()[:4] == b"\x89PNG"
