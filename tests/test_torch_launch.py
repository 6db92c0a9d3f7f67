"""Ranks as real processes (imbatracer_torch.parallel.launch.spawn) on the
CPU over gloo, each capped at one torch thread; no jax.

* A PT and a BPT frame of the procedural cornell at 32x32, rendered by
  two spawned ranks through engine.make_frame_fn, equal the one-process
  frame bit for bit (the BPT light pass at the ranks' band, as
  tests/test_torch_shard.py holds it).
* The CLI's rank function over two spawned ranks writes the same PNG,
  byte for byte, as the one-process CLI (PT and VCM, the generated
  instanced scene), and only rank 0 prints the perf line.
* `--interactive` across two spawned ranks on a pseudo-terminal: rank 0
  draws, moves, saves on `p`, and `x` ends both ranks with exit 0.
* A rank that raises ends the launch with an error within seconds while
  the other sleeps or waits in a collective: no hang.
* On a card (marked `cuda`): Comm refuses a CPU tensor on NCCL.
"""

import os
import pty
import re
import select
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.multiprocessing import ProcessRaisedException

from imbatracer_torch.frontend import cli
from imbatracer_torch.frontend.engine import make_frame_fn
from imbatracer_torch.frontend.renderer import (RenderSettings,
                                                camera_for_scene)
from imbatracer_torch.parallel import launch
from imbatracer_torch.parallel.comm import Comm
from imbatracer_torch.render.integrators.vcm import render_vcm_frame
from imbatracer_torch.scene.generate import write_instanced_scene
from imbatracer_torch.scene.procedural import make_cornell_scene
from torch_threads import cap_torch_threads

cap_torch_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, MAX_LEN, LPC = 32, 4, 512


def _settings(algo):
    return RenderSettings(width=W, height=W, max_path_len=MAX_LEN,
                          algorithm=algo, light_path_count=LPC)


def _frame_rank(comm, algo, out):
    scene, meta = make_cornell_scene(device=comm.device)
    frame_fn, _ = make_frame_fn(scene, meta, _settings(algo), comm=comm)
    comm.reset_counts()
    film = frame_fn(3)
    if comm.rank == 0:
        np.save(out, film.numpy())
        with open(out + ".calls", "w") as f:
            f.write(str(comm.calls))


def _raising_rank(comm, wait):
    if comm.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    if wait == "barrier":
        comm.barrier()
    else:
        time.sleep(300)


@pytest.mark.parametrize("algo,calls", [("pt", 1), ("bpt", 4)])
def test_spawned_ranks_match_one_process(algo, calls, tmp_path):
    out = str(tmp_path / "film.npy")
    launch.spawn(_frame_rank, 2, "cpu", "gloo", args=(algo, out), threads=1,
                 timeout=120)
    scene, meta = make_cornell_scene(device="cpu")
    frame_fn, _ = make_frame_fn(scene, meta, _settings(algo))
    if algo == "pt":
        ref = frame_fn(3).numpy()
    else:
        # One light step of LPC / 2 paths a rank: the single process's
        # light pass in bands of LPC / 2 paths (BPT's base radius is 1).
        ref = render_vcm_frame(
            scene, camera_for_scene(meta, _settings(algo), "cpu"), 3, 1.0,
            algo="bpt", width=W, height=W, max_len=MAX_LEN,
            light_path_count=LPC, light_band=LPC // 2,
            mat_kinds=tuple(sorted(set(scene.materials.kind.tolist())))
        ).numpy()
    got = np.load(out)
    assert np.array_equal(got, ref)
    # The census: PT one film gather; BPT one light step, the cache's
    # counts and rows, the camera film.
    assert int(open(out + ".calls").read()) == calls


@pytest.mark.parametrize("wait", ["sleep", "barrier"])
def test_a_failing_rank_ends_the_launch(wait):
    """Rank 1 raises while rank 0 sleeps (the launcher terminates it and
    raises rank 1's error) or waits in a barrier (gloo sees the peer go,
    and whichever rank's error comes first is raised)."""
    t0 = time.time()
    with pytest.raises(ProcessRaisedException) as err:
        launch.spawn(_raising_rank, 2, "cpu", "gloo", args=(wait,),
                     threads=1, timeout=60)
    assert time.time() - t0 < 60
    if wait == "sleep":
        assert "fails on purpose" in str(err.value)


@pytest.fixture(scope="module")
def scene_path(tmp_path_factory):
    return write_instanced_scene(str(tmp_path_factory.mktemp("launch")))


@pytest.mark.parametrize("algo", ["pt", "vcm"])
def test_cli_across_two_ranks(scene_path, algo, tmp_path, capfd):
    argv = [scene_path, "", "-a", algo, "-w", "24", "-h2", "16", "-s", "2",
            "--max-path-len", "3", "--device", "cpu", "-q"]
    one, two = str(tmp_path / "one.png"), str(tmp_path / "two.png")
    assert cli.main([argv[0], one] + argv[2:]) == 0
    capfd.readouterr()
    launch.spawn(cli.render_rank, 2, "cpu", "gloo",
                 args=([argv[0], two] + argv[2:],), threads=1, timeout=120)
    out = capfd.readouterr().out
    assert out.count("Done after") == 1 and "2 samples" in out
    with open(one, "rb") as a, open(two, "rb") as b:
        assert a.read() == b.read()


def test_interactive_across_two_ranks(scene_path, tmp_path):
    """Two spawned ranks of the CLI's `--interactive` on a pseudo-terminal:
    rank 0 reads the keys and draws, rank 1 follows its camera."""
    out = tmp_path / "o.png"
    argv = [scene_path, str(out), "--interactive", "-a", "pt", "-w", "16",
            "-h2", "12", "--max-path-len", "3", "--device", "cpu"]
    code = ("from imbatracer_torch.frontend import cli\n"
            "from imbatracer_torch.parallel import launch\n"
            "if __name__ == '__main__':\n"
            f"    launch.spawn(cli.render_rank, 2, 'cpu', 'gloo', "
            f"args=({argv!r},), threads=1, timeout=120)\n")
    master, slave = pty.openpty()
    env = dict(os.environ, PYTHONPATH=ROOT, COLUMNS="40", LINES="12",
               IMBATRACER_CACHE_DIR=str(tmp_path / "accel"))
    proc = subprocess.Popen([sys.executable, "-c", code], stdin=slave,
                            stdout=slave, stderr=slave, cwd=ROOT, env=env,
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
        assert read_until(lambda: max(spp(), default=0) >= 3, 120), bytes(buf)
        before = len(spp())
        os.write(master, b"w")
        assert read_until(lambda: any(
            b < a for a, b in zip(spp()[before - 1:], spp()[before:])), 60)
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


@pytest.mark.cuda
def test_nccl_refuses_cpu_tensors():
    if not torch.cuda.is_available() or not dist.is_nccl_available():
        pytest.skip("needs a CUDA device and a torch built with NCCL")
    comm = Comm.init("nccl", launch.ADDR, launch.free_port(), 0, 1,
                     "cuda:0", timeout=60)
    try:
        with pytest.raises(ValueError, match="NCCL"):
            comm.all_gather(torch.zeros(4))
        got = comm.all_gather(torch.ones(4, device="cuda:0"))
        assert len(got) == 1 and got[0].device.type == "cuda"
    finally:
        comm.close()
