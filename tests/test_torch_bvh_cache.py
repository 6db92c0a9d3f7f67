"""The port's BVH disk cache (imbatracer_torch.io.bvh_cache) and its use
in scene/build.build_scene, against the JAX package's cache.

* A stored build loads back bit for bit, stats included.
* build_scene writes a flat scene's build (binned or split, each under
  its own key) and loads it on the next build of the unchanged files;
  a stale key or a corrupt file makes a rebuild, with a warning, that
  gives the same arrays and rewrites the file.  Two-level scenes are not
  cached.
* The two packages share a cache directory and a file-name pattern but
  never load each other's files: a file JAX's `store_accel` wrote, under
  the port's name and key, is refused by the port, and the port's file
  is refused by JAX's `load_accel`.  Their fingerprints of the same
  files differ.
"""

import logging
import os

import numpy as np
import pytest

from imbatracer_tpu.accel.flatten import thread_bvh as jthread
from imbatracer_tpu.io import bvh_cache as jcache
from imbatracer_torch.accel.builder import triangle_bboxes
from imbatracer_torch.accel.flatten import thread_bvh
from imbatracer_torch.accel.native import build_bvh_native
from imbatracer_torch.convert import scene_to_numpy
from imbatracer_torch.io import bvh_cache
from imbatracer_torch.scene.build import build_scene
from imbatracer_torch.scene.generate import write_instanced_scene
from torch_threads import cap_torch_threads

cap_torch_threads()

# One instance of each mesh: 820 flat triangles, below the two-level rule.
FLAT = dict(ground=1, sphere=1, blob=1, crystal=1, card=1, panel=1)


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    d = tmp_path / "accel"
    monkeypatch.setenv("IMBATRACER_CACHE_DIR", str(d))
    return d


@pytest.fixture(scope="module")
def flat_scene(tmp_path_factory):
    return write_instanced_scene(str(tmp_path_factory.mktemp("flat")),
                                 counts=FLAT)


def _packed():
    rs = np.random.RandomState(4)
    v0 = rs.rand(300, 3).astype(np.float32) * 10
    v1 = v0 + rs.randn(300, 3).astype(np.float32)
    v2 = v0 + rs.randn(300, 3).astype(np.float32)
    nodes = build_bvh_native(*triangle_bboxes(v0, v1, v2))
    return nodes, (v0, v1, v2), thread_bvh(nodes, v0, v1, v2)


def _bits(x):
    return np.ascontiguousarray(x).reshape(-1).view(np.uint8)


def test_round_trip_is_bit_equal(tmp_path):
    _, _, packed = _packed()
    path = str(tmp_path / "a.npz")
    bvh_cache.store_accel(path, packed, "key1")
    got = bvh_cache.load_accel(path, "key1")
    for k in ("tri_v0", "tri_e1", "tri_e2", "tri_id"):
        a, b = getattr(packed, k), getattr(got, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=k)
    assert got.stats == packed.stats
    assert os.listdir(tmp_path) == ["a.npz"]        # no temporary left
    assert bvh_cache.load_accel(str(tmp_path / "missing.npz"), "k") is None


def _arrays(scene):
    return {k: v for k, v in scene_to_numpy(scene).items()
            if k.startswith("bvh.")}


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(_bits(a[k]), _bits(b[k]), err_msg=k)


@pytest.mark.parametrize("fault", ["stale", "corrupt"])
def test_build_scene_caches_and_rebuilds(fault, flat_scene, cache_dir,
                                         caplog):
    caplog.set_level(logging.INFO, logger="imbatracer_torch")
    first, _ = build_scene(flat_scene, quiet=True, device="cpu",
                           spatial=True)
    assert "BVH (sbvh)" in caplog.text and "wrote BVH cache" in caplog.text
    files = os.listdir(cache_dir)
    assert len(files) == 1 and files[0].endswith("_sbvh.npz")
    path = str(cache_dir / files[0])

    caplog.clear()
    second, _ = build_scene(flat_scene, quiet=True, device="cpu",
                            spatial=True)
    assert "BVH loaded from cache" in caplog.text
    _same(_arrays(first), _arrays(second))

    # The binned build of the same files has its own key and file.
    build_scene(flat_scene, quiet=True, device="cpu")
    assert len(os.listdir(cache_dir)) == 2

    if fault == "stale":
        bvh_cache.store_accel(path, bvh_cache.load_accel(path, _key(path)),
                              "stale-key")
    else:
        with open(path, "wb") as f:
            f.write(b"PK\x03\x04 not a zip archive")
    caplog.clear()
    third, _ = build_scene(flat_scene, quiet=True, device="cpu",
                           spatial=True)
    warned = [r for r in caplog.records if r.levelno == logging.WARNING]
    assert any(("stale" if fault == "stale" else "unreadable")
               in r.getMessage() for r in warned)
    assert "BVH (sbvh)" in caplog.text and "wrote BVH cache" in caplog.text
    _same(_arrays(first), _arrays(third))
    assert _key(path) != "stale-key"
    assert bvh_cache.load_accel(path, _key(path)) is not None


def _key(path):
    """The key stored in a cache file."""
    with np.load(path) as z:
        return bytes(z["key"]).decode()


def test_two_level_scenes_are_not_cached(tmp_path, cache_dir):
    path = write_instanced_scene(str(tmp_path / "inst"))
    scene, _ = build_scene(path, quiet=True, device="cpu", spatial=True)
    assert scene.bvh.two_level
    assert not cache_dir.exists() or not os.listdir(cache_dir)


def test_packages_never_load_each_others_files(tmp_path):
    nodes, (v0, v1, v2), packed = _packed()
    paths = [str(tmp_path / "a.obj"), str(tmp_path / "b.scene")]
    assert bvh_cache.fingerprint(paths) != jcache.fingerprint(paths)

    # JAX's file under the port's file name and key.
    key = bvh_cache.fingerprint(paths)
    path = str(tmp_path / f"b.scene.{key}.npz")
    jcache.store_accel(path, jthread(nodes, v0, v1, v2), key)
    assert jcache.load_accel(path, key) is not None
    assert bvh_cache.load_accel(path, key) is None

    # The port's file, read by JAX's loader with the port's key.
    bvh_cache.store_accel(path, packed, key)
    assert bvh_cache.load_accel(path, key) is not None
    assert jcache.load_accel(path, key) is None
