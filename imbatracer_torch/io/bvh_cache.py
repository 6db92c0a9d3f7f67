"""BVH disk cache: the port's own copy of imbatracer_tpu.io.bvh_cache
(`fingerprint`, `store_accel`, `load_accel`).

The reference serialises its acceleration structures into one container
file per scene (loaders/load_bvh.cpp:45-302).  Here the cache is one
compressed npz per flat scene holding the port's leaf-packed triangles
(accel/flatten.PackedTriangles) and their stats, keyed by a fingerprint
of the source assets so stale caches are rejected, and rebuilt from
whenever a file is stale or unreadable.  scene/build.build_scene keeps
the files in $IMBATRACER_CACHE_DIR (default: imbatracer_accel in the
temporary directory).

The JAX package writes its own layout (`ThreadedBvh`) to the same
directory under the same file-name pattern.  The port's fingerprint
mixes in `TAG` and its own `CACHE_VERSION`, so a key never matches a JAX
file's, and each file records `LAYOUT`: the port refuses a file without
it, and the JAX loader finds none of its arrays in the port's file.
"""

from __future__ import annotations

import hashlib
import os
import tempfile

import numpy as np

from ..accel.flatten import PackedTriangles
from ..utils.log import logger

CACHE_VERSION = 1  # bump when the packed layout changes
TAG = "torch"
LAYOUT = "imbatracer_torch.PackedTriangles"
_ARRAYS = ("tri_v0", "tri_e1", "tri_e2", "tri_id")
_STATS = ("nodes", "leaves", "max_depth")


def cache_dir() -> str:
    return os.environ.get("IMBATRACER_CACHE_DIR",
                          os.path.join(tempfile.gettempdir(),
                                       "imbatracer_accel"))


def fingerprint(paths: list[str], extra: str = "") -> str:
    h = hashlib.sha256()
    h.update(f"v{CACHE_VERSION}|{TAG}|{extra}".encode())
    for p in sorted(paths):
        try:
            st = os.stat(p)
            h.update(f"{p}|{st.st_size}|{st.st_mtime_ns}".encode())
        except OSError:
            h.update(f"{p}|missing".encode())
    return h.hexdigest()[:24]


def store_accel(path: str, packed: PackedTriangles, key: str) -> None:
    """Write the cache file; written to a temporary name and renamed, so
    a reader never sees half a file."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(
            f, key=np.frombuffer(key.encode(), np.uint8),
            layout=np.frombuffer(LAYOUT.encode(), np.uint8),
            **{k: getattr(packed, k) for k in _ARRAYS},
            **{f"stats_{k}": np.int64(packed.stats.get(k, 0))
               for k in _STATS})
    os.replace(tmp, path)
    logger.info("wrote BVH cache %s", path)


def load_accel(path: str, key: str) -> PackedTriangles | None:
    """Load a cached build; None when the file is absent, stale, of
    another layout or unreadable (the caller rebuilds, as the reference
    does on a magic mismatch, load_bvh.cpp:54-60)."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            if "layout" not in z or bytes(z["layout"]).decode() != LAYOUT:
                logger.warning("BVH cache of another layout (%s)", path)
                return None
            if bytes(z["key"]).decode() != key:
                logger.warning("BVH cache stale (%s)", path)
                return None
            return PackedTriangles(
                **{k: z[k] for k in _ARRAYS},
                stats={k: int(z[f"stats_{k}"]) for k in _STATS})
    except Exception as e:  # a corrupt file of any kind means a rebuild
        logger.warning("BVH cache unreadable (%s): %s", path, e)
        return None
