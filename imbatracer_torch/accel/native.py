"""ctypes binding for the port's native C++ BVH builder
(csrc/bvh_builder.cpp, compiled with g++ at first use into
build/imbatracer_torch/, see libbuild.py).

Scene assembly always builds through it: a library that does not build
or load, or a build that reports no nodes, raises.  The NumPy builder
(accel/builder.build_bvh) is never substituted, because it gives another
tree and so another tile packing.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..libbuild import NativeLib
from .builder import BvhNodes

LIB = NativeLib("bvh_builder", "bvh_builder.cpp", cuda=False)

_lib = None


def get_lib():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(LIB.build())
        lib.imba_build_bvh.restype = ctypes.c_int
        lib.imba_build_bvh.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_float,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        _lib = lib
    return _lib


def build_bvh_native(bbox_lo, bbox_hi, centers=None, leaf_size=4,
                     traversal_cost=1.0) -> BvhNodes:
    """Native binned-SAH build over primitive boxes."""
    lib = get_lib()
    n = bbox_lo.shape[0]
    lo = np.ascontiguousarray(bbox_lo, np.float32)
    hi = np.ascontiguousarray(bbox_hi, np.float32)
    if centers is None:
        centers = 0.5 * (lo + hi)
    ce = np.ascontiguousarray(centers, np.float32)

    cap = 2 * n + 2
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    right = np.empty(cap, np.int32)
    start = np.empty(cap, np.int32)
    count = np.empty(cap, np.int32)
    prim_ids = np.empty(n, np.int32)

    fp = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    ip = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
    n_nodes = lib.imba_build_bvh(
        fp(lo), fp(hi), fp(ce), n, leaf_size, ctypes.c_float(traversal_cost),
        fp(node_min), fp(node_max), ip(right), ip(start), ip(count),
        ip(prim_ids),
    )
    if n_nodes <= 0:
        raise RuntimeError(f"native BVH builder returned {n_nodes} nodes "
                           f"for {n} primitives")
    return BvhNodes(
        bbox_min=node_min[:n_nodes].copy(),
        bbox_max=node_max[:n_nodes].copy(),
        right=right[:n_nodes].copy(),
        start=start[:n_nodes].copy(),
        count=count[:n_nodes].copy(),
        prim_ids=prim_ids,
    )
