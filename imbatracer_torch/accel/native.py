"""ctypes binding for the port's native C++ BVH builders
(csrc/bvh_builder.cpp, compiled with g++ at first use into
build/imbatracer_torch/, see libbuild.py): binned SAH (`build_bvh_native`)
and spatial splits (`build_sbvh_native`, the `--sbvh` build).

Scene assembly always builds through it: a library that does not build
or load, or a build that reports no nodes, raises.  The NumPy builder
(accel/builder.build_bvh) and the NumPy split builder (accel/sbvh.py) are
never substituted: the first gives another tree and so another tile
packing, and the second is the plain version the tests hold the native
split build against.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..libbuild import NativeLib
from .builder import BvhNodes

fp = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
ip = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))

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
        lib.imba_build_sbvh.restype = ctypes.c_int
        lib.imba_build_sbvh.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
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


def build_sbvh_native(tri_verts, leaf_size=4, alpha=1e-5,
                      ref_budget=1.5) -> BvhNodes:
    """Native spatial-split build (the reference's SplitBvhBuilder, as
    imbatracer_tpu.accel.native.build_sbvh_native); tri_verts: (N, 3, 3).
    `prim_ids` may repeat a triangle: a reference per leaf it straddles,
    at most about ref_budget x N references in all."""
    lib = get_lib()
    n = tri_verts.shape[0]
    tv = np.ascontiguousarray(tri_verts, np.float32)

    node_cap = 4 * n + 2
    max_refs = int(n * ref_budget) + 16
    node_min = np.empty((node_cap, 3), np.float32)
    node_max = np.empty((node_cap, 3), np.float32)
    right = np.empty(node_cap, np.int32)
    start = np.empty(node_cap, np.int32)
    count = np.empty(node_cap, np.int32)
    prim_ids = np.empty(max_refs, np.int32)
    num_refs = np.zeros(1, np.int32)

    n_nodes = lib.imba_build_sbvh(
        fp(tv), n, leaf_size, ctypes.c_float(alpha),
        ctypes.c_float(ref_budget),
        fp(node_min), fp(node_max), ip(right), ip(start), ip(count),
        ip(prim_ids), ip(num_refs),
    )
    if n_nodes <= 0:
        raise RuntimeError(f"native split-BVH builder returned {n_nodes} "
                           f"nodes for {n} triangles")
    return BvhNodes(
        bbox_min=node_min[:n_nodes].copy(),
        bbox_max=node_max[:n_nodes].copy(),
        right=right[:n_nodes].copy(),
        start=start[:n_nodes].copy(),
        count=count[:n_nodes].copy(),
        prim_ids=prim_ids[: int(num_refs[0])].copy(),
    )
