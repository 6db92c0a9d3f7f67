"""imbatracer-torch: the imbatracer wavefront renderer in PyTorch + CUDA.

A port of `imbatracer_tpu` (the JAX/Pallas package beside it, which stays
the reference).  Module layout and names mirror the JAX package so each
function's counterpart is easy to find.  The port imports torch and never
jax, and no module of the JAX package: it keeps its own copies of the host
BVH builder (`accel/`, `csrc/bvh_builder.cpp`).

Every tensor lives on a device the caller names explicitly ("cuda" or
"cpu", see `device.py`).  On CUDA tensors, traversal runs the hand-written
kernels in `csrc/` (stream_traverse.cu, and khit_traverse.cu for alpha-
masked scenes); on CPU tensors it runs their plain PyTorch versions.
"""

__version__ = "0.1.0"
