"""imbatracer-torch: the imbatracer wavefront renderer in PyTorch + CUDA.

A port of `imbatracer_tpu` (the JAX/Pallas package beside it, which stays
the reference).  Module layout and names mirror the JAX package so each
function's counterpart is easy to find.  The port imports torch and never
jax, and no module of the JAX package: it keeps its own copies of the host
modules it needs (the BVH builder in `accel/` and `csrc/bvh_builder.cpp`,
the `.scene` / OBJ / image loaders in `io/`, two-level instancing in
`accel/instancing.py`).

Every tensor lives on a device the caller names explicitly ("cuda" or
"cpu", see `device.py`).  On CUDA tensors, traversal runs the hand-written
kernels in `csrc/` (stream_traverse.cu, its instanced variant included;
khit_traverse.cu for alpha-masked flat scenes; pairs_kernel.cu for the
pair queue; dispatch.cu for the sort keys, ray rows and hit resolves
around each call), shading runs pt_shade.cu and vcm_shade.cu, and merging
runs merge_kernel.cu; on CPU tensors each runs its plain PyTorch version.  `python -m imbatracer_torch <scene> <out.png>` is
the command line (`frontend/cli.py`).
"""

__version__ = "0.1.0"
