"""Load the JAX package's native BVH builder in this test process.

The port's scene tests compare against BVHs that JAX builds with its
native builder (imbatracer_tpu.accel.native).  That module compiles
`accel/cpp/libbvh.so` in place at first use, with no lock, and remembers
a failure for the life of the process (`_tried`).  When several pytest
workers compile it at once, one can load a half-written file, get None
and fall back to the NumPy builder, which builds another tree: the
comparisons then fail for a reason that is not the port's.

`ensure_jax_native` leaves a working library alone.  Otherwise it takes
an flock, compiles the source with the module's own flags into a file of
this process under the temporary directory (written whole, then
renamed), points the module at that file, loads it again and removes
the file; nothing is written into imbatracer_tpu/.  It raises if the
library still does not load.
"""

import fcntl
import os
import subprocess
import tempfile

from imbatracer_tpu.accel import native

# The flags of imbatracer_tpu.accel.native._compile.
FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")


def _private_build() -> str:
    d = os.path.join(tempfile.gettempdir(), "imbatracer_jax_native")
    os.makedirs(d, exist_ok=True)
    so = os.path.join(d, f"libbvh_{os.getpid()}.so")
    with open(os.path.join(d, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        tmp = f"{so}.tmp"
        res = subprocess.run(["g++", *FLAGS, "-o", tmp, native._SRC],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"compiling {native._SRC} failed:\n"
                               f"{res.stderr[:2000]}")
        os.replace(tmp, so)
    return so


def ensure_jax_native():
    """The JAX package's native builder library, loaded in this process."""
    lib = native.get_lib()
    if lib is not None:
        return lib
    native._LIB = _private_build()
    native._lib, native._tried = None, False
    lib = native.get_lib()
    if lib is None:
        raise RuntimeError(f"the JAX package's native BVH builder did not "
                           f"load from {native._LIB}")
    os.remove(native._LIB)        # loaded: the process keeps its mapping
    return lib
