"""Build-at-first-use of the port's native libraries.

Every native source of the port lives in `imbatracer_torch/csrc/` and is
compiled on the machine that runs it, into
`build/imbatracer_torch/lib<name>_<digest>.so` at the repository root.
The digest covers the compiler, its flags and the bytes of every source
and header, so an edit rebuilds and an unchanged tree reuses the file.
A build that fails raises: nothing falls back to another implementation.

Two kinds of library:
  * CUDA kernels (`nvcc` with a plain C interface, bound with ctypes);
  * the host BVH builder (`g++`).
`build_all` compiles several at once, one compiler process each.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "imbatracer_torch")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")

# Per library name: {"seconds": build time, "log": compiler stderr} for
# the builds this process ran (empty when the library was already built).
BUILD_INFO: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "with the CUDA toolkit's nvcc")


def _gxx() -> str:
    cand = shutil.which("g++")
    if cand is None:
        raise RuntimeError("g++ not found: the port's host BVH builder "
                           "(csrc/bvh_builder.cpp) is built with g++")
    return cand


@dataclass(frozen=True)
class NativeLib:
    name: str
    source: str              # file name under csrc/
    headers: tuple = ()      # file names under csrc/ the source includes
    cuda: bool = True

    def _flags(self):
        return NVCC_FLAGS if self.cuda else GXX_FLAGS

    def path(self) -> str:
        h = hashlib.sha256((("nvcc " if self.cuda else "g++ ")
                            + " ".join(self._flags())).encode())
        for f in (self.source, *self.headers):
            with open(os.path.join(CSRC, f), "rb") as fh:
                h.update(fh.read())
        return os.path.join(BUILD_DIR,
                            f"lib{self.name}_{h.hexdigest()[:16]}.so")

    def build(self) -> str:
        """Compile (once per content digest) and return the .so path."""
        so = self.path()
        if os.path.exists(so):
            return so
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc() if self.cuda else _gxx(), *self._flags(), "-o", tmp,
               os.path.join(CSRC, self.source)]
        t0 = time.time()
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"building {self.source} failed "
                               f"({res.returncode}):\n{res.stderr}")
        os.replace(tmp, so)
        BUILD_INFO[self.name] = dict(seconds=time.time() - t0,
                                     log=res.stderr.strip())
        return so


def build_all(libs) -> list:
    """Build several libraries at once (one compiler process each);
    returns their paths in order."""
    libs = list(libs)
    with ThreadPoolExecutor(max_workers=max(len(libs), 1)) as pool:
        return list(pool.map(NativeLib.build, libs))


def ptxas_lines(name: str) -> list:
    """The entry-function, register, shared-memory and spill lines of a
    CUDA library's last build."""
    log = BUILD_INFO.get(name, {}).get("log", "")
    return [ln.strip() for ln in log.splitlines()
            if any(k in ln for k in ("entry function", "registers", "smem",
                                     "spill"))]
