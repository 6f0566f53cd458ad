"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``*.cu`` under ``fedtorch_tpu_torch/csrc`` is compiled by one
``nvcc`` call into one shared library with a plain C interface, for
``sm_90a`` (Hopper):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         --fmad=false -shared -Xcompiler -fPIC -o lib.so csrc/*.cu

``--fmad=false`` keeps the quantizer's ``scale*(q - zp) + mean`` rounding
as written (the kernels' sources say why). The library goes to
``fedtorch_tpu_torch/_build/`` (git-ignored) under a name keyed by a hash
of the sources and flags, so an edited source rebuilds and an unchanged
one loads the existing library. Nothing here runs at import: the build
happens inside the first launch. A failed build raises with nvcc's
stderr.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")


class BuildResult(NamedTuple):
    path: Path
    seconds: float   # 0.0 when an up-to-date library was found
    log: str         # nvcc's stderr (ptxas register/spill report)


_lock = threading.Lock()
_lib = None


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH): the port's "
                           "CUDA kernels build on a machine with the CUDA "
                           "toolkit")
    return found


def build() -> BuildResult:
    """Compile ``csrc/*.cu`` unless a library of the same sources and
    flags is already built."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"libfedtorch_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return BuildResult(out, 0.0, "")
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with exit code {r.returncode}:\n"
                           f"{' '.join(cmd)}\n{r.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build adopts either
    return BuildResult(out, seconds, r.stderr)


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call and declared
    (``argtypes``/``restype`` for every entry point)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build().path))
            fn = lib.qdq_batch_f32
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib
