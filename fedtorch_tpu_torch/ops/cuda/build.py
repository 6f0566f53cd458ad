"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``*.cu`` under ``fedtorch_tpu_torch/csrc`` is compiled for
``sm_90a`` (Hopper) to an object of its own, all ``nvcc`` processes
started together, and the objects are linked by one more ``nvcc`` call
into one shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas=-v [per-source flags] -c src.cu -o src.o
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o lib.so *.o

The per-source flags (``SOURCE_FLAGS``, one entry for every source) give
the quantizer ``--fmad=false``, which keeps its ``scale*(q - zp) + mean``
rounding as written, and leave the attention kernels free to contract
their multiply-adds (each source's header says why). The bf16 attention
kernel writes its ``wgmma``, TMA and ``mbarrier`` PTX by hand
(``csrc/sm90_ptx.cuh``, which also holds the cluster PTX of both
attention kernels) and looks up ``cuTensorMapEncodeTiled`` through the
runtime; the TF32 one writes its ``mma.sync`` and ``cp.async`` PTX
inline. So no CUTLASS header and no ``-lcuda`` is
needed.
The library goes to ``fedtorch_tpu_torch/_build/`` (git-ignored) under a
name keyed by a hash of the sources (``*.cu`` and the ``*.cuh`` they
include) and of every flag, so an edited source or flag rebuilds and an
unchanged one loads the existing library. Nothing here runs at import: the build happens
inside the first launch. A failed compile or link raises with nvcc's
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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas=-v")
SOURCE_FLAGS = {
    "qdq_ragged.cu": ("--fmad=false",),
    "qdq_tiled.cu": ("--fmad=false",),
    "flash_fwd_sm90.cu": (),
    "flash_fwd_tf32.cu": (),
    "flash_fwd_tf32_f32.cu": (),
    "flash_fwd_tf32_bf16.cu": (),
    "flash_fwd_tf32_chunked.cu": (),
    "flash_fwd_tf32_cluster.cu": (),
}


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


def _flags(src: Path) -> tuple:
    if src.name not in SOURCE_FLAGS:
        raise RuntimeError(f"{src.name} has no entry in SOURCE_FLAGS")
    return (*COMPILE_FLAGS, *SOURCE_FLAGS[src.name])


def _run_all(cmds) -> list:
    """Run the commands at the same time; their stderr, or raise with the
    first failure's."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    logs = [p.communicate() for p in procs]
    for cmd, p, (_, err) in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed with exit code {p.returncode}:"
                               f"\n{' '.join(cmd)}\n{err}")
    return [err for _, err in logs]


def build() -> BuildResult:
    """Compile ``csrc/*.cu`` unless a library of the same sources and
    flags is already built."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    h = hashlib.sha256(" ".join(ARCH_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
        if src.suffix == ".cu":
            h.update(" ".join(_flags(src)).encode())
    out = BUILD_DIR / f"libfedtorch_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return BuildResult(out, 0.0, "")
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    t0 = time.perf_counter()
    try:
        logs = _run_all([[nvcc, *_flags(src), "-c", str(src), "-o", str(obj)]
                         for src, obj in zip(sources, objs)])
        logs += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                           *map(str, objs)]])
        os.replace(tmp, out)  # atomic: a concurrent build adopts either
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return BuildResult(out, time.perf_counter() - t0, "".join(logs))


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call and declared
    (``argtypes``/``restype`` for every entry point)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build().path))
            ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            signatures = {
                # (table, count, partials, nblocks, chunk, stream); the
                # table is a host array of 4 int64 per leaf
                "qdq_ragged_stats_f32": [ptr, i32, ptr, i64, i64, ptr],
                # (table, count, partials, nblocks, chunk, num_bits, stream)
                "qdq_ragged_apply_f32": [ptr, i32, ptr, i64, i64, i32, ptr],
                # (x, partials, rows, n, chunk, stream)
                "qdq_tiled_stats_f32": [ptr, ptr, i64, i64, i64, ptr],
                # (x, partials, out, rows, n, chunk, num_bits, stream)
                "qdq_tiled_apply_f32": [ptr, ptr, ptr, i64, i64, i64, i32,
                                        ptr],
                # (q, k, v, o, lse, last, B, T, H, D, q/k/v strides of b,
                #  t, h, scale, causal, stream)
                "flash_fwd_tc": [ptr] * 6 + [i64] * 13
                + [ctypes.c_float, i32, ptr],
                # (v, last, B, T, H, D, v strides of b, t, h, stream): the
                # wgmma kernel's pre-pass alone
                "flash_tc_last_nonfinite": [ptr] * 2 + [i64] * 7 + [ptr],
                # (q, k, v, o, lse, last, B, T, H, D, q/k/v strides of b,
                #  t, h, scale, causal, bf16, load mode, stream)
                "flash_fwd_tf32": [ptr] * 6 + [i64] * 13
                + [ctypes.c_float, i32, i32, i32, ptr],
                # (D, bf16, out: 3 int32) and (D, out): each kernel's
                # cluster launch at head dim D
                "flash_tf32_cluster_info": [i64, i32, ptr],
                "flash_tc_cluster_info": [i64, ptr],
            }
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib
