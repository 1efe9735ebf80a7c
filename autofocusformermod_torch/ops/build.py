"""Build the CUDA kernels in ``csrc/`` with nvcc and load them with ctypes.

The sources have a plain C interface (no PyTorch headers).  One nvcc per
source compiles them all at once into objects, and a last nvcc links the
objects into one shared library.  The library goes to
``build/torch_kernels/`` at the repository root, named by a digest of the
sources and flags, and is built on first use.  A missing nvcc or a failed
build raises; nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("knn.cu", "lapjv.cu", "local_attn.cu", "msdetrpc.cu", "point_sample.cu",
           "window_gather.cu")
HEADERS = ("local_attn_common.cuh",)    # included by the sources; part of the digest
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
DEFAULT_CUDA_HOME = "/usr/local/cuda"

P = ctypes.c_void_p
I = ctypes.c_int
# C entry points: name -> argument types (pointers and the stream as void*)
SIGNATURES = {
    "aff_knn": [P, P, P, P, I, I, I, I, P],
    "aff_knn_pruned": [P] * 5 + [ctypes.c_longlong] + [I] * 5 + [P],
    "aff_lapjv": [P, P, I, I, I, I, P],
    "aff_local_attn": [P] * 11 + [I] * 6 + [P],
    "aff_local_attn_bwd_dq": [P] * 14 + [I] * 6 + [P],
    "aff_local_attn_bwd_dkv": [P] * 8 + [I] * 6 + [P],
    "aff_msdetrpc": [P, P, P, P, I, I, I, I, I, P, I, P],
    "aff_msdetrpc_bwd": [P] * 9 + [I] * 5 + [P, I, P],
    "aff_msdetrpc_bwd_scratch": [I, I, P, I, P],
    "aff_msdetrpc_levels": [P] * 4 + [I] * 5 + [P, I, P],
    "aff_msdetrpc_levels_bwd": [P] * 9 + [I] * 5 + [P, I, P],
    "aff_msdetrpc_levels_t": [P] * 4 + [I] * 5 + [P, I, P],
    "aff_msdetrpc_levels_t_bwd": [P] * 9 + [I] * 5 + [P, I, P],
    "aff_msdetrpc_bh": [P] * 4 + [I] * 6 + [P, I, P],
    "aff_msdetrpc_bh_bwd": [P] * 9 + [I] * 6 + [P, I, P],
    "aff_msdetrpc_interleaved": [P] * 5 + [I] * 6 + [P],
    "aff_msdetrpc_interleaved_bwd": [P] * 11 + [I] * 6 + [P],
    "aff_point_sample": [P, P, P, I, I, I, I, P],
    "aff_point_sample_bwd": [P, P, P, I, I, I, I, P],
    "aff_point_sample_bwd_shared": [P, P, P, I, I, I, I, P],
    "aff_point_sample_nearest": [P, P, P, I, I, I, I, P],
    "aff_point_sample_nearest_shared": [P, P, P, I, I, I, I, P],
    "aff_point_sample_nearest_rows": [P, P, P, P, I, I, I, I, P],
    "aff_point_sample_shared": [P, P, P, I, I, I, I, P],
    "aff_window_gather": [P, P, P, I, I, I, I, P],
    "aff_window_gather_shared": [P, P, P, I, I, I, I, P],
}


def find_nvcc() -> Optional[str]:
    """nvcc from $CUDA_HOME, then PATH, then the default toolkit location."""
    home = os.environ.get("CUDA_HOME")
    if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(DEFAULT_CUDA_HOME, "bin", "nvcc")
    return default if os.path.isfile(default) else None


def build_library(nvcc: Optional[str] = None) -> Path:
    """Compile the kernels (unless this exact build exists) and return the path."""
    nvcc = nvcc or find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (checked $CUDA_HOME/bin, PATH and "
            f"{DEFAULT_CUDA_HOME}/bin): the CUDA kernels cannot be built")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        digest.update((CSRC / name).read_bytes())
    lib = BUILD_DIR / f"libaff_kernels_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{Path(name).stem}.{tag}.o" for name in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / name)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, obj in zip(SOURCES, objs)]
    logs = [f"== {name}\n{proc.communicate()[0]}" for name, proc in zip(SOURCES, procs)]
    failed = [name for name, proc in zip(SOURCES, procs) if proc.returncode != 0]
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    (BUILD_DIR / "ptxas.log").write_text("\n".join(logs))
    for obj in objs:
        obj.unlink()
    os.replace(tmp, lib)
    return lib


@functools.cache
def load_kernels() -> ctypes.CDLL:
    """Build (first call only) and load the kernel library."""
    lib = ctypes.CDLL(str(build_library()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error (cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
