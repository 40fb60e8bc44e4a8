"""Build and load the port's hand-written CUDA kernels.

The sources under `csrc/` are compiled at first use with `nvcc` into one
shared library with a plain C interface, loaded through `ctypes`. The
library lands in `build/memex_tpu_torch/` at the repository root (listed
in .gitignore), named by a hash of the sources, so an edited `.cu`
rebuilds and an unchanged one is reused. Nothing here runs at import:
a CPU-only host imports the package without a CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

from memex_tpu.log import get_logger

logger = get_logger(__name__)

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "memex_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(_CSRC_DIR, "*.cuh")))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in ([os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []) \
            + [shutil.which("nvcc") or ""]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def library_path() -> str:
    h = hashlib.sha256()
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libmemex_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile csrc/*.cu unless the library for these sources exists.
    Returns its path; raises with nvcc's output on failure."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    cu = [p for p in _sources() if p.endswith(".cu")]
    # Compile to a private name, then rename: a concurrent build never
    # loads a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu]
    logger.info("building CUDA kernels: %s", " ".join(cmd))
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    logger.info("ptxas report:\n%s", proc.stderr[-4000:])
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            c = ctypes
            lib.memex_fused_topk.restype = c.c_int
            lib.memex_fused_topk.argtypes = [
                c.c_void_p, c.c_void_p, c.c_int, c.c_void_p,  # q, db, bf16, alive
                c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,  # v, i, v2, i2
                c.c_int, c.c_int, c.c_int,  # n_q, d, n_slots
                c.c_longlong, c.c_int, c.c_int,  # limit, exact, keep2
                c.c_void_p,  # stream
            ]
            lib.memex_fused_topk_max_dim.restype = c.c_int
            lib.memex_fused_topk_max_dim.argtypes = []
            _lib = lib
        return _lib
