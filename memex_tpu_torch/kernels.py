"""Build and load the port's hand-written CUDA kernels.

The sources under `csrc/` are compiled at first use with `nvcc`, one
process per `.cu` file, all started together, and linked into one shared
library with a plain C interface, loaded through `ctypes`. The library
lands in `build/memex_tpu_torch/` at the repository root (listed in
.gitignore), named by a hash of the sources, so an edited source rebuilds
and an unchanged one is reused. Nothing here runs at import: a CPU-only
host imports the package without a CUDA toolkit.
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in (p for p in _sources() if p.endswith(".cu")):
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            logger.info("building CUDA kernels: %s", " ".join(cmd))
            objs.append(obj)
            procs.append((src, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, proc in procs:  # wait for all, so none outlives the build
            report = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {os.path.basename(src)} "
                              f"(exit {proc.returncode}):\n{report[-4000:]}")
            else:
                logger.info("ptxas report for %s:\n%s", os.path.basename(src), report[-4000:])
        if failed:
            raise RuntimeError("\n".join(failed))
        # Link to a private name, then rename: a concurrent build never
        # loads a half-written library.
        lib = os.path.join(tmp, "lib.so")
        proc = subprocess.run([nvcc, "-shared", "-o", lib, *objs], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {proc.returncode}):\n"
                               f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
        os.replace(lib, out)
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
            lib.memex_fused_topk_int8q.restype = c.c_int
            lib.memex_fused_topk_int8q.argtypes = [
                c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,  # q8, db, scales, alive
                c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,  # v, i, v2, i2
                c.c_int, c.c_int, c.c_int,  # n_q, d, n_slots
                c.c_longlong, c.c_int,  # limit, keep2
                c.c_void_p,  # stream
            ]
            lib.memex_fused_topk_int8.restype = c.c_int
            lib.memex_fused_topk_int8.argtypes = [
                c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,  # q, db, scales, alive
                c.c_void_p, c.c_void_p,  # v, i
                c.c_int, c.c_int, c.c_int, c.c_longlong,  # n_q, d, n_slots, limit
                c.c_void_p,  # stream
            ]
            lib.memex_fused_topk_int4q.restype = c.c_int
            lib.memex_fused_topk_int4q.argtypes = [
                c.c_void_p, c.c_void_p, c.c_void_p,  # qa, qb, db_p
                c.c_void_p, c.c_float, c.c_void_p,  # scales8, scale_mul, alive
                c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,  # v, i, v2, i2
                c.c_int, c.c_int, c.c_int,  # n_q, d, n_slots
                c.c_longlong, c.c_int, c.c_int,  # limit, deferred, keep2
                c.c_void_p,  # stream
            ]
            lib.memex_ivf_batch.restype = c.c_int
            lib.memex_ivf_batch.argtypes = [
                c.c_void_p, c.c_void_p, c.c_int, c.c_void_p,  # q, data, row_type, scales
                c.c_void_p, c.c_void_p, c.c_void_p,  # sizes, walk, n_chunks
                c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,  # v, i, v2, i2
                c.c_int, c.c_int, c.c_int, c.c_int,  # n_q, d, n_slots, m
                c.c_int, c.c_int,  # exact, keep2
                c.c_void_p,  # stream
            ]
            lib.memex_ivf_batch4.restype = c.c_int
            lib.memex_ivf_batch4.argtypes = [
                c.c_void_p, c.c_void_p, c.c_void_p,  # q, data4, rscales4
                c.c_void_p, c.c_void_p, c.c_void_p,  # sizes, walk, n_chunks
                c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,  # v, i, v2, i2
                c.c_int, c.c_int, c.c_int, c.c_int, c.c_int,  # n_q, d, n_slots, m, keep2
                c.c_void_p,  # stream
            ]
            lib.memex_ivf_probe.restype = c.c_int
            lib.memex_ivf_probe.argtypes = [
                c.c_void_p, c.c_void_p, c.c_int, c.c_void_p,  # q, data, row_type, scales
                c.c_void_p, c.c_void_p,  # sizes, probes
                c.c_void_p, c.c_void_p,  # v, i
                c.c_int, c.c_int, c.c_int, c.c_int, c.c_int,  # n_q, nprobe, d, n_slots, m
                c.c_void_p,  # stream
            ]
            for name in ("memex_fused_topk_max_dim", "memex_fused_topk_int8_max_dim",
                         "memex_fused_topk_int4q_max_dim", "memex_ivf_batch_max_dim",
                         "memex_ivf_batch4_max_dim", "memex_ivf_probe_max_dim"):
                getattr(lib, name).restype = c.c_int
                getattr(lib, name).argtypes = []
            _lib = lib
        return _lib
