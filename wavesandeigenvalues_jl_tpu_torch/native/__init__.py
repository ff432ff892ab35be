"""Host C++ kernels of the port: reverse Cuthill–McKee, COO duplicate
summing and a multithreaded complex CSR × panel product.

Counterpart of the JAX package's ``native/``: the same source
(``csrc/host_kernels.cpp``), the same g++ flags and the same C ABI, so
the same results.  The library is compiled on first use into
``wavesandeigenvalues_jl_tpu_torch/_build/host_kernels_<hash>.so`` (keyed
by a hash of the source, as :mod:`..ops.cuda_build` keys the kernels) and
loaded with ctypes.  There is no switch and no fallback: a failed build
raises with the compiler's output.  The numpy versions of the three
functions stay beside their callers as the plain versions the tests hold
them against (:func:`..ops.reorder.cuthill_mckee_numpy`,
:func:`..ops.sparse.coo_sum_duplicates_numpy`, ``CSR @ X``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "host_kernels.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_lib = None


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"host_kernels_{digest}.so")


def build() -> dict:
    """Compile the library if it is missing: {"path", "seconds", "log"}
    (seconds 0 for a library already built).  Raises RuntimeError with
    the compiler's output when g++ fails."""
    path = library_path()
    if os.path.exists(path):
        return {"path": path, "seconds": 0.0, "log": ""}
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build into a temp file first so concurrent processes never dlopen a
    # half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *CXX_FLAGS, SOURCE, "-o", tmp]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed ({' '.join(cmd)}): {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed ({' '.join(cmd)}):\n{proc.stderr}")
    os.replace(tmp, path)
    return {"path": path, "seconds": time.perf_counter() - t0,
            "log": proc.stderr}


def load():
    """The ctypes library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build()["path"])
            i64 = ctypes.c_int64
            p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            p_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
            lib.wae_rcm.argtypes = [i64, p_i64, p_i64, p_i64]
            lib.wae_rcm.restype = None
            lib.wae_coo_dedup.argtypes = [i64, p_i64, p_i64, p_f64, i64]
            lib.wae_coo_dedup.restype = i64
            lib.wae_csr_spmm.argtypes = [i64, i64, p_i64, p_i64, p_f64,
                                         p_f64, p_f64, i64]
            lib.wae_csr_spmm.restype = None
            _lib = lib
    return _lib


def rcm(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Reverse Cuthill–McKee permutation (new→old) of a symmetric
    adjacency without self-loops in CSR form."""
    lib = load()
    n = len(indptr) - 1
    perm = np.empty(n, dtype=np.int64)
    lib.wae_rcm(n, np.ascontiguousarray(indptr, np.int64),
                np.ascontiguousarray(indices, np.int64), perm)
    return perm


def coo_dedup(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
              n_cols: int = 0):
    """COO sort + dedup (duplicates summed, exact zeros dropped):
    (rows, cols, vals) int64/int64/complex128.  ``n_cols`` > 0 enables
    the packed-key parallel sort (requires n_rows·n_cols < 2⁶³)."""
    lib = load()
    rows = np.array(rows, np.int64, copy=True, order="C")
    cols = np.array(cols, np.int64, copy=True, order="C")
    vals = np.array(vals, np.complex128, copy=True, order="C")
    if n_cols and rows.size and int(rows.max()) >= (1 << 62) // max(n_cols, 1):
        n_cols = 0
    m = lib.wae_coo_dedup(len(rows), rows, cols,
                          vals.view(np.float64), n_cols)
    return rows[:m], cols[:m], vals[:m]


def csr_spmm(indptr, indices, data, X, n_threads: int = 0) -> np.ndarray:
    """Complex CSR @ panel X [n, k] (or a vector) in complex128 on
    ``n_threads`` host threads (0: one a hardware thread)."""
    lib = load()
    n = len(indptr) - 1
    X = np.ascontiguousarray(X, np.complex128)
    k = X.shape[1] if X.ndim == 2 else 1
    Y = np.empty((n, k), dtype=np.complex128)
    lib.wae_csr_spmm(n, k, np.ascontiguousarray(indptr, np.int64),
                     np.ascontiguousarray(indices, np.int64),
                     np.ascontiguousarray(data, np.complex128).view(np.float64),
                     X.reshape(n, k).view(np.float64),
                     Y.view(np.float64), n_threads)
    return Y if X.ndim == 2 else Y[:, 0]


__all__ = ["build", "load", "library_path", "rcm", "coo_dedup", "csr_spmm",
           "SOURCE", "BUILD_DIR"]
