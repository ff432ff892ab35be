"""Build and load the port's CUDA kernels.

Each kernel is one source ``csrc/<name>.cu`` with a plain C interface.  It
is compiled with ``nvcc`` for ``sm_90a`` into
``wavesandeigenvalues_jl_tpu_torch/_build/<name>_<hash>.so`` (keyed by a
hash of the source, so an edited source builds anew) and loaded with
ctypes.  :func:`compile_all` starts one ``nvcc`` per missing library, all
at once, and waits for them; :func:`load` then finds the library built.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
#: the kernels of the port, one source each
KERNELS = ("slab_thomas", "dense_gmres", "bsr_spmm", "window_spmm")


def source(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def library_path(name: str) -> str:
    with open(source(name), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"{name}_{digest}.so")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build "
                           "the port's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def compile_all(names=KERNELS) -> dict:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all started together.  Returns {name: {"path", "seconds",
    "log"}} (seconds 0 and an empty log for a library already built)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs, out = {}, {}
    for name in names:
        path = library_path(name)
        if os.path.exists(path):
            out[name] = {"path": path, "seconds": 0.0, "log": ""}
            continue
        # build into a temp file first so concurrent processes never dlopen
        # a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, source(name)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, cmd, tmp, path, time.perf_counter())
    failed = []
    for name, (proc, cmd, tmp, path, t0) in jobs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed ({' '.join(cmd)}):\n{log}")
            continue
        os.replace(tmp, path)
        out[name] = {"path": path, "seconds": seconds, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` if needed and load it: {"lib", "path",
    "seconds", "log"} (``lib`` a ctypes library whose C functions return a
    cudaError_t; ``<name>_error_string(int)`` names it)."""
    info = compile_all((name,))[name]
    lib = ctypes.CDLL(info["path"])
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    info["lib"] = lib
    return info


def check(lib, name: str, code: int):
    """Raise when a kernel's C entry point returned a CUDA error."""
    if code != 0:
        msg = getattr(lib, f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{name} launch failed: {msg}")


__all__ = ["KERNELS", "BUILD_DIR", "CSRC", "compile_all", "load", "check",
           "library_path", "source"]
