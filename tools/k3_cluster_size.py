#!/usr/bin/env python3
"""Kernel K3 (``csrc/slab_thomas.cu``) with thread-block clusters of 8 and
of 16 blocks, held against ``slab_thomas_ref`` and timed on the same inputs
(device time per launch, from CUDA-graph replays), in the order 8, 16, 16,
8:

    python3 tools/k3_cluster_size.py

16 is the source's constant and runs through the port's own build; 8 is a
copy of the source with that constant changed, built into the git-ignored
``_build/``.  Prints one line per cluster size and shape, and a JSON
summary as the last line.  Needs one CUDA device and nvcc.
"""
import ctypes
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from patched_kernel import build_patched  # noqa: E402
from wavesandeigenvalues_jl_tpu_torch.ops import cuda_build  # noqa: E402
from wavesandeigenvalues_jl_tpu_torch.ops.slab_thomas import (  # noqa: E402
    build, slab_thomas_ref)
from wavesandeigenvalues_jl_tpu_torch.utils.timing import \
    device_ms  # noqa: E402

SHAPES = [(2, 60, 256), (2, 13, 128), (2, 5, 384), (1, 1, 128)]
RTOL = 1e-5
CLUSTER = "constexpr int kCluster = 16;"


def inputs(sides, m, s):
    """The seeded stream and right-hand side of chip_smoke.py's K3 phase."""
    rng = np.random.default_rng(m * s)
    shp = (sides, 2 * m, s, s)
    stream = ((rng.standard_normal(shp) + 1j * rng.standard_normal(shp))
              * (0.5 / s)).astype(np.complex64)
    bt = (rng.standard_normal((sides, m, s))
          + 1j * rng.standard_normal((sides, m, s))).astype(np.complex64)
    return torch.from_numpy(stream).cuda(), torch.from_numpy(bt).cuda()


def libraries():
    """{cluster size: library}: 16 from the port's build, 8 patched."""
    lib8 = build_patched("slab_thomas", CLUSTER,
                         CLUSTER.replace("16", "8"), "cluster8")
    fn = lib8.slab_thomas_c64
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = lib8.slab_thomas_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return {8: lib8, 16: build()["lib"]}


def run(lib, stream, bt):
    x = torch.empty_like(bt)
    sides, m, s = bt.shape
    code = lib.slab_thomas_c64(stream.data_ptr(), bt.data_ptr(),
                               x.data_ptr(), sides, m, s,
                               torch.cuda.current_stream().cuda_stream)
    cuda_build.check(lib, "slab_thomas", code)
    return x


def main():
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        sys.exit(1)
    libs = libraries()
    data = {shape: inputs(*shape) for shape in SHAPES}
    refs = {shape: slab_thomas_ref(*data[shape]) for shape in SHAPES}
    out, ok = {}, True
    for cluster in (8, 16, 16, 8):
        for shape in SHAPES:
            stream, bt = data[shape]
            x = run(libs[cluster], stream, bt)
            torch.cuda.synchronize()
            ref = refs[shape]
            rel = ((x - ref).abs().max() / ref.abs().max()).item()
            ms = device_ms(lambda: run(libs[cluster], stream, bt))
            print(f"cluster {cluster} (sides, m, s)={shape}: rel err "
                  f"{rel:.3e} (tol {RTOL:.0e}) | {ms:.4f} ms", flush=True)
            ok &= bool(rel <= RTOL)
            out.setdefault(f"{cluster} {shape}", []).append(ms)
    print(json.dumps({"ok": ok, "ms": out}), flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
