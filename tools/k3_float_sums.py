#!/usr/bin/env python3
"""Kernel K3 (``csrc/slab_thomas.cu``) as it is, with the sums of a step
accumulated in float64 across chunks, against a copy that sums a whole
step in float32 (the kernel before that change), on the same seeded
inputs at the paths' shapes: device time per launch (CUDA-graph replays)
in the order float64, float32, float32, float64, and each one's largest
distance to the plain version run in complex128, relative to its largest
entry:

    python3 tools/k3_float_sums.py

The float32 copy is built into the git-ignored ``_build/`` from the
source with its float64 lines replaced.  Prints one line per shape and a
JSON summary as the last line.  Needs one CUDA device and nvcc.
"""
import ctypes
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from k3_cluster_size import inputs  # noqa: E402
from patched_kernel import build_patched  # noqa: E402
from wavesandeigenvalues_jl_tpu_torch.ops import cuda_build  # noqa: E402
from wavesandeigenvalues_jl_tpu_torch.ops.slab_thomas import (  # noqa: E402
    build, slab_thomas_ref)
from wavesandeigenvalues_jl_tpu_torch.utils.timing import \
    device_ms  # noqa: E402

#: the slab path's, path H2's, path I2's and path I3's shapes
SHAPES = [(2, 60, 256), (2, 45, 768), (2, 20, 1280), (2, 24, 640)]
#: the float64 lines of the source and the float32 ones they replaced
FLOAT32_SUMS = [
    ("""    double2* part = reinterpret_cast<double2*>(carry + 2 * s);  // [256]
    uint64_t* full = reinterpret_cast<uint64_t*>(part + kConsumers);""",
     """    float2* part = carry + 2 * s;                            // [2][256]
    uint64_t* full = reinterpret_cast<uint64_t*>(part + 2 * kConsumers);"""),
    ("""            float2 rhs[kCols];
            double sr[kCols], si[kCols];             // the step's sums
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
                sr[c] = si[c] = 0.0;
                rhs[c] = make_float2(0.f, 0.f);""",
     """            float2 rhs[kCols], sum[kCols];
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
                sum[c] = make_float2(0.f, 0.f);
                rhs[c] = sum[c];"""),
    ("""                ++used;
                for (int q = 0; q < chunks; ++q, ++n) {""",
     """                ++used;
                float ar[kCols], ai[kCols];
#pragma unroll
                for (int c = 0; c < kCols; ++c)
                    ar[c] = ai[c] = 0.f;
                for (int q = 0; q < chunks; ++q, ++n) {"""),
    ("""                        const float2* u = prev + q * rows;
                        float ar[kCols], ai[kCols];  // this chunk's sums
#pragma unroll
                        for (int c = 0; c < kCols; ++c)
                            ar[c] = ai[c] = 0.f;
""", """                        const float2* u = prev + q * rows;
"""),
    ("""                        }
#pragma unroll
                        for (int c = 0; c < kCols; ++c) {
                            sr[c] += ar[c];
                            si[c] += ai[c];
                        }
                    }
                    __syncwarp();""", """                        }
                    }
                    __syncwarp();"""),
    ("""                    part[tid] = make_double2(sr[0], si[0]);
                    consumer_sync();
                    if (tid < w) {
                        sr[0] = si[0] = 0.0;
                        for (int t = 0; t < ks_count; ++t) {
                            sr[0] += part[t * w + jt].x;
                            si[0] += part[t * w + jt].y;
                        }
                    }
                }""", """                    float2* pp = part + (g & 1) * kConsumers;
                    pp[tid] = make_float2(ar[0], ai[0]);
                    consumer_sync();
                    if (tid < w)
                        for (int t = 0; t < ks_count; ++t) {
                            sum[0].x += pp[t * w + jt].x;
                            sum[0].y += pp[t * w + jt].y;
                        }
                } else {
#pragma unroll
                    for (int c = 0; c < kCols; ++c)
                        sum[c] = make_float2(ar[c], ai[c]);
                }"""),
    ("""                        const float2 y = make_float2(
                            (float)(rhs[c].x - sr[c]),
                            (float)(rhs[c].y - si[c]));""",
     """                        const float2 y = make_float2(rhs[c].x - sum[c].x,
                                                     rhs[c].y - sum[c].y);"""),
    ("""        + 2 * (size_t)s * sizeof(float2) + kConsumers * sizeof(double2)""",
     """        + (2 * (size_t)s + 2 * kConsumers) * sizeof(float2)"""),
]


def bind(lib):
    """Argument and result types of a K3 library's C entry points."""
    fn = lib.slab_thomas_c64
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = lib.slab_thomas_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def launcher(lib, st, b):
    fn = lib.slab_thomas_c64
    x = torch.empty_like(b)
    sides, m, s = b.shape

    def run():
        code = fn(st.data_ptr(), b.data_ptr(), x.data_ptr(), sides, m, s,
                  torch.cuda.current_stream().cuda_stream)
        cuda_build.check(lib, "slab_thomas", code)
        return x
    return run


def main():
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    libs = {"float64": build()["lib"],
            "float32": bind(build_patched("slab_thomas",
                                          [a for a, _ in FLOAT32_SUMS],
                                          [b for _, b in FLOAT32_SUMS],
                                          "float32_sums"))}
    out = {}
    for shape in SHAPES:
        st, b = inputs(*shape)
        ref = slab_thomas_ref(st.to(torch.complex128), b.to(torch.complex128))
        scale = ref.abs().max().item()
        runs = {k: launcher(lib, st, b) for k, lib in libs.items()}
        err = {k: (run().to(torch.complex128) - ref).abs().max().item()
               / scale for k, run in runs.items()}
        turns = [(k, device_ms(runs[k])) for k in
                 ("float64", "float32", "float32", "float64")]
        ms = {k: min(t for kk, t in turns if kk == k) for k in libs}
        print(f"K3 {shape} on {card}: device ms float64 sums "
              f"{ms['float64']:.4f}, float32 {ms['float32']:.4f} (turns "
              + " / ".join(f"{t:.4f}" for _, t in turns) + ") | against "
              f"complex128: float64 sums {err['float64']:.3e}, float32 "
              f"{err['float32']:.3e}", flush=True)
        out[str(shape)] = {"ms": ms, "turns": [t for _, t in turns],
                           "err": err}
    print(json.dumps({"card": card, "shapes": out}), flush=True)


if __name__ == "__main__":
    main()
