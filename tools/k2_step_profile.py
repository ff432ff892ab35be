#!/usr/bin/env python3
"""Where kernel K2 (``csrc/dense_gmres.cu``) spends an Arnoldi step: a copy
of its source with ``globaltimer``/``clock64`` stamps at each phase of the
step, read at j = 0, m/2 and m − 1, in every block.

    python3 tools/k2_step_profile.py [--shape S N m cycles]

The kernel carries its stamp points as ``K2_MARK()`` and ``K2_STEP(j, m)``
hooks that compile to nothing; the copy defines them.  The shape defaults
to the main path's (2, 1408, 80, 1), on the seeded test problem of
``ops/gmres.gmres_test_problem`` (the timing does not depend on the
values: there is no early exit).

For each stamped step it prints each phase's time in block 0 (the first
row block of side 0), and the median and largest over all row blocks, from
``clock64`` differences scaled to µs by block 0's clock against
``globaltimer``, and the phases of side 0's Givens block; then the
kernel's device time with and without stamps (CUDA events over 20
launches).  Needs one CUDA device and nvcc; the copy builds into the
git-ignored ``_build/``.
"""
import argparse
import ctypes
import importlib
import os
import statistics
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from patched_kernel import build_patched  # noqa: E402
from wavesandeigenvalues_jl_tpu_torch.ops import cuda_build  # noqa: E402
from wavesandeigenvalues_jl_tpu_torch.ops.gmres import \
    gmres_test_problem  # noqa: E402
from wavesandeigenvalues_jl_tpu_torch.utils.timing import \
    events_ms  # noqa: E402

#: the wrapper module (the package's ``ops.dense_gmres`` names the function)
k2 = importlib.import_module("wavesandeigenvalues_jl_tpu_torch.ops.dense_gmres")

SAMPLES, POINTS, MAX_BLOCKS = 3, 40, 1024

#: stamp storage, the step's sample row (j = 0, m/2, m − 1, else −1) and a
#: mark: thread 0 of each block stamps the next point of its row
STAMPS = r"""
#define K2_SAMPLES 3
#define K2_POINTS 40
#define K2_MAX_BLOCKS 1024
__device__ unsigned long long k2_gt[K2_MAX_BLOCKS][K2_SAMPLES][K2_POINTS];
__device__ long long k2_ck[K2_MAX_BLOCKS][K2_SAMPLES][K2_POINTS];
__device__ int k2_state[K2_MAX_BLOCKS][2];      // row, next point
__device__ __forceinline__ void k2_begin(int j, int m)
{
    if (threadIdx.x == 0 && blockIdx.x < K2_MAX_BLOCKS) {
        k2_state[blockIdx.x][0] = j == 0 ? 0 : j == m / 2 ? 1
                                  : j == m - 1 ? 2 : -1;
        k2_state[blockIdx.x][1] = 0;
    }
}
__device__ __forceinline__ void k2_mark()
{
    if (threadIdx.x == 0 && blockIdx.x < K2_MAX_BLOCKS) {
        const int row = k2_state[blockIdx.x][0];
        const int p = k2_state[blockIdx.x][1];
        if (row >= 0 && p < K2_POINTS) {
            unsigned long long g;
            asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
            k2_gt[blockIdx.x][row][p] = g;
            k2_ck[blockIdx.x][row][p] = clock64();
        }
        k2_state[blockIdx.x][1] = p + 1;
    }
}
extern "C" int k2_read_stamps(void* gt, void* ck)
{
    cudaError_t e = cudaMemcpyFromSymbol(gt, k2_gt, sizeof(k2_gt));
    if (e == cudaSuccess)
        e = cudaMemcpyFromSymbol(ck, k2_ck, sizeof(k2_ck));
    return (int)e;
}
extern "C" int k2_clear_stamps()
{
    static unsigned long long zero[K2_MAX_BLOCKS][K2_SAMPLES][K2_POINTS];
    cudaError_t e = cudaMemcpyToSymbol(k2_gt, zero, sizeof(zero));
    if (e == cudaSuccess)
        e = cudaMemcpyToSymbol(k2_ck, zero, sizeof(zero));
    return (int)e;
}
"""

#: the kernel carries its stamp points as K2_MARK() and K2_STEP(j, m)
#: hooks, empty unless K2_PROFILE_HOOKS is defined first
HOOK = "#ifndef K2_PROFILE_HOOKS\n"
HOOK_DEF = (STAMPS + "#define K2_PROFILE_HOOKS\n"
            "#define K2_MARK() k2_mark()\n"
            "#define K2_STEP(j, m) k2_begin(j, m)\n" + HOOK)

#: the stamp points: a row block's step, and its side's Givens block's
#: step (blocks sides·G and on)
PHASES = [
    "prefetch streamed rows", "wait W[j] (norm barrier)", "norm sum + load v",
    "matvec", "proj 1 dots", "proj 1 barrier", "proj 1 partial sums",
    "proj 1 subtract", "proj 2 dots", "proj 2 barrier",
    "proj 2 partial sums", "proj 2 subtract", "norm partial + write w"]
GIVENS_PHASES = ["wait proj 1", "sum h1", "wait proj 2", "sum h2",
                 "wait norm", "sum hn", "rotate column j"]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", type=int, nargs=4,
                    default=(2, 1408, 80, 1))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        sys.exit(1)
    S, N, m, cycles = args.shape
    unstamped = k2.build()["lib"]
    lib = build_patched("dense_gmres", HOOK, HOOK_DEF, "step_profile")
    k2.bind(lib)
    err = lib.dense_gmres_error_string
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    lib.k2_read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_void_p]

    P0, b0, _, _ = gmres_test_problem(N)
    P = torch.from_numpy(P0[:S].copy()).cuda()
    b = torch.from_numpy(b0[:S].copy()).cuda()
    name = torch.cuda.get_device_name(0)
    blocks = S * k2.plan(S, N, m, k2.sm_count(P.device)).G    # row blocks
    print(f"K2 step profile at (sides, N, m, cycles) = ({S}, {N}, {m}, "
          f"{cycles}) on {name}", flush=True)
    cuda_build.check(lib, "dense_gmres", lib.k2_clear_stamps())
    k2.launch(lib, P, b, m, cycles)
    torch.cuda.synchronize()
    gt = np.zeros((MAX_BLOCKS, SAMPLES, POINTS), np.uint64)
    ck = np.zeros((MAX_BLOCKS, SAMPLES, POINTS), np.int64)
    cuda_build.check(lib, "dense_gmres", lib.k2_read_stamps(
        gt.ctypes.data, ck.ctypes.data))
    gt_all, ck_all = gt, ck
    gt, ck = gt[:blocks].astype(np.int64), ck[:blocks]
    npts = len(PHASES) + 1
    # block 0's SM clock in cycles per ns, over its three stamped steps
    span_ck = sum(int(ck[0, r, npts - 1] - ck[0, r, 0]) for r in range(3))
    span_gt = sum(int(gt[0, r, npts - 1] - gt[0, r, 0]) for r in range(3))
    ghz = span_ck / span_gt
    print(f"block 0 clock {ghz:.3f} GHz (clock64 over globaltimer); "
          f"{blocks} blocks", flush=True)
    for r, j in enumerate((0, m // 2, m - 1)):
        d = np.diff(ck[:, r, :npts], axis=1) / ghz / 1e3        # µs
        step = (ck[:, r, npts - 1] - ck[:, r, 0]) / ghz / 1e3
        print(f"j = {j}: step {step[0]:.2f} us in block 0 (median over "
              f"blocks {statistics.median(step):.2f}, max "
              f"{step.max():.2f})", flush=True)
        for k, ph in enumerate(PHASES):
            print(f"  {ph:<24s} block 0 {d[0, k]:7.3f} us | median "
                  f"{np.median(d[:, k]):7.3f} | max {d[:, k].max():7.3f}",
                  flush=True)
    # arrival spread: the latest block's step start after the earliest's
    start = gt[:, :, 0]
    print("step start, latest block after the earliest (globaltimer): "
          + ", ".join(f"j={j}: {(start[:, r].max() - start[:, r].min()) / 1e3:.2f}"
                      " us" for r, j in enumerate((0, m // 2, m - 1))),
          flush=True)
    # the Givens block of side 0, on the same SM clock scale
    gtb, ckb = gt_all[blocks].astype(np.int64), ck_all[blocks]
    ng = len(GIVENS_PHASES) + 1
    for r, j in enumerate((0, m // 2, m - 1)):
        d = np.diff(ckb[r, :ng]) / ghz / 1e3
        lag = (gtb[r, 0] - gt[0, r, 0]) / 1e3
        print(f"Givens block, column j = {j} (starts {lag:.2f} us after "
              "block 0's step): " + ", ".join(
                  f"{ph} {d[k]:.3f}" for k, ph in
                  enumerate(GIVENS_PHASES)) + " us", flush=True)

    def run(lb):
        return lambda: k2.launch(lb, P, b, m, cycles)
    t = [events_ms(run(lb)) for lb in (unstamped, lib, lib, unstamped)]
    print(f"device time over 20 back-to-back launches (CUDA events), order "
          f"unstamped, stamped, stamped, unstamped: {t[0]:.4f} / {t[1]:.4f} / "
          f"{t[2]:.4f} / {t[3]:.4f} ms; per step (unstamped) "
          f"{min(t[0], t[3]) / ((m + 1) * cycles) * 1e3:.2f} us", flush=True)


if __name__ == "__main__":
    main()
