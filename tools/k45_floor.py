#!/usr/bin/env python3
"""Where the CSR SpMM of the large-operator apply (K4/K5) spends its time,
on the reordered 57,210-DOF operator (the passive octosplit family at
ω = 2π·300, Cuthill–McKee order) at r = 128 and r = 16.  Device time per
launch from CUDA-graph replays (``utils/timing.device_ms``) of:

(a) the warp-per-row kernel (``tools/warp_row_spmm.cu``, the design that
    ``csrc/window_spmm.cu`` replaced) as it is;
(b) a copy of it whose gather reads the row's own X row: the same FMAs,
    loads and stores, with no band gather;
(c) a copy of it that skips the inner loop: it streams only indptr, cols,
    vals and the Y stores;
(d) the byte floor of this card at this size: ``Yb.copy_(Xb)`` on the
    [n, r] complex64 panel (a yardstick here, never called by the port);
(e) the port's kernel, ``csrc/window_spmm.cu``, with its launch plan;
(f) a copy of it whose consumers compute nothing: the TMA stream of X
    through the ring, its barriers, the row bounds and zero Y stores;
(g) a copy that takes X from registers, not from the ring: no
    shared-memory reads;
(h) a copy that broadcasts no (slot, val) pair: each lane uses its own
    pair, and in-window slots only;
(i) a copy whose consumers never wait for a stage to land (their reads
    race the TMA stream);
(j) a copy that makes its (slot, val) pairs in registers: no loads of
    slots and vals;

then (a) and (e) again, in that order, so that the two are compared
within one run; and, from a copy of the port's kernel whose K45_MARK
hooks read ``clock64``, where each consumer warp spends its cycles over a
launch: issuing a tile's loads (and waiting for the last tile's pairs),
waiting for the tile's stages, the FMAs, and the Y stores and stage
releases (the median and the largest over all warps of all blocks).

    python3 tools/k45_floor.py

Needs one CUDA device and nvcc; the copies build into the git-ignored
``_build/``.
"""
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

TOOLS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(TOOLS))

from patched_kernel import build_patched  # noqa: E402
from wavesandeigenvalues_jl_tpu_torch.models.rijke import \
    large_operator_family  # noqa: E402
from wavesandeigenvalues_jl_tpu_torch.ops.bsr_spmm import \
    random_panel  # noqa: E402
from wavesandeigenvalues_jl_tpu_torch.ops.reorder import (  # noqa: E402
    cuthill_mckee, permute_csr)
from wavesandeigenvalues_jl_tpu_torch.ops.window_spmm import (  # noqa: E402
    CONSUMER_WARPS, WindowSpmm, bind, launch)
from wavesandeigenvalues_jl_tpu_torch.utils.timing import \
    device_ms  # noqa: E402

#: the warp-per-row kernel's source, a yardstick kept beside the tools
WARP_ROW = os.path.join(TOOLS, "warp_row_spmm.cu")
OMEGA = 2 * np.pi * 300.0
WIDTHS = (128, 16)
#: (b) gathers the row's own X row; the select keeps the shuffle and the
#: load inside the loop
GATHER = "const int cj = __shfl_sync(0xffffffffu, col, j);"
OWN_ROW = ("const int cj = __shfl_sync(0xffffffffu, col, j) < 0 ? 0 : "
           "row;")
#: (c) runs no inner loop; the sum keeps the loads of cols and vals alive
INNER = "const int cnt = min(32, end - base);"
NO_INNER = "acc[0].x += v.x + v.y + (float)col; const int cnt = 0;"
#: the port kernel's lines that (f)-(i) change
ROUNDS = "const int rounds = (most + kLanes - 1) / kLanes;"
RING_READ = ("const float4 x = *reinterpret_cast<const float4*>(row + "
             "off[u]);")
SHUFFLES = ["s[j] = __shfl_sync(0xffffffffu, sm, j, kLanes);",
            "const float ax = __shfl_sync(0xffffffffu, am.x, j, kLanes);",
            "const float ay = __shfl_sync(0xffffffffu, am.y, j, kLanes);"]
TILE_WAIT = "mbar_wait(full + j % kStages, (waited / kStages) & 1);"
PORT_COPIES = {
    "(f) stream and barriers only": (ROUNDS, ROUNDS.replace(
        "= (most", "= 0 & (most")),
    "(g) X from registers": (RING_READ,
                             "const float4 x = make_float4(a[j].x, a[j].y, "
                             "__int_as_float(s[j]), (float)u);"),
    "(h) no pair broadcast": (SHUFFLES, [
        "s[j] = (sm + j) & 1023;", "const float ax = am.x + j;",
        "const float ay = am.y;"]),
    "(i) no wait for a stage": (TILE_WAIT, "(void)j;"),
    "(j) pairs from registers": (
        ["s[m] = __ldg(slots + k);", "a[m] = __ldg(vals + k);"],
        ["s[m] = k & 1023;", "a[m] = make_float2(1.f, (float)k);"])}


#: the stamped copy: per warp, the cycles of each phase summed over its
#: tiles, kept in a device array the tool reads back
HOOK = "#ifndef K45_PROFILE_HOOKS\n"
STAMPS = r"""
#define K45_BLOCKS 1024
__device__ long long k45_cycles[K45_BLOCKS][32][4];
#define K45_BEGIN() long long k45_last = clock64(); \
    long long k45_acc[4] = {0, 0, 0, 0};
#define K45_MARK(phase) { const long long now = clock64(); \
    k45_acc[phase] += now - k45_last; k45_last = now; }
#define K45_END() if (lane == 0 && blockIdx.x < K45_BLOCKS) \
    for (int p = 0; p < 4; ++p) k45_cycles[blockIdx.x][warp][p] = k45_acc[p];
extern "C" int k45_read(void* out)
{
    return (int)cudaMemcpyFromSymbol(out, k45_cycles, sizeof(k45_cycles));
}
#define K45_PROFILE_HOOKS
"""
PHASES = ["loads issued, last pairs in", "wait for stages", "FMAs",
          "Y stores, releases"]


def warp_row_fn(lib):
    fn = lib.warp_row_spmm_c64
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def warp_row_libs():
    """{label: C entry point} of (a), (b) and (c)."""
    return {"(a) warp per row": warp_row_fn(build_patched(
                "warp_row_spmm", [], [], "as_is", WARP_ROW)),
            "(b) own X row, no band gather": warp_row_fn(build_patched(
                "warp_row_spmm", GATHER, OWN_ROW, "own_row", WARP_ROW)),
            "(c) no inner loop": warp_row_fn(build_patched(
                "warp_row_spmm", INNER, NO_INNER, "no_inner", WARP_ROW))}


def main():
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    fns = warp_row_libs()
    port_libs = {label: bind(build_patched("window_spmm", old, new,
                                           label[1]))
                 for label, (old, new) in PORT_COPIES.items()}
    stamped = bind(build_patched("window_spmm", HOOK, STAMPS + HOOK,
                                 "stamped"))
    stamped.k45_read.argtypes = [ctypes.c_void_p]
    L = large_operator_family()
    L.params[L.eigval] = OMEGA
    A = L.assemble({})
    Ar = permute_csr(A, cuthill_mckee(A))
    n = Ar.shape[0]
    print(f"operator: n = {n}, nnz = {Ar.nnz}", flush=True)
    for r in WIDTHS:
        op = WindowSpmm.from_csr(Ar, nrhs=r, device="cuda")
        Xd = op.panel(random_panel(n, r, seed=r))
        Y = torch.empty_like(Xd)
        ptrs = [t.data_ptr() for t in (op.indptr, op.cols, op.vals, Xd, Y)]

        def run(fn):
            def call():
                code = fn(*ptrs, n, r,
                          torch.cuda.current_stream().cuda_stream)
                if code:
                    raise RuntimeError(f"launch failed: {code}")
            return call

        times = {label: device_ms(run(fn)) for label, fn in fns.items()}
        times["(d) Yb.copy_(Xb)"] = device_ms(lambda: Y.copy_(Xd))
        port = "(e) csrc/window_spmm.cu"
        times[port] = device_ms(lambda: op.apply(Xd))
        lp = op.launch_plan(r)
        for label, lib in port_libs.items():
            times[label] = device_ms(
                lambda lib=lib: launch(lib, op.vals, Xd, lp))
        again = (device_ms(run(fns["(a) warp per row"])),
                 device_ms(lambda: op.apply(Xd)))
        print(f"r = {r}, device ms per launch (CUDA graphs of 20): " +
              "; ".join(f"{k} {v:.4f}" for k, v in times.items()) +
              f"; again (a) {again[0]:.4f}, (e) {again[1]:.4f}", flush=True)
        launch(stamped, op.vals, Xd, lp)
        torch.cuda.synchronize()
        cycles = np.zeros((1024, 32, 4), np.int64)
        code = stamped.k45_read(cycles.ctypes.data)
        if code:
            raise RuntimeError(f"reading the stamps failed: {code}")
        warps = cycles[:lp.blocks, :CONSUMER_WARPS].reshape(-1, 4)
        total = warps.sum(1)
        print(f"r = {r}, cycles of a consumer warp over one launch "
              f"(stamped copy; {lp.blocks} blocks x {CONSUMER_WARPS} "
              f"warps): total median {np.median(total):.0f}, max "
              f"{total.max()}; " + "; ".join(
                  f"{ph} median {np.median(warps[:, k]):.0f} max "
                  f"{warps[:, k].max()}" for k, ph in enumerate(PHASES)),
              flush=True)


if __name__ == "__main__":
    main()
