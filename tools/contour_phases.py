#!/usr/bin/env python3
"""Time the parts of the slab contour solve (path D of ``chip_smoke.py``)
on one NVIDIA GPU, at 57,210 DOF, for one chunk of 16 contour nodes.

Prints, beside the card's name and power limit: the solver's host set-up
and one chunk's host prep; one factorization pass split into the time the
host takes to issue it and the time it then waits for the card, with the
longest gap a second Python thread saw meanwhile (a gap near the pass's
length would mean the main thread holds the interpreter lock, so the prep
thread could not run); the device time of each operation of one factor
step at [16, s_max, s_max] complex64 and of a re-solve pass; one host
residual (its product in the native CSR SpMM) and the same product in
scipy.

    python3 tools/contour_phases.py
"""
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from wavesandeigenvalues_jl_tpu_torch.models.rijke import \
    large_operator_family  # noqa: E402
from wavesandeigenvalues_jl_tpu_torch.nlevp.solvers import (  # noqa: E402
    gauss_nodes, initialize_V)
from wavesandeigenvalues_jl_tpu_torch.ops import slab_solve as ss  # noqa

CONTOUR = [2 * np.pi * (150 - 5j), 2 * np.pi * (1000 - 5j),
           2 * np.pi * (1000 + 5j), 2 * np.pi * (150 + 5j)]
B, L_COLS, REPS = 16, 8, 20


def events_ms(fn):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main():
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    L = large_operator_family()
    t0 = time.perf_counter()
    sv = ss.SlabSolver(L)
    setup = time.perf_counter() - t0
    m, s = sv.part.m, sv.part.smax
    zs, _ = gauss_nodes(CONTOUR, 24)
    V = initialize_V(L.size, L_COLS)
    t0 = time.perf_counter()
    P = sv._prep_chunk(sv.coefficients(zs[:B]),
                       np.broadcast_to(V[None], (B,) + V.shape).copy())
    prep = time.perf_counter() - t0
    print(f"n={L.size} m={m} s_max={s} on {card}: solver set-up {setup:.3f} "
          f"s, one chunk's prep {prep:.3f} s", flush=True)

    gaps, stop = [], threading.Event()

    def beat():
        last = time.perf_counter()
        while not stop.is_set():
            time.sleep(0.001)
            now = time.perf_counter()
            gaps.append((now - last, now))
            last = now

    thread = threading.Thread(target=beat)
    thread.start()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d, b = sv._to_device(P["dpad"]), sv._to_device(P["bsc"])
        t1 = time.perf_counter()
        X, DT, _info = ss._factor_pass(d, b, sv._maps, s)
        t2 = time.perf_counter()
        X.cpu()
        t3 = time.perf_counter()
    finally:
        stop.set()
        thread.join()
    gap = max(g for g, at in gaps if t1 <= at <= t3 + 0.01)
    print(f"factor pass of one chunk on {card}: upload {t1 - t0:.3f} s, "
          f"issued in {t2 - t1:.3f} s, then waited {t3 - t2:.3f} s; longest "
          f"gap of a second thread {gap * 1e3:.1f} ms", flush=True)

    A = torch.randn(B, s, s, dtype=torch.complex64, device="cuda")
    y = torch.randn(B, s, L_COLS, dtype=torch.complex64, device="cuda")
    mp = sv._maps
    parts = {
        "inv_ex": lambda: torch.linalg.inv_ex(A),
        "lu_factor_ex": lambda: torch.linalg.lu_factor_ex(A),
        "matmul s x s x s": lambda: A @ A,
        "panel gather+scatter": lambda: ss._slab_panel(
            d, mp["eidx"][m // 2], mp["dest"][m // 2], s),
        "band apply (U, l=8)": lambda: ss._band_apply(
            d, mp["eidU"][m // 2], mp["colU"][m // 2], y),
        "re-solve pass": lambda: ss._resolve_pass(DT, d, b, mp),
        "double re-solve pass": lambda: ss._double_resolve_pass(DT, d, b,
                                                                mp),
    }
    for name, fn in parts.items():
        print(f"{name} at B={B}, s={s} on {card}: {events_ms(fn):.3f} ms",
              flush=True)
    lu_flops = B * 8 / 3 * s ** 3
    print(f"the LU's fp32 operations {lu_flops / 1e9:.2f} GFLOP a step",
          flush=True)

    Xj = np.ascontiguousarray(X[0].cpu().numpy().astype(np.complex128))
    t0 = time.perf_counter()
    sv._residual(P, 0, Xj)
    t1 = time.perf_counter()
    import scipy.sparse as sp
    mat = sp.csr_matrix((P["data"][0], sv._indices, sv._indptr),
                        shape=(sv.n, sv.n))
    t2 = time.perf_counter()
    mat @ Xj
    t3 = time.perf_counter()
    print(f"host residual of one shift {(t1 - t0) * 1e3:.1f} ms (native "
          f"CSR SpMM); the same product in scipy {(t3 - t2) * 1e3:.1f} ms",
          flush=True)


if __name__ == "__main__":
    main()
