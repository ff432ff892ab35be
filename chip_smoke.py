#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Builds the port's four kernels from ``wavesandeigenvalues_jl_tpu_torch/
csrc`` (one ``nvcc`` per source, started together), holds each against its
plain PyTorch version on the card, and drives the port's paths once at
their real size, each with the launch counters set to 0 just before it:

* the slab local eigensolve: ``mslp`` on the 7,259-DOF active Rijke tube
  through the slab engine and the block-Thomas kernel K3;
* path A, the dense local eigensolve: ``mslp`` on the 1,369-DOF active
  Rijke tube through ``FusedPencilSolver`` and the dense GMRES kernel K2;
* path B, the operator apply Y = L(ω)·X on the 7,259-DOF family and a
  128-column panel through the BSR SpMM kernel K1 (the blocks' nonzeros
  only), at bs = 32, 64, 128;
* path C, the large-operator apply: ``operator_apply(kernel="window")`` on
  the 57,210-DOF octosplit passive family and a 128-column panel through
  the CSR SpMM kernel that stands for K4 and K5;
* path D, the contour: Beyn on path C's family through the slab direct
  solver (``ops/slab_solve.SlabSolver``: plain PyTorch, no kernel of its
  own), checked against the pinned JAX host Beyn modes, then the 437-DOF
  passive family through the "host", "dense" and "slab" backends;
* path E, the general local engine (plain PyTorch, no kernel of its own):
  ``householder(order=3)`` on the 4,087-DOF active Rijke tube through
  ``DeviceLU`` (complex128 LU and the dual Arnoldi on the card), the
  order-16 perturbation series in n with its Padé [8/8] value, and
  ``householder(order=2)`` at 437 DOF on the "device_gmres" backend, each
  against pinned JAX host values; then a report of ``DeviceGMRES``'s
  refined residual on the 7,259-DOF operator (ROADMAP.md Queue 3, F4);
* path F, the matrix-free contour: Beyn on the 55,401-DOF passive family
  (``rijke_mesh(3, 12, 12)`` octosplit twice) through the panel GMRES with
  the ``MultiGrid`` V-cycle over the 7,415- and 999-DOF ancestors
  (``ops/panel_solve``: plain PyTorch, no kernel of its own), against the
  pinned JAX host Beyn modes;
* path G, the parameter study: ``track_branch`` over six flame delays τ on
  the 4,087-DOF active family (each ``mslp`` through the slab engine and
  K3, each Taylor jet through ``DeviceLU``), and the two-point Padé of its
  first two jets, against pinned JAX host values; then K3 against its
  plain version on the first and the last of G1's own K3 inputs, at G's
  slab shape (2, 18, 256).

Every phase prints one line and any failure exits non-zero.  The
second-to-last line is the kernels' JSON record, the last line the device
record:

    python3 chip_smoke.py

Needs one CUDA device; exits 1 without one.
"""
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

Z0 = 340 * 2 * np.pi
#: JAX host mslp (complex128 sparse LU) on the 7,259-DOF active family
OMEGA_7259 = 1086.2565809909638 + 375.8712163601356j
#: JAX host mslp on the 1,369-DOF active family (n_rings=3, nz 17 + 17)
OMEGA_1369 = 1075.8988207005789 + 376.3799204921555j
#: the tolerance of the JAX package's tests/test_fused_slab.py:47
OMEGA_RTOL = 1e-8
#: K3 against its plain version: float32 sums in another order over 2m steps
K3_RTOL = 1e-5
#: K1, K2 and K3 are held against their plain versions on this many
#: launches, each into its own output: a race in their barriers shows on
#: some only
REPEATS = 50
#: (sides, m, s) of the 7,259-DOF slice, of the 437-DOF test family, and a
#: wider s with a short m
K3_SHAPES = [(2, 60, 256), (2, 13, 128), (2, 5, 384)]
#: K2 against its plain version on the JAX test problem (float32 sums in
#: another order) and that test's residual bar (test_pallas_gmres.py:49)
K2_RTOL, K2_RES = 1e-5, 5e-6
#: K2 against its plain version at the main-path shape: 80 Arnoldi steps
#: of float32 sums in another order on a penalty-scaled operator
K2_MAIN_RTOL = 1e-4
#: operator apply against the complex128 host CSR product, per entry
#: relative to (|A|·|X|): complex64 data and sums
K1_RTOL = 1e-5
OMEGA_APPLY = 2 * np.pi * 300.0
K1_BLOCK_SIZES = (32, 64, 128)
#: the JAX bench's large operator (BENCH_DETAIL.json "large_operator")
LARGE_DIM, LARGE_NNZ = 57210, 819730
#: the large apply against the complex128 host product, globally: the JAX
#: bench's bar (bench.py:585)
LARGE_GLOBAL_RTOL = 5e-5
#: panel widths of the K4/K5 comparison: the main path's, and a small one
K45_WIDTHS = (128, 16)
#: chain(20) against the plain chain, globally: 20 applies of float32 sums
#: in another order, each normalized
CHAIN_M, CHAIN_RTOL = 20, 1e-5
#: the warp-per-row CSR SpMM that csrc/window_spmm.cu replaced: a yardstick
#: timed beside it, never called by the port
TOOLS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools")
WARP_ROW = os.path.join(TOOLS, "warp_row_spmm.cu")
#: Beyn's contour of tests/test_slab_solve.py:86-88 (150–1000 Hz at ±5 Hz;
#: 4 edges × 24 nodes) and its arguments
CONTOUR = [2 * np.pi * (150 - 5j), 2 * np.pi * (1000 - 5j),
           2 * np.pi * (1000 + 5j), 2 * np.pi * (150 + 5j)]
CONTOUR_KW = dict(l=8, N=24, rtol=1e-12, res_tol=1e-6)
#: JAX host Beyn (complex128 SuperLU per node) on path C's 57,210-DOF
#: passive family, computed with the JAX package as
#:   mesh = octosplit(rijke_mesh(n_rings=4, nz_cold=58, nz_hot=58))
#:   L = discretize(mesh, {"Interior": ("interior", ()),
#:                         "Outlet": ("admittance", ("Y", 1e15))},
#:                  mesh.generate_field(c, order="lin"))
#:   beyn(L, CONTOUR, l=8, N=24, rtol=1e-12, res_tol=1e-6, backend="host")
#: with c = sqrt(1.4·287.05·T), T = 300 K for z < 0 and 1200 K above
OMEGA_57K = (1710.9389595206271 - 6.717168685029256e-09j,
             4363.358767721035 - 6.6306878059490884e-09j)
#: the same call on the 437-DOF passive family (rijke_mesh(n_rings=2,
#: nz_cold=10, nz_hot=10))
OMEGA_437_PASSIVE = (1713.1997319995933 + 5.834139044672012e-10j,
                     4373.996493943504 + 1.296587899289208e-09j)
#: each 57,210-DOF mode within this × f of JAX's; the bar of the slab
#: solves' max relres: the refine_tol of the JAX package's own slab contour
#: run (SCALE.json "solver"; the solver refines toward its default 1e-11);
#: the small backends within 1e-6 Hz
CONTOUR_RTOL, CONTOUR_RELRES, SMALL_HZ_ATOL = 1e-7, 1e-8, 1e-6
#: the JAX package's sweep cap of the slab refinement (the port's is 12),
#: run once more on the 57,210-DOF contour to show what it leaves
JAX_SWEEP_CAP = 4
#: path E: JAX host (complex128 SuperLU) on the 4,087-DOF active family
#: (rijke_mesh(n_rings=4, nz_cold=32, nz_hot=32)):
#:   sol, n, flag = householder(L, Z0, maxiter=12, tol=1e-9, order=3)
#: (4 iterations, flag 0), then perturb(sol, L, "n", 16): its c1..c4, the
#: [8/8] Padé value sol("n", 0.5, 8, 8), and householder(order=3) re-solved
#: at n = 0.5 from sol's ω
OMEGA_4087_H3 = 1086.7599456500598 + 377.11803455561125j
PERT_4087_C = (-364.37890125585517 - 116.41422973501396j,
               242.27005455348984 + 18.745206142649923j,
               -193.28905011592644 + 34.56470736768021j,
               163.28275989263645 - 73.14140918834569j)
PADE_4087_88 = 1370.7464868377333 + 422.5851856222397j
OMEGA_4087_N05 = 1370.7464868459433 + 422.585185713891j
#: the bars of c1..c4 (relative) and of the Padé value (× |ω|)
PERT_RTOL, PADE_RTOL = 1e-8, 1e-7
#: JAX host householder(L437, Z0, maxiter=12, tol=1e-9, order=2)
OMEGA_437_H2 = 1074.9363291293967 + 373.15894122636877j
#: JAX DeviceGMRES(L7259(Z0)) at its defaults, complex128 on the CPU: the
#: relative residual its refined solve returns for the rhs
#: default_rng(0) normal + 1j·normal, for "N" and "H" (ROADMAP Queue 3 F4)
F4_JAX_RELRES = (0.04042617386794759, 0.015015369539456725)
#: path F: the passive family on rijke_mesh(n_rings=3, nz_cold=12,
#: nz_hot=12) and its first and second octosplit: (n, nnz) per level
PANEL_LEVELS = ((999, 13831), (7415, 103387), (55401, 764449))
#: JAX host Beyn (complex128 SuperLU per node) on the 55,401-DOF level,
#: over CONTOUR with CONTOUR_KW, computed on the CPU with the JAX package by
#:   JAX_PLATFORMS=cpu PYTHONPATH=. python3 tools/jax_references.py beyn55k
OMEGA_55K = (1710.3374635599298 + 1.3872286915322489e-08j,
             4363.757748186899 - 1.7946134867430164e-09j)
#: path G: JAX track_branch(L4087, "τ", linspace(1e-3, 2e-3, 6), Z0,
#: order=2) on its "host" backend, computed on the CPU by
#:   JAX_PLATFORMS=cpu PYTHONPATH=. python3 tools/jax_references.py track
#: each point's ω and flag, and multipoint_pade(2, 3, ...) of the first two
#: jets at their midpoint
TRACK_TAUS = np.linspace(1e-3, 2e-3, 6)
TRACK_4087_OMEGA = (1086.759945650055 + 377.1180345556135j,
                    1027.2698461922564 + 440.5132184709328j,
                    959.5543980782559 + 487.0420955618803j,
                    891.2832282679909 + 516.8965740155245j,
                    827.2628863887685 + 533.6289013387345j,
                    769.3692291098627 + 541.1393130877415j)
TRACK_4087_FLAGS = (0, 0, 0, 0, 0, 0)
PADE2PT_4087 = 1058.5523879995233 + 410.709142172364j
#: path G's bars: each ω and the two-point Padé value, relative
TRACK_RTOL = 1e-8
#: published peaks of one H100 SXM (HBM3 bandwidth, dense FP32 rate)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of the bytes over HBM bandwidth and
    the float32 operations over the non-tensor fp32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device():
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    import wavesandeigenvalues_jl_tpu_torch  # noqa: F401  (sets TF32 flags)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    print(card, flush=True)
    print(f"device: torch {torch.__version__} cuda "
          f"{torch.version.cuda} | tf32 matmul={tf32[0]} cudnn={tf32[1]} "
          f"fp32 precision={tf32[2]}", flush=True)
    check(tf32 == (False, False, "highest"), f"TF32 not off: {tf32}")
    return card


def phase_build():
    """One nvcc per kernel source, all started together (the port's four,
    and the warp-per-row yardstick of K4/K5 through
    ``tools/patched_kernel.build_patched`` with no line changed), then load
    each."""
    import importlib
    from concurrent.futures import ThreadPoolExecutor

    sys.path.insert(0, TOOLS)
    from patched_kernel import build_patched

    from wavesandeigenvalues_jl_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        yardstick = pool.submit(build_patched, "warp_row_spmm", [], [],
                                "as_is", WARP_ROW)
        info = cuda_build.compile_all()
        lib = yardstick.result()
    wall = time.perf_counter() - t0
    for name in cuda_build.KERNELS:
        importlib.import_module(
            f"wavesandeigenvalues_jl_tpu_torch.ops.{name}").build()
    for name, rec in info.items():
        ptxas = " ".join(ln.strip() for ln in rec["log"].splitlines()
                         if "registers" in ln or "spill" in ln)
        print(f"build: {name} {rec['path']} nvcc {rec['seconds']:.2f} s | "
              f"{ptxas}", flush=True)
    print(f"build: {len(info)} kernels and the warp-per-row yardstick in "
          f"{wall:.2f} s of wall, loaded in {time.perf_counter() - t0:.2f} s",
          flush=True)
    fn = lib.warp_row_spmm_c64
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _median_ms(fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _library_ms(fn, what):
    """(ms, device ms, text) of a PyTorch yardstick call: the median per
    call with the host's launch, as for every kernel, and the device time
    per call (``utils.timing.device_ms``: CUDA-graph replays); (None,
    None, why) where PyTorch refuses it.  The yardstick is not the port,
    so its refusal does not fail the run."""
    from wavesandeigenvalues_jl_tpu_torch.utils.timing import device_ms
    try:
        ms, dev = _median_ms(fn), device_ms(fn)
    except RuntimeError as e:
        return None, None, f"{what} refused: {str(e).splitlines()[0]}"
    return ms, dev, f"{what} {ms:.4f} ms a call, {dev:.4f} ms on the device"


def _max_err(fn, ref, what):
    """(max |fn() − ref|, outputs) over REPEATS launches, each into its own
    output (launched back to back, compared after); fails on a non-finite
    one."""
    outs = [fn() for _ in range(REPEATS)]
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(y).all()) for y in outs),
          f"{what}: non-finite output")
    return max((y - ref).abs().max().item() for y in outs), outs


def _wrappers():
    from wavesandeigenvalues_jl_tpu_torch.ops import (bsr_spmm, dense_gmres,
                                                      slab_thomas, window_spmm)
    return slab_thomas, dense_gmres, bsr_spmm, window_spmm


def reset_counts():
    for fn in _wrappers():
        fn.launches = 0
        fn.twin_calls = 0


def read_counts():
    return {fn.__name__: (fn.launches, fn.twin_calls) for fn in _wrappers()}


def _compare_k3(st, b, label):
    """K3 against slab_thomas_ref on the card on one input (stream
    [sides, 2m, s, s], rhs [sides, m, s]): print its line, check it at
    K3_RTOL and return its record."""
    from wavesandeigenvalues_jl_tpu_torch.ops.slab_thomas import (
        slab_thomas, slab_thomas_ref)
    from wavesandeigenvalues_jl_tpu_torch.utils.timing import device_ms
    sides, m, s = b.shape
    ref = slab_thomas_ref(st, b)
    err, _ = _max_err(lambda: slab_thomas(st, b), ref, f"K3 {label}")
    rel = err / ref.abs().max().item()
    ms = _median_ms(lambda: slab_thomas(st, b))
    dev_ms = device_ms(lambda: slab_thomas(st, b))
    plain_ms = _median_ms(lambda: slab_thomas_ref(st, b))
    # stream read once, bt read once, x written once; 8 flops per
    # complex multiply-add of the 2m [1,s]x[s,s] products
    bound_ms, bound_by = bound(
        8 * (st.numel() + 2 * b.numel()), 8 * sides * 2 * m * s * s)
    gbs = sides * 2 * m * s * s * 8 / (dev_ms * 1e-3) / 1e9
    print(f"K3 (sides, m, s)=({sides}, {m}, {s}) {label}: max abs err over "
          f"{REPEATS} launches {err:.3e} rel {rel:.3e} (tol "
          f"{K3_RTOL:.0e}) | kernel {ms:.4f} ms a call with the host's "
          f"launch, {dev_ms:.4f} ms on the device ({gbs:.1f} GB/s of "
          f"stream, {dev_ms / (2 * m) * 1e3:.2f} us a step), plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); no "
          "single PyTorch call computes the block recursion",
          flush=True)
    check(rel <= K3_RTOL,
          f"K3 {label} disagrees with its plain version: {rel}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "device_ms": dev_ms, "library_device_ms": None}


def phase_compare_k3():
    """K3 against slab_thomas_ref on the card, at the slice's shapes, on
    seeded random inputs."""
    out = {}
    for sides, m, s in K3_SHAPES:
        rng = np.random.default_rng(m * s)
        shp = (sides, 2 * m, s, s)
        stream = ((rng.standard_normal(shp) + 1j * rng.standard_normal(shp))
                  * (0.5 / s)).astype(np.complex64)
        bt = (rng.standard_normal((sides, m, s))
              + 1j * rng.standard_normal((sides, m, s))).astype(np.complex64)
        out[(sides, m, s)] = _compare_k3(torch.from_numpy(stream).cuda(),
                                         torch.from_numpy(bt).cuda(),
                                         "random")
    return out


def _first_dense_step(L):
    """P [2, N, N] and the preconditioned rhs [2, N] of the first K2 launch
    of the dense mslp from Z0 (σ = 0, v = w = ones)."""
    from wavesandeigenvalues_jl_tpu_torch.nlevp.fused_local import \
        FusedPencilSolver
    solver = FusedPencilSolver(L, "cuda")
    c, _ = solver.coefficients(complex(Z0))
    solver.refresh_bj(c, 0.0)
    ct = torch.from_numpy(c).cuda()
    _, g = solver.solve_data(ct, torch.zeros((), dtype=torch.complex128,
                                             device="cuda"))
    ones = torch.ones(2, solver.n, dtype=torch.complex64, device="cuda")
    b = solver._spmv(solver.mdat2.to(torch.complex64), ones)
    return solver.operators(g), solver.preconditioned(b)


def _gmres_flops(S, N, m, cycles):
    """float32 operations of GMRES(m) from x0 = 0: m matvecs a cycle plus
    one for the residual of each restart (the first cycle's is b), CGS2
    dots and updates, norms and x += V y over the m basis vectors."""
    matvecs = m * cycles + cycles - 1
    per = 32 * N * m * (m + 1) // 2 + (m + 1) * 4 * N + 8 * N * m
    return S * (matvecs * 8 * N * N + cycles * per)


def phase_compare_k2(L1369):
    """K2 against dense_gmres_ref on the card over REPEATS launches (each
    into its own output, every one the same bits), with torch.linalg.solve
    as the library yardstick."""
    from wavesandeigenvalues_jl_tpu_torch.ops.dense_gmres import (
        dense_gmres, dense_gmres_ref, plan, sm_count)
    from wavesandeigenvalues_jl_tpu_torch.ops.gmres import gmres_test_problem
    from wavesandeigenvalues_jl_tpu_torch.utils.timing import (device_ms,
                                                               events_ms)
    out = {}
    P, b, Gs, b_host = gmres_test_problem(256)
    cases = [((2, 256, 30, 2), torch.from_numpy(P).cuda(),
              torch.from_numpy(b).cuda())]
    P1, b1 = _first_dense_step(L1369)
    cases.append(((2, P1.shape[1], 80, 1), P1, b1))
    for (S, N, m, cycles), P, b in cases:
        ref = dense_gmres_ref(P, b, m, cycles)
        err, xs = _max_err(lambda: dense_gmres(P, b, m, cycles), ref,
                           f"K2 {N}")
        same = all(torch.equal(y, xs[0]) for y in xs)
        x = xs[0]
        del xs
        rel = err / ref.abs().max().item()
        # preconditioned residuals ‖P x − b‖/‖b‖ of kernel and plain
        res = [((P @ y.unsqueeze(-1)).squeeze(-1) - b).norm(dim=-1)
               .div(b.norm(dim=-1)).max().item() for y in (x, ref)]
        ms = _median_ms(lambda: dense_gmres(P, b, m, cycles))
        dev_ms = device_ms(lambda: dense_gmres(P, b, m, cycles))
        plain_ms = _median_ms(lambda: dense_gmres_ref(P, b, m, cycles),
                              reps=3, warmup=1)
        # the yardstick solves the same systems with the padding rows of
        # P (all zero, with zero rhs) given a unit diagonal, since
        # torch.linalg.solve refuses a singular matrix
        Pl = P.clone()
        dead = Pl.abs().sum(-1) == 0
        Pl.diagonal(dim1=-2, dim2=-1)[dead] = 1
        # cuSOLVER refuses graph capture: its device time is taken by
        # CUDA events over back-to-back calls
        library_ms = _median_ms(lambda: torch.linalg.solve(Pl, b))
        library_dev = events_ms(lambda: torch.linalg.solve(Pl, b))
        library = (f"torch.linalg.solve {library_ms:.4f} ms a call, "
                   f"{library_dev:.4f} ms by CUDA events over 20 "
                   "back-to-back calls")
        bound_ms, bound_by = bound(8 * (P.numel() + 2 * b.numel()),
                                   _gmres_flops(S, N, m, cycles))
        pl = plan(S, N, m, sm_count(P.device))
        step_us = dev_ms / ((m + 1) * cycles) * 1e3
        line = (f"K2 (sides, N, m, cycles)=({S}, {N}, {m}, {cycles}), "
                f"{pl.G} row blocks of {pl.R} rows a side ({pl.res} "
                f"resident) + {S} Givens blocks, {pl.smem} B of shared "
                f"memory: over {REPEATS} launches max abs err {err:.3e} "
                f"rel {rel:.3e}, every launch the same bits: {same} | "
                f"residual ‖Px−b‖/‖b‖ kernel {res[0]:.3e} plain "
                f"{res[1]:.3e} | kernel {ms:.4f} ms a call, {dev_ms:.4f} ms "
                f"on the device ({step_us:.2f} us a step), plain "
                f"{plain_ms:.4f} ms, {library}, bound {bound_ms:.4f} ms "
                f"({bound_by})")
        if cycles == 2:
            xh = x.cpu().numpy().astype(np.complex128)
            true = [np.linalg.norm(Gs[s] @ xh[s] - b_host)
                    / np.linalg.norm(b_host) for s in range(2)]
            line += (f" | true residuals {true[0]:.3e} {true[1]:.3e} (tol "
                     f"{K2_RES:.0e})")
        print(line, flush=True)
        tol = K2_RTOL if cycles == 2 else K2_MAIN_RTOL
        check(rel <= tol, f"K2 disagrees with its plain version at N={N}: "
              f"{rel:.3e} > {tol:.0e}")
        check(same, f"K2 launches at N={N} differ")
        if cycles == 2:
            check(max(true) <= K2_RES, f"K2 residual {max(true):.3e}")
        out[(S, N, m, cycles)] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "device_ms": dev_ms,
            "library_device_ms": library_dev}
    return out


def _run_mslp(L, label, expected_n, omega_ref, solver_cls, kernel):
    """Drive mslp on the card with the counters set to 0 just before it;
    print its line, check it, and return the counts read just after.  The
    fused engine must carry the whole solve: its hand-over to the general
    engine (a non-finite device step) is an error here, every iteration
    must be one of its device or polish steps, and no phase of the general
    engine may have run."""
    import warnings

    from wavesandeigenvalues_jl_tpu_torch.nlevp import mslp
    from wavesandeigenvalues_jl_tpu_torch.utils import timing

    check(L.size == expected_n, f"family dimension {L.size}, expected "
          f"{expected_n}")
    timing.reset()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="fused device step",
                                category=RuntimeWarning)
        sol, n_it, flag = mslp(L, Z0, maxiter=30, tol=1e-11)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    rep = timing.report()

    om = sol.params[sol.eigval]
    rel = abs(om - omega_ref) / abs(omega_ref)
    solver = L._fused_solver[1]
    none = {"calls": 0, "total_s": 0.0}
    steps = rep.get("fused_local.device_step", none)
    polish = rep.get("fused_local.polish_step", none)
    setup = rep.get("fused_local.setup", none)
    print(f"{label}: n={L.size} {type(solver).__name__} | mslp wall "
          f"{wall:.3f} s (setup {setup['total_s']:.3f} s, {steps['calls']} "
          f"device steps {steps['total_s']:.3f} s, {polish['calls']} polish "
          f"steps {polish['total_s']:.3f} s) | iterations {n_it} flag {flag} "
          f"| omega {om!r} rel err {rel:.3e} (tol {OMEGA_RTOL:.0e}) | "
          f"launches, plain calls {counts} | peak device memory "
          f"{peak / 2**20:.1f} MiB", flush=True)
    check(isinstance(solver, solver_cls),
          f"{label}: solver {type(solver).__name__}")
    check(flag == 0, f"{label}: mslp flag {flag}")
    check(rel <= OMEGA_RTOL, f"{label}: omega off by {rel:.3e} relative")
    check(1 <= steps["calls"] <= n_it <= steps["calls"] + polish["calls"],
          f"{label}: {n_it} iterations from {steps['calls']} device and "
          f"{polish['calls']} polish steps")
    general = sorted(k for k in rep if "device_solve" in k
                     or "dual_arnoldi" in k)
    check(not general, f"{label}: the general engine ran {general}")
    launches, twin = counts[kernel]
    check(launches > 0, f"{label} never launched {kernel}")
    check(twin == 0, f"{label}: the plain {kernel} ran {twin} times")
    check(sol.v.shape == (L.size,) and np.isfinite(sol.v).all(),
          f"{label}: eigenvector not finite")
    return counts


def phase_slab_path(L7259):
    """rijke_mesh → discretize → mslp on the card at 7,259 DOF (K3)."""
    from wavesandeigenvalues_jl_tpu_torch.nlevp.fused_slab import \
        FusedSlabPencilSolver
    return _run_mslp(L7259, "slab path", 7259, OMEGA_7259,
                     FusedSlabPencilSolver, "slab_thomas")


def phase_dense_path(L1369):
    """Path A: mslp on the card at 1,369 DOF through the dense engine (K2)."""
    from wavesandeigenvalues_jl_tpu_torch.nlevp.fused_local import \
        FusedPencilSolver
    return _run_mslp(L1369, "main path A (dense)", 1369, OMEGA_1369,
                     FusedPencilSolver, "dense_gmres")


def phase_apply_path(L7259):
    """Path B: operator_apply on the card at 7,259 DOF through K1.  At each
    block size a first call at Z0 builds the ordering and block structure;
    the call at OMEGA_APPLY that follows reuses them and is checked
    row-wise against the complex128 scipy CSR product."""
    import scipy.sparse as sp

    from wavesandeigenvalues_jl_tpu_torch.ops.bsr_spmm import (operator_apply,
                                                                random_panel)
    L7259.params[L7259.eigval] = OMEGA_APPLY
    A = L7259.assemble({})
    n = A.shape[0]
    X = random_panel(n, 128)
    As = sp.csr_matrix((A.data, A.indices, A.indptr), shape=A.shape)
    Yref = As @ X.astype(np.complex128)
    scale = abs(As) @ np.abs(X).astype(np.float64)
    counts = {}
    for bs in K1_BLOCK_SIZES:
        reset_counts()
        t0 = time.perf_counter()
        operator_apply(L7259, Z0, X, bs=bs)
        cold = time.perf_counter() - t0
        cold_counts = read_counts()
        plan = L7259._bsr_plan[2]
        reset_counts()
        t0 = time.perf_counter()
        Y = operator_apply(L7259, OMEGA_APPLY, X, bs=bs)
        wall = time.perf_counter() - t0
        counts[bs] = read_counts()
        check(L7259._bsr_plan[2] is plan,
              f"operator_apply bs={bs}: the plan was rebuilt")
        check(Y.shape == (n, 128) and np.isfinite(Y).all(),
              f"operator_apply bs={bs}: bad output")
        rel = float((np.abs(Y - Yref) / np.maximum(scale, 1e-300)).max())
        print(f"main path B (apply) bs={bs}: n={n} r=128 | wall first call "
              f"(builds the plan) {cold:.4f} s, next call {wall:.4f} s | max "
              f"|Y−Y_ref|/(|A||X|) {rel:.3e} (tol {K1_RTOL:.0e}) | launches, "
              f"plain calls {counts[bs]} (first call {cold_counts})",
              flush=True)
        check(rel <= K1_RTOL, f"operator_apply bs={bs} off by {rel:.3e}")
        for c in (cold_counts, counts[bs]):
            launches, twin = c["bsr_spmm"]
            check(launches == 1 and twin == 0, f"operator_apply bs={bs}: "
                  f"K1 launches {launches}, plain {twin}")
    return counts, A


def phase_compare_k1(A):
    """K1 against its plain version on the reordered 7,259-DOF operator at
    each block size, with two yardsticks on the same operator and panel:
    torch.sparse.mm of the CSR operator, and the port's own CSR kernel
    (window_spmm, the K4/K5 counterpart)."""
    from wavesandeigenvalues_jl_tpu_torch.ops.bsr_spmm import (
        BsrSpmm, bsr_spmm, bsr_spmm_packed_ref, random_panel)
    from wavesandeigenvalues_jl_tpu_torch.ops.device import BsrOperator
    from wavesandeigenvalues_jl_tpu_torch.ops.reorder import (cuthill_mckee,
                                                              permute_csr)
    from wavesandeigenvalues_jl_tpu_torch.ops.window_spmm import WindowSpmm
    from wavesandeigenvalues_jl_tpu_torch.utils.timing import device_ms
    Ar = permute_csr(A, cuthill_mckee(A))
    X = random_panel(A.shape[0], 128)
    csr = torch.sparse_csr_tensor(
        torch.from_numpy(Ar.indptr), torch.from_numpy(Ar.indices.astype(
            np.int64)), torch.from_numpy(Ar.data.astype(np.complex64)),
        size=Ar.shape).cuda()
    Xd = torch.from_numpy(X).cuda()
    library_ms, library_dev, library = _library_ms(
        lambda: torch.sparse.mm(csr, Xd), "torch.sparse.mm")
    window = WindowSpmm.from_csr(Ar, nrhs=128, device="cuda")
    window_ms = _median_ms(lambda: window.apply(Xd))
    window_dev = device_ms(lambda: window.apply(Xd))
    out = {}
    for bs in K1_BLOCK_SIZES:
        bsr = BsrOperator.from_csr(Ar, bs=bs)
        op = BsrSpmm(bsr, "cuda")
        Xp = op.panel(X)
        args = (op.row_ptr, op.lcol, op.vals, op.block_cols, Xp)
        ref = bsr_spmm_packed_ref(*args)
        scale = bsr_spmm_packed_ref(
            op.row_ptr, op.lcol, op.vals.abs().to(torch.complex64),
            op.block_cols, Xp.abs().to(torch.complex64)).real
        err, Ys = _max_err(lambda: bsr_spmm(*args), ref, f"K1 bs={bs}")
        rel = max(((Y - ref).abs() / scale.clamp_min(1e-30)).max().item()
                  for Y in Ys)
        del Ys
        ms = _median_ms(lambda: bsr_spmm(*args))
        dev_ms = device_ms(lambda: bsr_spmm(*args))
        plain_ms = _median_ms(lambda: bsr_spmm_packed_ref(*args))
        # the bytes the product must move (each nonzero's value and column,
        # row_ptr and block_cols once, X read once, Y written once) and the
        # operations it needs (8 per nonzero and column); beside it, the
        # bound of the dense-block layout, which counted the padded blocks
        bound_ms, bound_by = bound(op.bytes, op.flops)
        padded_ms, _ = bound(op.padded_bytes, op.flops)
        print(f"K1 bs={bs}: {op.nbr} block rows x {op.maxb} slots, "
              f"{op.nnz_blocks} blocks, {op.nnz} nonzeros, fill "
              f"{bsr.fill_ratio:.4f} | over {REPEATS} launches max abs err "
              f"{err:.3e}, max err/(|A||X|) {rel:.3e} (tol {K1_RTOL:.0e}) | "
              f"kernel {ms:.4f} ms a call with the host's launch, "
              f"{dev_ms:.4f} ms on the device "
              f"({op.bytes / dev_ms * 1e-6:.1f} GB/s), plain "
              f"{plain_ms:.4f} ms | {library} | window_spmm {window_ms:.4f} "
              f"ms a call, {window_dev:.4f} ms on the device | bound "
              f"{bound_ms:.4f} ms ({bound_by}: {op.bytes / 1e6:.2f} MB, "
              f"{op.flops / 1e9:.4f} GFLOP), {bound_ms / dev_ms * 100:.1f} % "
              f"of it on the device | padded layout bound {padded_ms:.4f} "
              f"ms ({op.padded_bytes / 1e6:.1f} MB)", flush=True)
        check(rel <= K1_RTOL, f"K1 bs={bs} disagrees with its plain "
              f"version: {rel:.3e}")
        out[bs] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": library_ms, "device_ms": dev_ms,
                   "library_device_ms": library_dev}
    return out


def _rowwise_scipy(Y, As, X):
    """(max |Y − Y_ref| / (|A|·|X|), ‖Y − Y_ref‖ / ‖Y_ref‖) against the
    complex128 scipy product."""
    Yref = As @ X.astype(np.complex128)
    scale = abs(As) @ np.abs(X).astype(np.float64)
    row = float((np.abs(Y - Yref) / np.maximum(scale, 1e-300)).max())
    return row, float(np.linalg.norm(Y - Yref) / np.linalg.norm(Yref))


def phase_large_path():
    """Path C: the 57,210-DOF octosplit passive family (host) and
    operator_apply(kernel="window") on the card.  A first call at Z0
    builds the plan (Cuthill–McKee, the permuted structure and value stack
    on the card); the call at OMEGA_APPLY that follows reuses it and is
    checked against the complex128 scipy product."""
    import scipy.sparse as sp

    from wavesandeigenvalues_jl_tpu_torch.models.rijke import \
        large_operator_family
    from wavesandeigenvalues_jl_tpu_torch.ops.bsr_spmm import (operator_apply,
                                                                random_panel)
    from wavesandeigenvalues_jl_tpu_torch.utils import timing

    t0 = time.perf_counter()
    L = large_operator_family()
    family_s = time.perf_counter() - t0
    L.params[L.eigval] = OMEGA_APPLY
    A = L.assemble({})
    n = A.shape[0]
    check((n, A.nnz) == (LARGE_DIM, LARGE_NNZ),
          f"large operator n={n} nnz={A.nnz}, expected {LARGE_DIM} and "
          f"{LARGE_NNZ}")
    X = random_panel(n, 128)
    As = sp.csr_matrix((A.data, A.indices, A.indptr), shape=A.shape)

    timing.reset()
    reset_counts()
    t0 = time.perf_counter()
    operator_apply(L, Z0, X, kernel="window")
    cold = time.perf_counter() - t0
    cold_counts = read_counts()
    rep = timing.report()
    plan = L._window_plan[2]
    reset_counts()
    t0 = time.perf_counter()
    Y = operator_apply(L, OMEGA_APPLY, X, kernel="window")
    wall = time.perf_counter() - t0
    counts = read_counts()

    check(L._window_plan[2] is plan, "operator_apply window: plan rebuilt")
    check(Y.shape == (n, 128) and np.isfinite(Y).all(),
          "operator_apply window: bad output")
    lp = plan.op.launch_plan(128)
    row, glob = _rowwise_scipy(Y, As, X)
    print(f"main path C (large apply): n={n} nnz={A.nnz} r=128 | mesh + "
          f"octosplit + discretize {family_s:.2f} s | wall first call "
          f"(builds the plan) {cold:.4f} s, of it Cuthill–McKee "
          f"{rep['apply_plan.cuthill_mckee']['total_s']:.4f} s and "
          f"permutation {rep['apply_plan.permute']['total_s']:.4f} s | next "
          f"call {wall:.4f} s | max |Y−Y_ref|/(|A||X|) {row:.3e} (tol "
          f"{K1_RTOL:.0e}), ‖Y−Y_ref‖/‖Y_ref‖ {glob:.3e} (tol "
          f"{LARGE_GLOBAL_RTOL:.0e}) | launches, plain calls {counts} "
          f"(first call {cold_counts}) | nonzeros outside their tile's ring "
          f"window {lp.out_of_window}", flush=True)
    check(lp.out_of_window == 0, f"large apply: {lp.out_of_window} nonzeros "
          "outside their ring window")
    check(row <= K1_RTOL, f"large apply row-wise error {row:.3e}")
    check(glob < LARGE_GLOBAL_RTOL, f"large apply global error {glob:.3e}")
    for c in (cold_counts, counts):
        launches, twin = c["window_spmm"]
        check(launches == 1 and twin == 0, f"large apply: window_spmm "
              f"launches {launches}, plain {twin}")
    return counts, L, plan


def _block_slots(indptr, cols, bs):
    """maxb of ``BsrOperator.from_csr`` on a CSR pattern: the most block
    columns one block row of size bs touches."""
    n = len(indptr) - 1
    nbr = -(-n // bs)
    rows = np.repeat(np.arange(n), np.diff(indptr))
    blocks = np.unique(rows // bs * nbr + cols // bs)
    return int(np.bincount(blocks // nbr).max())


def phase_compare_k45(L, plan, warp_row):
    """The CSR SpMM kernel (K4/K5) against window_spmm_ref on the card, on
    the reordered 57,210-DOF operator at OMEGA_APPLY, over REPEATS launches
    that must agree bit for bit, with two yardsticks on the same operator
    and panel: torch.sparse.mm of the same CSR, and the warp-per-row kernel
    it replaced (``warp_row``); then chain(20) against the plain chain,
    timed in turns with chain(20) of the replaced kernel."""
    from wavesandeigenvalues_jl_tpu_torch.ops.bsr_spmm import random_panel
    from wavesandeigenvalues_jl_tpu_torch.ops.window_spmm import (
        CHUNK, RING_ROWS, TILE_ROWS, WindowSpmm, window_spmm, window_spmm_ref)
    from wavesandeigenvalues_jl_tpu_torch.utils.timing import device_ms
    L.params[L.eigval] = OMEGA_APPLY
    indptr, cols = plan.op.indptr, plan.op.cols
    vals = plan.family.data(L.coefficients()).to(torch.complex64)
    n, nnz = indptr.numel() - 1, cols.numel()
    csr = torch.sparse_csr_tensor(indptr.long(), cols.long(), vals,
                                  size=(n, n))
    slots = {bs: _block_slots(indptr.cpu().numpy(), cols.cpu().numpy(), bs)
             for bs in K1_BLOCK_SIZES}
    print("K1 window of this operator in path C's ordering (slots maxb, "
          "staged rows maxb·bs): " + ", ".join(
              f"bs {bs}: {k} slots, {k * bs} rows"
              for bs, k in slots.items()), flush=True)
    out = {}
    for r in K45_WIDTHS:
        op = WindowSpmm(indptr.cpu().numpy(), cols.cpu().numpy(),
                        vals.cpu().numpy(), (n, n), nrhs=r)
        # the plan runs only on the structure tensors it was made from
        indptr, cols, lp = op.indptr, op.cols, op.launch_plan(r)
        Xd = op.panel(random_panel(n, r, seed=r))
        ref = window_spmm_ref(indptr, cols, vals, Xd)
        scale = window_spmm_ref(indptr, cols, vals.abs().to(torch.complex64),
                                Xd.abs().to(torch.complex64)).real
        err, Ys = _max_err(lambda: window_spmm(indptr, cols, vals, Xd, lp),
                           ref, f"K4/K5 r={r}")
        same = all(torch.equal(y, Ys[0]) for y in Ys)
        rel = max(((y - ref).abs() / scale.clamp_min(1e-30)).max().item()
                  for y in Ys)
        del Ys
        ms = _median_ms(lambda: window_spmm(indptr, cols, vals, Xd, lp))
        plain_ms = _median_ms(lambda: window_spmm_ref(indptr, cols, vals,
                                                      Xd))
        library_ms, library_dev, library = _library_ms(
            lambda: torch.sparse.mm(csr, Xd), "torch.sparse.mm")
        def warp_row_product(indptr, cols, vals, X):
            Y = torch.empty_like(X)
            stream = torch.cuda.current_stream().cuda_stream
            code = warp_row(indptr.data_ptr(), cols.data_ptr(),
                            vals.data_ptr(), X.data_ptr(), Y.data_ptr(), n,
                            X.shape[1], stream)
            check(code == 0, f"warp-per-row kernel launch failed: {code}")
            return Y
        # the two kernels in turns: new, old, old, new
        kernel = lambda: window_spmm(indptr, cols, vals, Xd, lp)  # noqa: E731
        old = lambda: warp_row_product(indptr, cols, vals, Xd)  # noqa: E731
        turns = [device_ms(f) for f in (kernel, old, old, kernel)]
        dev_ms, old_ms = min(turns[0], turns[3]), min(turns[1], turns[2])
        Yw = old()
        old_rel = ((Yw - ref).abs() / scale.clamp_min(1e-30)).max().item()
        bound_ms, bound_by = bound(op.stream_bytes, op.flops)
        gbs = op.stream_bytes / (dev_ms * 1e-3) / 1e9
        # what the design moves: the structure once (the chunks of a range
        # share it through L2), the X rows its streams stage, Y once
        staged = 8.0 * lp.staged_rows * r
        moved = (12.0 * nnz + 4.0 * (n + 1) + 8.0 * (lp.tiles.shape[0]
                 + lp.ranges) + staged + 8.0 * n * r)
        print(f"K4/K5 (window_spmm) n={n} nnz={nnz} r={r}: plan "
              f"w={min(CHUNK, r)} x {lp.chunks} chunks, tiles of "
              f"{TILE_ROWS} rows, ring of {RING_ROWS} rows, {lp.ranges} "
              f"ranges, {lp.blocks} blocks; {lp.out_of_window} nonzeros "
              f"outside their window; X staged {lp.staged_rows / n:.3f} x "
              f"the panel ({staged / 1e6:.1f} MB), {moved / 1e6:.1f} MB "
              f"moved at most ({moved / (dev_ms * 1e-3) / 1e9:.1f} GB/s) | "
              f"over {REPEATS} launches max abs err {err:.3e}, max "
              f"err/(|A||X|) {rel:.3e} (tol {K1_RTOL:.0e}), every launch the "
              f"same bits: {same} | kernel {ms:.4f} ms a call, {dev_ms:.4f} "
              f"ms on the device ({gbs:.1f} GB/s of "
              f"{op.stream_bytes / 1e6:.1f} MB; turns new/old/old/new "
              f"{turns[0]:.4f} / {turns[1]:.4f} / {turns[2]:.4f} / "
              f"{turns[3]:.4f} ms), warp-per-row kernel {old_ms:.4f} ms on "
              f"the device (err/(|A||X|) {old_rel:.3e}), plain "
              f"{plain_ms:.4f} ms, {library} | bound {bound_ms:.4f} ms "
              f"({bound_by}; {op.flops / 1e9:.4f} GFLOP), "
              f"{bound_ms / dev_ms * 100:.1f} % of it on the device",
              flush=True)
        check(rel <= K1_RTOL, f"K4/K5 r={r} disagrees with its plain "
              f"version: {rel:.3e}")
        check(same, f"K4/K5 r={r}: launches differ")
        out[r] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                  "bound_ms": bound_ms, "bound_by": bound_by,
                  "library_ms": library_ms, "device_ms": dev_ms,
                  "library_device_ms": library_dev,
                  "replaced_kernel_device_ms": old_ms}
        if r == 128:
            chain, plain_chain, old_chain = (
                op.chain(CHAIN_M), op.chain(CHAIN_M, window_spmm_ref),
                op.chain(CHAIN_M, warp_row_product))
            Yc, Yp = chain(Xd), plain_chain(Xd)
            crel = ((Yc - Yp).norm() / Yp.norm()).item()
            orel = ((old_chain(Xd) - Yp).norm() / Yp.norm()).item()
            # the chain of each kernel in turns: new, old, old, new
            cturns = [_median_ms(lambda f=f: f(Xd)) / CHAIN_M
                      for f in (chain, old_chain, old_chain, chain)]
            chain_ms = min(cturns[0], cturns[3])
            old_chain_ms = min(cturns[1], cturns[2])
            print(f"K4/K5 chain({CHAIN_M}): {chain_ms:.4f} ms per apply "
                  f"(apply + normalization, a call), with the warp-per-row "
                  f"kernel {old_chain_ms:.4f} ms (turns new/old/old/new "
                  + " / ".join(f"{t:.4f}" for t in cturns) + ") | against "
                  f"the plain chain ‖ΔY‖/‖Y‖ {crel:.3e} (tol "
                  f"{CHAIN_RTOL:.0e}), the warp-per-row chain's {orel:.3e}",
                  flush=True)
            check(bool(torch.isfinite(Yc).all()) and crel <= CHAIN_RTOL,
                  f"chain({CHAIN_M}) disagrees with the plain chain: {crel}")
    return out


def _hz(Om):
    return np.sort(np.asarray(Om).real) / 2 / np.pi


def _contour_line(tag, L, card, part, chunk, Om, res, info, wall, peak,
                  counts):
    """Print one 57,210-DOF contour run; returns the modes' relative
    errors against the pinned JAX host Beyn (inf if the count differs)."""
    m, s = part.m, part.smax
    tm = info["solver_timings"]
    nodes = 4 * CONTOUR_KW["N"]
    chunks = tm["factor_steps"] // m
    shifts = chunks * chunk                   # factored, padding included
    # the factorization's fp32 operations a shift and slab at the padded
    # width s: L·C, the LU, the solve against I and Dt⁻¹U (complex: 8
    # real operations a multiply-add), over the card's fp32 peak
    flops = (8 + 8 / 3 + 8 + 8) * s ** 3
    floor_s = shifts * m * flops / FP32_FLOPS_PER_S
    f, f_ref = _hz(Om), _hz(OMEGA_57K)
    rel = (np.abs(f - f_ref) / f_ref if len(f) == len(f_ref)
           else np.full(len(f_ref), np.inf))
    times = " ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                     for k, v in sorted(tm.items()))
    from wavesandeigenvalues_jl_tpu_torch.ops.slab_solve import SLAB_BUDGET
    fmt = lambda xs: "[" + ", ".join(f"{x:.3e}" for x in xs) + "]"  # noqa
    sig = info["sigma"]
    print(f"main path D (contour{tag}) on {card}: n={L.size} slabs m={m} "
          f"s_max={s} (median {int(np.median(part.sizes))}) | {nodes} nodes "
          f"in {chunks} chunks of {chunk} shifts (budget {SLAB_BUDGET:.1e} "
          f"B) | modes Hz {', '.join(f'{x:.8f}' for x in f)} rel err "
          f"{fmt(rel)} (tol {CONTOUR_RTOL:.0e}) | eigenpair residuals "
          f"{fmt(res)} (res_tol {CONTOUR_KW['res_tol']:.0e}) | max relres "
          f"{info['max_relres']:.3e} (bar {CONTOUR_RELRES:.0e}), chunks "
          f"above refine_tol {len(info['unconverged'])}, "
          f"{tm['resolve_steps'] // m} re-solve sweeps over the chunks | "
          f"Hankel singular values {fmt(sig)}, sigma_max/sigma_2 "
          f"{sig[0] / sig[1]:.3e} | wall {wall:.3f} s | solver timings: "
          f"{times} | peak device memory {peak / 2**20:.1f} MiB | "
          f"factorization floor {floor_s:.3f} s ({flops / 1e9:.3f} GFLOP a "
          f"shift and slab, {shifts} shifts x {m} slabs at 67 TFLOP/s fp32) "
          f"| launches, plain calls {counts}", flush=True)
    return rel


def phase_contour_path(L, card):
    """Path D: Beyn on the card at 57,210 DOF through the slab direct
    solver, the call a user makes (``beyn(..., backend="slab")`` at the
    solver's defaults), with the counters set to 0 just before it (the
    slab solver is plain PyTorch: no kernel of the port runs here).
    Checks the mode count and each mode within CONTOUR_RTOL·f of the
    pinned JAX host Beyn, and max relres ≤ CONTOUR_RELRES.  Then the same
    call at the JAX package's sweep cap, whose unconverged chunks must be
    reported; its modes are printed, not held to the bar."""
    import warnings

    from wavesandeigenvalues_jl_tpu_torch.nlevp import beyn
    from wavesandeigenvalues_jl_tpu_torch.ops.slab_solve import (
        SlabPartition, auto_chunk)
    check(L.size == LARGE_DIM, f"contour family dimension {L.size}")
    S = L._stack()
    part = SlabPartition(S.indptr, S.indices, L.size)
    chunk = auto_chunk(part)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    Om, P, res, info = beyn(L, CONTOUR, backend="slab",
                            return_residuals=True, return_info=True,
                            **CONTOUR_KW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    rel = _contour_line("", L, card, part, chunk, Om, res, info, wall, peak,
                        counts)
    check(len(Om) == len(OMEGA_57K),
          f"contour found {len(Om)} modes, JAX host {len(OMEGA_57K)}")
    check(rel.max() <= CONTOUR_RTOL, f"contour modes off by {rel.max():.3e}")
    check(info["max_relres"] <= CONTOUR_RELRES,
          f"contour max relres {info['max_relres']:.3e}")
    check(P.shape == (L.size, len(Om)) and np.isfinite(P).all(),
          "contour eigenvectors not finite")
    check(all(t == 0 for _, t in counts.values()),
          f"contour ran a plain kernel version: {counts}")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", RuntimeWarning)
        Om, P, res, info = beyn(L, CONTOUR, backend="slab",
                                refine_sweeps=JAX_SWEEP_CAP,
                                return_residuals=True, return_info=True,
                                **CONTOUR_KW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _contour_line(f", refine_sweeps={JAX_SWEEP_CAP}", L, card, part, chunk,
                  Om, res, info, wall, torch.cuda.max_memory_allocated(),
                  read_counts())
    above = info["max_relres"] > 1e-11       # the solver's refine_tol
    warned = any("refine_tol" in str(w.message) for w in caught)
    check(bool(info["unconverged"]) == above == warned,
          f"unconverged chunks {info['unconverged']} not reported as such "
          f"(max relres {info['max_relres']:.3e}, warned {warned})")
    return wall


def phase_contour_small(card):
    """Path D at 437 DOF: the passive family through the "host", "dense"
    and "slab" backends of ``beyn``, each within SMALL_HZ_ATOL of the
    pinned JAX host modes.  "host" is SuperLU on the host's CPU whatever
    the device; the other two run on the card."""
    from wavesandeigenvalues_jl_tpu_torch.mesh.generate import rijke_mesh
    from wavesandeigenvalues_jl_tpu_torch.models import discretize
    from wavesandeigenvalues_jl_tpu_torch.models.rijke import \
        passive_rijke_setup
    from wavesandeigenvalues_jl_tpu_torch.nlevp import beyn
    mesh = rijke_mesh(n_rings=2, nz_cold=10, nz_hot=10)
    L = discretize(mesh, *passive_rijke_setup(mesh))
    f_ref = _hz(OMEGA_437_PASSIVE)
    for backend in ("host", "dense", "slab"):
        t0 = time.perf_counter()
        Om, P = beyn(L, CONTOUR, backend=backend, **CONTOUR_KW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        f = _hz(Om)
        err = np.abs(f - f_ref).max() if len(f) == len(f_ref) else np.inf
        where = ("SuperLU on the host CPU" if backend == "host"
                 else f"on {card}")
        print(f"main path D (contour, n={L.size}) backend {backend}, "
              f"{where}: modes Hz {', '.join(f'{x:.8f}' for x in f)} max "
              f"|Δf| {err:.3e} "
              f"Hz (tol {SMALL_HZ_ATOL:.0e}) | wall {wall:.3f} s", flush=True)
        check(err <= SMALL_HZ_ATOL, f"backend {backend}: modes off by {err}")
        check(np.isfinite(P).all(), f"backend {backend}: bad eigenvectors")


def _report_sum(rep, name):
    """(calls, seconds) of the phases named ``name`` at any nesting (a
    factorization inside ``perturb`` is "perturb.device_solve.factor")."""
    hits = [v for k, v in rep.items() if k == name or k.endswith("." + name)]
    return (sum(v["calls"] for v in hits), sum(v["total_s"] for v in hits))


def _engine_line(rep, steps, per="a step"):
    """The general engine's parts from a ``utils.timing`` report, each also
    over ``steps``."""
    from wavesandeigenvalues_jl_tpu_torch.ops.device_solve import \
        TRANSFER_BYTES
    parts = [("factorizations", "device_solve.factor"),
             ("dual Arnoldi", "eigs.dual_arnoldi"),
             ("refined solves", "device_solve.refine"),
             ("device solves (refinement sweeps)", "device_solve.refine.solve"),
             ("host residuals", "device_solve.refine.host_residual"),
             ("perturb", "perturb")]
    out = []
    for what, name in parts:
        calls, secs = _report_sum(rep, name)
        out.append(f"{what} {calls} in {secs:.3f} s ({calls / steps:.1f} "
                   f"{per}, {secs / steps:.3f} s {per})")
    moved = {k: v / 2**20 for k, v in TRANSFER_BYTES.items()}
    return ("; ".join(out) + f" | host->device {moved['to_device']:.1f} MiB,"
            f" device->host {moved['to_host']:.1f} MiB")


def phase_general_engine(card, L7259):
    """Path E, the general local engine on the card.  E1: householder of
    order 3 at 4,087 DOF through DeviceLU (complex128 LU on the card) and
    the dual Arnoldi there; E2: perturbation theory on the same family
    (order-16 series in n from one factorization, Padé [8/8]); E3:
    householder of order 2 at 437 DOF on the "device_gmres" backend.
    Then, a report and no check, DeviceGMRES's refined relres on the
    7,259-DOF operator (F4).  The counters are set to 0 before E1 and read
    after E3: the general engine launches none of the port's kernels."""
    from wavesandeigenvalues_jl_tpu_torch.models.rijke import \
        active_rijke_family
    from wavesandeigenvalues_jl_tpu_torch.nlevp import (householder,
                                                        perturb, polyval)
    from wavesandeigenvalues_jl_tpu_torch.ops import device_solve
    from wavesandeigenvalues_jl_tpu_torch.utils import timing
    from wavesandeigenvalues_jl_tpu_torch.utils.config import (
        set_solve_backend, solve_backend)

    check(solve_backend() == "device", f"solve backend {solve_backend()}")
    factors = []
    factor_init = device_solve.DeviceLU.__init__

    def recording_init(self, *args, **kwargs):
        factor_init(self, *args, **kwargs)
        factors.append((self._fac[0].device.type, self._fac[0].dtype))

    device_solve.DeviceLU.__init__ = recording_init
    t0 = time.perf_counter()
    L = active_rijke_family(n_rings=4, nz_cold=32, nz_hot=32)
    build = time.perf_counter() - t0
    check(L.size == 4087, f"path E family dimension {L.size}")

    # E1: householder(order=3) through DeviceLU on the card
    timing.reset()
    for key in device_solve.TRANSFER_BYTES:
        device_solve.TRANSFER_BYTES[key] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    sol, n_it, flag = householder(L, Z0, maxiter=12, tol=1e-9, order=3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    om = sol.params[sol.eigval]
    rel = abs(om - OMEGA_4087_H3) / abs(OMEGA_4087_H3)
    print(f"main path E1 (householder order 3, DeviceLU) on {card}: "
          f"n={L.size} (family built in {build:.2f} s) | wall {wall:.3f} s, "
          f"{n_it} Newton steps | {_engine_line(timing.report(), n_it)} | "
          f"peak device memory {peak / 2**20:.1f} MiB | iterations {n_it} "
          f"flag {flag} | omega {om!r} rel err {rel:.3e} (tol "
          f"{OMEGA_RTOL:.0e})", flush=True)
    arnoldi_calls = _report_sum(timing.report(), "eigs.dual_arnoldi")[0]
    check(flag == 0, f"E1: flag {flag}")
    check(n_it == 4, f"E1: {n_it} iterations, JAX host 4")
    check(arnoldi_calls == n_it, f"E1: {arnoldi_calls} dual Arnoldi runs on "
          f"the card in {n_it} steps (a host Arnoldi took over)")
    check(rel <= OMEGA_RTOL, f"E1: omega off by {rel:.3e}")
    check(np.isfinite(sol.v).all(), "E1: eigenvector not finite")

    # E2: perturbation theory from the converged eigentriple
    timing.reset()
    for key in device_solve.TRANSFER_BYTES:
        device_solve.TRANSFER_BYTES[key] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    perturb(sol, L, "n", 16)
    torch.cuda.synchronize()
    wall_p = time.perf_counter() - t0
    parts = _engine_line(timing.report(), 16, "an order")
    peak = torch.cuda.max_memory_allocated()
    c = np.asarray(sol.eigval_pert["n/Taylor"])
    c_rel = np.abs(c[1:5] - np.asarray(PERT_4087_C)) / np.abs(PERT_4087_C)
    pade = sol("n", 0.5, 8, 8)
    taylor = polyval(c, 0.5 - sol.params["n"])
    pade_rel = abs(pade - PADE_4087_88) / abs(PADE_4087_88)
    L.params["n"] = 0.5
    t0 = time.perf_counter()
    exact, n_ex, flag_ex = householder(L, om, maxiter=12, tol=1e-9, order=3)
    wall_ex = time.perf_counter() - t0
    L.params["n"] = 1.0
    om_ex = exact.params[exact.eigval]
    rel_ex = abs(om_ex - OMEGA_4087_N05) / abs(OMEGA_4087_N05)
    fmt = lambda xs: "[" + ", ".join(f"{x:.3e}" for x in xs) + "]"  # noqa
    print(f"main path E2 (perturb n, order 16) on {card}: wall {wall_p:.3f} "
          f"s | {parts} | peak device memory {peak / 2**20:.1f} MiB | c1..c4 "
          f"{', '.join(repr(complex(x)) for x in c[1:5])} rel err "
          f"{fmt(c_rel)} (tol {PERT_RTOL:.0e}) | Pade[8/8] at n=0.5 "
          f"{pade!r} rel err {pade_rel:.3e} (tol {PADE_RTOL:.0e}) | against "
          f"householder re-solved at n=0.5 ({om_ex!r}, flag {flag_ex}, "
          f"{n_ex} steps, {wall_ex:.3f} s; JAX host {OMEGA_4087_N05!r}, rel "
          f"err {rel_ex:.3e}, tol {OMEGA_RTOL:.0e}): "
          f"Taylor(16) err {abs(taylor - om_ex) / abs(om_ex):.3e}, "
          f"Pade[8/8] err {abs(pade - om_ex) / abs(om_ex):.3e} (relative)",
          flush=True)
    check(c_rel.max() <= PERT_RTOL, f"E2: c1..c4 off by {c_rel.max():.3e}")
    check(pade_rel <= PADE_RTOL, f"E2: Pade value off by {pade_rel:.3e}")
    check(flag_ex == 0, f"E2: re-solve flag {flag_ex}")
    check(rel_ex <= OMEGA_RTOL, f"E2: re-solve at n=0.5 off JAX host by "
          f"{rel_ex:.3e}")

    # E3: the "device_gmres" backend on the 437-DOF family
    L437 = active_rijke_family()
    prev = set_solve_backend("device_gmres")
    try:
        timing.reset()
        t0 = time.perf_counter()
        sol3, n3, flag3 = householder(L437, Z0, maxiter=12, tol=1e-9,
                                      order=2)
        torch.cuda.synchronize()
        wall3 = time.perf_counter() - t0
    finally:
        set_solve_backend(prev)
    counts = read_counts()
    om3 = sol3.params[sol3.eigval]
    rel3 = abs(om3 - OMEGA_437_H2) / abs(OMEGA_437_H2)
    solves = _report_sum(timing.report(), "device_solve.refine.solve")
    print(f"main path E3 (householder order 2, device_gmres) on {card}: "
          f"n={L437.size} | wall {wall3:.3f} s, {n3} Newton steps, "
          f"{solves[0]} GMRES solves in {solves[1]:.3f} s | flag {flag3} | "
          f"omega {om3!r} rel err {rel3:.3e} (tol {OMEGA_RTOL:.0e}) | "
          f"launches, plain calls over E1-E3 {counts} | DeviceLU "
          f"factorizations {len(factors)}, on {sorted(set(factors))}",
          flush=True)
    check(flag3 == 0, f"E3: flag {flag3}")
    check(rel3 <= OMEGA_RTOL, f"E3: omega off by {rel3:.3e}")
    check(all(t == 0 for _, t in counts.values()),
          f"path E ran a plain kernel version: {counts}")
    check(factors and set(factors) == {("cuda", torch.complex128)},
          f"path E factorizations: {sorted(set(factors))}")
    device_solve.DeviceLU.__init__ = factor_init

    # F4, a report: DeviceGMRES at 7,259 DOF and its defaults
    A = L7259(Z0)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(A.shape[0]) + 1j * rng.standard_normal(A.shape[0])
    F = device_solve.DeviceGMRES(A)
    relres = []
    t0 = time.perf_counter()
    for trans in ("N", "H"):
        F.solve(b, trans)
        relres.append(F.last_relres)
    print(f"report F4: DeviceGMRES(L(Z0)) on {card}, n={A.shape[0]}, bs "
          f"{F.bs}, GMRES({F.restart}), {F.max_restarts} restarts: refined "
          f"relres N {relres[0]:.3e}, H {relres[1]:.3e} in "
          f"{time.perf_counter() - t0:.3f} s (JAX on the CPU, same rhs: "
          f"{F4_JAX_RELRES[0]:.3e}, {F4_JAX_RELRES[1]:.3e}; refinement "
          f"target 1e-13)", flush=True)
    check(all(np.isfinite(relres)), f"F4: relres not finite {relres}")


def phase_panel_path(card):
    """Path F: Beyn on the card at 55,401 DOF through the panel GMRES and
    the MultiGrid V-cycle (``beyn(..., backend="gmres", coarse=mg)`` at the
    solver's defaults), with the counters set to 0 just before it (the
    panel solver is plain PyTorch: no kernel of the port runs here).
    Checks the mode count and each mode within CONTOUR_RTOL·f of the
    pinned JAX host Beyn, max relres ≤ CONTOUR_RELRES and no shift left
    above refine_tol."""
    from wavesandeigenvalues_jl_tpu_torch.mesh.generate import rijke_mesh
    from wavesandeigenvalues_jl_tpu_torch.mesh.refine import (octosplit,
                                                              p1_prolongation)
    from wavesandeigenvalues_jl_tpu_torch.models import discretize
    from wavesandeigenvalues_jl_tpu_torch.models.rijke import \
        passive_rijke_setup
    from wavesandeigenvalues_jl_tpu_torch.nlevp import beyn
    from wavesandeigenvalues_jl_tpu_torch.ops.panel_solve import (
        PANEL_BUDGET, MultiGrid)

    # the families of large_operator_family(3, 12, 12, refine=r), r = 0..2,
    # on one chain of meshes, and the prolongations between them
    t0 = time.perf_counter()
    meshes = [rijke_mesh(n_rings=3, nz_cold=12, nz_hot=12)]
    for _ in range(2):
        meshes.append(octosplit(meshes[-1]))
    L0, L1, L2 = (discretize(m, *passive_rijke_setup(m)) for m in meshes)
    P0, P1 = (p1_prolongation(m) for m in meshes[:2])
    build = time.perf_counter() - t0
    sizes = tuple((L.size, L._stack().nnz) for L in (L0, L1, L2))
    check(sizes == PANEL_LEVELS, f"path F levels {sizes}, expected "
          f"{PANEL_LEVELS}")
    t0 = time.perf_counter()
    mg = MultiGrid([L1, L0], [P1, P0], bs=64)
    mg_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    Om, P, res, info = beyn(L2, CONTOUR, backend="gmres", coarse=mg,
                            return_residuals=True, return_info=True,
                            **CONTOUR_KW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()

    tm = info["solver_timings"]
    f, f_ref = _hz(Om), _hz(OMEGA_55K)
    rel = (np.abs(f - f_ref) / f_ref if len(f) == len(f_ref)
           else np.full(len(f_ref), np.inf))
    fmt = lambda xs: "[" + ", ".join(f"{x:.3e}" for x in xs) + "]"  # noqa
    sig = info["sigma"]
    print(f"main path F (panel GMRES contour) on {card}: n={L2.size} "
          f"nnz={sizes[2][1]}, MultiGrid levels n={sizes[1][0]} and "
          f"n={sizes[0][0]} (bs 64; families and prolongations built in "
          f"{build:.2f} s, MultiGrid in {mg_s:.2f} s) | {4 * CONTOUR_KW['N']} "
          f"nodes x l={CONTOUR_KW['l']}: {tm['chunks']} device passes of up "
          f"to {tm['chunk']} shifts (budget {PANEL_BUDGET:.1e} B), "
          f"{tm['restarts'] / max(tm['solves'], 1):.3f} restarts a solve "
          f"({tm['solves']} solves), {tm['sweeps']} refinement sweeps | modes "
          f"Hz {', '.join(f'{x:.8f}' for x in f)} rel err {fmt(rel)} (tol "
          f"{CONTOUR_RTOL:.0e}) | eigenpair residuals {fmt(res)} | max relres "
          f"{info['max_relres']:.3e} (bar {CONTOUR_RELRES:.0e}), shifts above "
          f"refine_tol {len(info['unconverged'])} | Hankel singular values "
          f"{fmt(sig)} | wall {wall:.3f} s: prep_s {tm['prep_s']:.3f}, "
          f"device_s {tm['device_s']:.3f}, residual_s {tm['residual_s']:.3f} "
          f"| peak device memory {peak / 2**20:.1f} MiB | launches, plain "
          f"calls {counts}", flush=True)
    check(len(Om) == len(OMEGA_55K),
          f"path F found {len(Om)} modes, JAX host {len(OMEGA_55K)}")
    check(rel.max() <= CONTOUR_RTOL, f"path F modes off by {rel.max():.3e}")
    check(info["max_relres"] <= CONTOUR_RELRES,
          f"path F max relres {info['max_relres']:.3e}")
    check(not info["unconverged"],
          f"path F shifts above refine_tol: {info['unconverged']}")
    check(P.shape == (L2.size, len(Om)) and np.isfinite(P).all(),
          "path F eigenvectors not finite")
    check(all(c == (0, 0) for c in counts.values()),
          f"path F launched a kernel or its plain version: {counts}")
    return wall


def phase_param_path(card):
    """Path G: the parameter study on the card, on the 4,087-DOF active
    family.  G1: track_branch over TRACK_TAUS from Z0 at order 2 (each
    mslp through the fused slab engine and K3, each order-2 jet in τ
    through DeviceLU), with the counters set to 0 just before it; G2: the
    [2/3] two-point Padé of G1's first two jets at their midpoint.  The
    fused engine's hand-over to the general engine is an error here.
    The first and the last K3 input of G1 are kept, and after the counts
    are read K3 is held against its plain version on each.  Returns the
    counts of G1 and the K3 record at G1's shape."""
    import warnings

    from wavesandeigenvalues_jl_tpu_torch.models.rijke import \
        active_rijke_family
    from wavesandeigenvalues_jl_tpu_torch.nlevp import (fused_slab,
                                                        multipoint_pade,
                                                        track_branch)
    from wavesandeigenvalues_jl_tpu_torch.utils import timing

    L = active_rijke_family(n_rings=4, nz_cold=32, nz_hot=32)
    check(L.size == 4087, f"path G family dimension {L.size}")
    k3_inputs = []
    launch = fused_slab.slab_thomas

    def keep_input(stream, bt):
        # the first input is kept, the last overwrites the second
        del k3_inputs[1:]
        k3_inputs.append((stream.clone(), bt.clone()))
        return launch(stream, bt)

    fused_slab.slab_thomas = keep_input
    try:
        timing.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message="fused device step",
                                    category=RuntimeWarning)
            sols, flags = track_branch(L, "τ", TRACK_TAUS, Z0, order=2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    finally:
        fused_slab.slab_thomas = launch
    peak = torch.cuda.max_memory_allocated()
    rep = timing.report()
    none = {"calls": 0, "total_s": 0.0}
    steps = rep.get("fused_local.device_step", none)
    polish = rep.get("fused_local.polish_step", none)
    pert = rep.get("perturb", none)
    factors, factor_s = _report_sum(rep, "device_solve.factor")
    check(all(s is not None for s in sols), f"path G: a failed point {flags}")
    om = np.array([s.params[s.eigval] for s in sols])
    rel = np.abs(om - np.asarray(TRACK_4087_OMEGA)) / np.abs(TRACK_4087_OMEGA)
    jets = [np.asarray(s.eigval_pert.get("τ/Taylor", [])) for s in sols]
    mid = 0.5 * (TRACK_TAUS[0] + TRACK_TAUS[1])
    pade = multipoint_pade(2, 3, [(TRACK_TAUS[0], jets[0]),
                                  (TRACK_TAUS[1], jets[1])])(mid)
    pade_rel = abs(pade - PADE2PT_4087) / abs(PADE2PT_4087)
    solver = L._fused_solver[1]
    part = solver.part
    fmt = lambda xs: "[" + ", ".join(f"{x:.3e}" for x in xs) + "]"  # noqa
    print(f"main path G (track_branch over tau, order 2) on {card}: "
          f"n={L.size} {type(solver).__name__}, slab partition m={part.m} "
          f"smax={part.smax}, K3 at (sides, m, s)=(2, {solver.m}, "
          f"{solver.s}), {len(TRACK_TAUS)} points | G1 wall {wall:.3f} s "
          f"({wall / len(TRACK_TAUS):.3f} s a point): {steps['calls']} fused "
          f"device steps {steps['total_s']:.3f} s, {polish['calls']} polish "
          f"steps {polish['total_s']:.3f} s, {pert['calls']} jets "
          f"{pert['total_s']:.3f} s, {factors} DeviceLU factorizations "
          f"{factor_s:.3f} s | flags {tuple(flags)} "
          f"(JAX host {TRACK_4087_FLAGS}) | omega rel err {fmt(rel)} (tol "
          f"{TRACK_RTOL:.0e}) | jets of order {[len(j) - 1 for j in jets]} "
          f"| G2 two-point Pade [2/3] at tau={mid:.6g}: {complex(pade)!r} "
          f"rel err {pade_rel:.3e} (tol {TRACK_RTOL:.0e}) | peak device "
          f"memory {peak / 2**20:.1f} MiB | launches, plain calls {counts}",
          flush=True)
    check(isinstance(solver, fused_slab.FusedSlabPencilSolver),
          f"path G: solver {type(solver).__name__}")
    check(tuple(flags) == TRACK_4087_FLAGS, f"path G flags {flags}")
    check(rel.max() <= TRACK_RTOL, f"path G omega off by {rel.max():.3e}")
    check(all(len(j) == 3 for j in jets[:-1]),
          f"path G: a jet was dropped {[len(j) for j in jets]}")
    check(pade_rel <= TRACK_RTOL, f"path G2 Pade off by {pade_rel:.3e}")
    check(counts["slab_thomas"][0] > 0,
          "path G never launched slab_thomas (K3)")
    check(len(k3_inputs) == 2, f"path G kept {len(k3_inputs)} K3 inputs")
    check(all(t == 0 for _, t in counts.values()),
          f"path G ran a plain kernel version: {counts}")
    check(factors == pert["calls"] > 0,
          f"path G: {factors} DeviceLU factorizations for "
          f"{pert['calls']} jets")
    recs = [_compare_k3(st, b, f"path G1 {which} launch")
            for which, (st, b) in zip(("first", "last"), k3_inputs)]
    check(tuple(k3_inputs[0][1].shape) == (2, solver.m, solver.s),
          f"path G K3 input {tuple(k3_inputs[0][1].shape)}")
    return counts, max(recs, key=lambda r: r["max_abs_err"])


def main():
    from wavesandeigenvalues_jl_tpu_torch.models.rijke import \
        active_rijke_family
    t_start = time.perf_counter()
    card = phase_device()
    warp_row = phase_build()
    k3 = phase_compare_k3()

    t0 = time.perf_counter()
    L7259 = active_rijke_family(n_rings=4, nz_cold=58, nz_hot=58)
    L1369 = active_rijke_family(n_rings=3, nz_cold=17, nz_hot=17)
    print(f"discretize: n={L7259.size} and n={L1369.size} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    k2 = phase_compare_k2(L1369)
    slab = phase_slab_path(L7259)
    dense = phase_dense_path(L1369)
    apply_counts, A = phase_apply_path(L7259)
    k1 = phase_compare_k1(A)
    t0 = time.perf_counter()
    large_counts, L57k, plan = phase_large_path()
    k45 = phase_compare_k45(L57k, plan, warp_row)
    t_d = time.perf_counter()
    phase_contour_path(L57k, card)
    phase_contour_small(card)
    del L57k, plan
    t_e = time.perf_counter()
    phase_general_engine(card, L7259)
    t_f = time.perf_counter()
    phase_panel_path(card)
    t_g = time.perf_counter()
    param_counts, k3_g = phase_param_path(card)
    t_end = time.perf_counter()
    print(f"path C phases: {t_d - t0:.2f} s, path D phases: "
          f"{t_e - t_d:.2f} s, path E phases: {t_f - t_e:.2f} s, path F: "
          f"{t_g - t_f:.2f} s, path G: {t_end - t_g:.2f} s of the run's "
          f"{t_end - t_start:.2f} s", flush=True)

    launches_c = large_counts["window_spmm"][0]
    rows = [
        ("slab_thomas", "slab_thomas", "pallas_thomas.py:49",
         k3[K3_SHAPES[0]], slab["slab_thomas"][0]),
        ("slab_thomas/path G", "slab_thomas", "pallas_thomas.py:49", k3_g,
         param_counts["slab_thomas"][0]),
        ("dense_gmres", "dense_gmres", "pallas_gmres.py:50",
         k2[(2, 1408, 80, 1)], dense["dense_gmres"][0]),
        ("bsr_spmm", "bsr_spmm", "pallas_spmv.py:94", k1[128],
         apply_counts[128]["bsr_spmm"][0]),
        ("window_spmm/K4", "window_spmm", "window_spmm.py:162", k45[128],
         launches_c),
        ("window_spmm/K5", "window_spmm", "window_spmm2.py:136", k45[128],
         launches_c),
    ]
    print(json.dumps({"kernels": [dict(
        name=name, route="cuda",
        source=f"wavesandeigenvalues_jl_tpu_torch/csrc/{src}.cu",
        replaces=f"wavesandeigenvalues_jl_tpu/ops/{where}",
        launches=launches, **rec)
        for name, src, where, rec, launches in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
