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
  slab shape (2, 18, 256);
* path H, the annular combustor: the 12-sector ``annular_halfcell(DOS=12,
  nr=4, nphi=4, nz=48)`` extended to its Bloch unit cell (1,960 DOF) and
  its full annulus (23,520 DOF).  H1: ``mslp`` at b = 0…6 on the unit
  cell through the slab engine and K3; H2: the full annulus from H1's
  b = 1 frequency through the slab engine and K3; H3: ``bloch_expand`` of
  H1's b = 1 eigenvector against the full operator; H4: the batched
  ``bloch_mode_sweep`` over b = 0…6 (plain PyTorch); H5: b = 1 on a
  984-DOF cell through the dense engine and K2 at N = 1,024.  Each
  against pinned JAX host values; K3 and K2 are held against their plain
  versions on the first and the last (K2: the first) of their own inputs;
* path I, every front-end: I1 the 7,259-DOF active Rijke with the scalar
  and the two-branch ``fancyflame`` and tutorial 08's custom FTF, through
  the slab engine and K3; I2 the active Rijke with cubic Hermite elements
  (19,674 DOF) through the slab engine and K3 at (2, 20, 1280), and the
  point getters on its mode; I3 tutorial 11's APE duct (12,532 DOF) with
  its Hermite potential flow, through the slab engine and K3 at (2, 24,
  640); I4 tutorial 12's networks through the dense engine and K2 at N =
  128, and the duct through Beyn's dense backend; I5 the 1,369-DOF shape
  sensitivities (``householder(order=2)`` and the finite-difference
  re-solves through ``DeviceLU``, the discrete adjoint on the host).
  Each against pinned JAX host values; K3 and K2 held against their plain
  versions on the parts' own inputs as in path H;
* path J, mesh I/O, persistence and fitting: J1 the slab path's 7,259-DOF
  Rijke mesh written as gmsh v4.1 and v2.2 (``write_gmsh41``,
  ``write_gmsh22`` below), read back by ``read_mesh``, discretized and
  solved through the slab engine and K3, its mode written by
  ``vtk_write`` (ascii and binary) and parsed back; J2 the vector-fitted
  n–τ flame (``fit_state_space``) at 7,259 DOF through the slab engine
  and K3; J3 ``save_family``/``load_family`` of the J2 and slab-path
  families, each re-solved, ``save_solution``/``read_solution``, and the
  TOML dialect (``save_family_toml``/``load_family_toml``, one panel
  apply through K1 on each family); J4 J1's v2.2 mesh solved under
  ``start_device_trace``/``stop_device_trace``, K3's launches counted in
  the Chrome trace.  Against pinned JAX host values and the slab path;
  K3 held against its plain version on J1's first and last inputs;
* path K, the distributed layer (``parallel/``, plain PyTorch and
  torch.distributed, no kernel): K0 ``init_multihost`` on NCCL, a
  one-rank world (one GPU here), and a (1 × 1) ("shift", "row")
  DeviceMesh; K1 ``make_dist_spmm`` on path C's family and panel in 4 row
  parts on the one rank (real halos between them) against the complex128
  product and path C's Y, with ``make_dist_spmv`` and ``dist_dot``; K2
  ``beyn_dist`` on path F's family and MultiGrid at the JAX package's
  solver defaults against the pinned JAX host modes; K3 ``beyn_batched``
  at 437 DOF on the mesh's shift axis against the unsharded dense
  backend.  The process group is destroyed at the end.

The build phase also compiles the port's host C++ library
(``native/``, g++) beside the kernels.  Every phase prints one line and any failure exits non-zero.  The
second-to-last line is the kernels' JSON record, the last line the device
record:

    python3 chip_smoke.py

Needs one CUDA device; exits 1 without one.
"""
import contextlib
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from portbench.roofline import (FP32_FLOPS_PER_S, HBM_BYTES_PER_S, bound_s,
                                slab_thomas_work)
from portbench.roofline_k2 import dense_gmres_work

Z0 = 340 * 2 * np.pi
#: JAX host mslp (complex128 sparse LU) on the 7,259-DOF active family
OMEGA_7259 = 1086.2565809909638 + 375.8712163601356j
#: JAX host mslp on the 1,369-DOF active family (n_rings=3, nz 17 + 17)
OMEGA_1369 = 1075.8988207005789 + 376.3799204921555j
#: the tolerance of the JAX package's tests/test_fused_slab.py:47
OMEGA_RTOL = 1e-8
#: K3 against its plain version: float32 sums in another order over 2m steps
K3_RTOL = 1e-5
#: where float32 itself loses digits on an input, K3 and K2 are held to
#: within this factor of their plain complex64 versions' own quality
#: instead: K3 (large ‖W_i‖₂ grow the carry of the forward recursion, as on
#: the full annulus's first K3 input) by its distance to the plain version
#: run in complex128; K2 (GMRES(80) stopping at a relres near 1e-3, as on
#: the 984-DOF cell's first K2 input) by its residual ‖Px − b‖/‖b‖
COND_FACTOR = 2
#: K1, K2 and K3 are held against their plain versions on this many
#: launches, each into its own output: a race in their barriers shows on
#: some only
REPEATS = 50
#: (sides, m, s) of the 7,259-DOF slice, of the 437-DOF test family, a
#: wider s with a short m, path H's full annulus, and path I's Hermite
#: Rijke and APE duct (on random inputs, where float32 loses no digits)
K3_SHAPES = [(2, 60, 256), (2, 13, 128), (2, 5, 384), (2, 45, 768),
             (2, 20, 1280), (2, 24, 640)]
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
#: path H: JAX host values on the CPU, computed by
#:   JAX_PLATFORMS=cpu PYTHONPATH=. python3 tools/jax_references.py bloch
#: the 12-sector annulus annular_halfcell(DOS=12, nr=4, nphi=4, nz=48),
#: c = 347 m/s below z = 0.2 m and 850 m/s above (per tet), Outlet Y = 1e15;
#: mslp(tol=1e-11, scale=2π, maxiter=30) at b = 0…6 from BLOCH_GUESSES on
#: the unit cell, the full annulus from the b = 1 frequency, the sweep from
#: the same guesses, and b = 1 on the 984-DOF cell (nr=3, nphi=3, nz=40)
#: from 426 Hz
BLOCH_GUESSES = (337.0, 426.0, 593.0, 782.0, 980.0, 1184.0, 1393.0)
BLOCH_1960_OMEGA = (2115.259577886463 + 8.270111377168796e-13j,
                    2674.8316377855595 + 4.849946438006573e-13j,
                    3728.4716410486753 + 3.2021735743042276e-14j,
                    4911.076238468039 - 7.800939780260357e-15j,
                    6158.8756201590495 - 2.5013257504584906e-14j,
                    7441.495459432678 + 1.9782855946943142e-14j,
                    8753.123271317338 + 7.49268694037311e-19j)
BLOCH_23520_OMEGA = 2674.8316377855595 + 2.2406740485653811e-13j
BLOCH_SWEEP_OMEGA = (2115.259577886461 + 8.270111377168721e-13j,
                     2674.8316377855676 + 6.364897683031014e-13j,
                     3728.4716410486726 + 6.383670691804471e-14j,
                     4911.076238468036 - 2.098187904020768e-13j,
                     6158.875620159046 - 1.5267019948548564e-13j,
                     7441.495459432679 + 1.9248423232212965e-13j,
                     8753.123271317338 + 7.492686947010038e-19j)
BLOCH_984_OMEGA = 2662.43241555504 + 2.4375002297671426e-13j
BLOCH_KW = dict(tol=1e-11, scale=2 * np.pi, maxiter=30)
#: |f_unit − f_full| (Hz), and the full operator's residual of the expanded
#: eigenvector: the bars of tests/test_bloch.py:66,96
BLOCH_UNIT_FULL_HZ, BLOCH_RES = 1e-8, 1e-12
#: path I: JAX host values on the CPU, computed by
#:   JAX_PLATFORMS=cpu PYTHONPATH=. python3 tools/jax_references.py frontends
#: I1: the 7,259-DOF active Rijke (rijke_mesh(4, 58, 58)) with its flame
#: replaced by the scalar fancyflame (n 1, τ 1e-3, a −1e-8), tutorial 08's
#: custom n–τ FTF (against OMEGA_7259, the built-in flame's) and the
#: two-branch fancyflame FANCY_LIST, mslp from Z0 at I1_KW
FANCY_LIST = (["n1", "n2"], ["τ1", "τ2"], ["a1", "a2"], [0.7, 0.3],
              [1e-3, 1.5e-3], [-1e-8, -2e-8])
I1_KW = dict(maxiter=30, tol=1e-10)
OMEGA_7259_FANCY = 1089.0759764935967 + 380.102109046612j
OMEGA_7259_FANCY_LIST = 1051.1707281219417 + 443.2655856132017j
#: I2: the active Rijke on rijke_mesh(3, 17, 17) with cubic Hermite
#: elements (19,674 DOF), mslp from Z0 at I2_KW (JAX host reaches flag 0
#: there in 6 steps); p and n·∇p at the flame's reference point over p at
#: X_NORM, of the eigenvector (getters get_p / get_n_grad_p)
I2_KW = dict(maxiter=30, tol=1e-8)
X_NORM = [0.01, 0.0, -0.2]
OMEGA_HERM_19674 = 1079.6694682771572 + 375.26951590767567j
HERM_19674_POINT = (0.7688893915642817 - 0.17335253741897477j,
                    -1.9886722407679345 - 1.3876364351346282j)
POINT_RTOL = 1e-6
#: I3: tutorial 11's APE duct on box_mesh(0.25, 0.25, 1.0, 4, 4, 24), q =
#: 0.05 m³/s through Zmin/Zmax, the Hermite potential flow (order "lin"),
#: mslp from 1.05·iπc at I3_KW; the eigenvalue symbol is s
APE_Q = 0.05
I3_KW = dict(maxiter=30, tol=1e-9)
S_APE = 4.873983706890269e-11 + 1069.1587105522558j
#: I4: tutorial 12's networks (c 347 m/s, A 0.01 m²): the closed–open duct
#: (mslp from 2π·80 Hz; Beyn over NET_GAMMA, l=6, K=2, N=64, res_tol
#: 1e-6), the Rijke network at n = 0 (from 2π·150 Hz) and n = 0.3 (from the
#: n = 0 mode), and the Helmholtz-damper network (from 2π·90 Hz)
NET_C, NET_A = 347.0, 0.01
NET_GAMMA = 2 * np.pi * np.array([20 + 20j, 20 - 20j, 500 - 20j, 500 + 20j])
NET_DUCT = 545.0663253978291 - 3.170608645964694e-14j
NET_DUCT_BEYN = (2725.3316269892857 + 1.5137521743115685e-10j,
                 1635.1989761934328 + 8.252813607439369e-11j,
                 545.0663253972237 - 1.650464687717564e-10j)
NET_RIJKE_N0 = 854.2858356344977 + 8.885083621635902e-14j
NET_RIJKE_N03 = 746.8076327231503 + 72.90219377743024j
NET_DAMPER = 541.7820586624792 + 0.001099080835227043j
#: the duct's first mode against c/4L
NET_F1_RTOL = 1e-6
#: I5: the 1,369-DOF active Rijke (rijke_mesh(3, 17, 17)),
#: householder(Z0, maxiter=20, tol=1e-11, order=2), the discrete-adjoint
#: sensitivity over every surface point (h 1e-8): its largest entry, the sum
#: of its z-components over the Outlet's points, and its entries (x, y, z)
#: at the six points linspace(0, n_surface − 1, 6) of the surface points;
#: the finite differences (h 1e-6) at those points, where the JAX package
#: returns (None where it raises IndexError, ROADMAP.md Queue 3 F6)
OMEGA_1369_H2 = 1075.8988207005825 + 376.3799204921499j
SENS_MAX = -44770.86668832157 + 18488.532292261614j
SENS_OUTLET_Z = -1571.9660576008487 - 1038.4961462185152j
SENS_PICKED = (
    (1.7010061650564456e-05 - 3.7511005549654974e-05j,
     3.501129513724943e-05 + 1.9684880702530716e-05j,
     53.362485901638735 + 58.06901670492694j),
    (30.30197621547137 + 23.866375562630232j,
     52.48512287938182 + 41.33925424775005j,
     -0.00010150196777658493 + 0.006485939831065934j),
    (77.93677556486217 - 26.937212792455707j,
     -0.3439732274180002 - 0.13030471803701632j,
     -0.1905743428714004 - 0.03386629016620191j),
    (48.08925876883153 + 19.73102514418711j,
     -56.611927975516416 - 19.651114452891477j,
     0.05126153859208671 + 0.007198873693937458j),
    (76.63904632274425 + 46.51004202325207j,
     64.41855633476621 + 39.35501820254267j,
     -1.5759365410872306e-05 + 4.536974685720452e-05j),
    (47.04640703761708 + 31.067682460163212j,
     -20.32337166078758 - 13.420611068632068j,
     -29.454087369911047 - 19.45933363252556j))
FD_PICKED = (None, None,
             (77.9355228814893 - 26.939698528849476j,
              -0.34397760373394703 - 0.13032220635977865j,
              -0.20967172531527467 - 0.07282153546839254j),
             None, None, None)
#: the DA values against JAX's: the largest entry and the outlet sum each
#: relative to itself; the six picked entries relative to the largest of
#: them, at a bar above the DA's own round-off resolution (its central
#: difference of the operator at h = 1e-8 moves the picked entries by
#: 1.3e-6 to 1.7e-6 of the largest when h is 2e-8 or 5e-9, JAX host,
#: tools/jax_references.py frontends shape); DA against FD: the bar of
#: tests/test_shape.py:50
SENS_RTOL, PICKED_RTOL, DA_FD_RTOL = 1e-6, 1e-5, 5e-3
#: path J: the fitted flame of tests/test_fitting.py:47-72 (vector fitting
#: of the noise-free n–τ response, τ 1e-3, order 12, 120 points from 100 to
#: 600 Hz; its largest error against the samples within FIT_ERR) on the
#: 7,259-DOF Rijke with the speed of sound per point and the flame
#: referenced 1.2 mm upstream; JAX host mslp from Z0 (maxiter 20, tol
#: 1e-10) with the fitted flame and with the built-in n–τ flame, computed by
#:   JAX_PLATFORMS=cpu PYTHONPATH=. python3 tools/jax_references.py io
FIT_FREQS, FIT_TAU, FIT_ORDER = np.linspace(100, 600, 120), 1e-3, 12
FIT_X_REF, FIT_ERR = [0.0, 0.0, -0.0012], 1e-6
OMEGA_7259_FITTED = 1074.8973884206362 + 373.89254677273397j
OMEGA_7259_FIT_NTAU = 1074.8957455993418 + 373.89096626744697j
#: the fitted flame's ω against the n–τ flame's: tests/test_fitting.py:72
FIT_NTAU_RTOL = 1e-3
#: J1's and J4's ω (a gmsh copy of the slab path's mesh, its simplices in
#: Mesh.from_raw's order) against the slab path's; a family reloaded from
#: npz re-solved, and one reloaded from TOML applied, against the original
J_SAME_RTOL, J_RELOAD_RTOL = 1e-12, 1e-14
#: path K: the row parts of the sharded apply (K1) and contour (K2) on the
#: one card; K1 against the complex128 CSR product, row-wise (the product
#: is complex128 throughout); K3's sharded dense contour against the
#: unsharded one, relative to |ω|
K_ROW_PARTS, K1_ROW_RTOL, K3_DENSE_RTOL = 4, 1e-12, 1e-12


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def bound(nbytes, flops):
    """(bound_ms, bound_by): :func:`portbench.roofline.bound_s` in ms, and
    which of the bytes or the operations sets it."""
    by_bytes = nbytes / HBM_BYTES_PER_S >= flops / FP32_FLOPS_PER_S
    return bound_s(nbytes, flops) * 1e3, "bytes" if by_bytes else "operations"


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
    ``tools/patched_kernel.build_patched`` with no line changed), and g++
    on the port's host library beside them; then load each."""
    import importlib
    from concurrent.futures import ThreadPoolExecutor

    sys.path.insert(0, TOOLS)
    from patched_kernel import build_patched

    from wavesandeigenvalues_jl_tpu_torch import native
    from wavesandeigenvalues_jl_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        yardstick = pool.submit(build_patched, "warp_row_spmm", [], [],
                                "as_is", WARP_ROW)
        host = pool.submit(native.build)
        info = cuda_build.compile_all()
        lib = yardstick.result()
        host = host.result()
    wall = time.perf_counter() - t0
    native.load()
    for name in cuda_build.KERNELS:
        importlib.import_module(
            f"wavesandeigenvalues_jl_tpu_torch.ops.{name}").build()
    for name, rec in info.items():
        ptxas = " ".join(ln.strip() for ln in rec["log"].splitlines()
                         if "registers" in ln or "spill" in ln)
        print(f"build: {name} {rec['path']} nvcc {rec['seconds']:.2f} s | "
              f"{ptxas}", flush=True)
    print(f"build: host_kernels {host['path']} g++ {host['seconds']:.2f} s",
          flush=True)
    print(f"build: {len(info)} kernels, the warp-per-row yardstick and the "
          f"host library in {wall:.2f} s of wall, loaded in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
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


#: the kernel wrappers whose launches and plain calls ``utils.timing``
#: counts (``<kernel>.launches``, ``<kernel>.twin_calls``)
KERNELS = ("slab_thomas", "dense_gmres", "bsr_spmm", "window_spmm")
#: what read_counts() subtracts from the counters' totals
_COUNT_BASE = {k: (0, 0) for k in KERNELS}


def _count_totals():
    from wavesandeigenvalues_jl_tpu_torch.utils import timing
    return {k: (timing.total(f"{k}.launches"),
                timing.total(f"{k}.twin_calls")) for k in KERNELS}


def reset_counts():
    _COUNT_BASE.update(_count_totals())


def read_counts():
    """{kernel: (launches, plain calls)} since the last reset_counts()."""
    return {k: (a - _COUNT_BASE[k][0], b - _COUNT_BASE[k][1])
            for k, (a, b) in _count_totals().items()}


def reset_timing():
    """``utils.timing.reset()``, the kernel counts of read_counts() running
    on across it."""
    from wavesandeigenvalues_jl_tpu_torch.utils import timing
    counted = read_counts()
    timing.reset()
    _COUNT_BASE.update({k: (-a, -b) for k, (a, b) in counted.items()})


def _compare_k3(st, b, label, exact=False):
    """K3 against slab_thomas_ref on the card on one input (stream
    [sides, 2m, s, s], rhs [sides, m, s]): print its line, check it and
    return its record.  The check is K3_RTOL against the plain complex64
    version; with ``exact`` it is against the plain version run in
    complex128 on the same input instead: K3 within COND_FACTOR times
    the plain complex64 version's own error there (or K3_RTOL), for inputs
    on which float32 itself loses digits."""
    from wavesandeigenvalues_jl_tpu_torch.ops.slab_thomas import (
        slab_thomas, slab_thomas_ref)
    from wavesandeigenvalues_jl_tpu_torch.utils.timing import device_ms
    sides, m, s = b.shape
    ref = slab_thomas_ref(st, b)
    err, outs = _max_err(lambda: slab_thomas(st, b), ref, f"K3 {label}")
    rel = err / ref.abs().max().item()
    extra, ok = "", rel <= K3_RTOL
    if exact:
        ref128 = slab_thomas_ref(st.to(torch.complex128),
                                 b.to(torch.complex128))
        scale = ref128.abs().max().item()
        plain128 = (ref - ref128).abs().max().item() / scale
        k128 = max((y - ref128).abs().max().item() for y in outs) / scale
        bar = max(K3_RTOL, COND_FACTOR * plain128)
        W = st[:, :m].to(torch.complex128)
        w2 = torch.linalg.eigvalsh(W.mH @ W).max().sqrt().item()
        del W
        del ref128
        extra = (f" | max ‖W_i‖₂ {w2:.1f}; against the complex128 "
                 f"recursion: kernel {k128:.3e}, "
                 f"plain complex64 {plain128:.3e} (bar {bar:.3e} = max("
                 f"{K3_RTOL:.0e}, {COND_FACTOR} x plain's))")
        ok = k128 <= bar
    del outs
    ms = _median_ms(lambda: slab_thomas(st, b))
    dev_ms = device_ms(lambda: slab_thomas(st, b))
    plain_ms = _median_ms(lambda: slab_thomas_ref(st, b))
    bound_ms, bound_by = bound(*slab_thomas_work(sides, m, s))
    gbs = sides * 2 * m * s * s * 8 / (dev_ms * 1e-3) / 1e9
    print(f"K3 (sides, m, s)=({sides}, {m}, {s}) {label}: max abs err over "
          f"{REPEATS} launches {err:.3e} rel {rel:.3e} (tol "
          f"{'see below' if exact else f'{K3_RTOL:.0e}'}){extra} | kernel "
          f"{ms:.4f} ms a call with the host's launch, {dev_ms:.4f} ms on "
          f"the device ({gbs:.1f} GB/s of stream, "
          f"{dev_ms / (2 * m) * 1e3:.2f} us a step), plain {plain_ms:.4f} "
          f"ms, bound {bound_ms:.4f} ms ({bound_by}); no single PyTorch "
          "call computes the block recursion", flush=True)
    check(ok, f"K3 {label} disagrees with its plain version: {rel}"
          + extra)
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


def _compare_k2(P, b, m, cycles, tol, label, extra=lambda x: "",
                exact=False):
    """K2 against dense_gmres_ref on the card on one input (P [S, N, N],
    b [S, N]) over REPEATS launches (each into its own output, every one
    the same bits), with torch.linalg.solve as the library yardstick:
    print its line (``extra(x)`` appended), check it at ``tol`` and return
    its record.  With ``exact``, for an input on which GMRES(m) stops far
    from convergence (so that x is not determined to float32 precision),
    the check is on the quantity GMRES minimises instead: K2's residual
    ‖Px − b‖/‖b‖, in complex128, within COND_FACTOR times the plain
    complex64 version's; the distances of both x to the plain version run
    in complex128 are printed beside it."""
    from wavesandeigenvalues_jl_tpu_torch.ops.dense_gmres import (
        dense_gmres, dense_gmres_ref, plan, sm_count)
    from wavesandeigenvalues_jl_tpu_torch.utils.timing import (device_ms,
                                                               events_ms)
    S, N = b.shape
    ref = dense_gmres_ref(P, b, m, cycles)
    err, xs = _max_err(lambda: dense_gmres(P, b, m, cycles), ref,
                       f"K2 {label}")
    same = all(torch.equal(y, xs[0]) for y in xs)
    x = xs[0]
    del xs
    rel = err / ref.abs().max().item()
    ok, exact_txt = rel <= tol, ""
    if exact:
        P128, b128 = P.to(torch.complex128), b.to(torch.complex128)
        ref128 = dense_gmres_ref(P128, b128, m, cycles)
        scale = ref128.abs().max().item()
        d = [(y - ref128).abs().max().item() / scale for y in (x, ref)]
        r = [((P128 @ y.to(torch.complex128).unsqueeze(-1)).squeeze(-1)
              - b128).norm(dim=-1).div(b128.norm(dim=-1)).max().item()
             for y in (x, ref, ref128)]
        bar = COND_FACTOR * r[1]
        del P128, b128, ref128
        exact_txt = (f"; x against the plain version in complex128: kernel "
                     f"{d[0]:.3e}, plain complex64 {d[1]:.3e}; residual "
                     f"‖Px−b‖/‖b‖ in complex128: kernel {r[0]:.3e}, plain "
                     f"complex64 {r[1]:.3e}, plain complex128 {r[2]:.3e} "
                     f"(bar {bar:.3e} = {COND_FACTOR} x plain complex64's)")
        ok = r[0] <= bar
    # preconditioned residuals ‖P x − b‖/‖b‖ of kernel and plain
    res = [((P @ y.unsqueeze(-1)).squeeze(-1) - b).norm(dim=-1)
           .div(b.norm(dim=-1)).max().item() for y in (x, ref)]
    ms = _median_ms(lambda: dense_gmres(P, b, m, cycles))
    dev_ms = device_ms(lambda: dense_gmres(P, b, m, cycles))
    plain_ms = _median_ms(lambda: dense_gmres_ref(P, b, m, cycles),
                          reps=3, warmup=1)
    # the yardstick solves the same systems with the padding rows of P
    # (all zero, with zero rhs) given a unit diagonal, since
    # torch.linalg.solve refuses a singular matrix
    Pl = P.clone()
    dead = Pl.abs().sum(-1) == 0
    Pl.diagonal(dim1=-2, dim2=-1)[dead] = 1
    # cuSOLVER refuses graph capture: its device time is taken by CUDA
    # events over back-to-back calls
    library_ms = _median_ms(lambda: torch.linalg.solve(Pl, b))
    library_dev = events_ms(lambda: torch.linalg.solve(Pl, b))
    library = (f"torch.linalg.solve {library_ms:.4f} ms a call, "
               f"{library_dev:.4f} ms by CUDA events over 20 "
               "back-to-back calls")
    bound_ms, bound_by = bound(*dense_gmres_work(S, N, m, cycles))
    pl = plan(S, N, m, sm_count(P.device))
    step_us = dev_ms / ((m + 1) * cycles) * 1e3
    print(f"K2 (sides, N, m, cycles)=({S}, {N}, {m}, {cycles}) {label}, "
          f"{pl.G} row blocks of {pl.R} rows a side ({pl.res} resident) + "
          f"{S} Givens blocks, {pl.smem} B of shared memory: over {REPEATS} "
          f"launches max abs err {err:.3e} rel {rel:.3e} ("
          + (exact_txt[2:] if exact else f"tol {tol:.0e}")
          + f"), every launch the same bits: {same} | residual ‖Px−b‖/‖b‖ "
          f"kernel {res[0]:.3e} plain {res[1]:.3e} | kernel {ms:.4f} ms a "
          f"call, {dev_ms:.4f} ms on the device ({step_us:.2f} us a step), "
          f"plain {plain_ms:.4f} ms, {library}, bound {bound_ms:.4f} ms "
          f"({bound_by})" + extra(x), flush=True)
    check(ok, f"K2 {label} disagrees with its plain version at N={N}: "
          f"{rel:.3e} > {tol:.0e}{exact_txt}")
    check(same, f"K2 {label} launches at N={N} differ")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "device_ms": dev_ms,
            "library_device_ms": library_dev}


def phase_compare_k2(L1369):
    """K2 against dense_gmres_ref on the card: the JAX test problem (with
    its true residuals) and the first K2 input of the 1,369-DOF mslp."""
    from wavesandeigenvalues_jl_tpu_torch.ops.gmres import gmres_test_problem
    P, b, Gs, b_host = gmres_test_problem(256)
    true = []

    def true_residuals(x):
        xh = x.cpu().numpy().astype(np.complex128)
        true.extend(np.linalg.norm(Gs[s] @ xh[s] - b_host)
                    / np.linalg.norm(b_host) for s in range(2))
        return (f" | true residuals {true[0]:.3e} {true[1]:.3e} (tol "
                f"{K2_RES:.0e})")

    out = {(2, 256, 30, 2): _compare_k2(
        torch.from_numpy(P).cuda(), torch.from_numpy(b).cuda(), 30, 2,
        K2_RTOL, "test problem", true_residuals)}
    check(max(true) <= K2_RES, f"K2 residual {max(true):.3e}")
    P1, b1 = _first_dense_step(L1369)
    out[(2, P1.shape[1], 80, 1)] = _compare_k2(P1, b1, 80, 1, K2_MAIN_RTOL,
                                               "path A first step")
    return out


def _run_mslp(L, label, expected_n, omega_ref, solver_cls, kernel):
    """Drive mslp on the card with the counters set to 0 just before it;
    print its line, check it, and return the counts read just after and
    the eigenvalue.  The
    fused engine must carry the whole solve: its hand-over to the general
    engine (a non-finite device step) is an error here, every iteration
    must be one of its device or polish steps, and no phase of the general
    engine may have run."""
    import warnings

    from wavesandeigenvalues_jl_tpu_torch.nlevp import mslp
    from wavesandeigenvalues_jl_tpu_torch.utils import timing

    check(L.size == expected_n, f"family dimension {L.size}, expected "
          f"{expected_n}")
    reset_timing()
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
    return counts, om


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

    reset_timing()
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
    return counts, L, plan, X, Y


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
    from wavesandeigenvalues_jl_tpu_torch.utils import timing
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
    moved = {k: timing.total(f"device_solve.{k}_bytes") / 2**20
             for k in ("to_device", "to_host")}
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
    reset_timing()
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
    reset_timing()
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
        reset_timing()
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
    return wall, L2, mg


@contextlib.contextmanager
def _kept_inputs(module, name, last=True):
    """Within the block, ``module.name`` (a kernel wrapper as a solver
    module looks it up) keeps copies of its tensor arguments: the first
    call's, and with ``last`` the last call's after it.  Yields the list
    of kept argument tuples."""
    launch = getattr(module, name)
    kept = []

    def keeping(*args):
        if last or not kept:
            del kept[1:]
            kept.append(tuple(a.clone() if isinstance(a, torch.Tensor)
                              else a for a in args))
        return launch(*args)

    setattr(module, name, keeping)
    try:
        yield kept
    finally:
        setattr(module, name, launch)


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
    with _kept_inputs(fused_slab, "slab_thomas") as k3_inputs:
        reset_timing()
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


def _bloch_family(nr, nphi, nz, unit):
    """(mesh, family) of path H's 12-sector annulus built by the port:
    the unit cell (Bloch-reduced, parameter "b") or the full annulus."""
    from wavesandeigenvalues_jl_tpu_torch.mesh import (annular_halfcell,
                                                       extend_mesh)
    from wavesandeigenvalues_jl_tpu_torch.models import discretize
    half = annular_halfcell(DOS=12, nr=nr, nphi=nphi, nz=nz)
    mesh = extend_mesh(half, [("Interior", "full"), ("Outlet", "full")],
                       unit=unit)
    c = mesh.generate_field(lambda x, y, z: np.where(z < 0.2, 347.0, 850.0),
                            order="const")
    L = discretize(mesh, {"Interior": ("interior", ()),
                          "Outlet": ("admittance", ("Y", 1e15))}, c,
                   b="b" if unit else None)
    return mesh, L


def _fused_mslp(L, f0, label, solver_cls, kw=BLOCH_KW):
    """mslp(L, f0) on the card at ``kw`` with the fused engine's
    hand-over turned into an error: every iteration must be one of its
    device or polish steps and no phase of the general engine may run.
    Returns (solution, iterations, flag, device steps, polish steps)."""
    import warnings

    from wavesandeigenvalues_jl_tpu_torch.nlevp import mslp
    from wavesandeigenvalues_jl_tpu_torch.utils import timing
    reset_timing()
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="fused device step",
                                category=RuntimeWarning)
        sol, n_it, flag = mslp(L, f0, **kw)
    rep = timing.report()
    steps = rep.get("fused_local.device_step", {"calls": 0})["calls"]
    polish = rep.get("fused_local.polish_step", {"calls": 0})["calls"]
    solver = L._fused_solver[1]
    check(isinstance(solver, solver_cls),
          f"{label}: solver {type(solver).__name__}")
    check(1 <= steps <= n_it <= steps + polish, f"{label}: {n_it} "
          f"iterations from {steps} device and {polish} polish steps")
    general = sorted(k for k in rep if "device_solve" in k
                     or "dual_arnoldi" in k)
    check(not general, f"{label}: the general engine ran {general}")
    check(sol.v.shape == (L.size,) and np.isfinite(sol.v).all(),
          f"{label}: eigenvector not finite")
    return sol, n_it, flag, steps, polish


def _rel(a, b):
    return abs(a - b) / abs(b)


def phase_bloch_path(card):
    """Path H: the 12-sector annular combustor on the card.  Each part is
    driven with the counters set to 0 just before it and read just after.
    H1: mslp at b = 0…6 on the 1,960-DOF unit cell from BLOCH_GUESSES
    through the slab engine and K3; H2: the 23,520-DOF full annulus from
    H1's b = 1 frequency through the slab engine and K3; H3: H1's b = 1
    eigenvector expanded to the full annulus, its residual there; H4:
    bloch_mode_sweep over b = 0…6 (plain PyTorch: no kernel); H5: b = 1 on
    the 984-DOF cell through the dense engine and K2.  After the counts
    are read, K3 is held against its plain version on the first and the
    last of H1's and of H2's own inputs, and K2 on H5's first.  Returns
    the counts and kernel records of H1, H2 and H5."""
    import scipy.sparse as sp
    import scipy.sparse.linalg  # noqa: F401  (sp.linalg.norm)

    from wavesandeigenvalues_jl_tpu_torch.mesh import bloch_expand
    from wavesandeigenvalues_jl_tpu_torch.nlevp import (bloch_mode_sweep,
                                                        fused_local,
                                                        fused_slab)
    from wavesandeigenvalues_jl_tpu_torch.nlevp.bloch_sweep import (
        SweepStep, sweep_coefficients)
    from wavesandeigenvalues_jl_tpu_torch.utils import timing
    from wavesandeigenvalues_jl_tpu_torch.utils.timing import events_ms
    Slab = fused_slab.FusedSlabPencilSolver
    fmt = lambda xs: "[" + ", ".join(f"{x:.3e}" for x in xs) + "]"  # noqa
    out = {}

    # H1: the unit cell, b = 0…6
    t0 = time.perf_counter()
    unit, Lu = _bloch_family(4, 4, 48, unit=True)
    build = time.perf_counter() - t0
    check(Lu.size == 1960 and unit.dos.DOS == 12,
          f"path H unit cell n={Lu.size} DOS={unit.dos.DOS}")
    sols, flags, its, steps, polish = [], [], [], 0, 0
    with _kept_inputs(fused_slab, "slab_thomas") as k3_unit:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        for b, f0 in enumerate(BLOCH_GUESSES):
            Lu.params["b"] = float(b)
            sol, n_it, flag, st, po = _fused_mslp(Lu, f0, f"H1 b={b}", Slab)
            sols.append(sol)
            flags.append(flag)
            its.append(n_it)
            steps, polish = steps + st, polish + po
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    om = [s.params["ω"] for s in sols]
    rel = [_rel(a, b) for a, b in zip(om, BLOCH_1960_OMEGA)]
    solver = Lu._fused_solver[1]
    print(f"main path H1 (unit cell, mslp b=0..6) on {card}: n={Lu.size} "
          f"DOS={unit.dos.DOS} (meshes + discretize {build:.2f} s) "
          f"{type(solver).__name__}, slab partition m={solver.part.m} "
          f"smax={solver.part.smax}, K3 at (2, {solver.m}, {solver.s}) | "
          f"wall {wall:.3f} s ({steps} fused device steps, {polish} polish "
          f"steps) | iterations {its} flags {flags} | Hz "
          + ", ".join(f"{w.real / 2 / np.pi:.6f}" for w in om)
          + f" | omega rel err {fmt(rel)} (tol {OMEGA_RTOL:.0e}) | peak "
          f"device memory {peak / 2**20:.1f} MiB | launches, plain calls "
          f"{counts}", flush=True)
    check(all(f == 0 for f in flags), f"H1 flags {flags}")
    check(max(rel) <= OMEGA_RTOL, f"H1 omega off by {max(rel):.3e}")
    check(counts["slab_thomas"][0] > 0, "H1 never launched slab_thomas")
    check(all(t == 0 for _, t in counts.values()),
          f"H1 ran a plain kernel version: {counts}")
    check(len(k3_unit) == 2 and tuple(k3_unit[0][1].shape) == (2, 48, 128),
          f"H1 K3 inputs {[tuple(k[1].shape) for k in k3_unit]}")
    out["unit"] = (counts, max((_compare_k3(st, b, f"path H1 {w} launch")
                                for w, (st, b) in zip(("first", "last"),
                                                      k3_unit)),
                               key=lambda r: r["max_abs_err"]))
    del k3_unit

    # H2: the full annulus from H1's b = 1 frequency
    t0 = time.perf_counter()
    full, Lf = _bloch_family(4, 4, 48, unit=False)
    build = time.perf_counter() - t0
    check(Lf.size == 23520, f"path H full annulus n={Lf.size}")
    f1 = om[1] / 2 / np.pi
    with _kept_inputs(fused_slab, "slab_thomas") as k3_full:
        reset_timing()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        solf, n_it, flag, st, po = _fused_mslp(Lf, f1.real, "H2", Slab)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    setup = timing.report().get("fused_local.setup", {"total_s": 0.0})
    peak = torch.cuda.max_memory_allocated()
    omf = solf.params["ω"]
    gap = abs(om[1] - omf) / 2 / np.pi
    relf = _rel(omf, BLOCH_23520_OMEGA)
    solver = Lf._fused_solver[1]
    print(f"main path H2 (full annulus, mslp from H1's b=1) on {card}: "
          f"n={Lf.size} (mesh + discretize {build:.2f} s) "
          f"{type(solver).__name__}, slab partition m={solver.part.m} "
          f"smax={solver.part.smax}, K3 at (2, {solver.m}, {solver.s}), "
          f"stream {2 * 2 * solver.m * solver.s ** 2 * 8 / 1e9:.2f} GB | "
          f"wall {wall:.3f} s (setup {setup['total_s']:.3f} s, {st} fused "
          f"device steps, {po} polish steps) | iterations {n_it} flag "
          f"{flag} | {omf.real / 2 / np.pi!r} Hz, |f_unit - f_full| "
          f"{gap:.3e} Hz (tol {BLOCH_UNIT_FULL_HZ:.0e}), omega rel err "
          f"{relf:.3e} (tol {OMEGA_RTOL:.0e}) | peak device memory "
          f"{peak / 2**20:.1f} MiB | launches, plain calls {counts}",
          flush=True)
    check(flag == 0, f"H2 flag {flag}")
    check(gap <= BLOCH_UNIT_FULL_HZ, f"H2 |f_unit - f_full| {gap:.3e} Hz")
    check(relf <= OMEGA_RTOL, f"H2 omega off by {relf:.3e}")
    check(counts["slab_thomas"][0] > 0, "H2 never launched slab_thomas")
    check(all(t == 0 for _, t in counts.values()),
          f"H2 ran a plain kernel version: {counts}")
    check(len(k3_full) == 2 and tuple(k3_full[0][1].shape) == (2, 45, 768),
          f"H2 K3 inputs {[tuple(k[1].shape) for k in k3_full]}")
    out["full"] = (counts, max((_compare_k3(st, b, f"path H2 {w} launch",
                                            exact=True)
                                for w, (st, b) in zip(("first", "last"),
                                                      k3_full)),
                               key=lambda r: r["max_abs_err"]))
    del k3_full
    Lf._fused_solver = None

    # H3: H1's b = 1 eigenvector on the full annulus (host complex128)
    reset_counts()
    t0 = time.perf_counter()
    v = bloch_expand(unit, sols[1], "b")
    A = Lf(om[1])
    A = sp.csr_matrix((A.data, A.indices, A.indptr), shape=A.shape)
    res = np.linalg.norm(A @ v) / (np.linalg.norm(v)
                                   * sp.linalg.norm(A, "fro"))
    counts = read_counts()
    print(f"main path H3 (bloch_expand of H1's b=1 eigenvector): "
          f"len {len(v)} = full n {Lf.size} | ‖L_full(ω)v‖/(‖v‖‖L_full(ω)‖_F)"
          f" {res:.3e} (tol {BLOCH_RES:.0e}), host complex128 sparse | wall "
          f"{time.perf_counter() - t0:.3f} s | launches, plain calls "
          f"{counts}", flush=True)
    check(len(v) == Lf.size and res <= BLOCH_RES,
          f"H3 residual {res:.3e} (length {len(v)})")
    del Lf, A

    # H4: the batched sweep on the card
    reset_timing()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    swept = bloch_mode_sweep(Lu, np.asarray(BLOCH_GUESSES), range(7),
                             **BLOCH_KW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    rep = timing.report()
    part = {k.split(".")[-1]: (v["calls"], v["total_s"])
            for k, v in rep.items() if k.startswith("bloch_sweep.")}
    oms = [s.params["ω"] for s, _, _ in swept]
    fl = [f for _, _, f in swept]
    rel_h1 = [_rel(a, b) for a, b in zip(oms, om)]
    rel_jax = [_rel(a, b) for a, b in zip(oms, BLOCH_SWEEP_OMEGA)]
    # the step's batched complex64 LU at the sweep's last iterate, timed
    # by CUDA events (cuSOLVER refuses graph capture)
    sw = SweepStep(Lu, "cuda")
    c, _ = sweep_coefficients(Lu, oms, range(7), "b", sw.k_aux)
    Ab = sw.operators(torch.from_numpy(c).cuda())
    lu_ms = events_ms(lambda: sw.factor(Ab))
    n_steps = part.get("device_step", (0, 0.0))[0]
    print(f"main path H4 (bloch_mode_sweep b=0..6) on {card}: n={Lu.size}, "
          f"batched LU on [{Ab.shape[0]}, {sw.N}, {sw.N}] complex64 | wall "
          f"{wall:.3f} s: "
          + ", ".join(f"{k} {n} in {t:.3f} s" for k, (n, t) in part.items())
          + f" | LU {lu_ms:.3f} ms a step by CUDA events, "
          f"{n_steps * lu_ms / 1e3 / wall:.2%} of the wall | iterations "
          f"{[n for _, n, _ in swept]} flags {fl} | omega rel err vs H1 "
          f"{fmt(rel_h1)}, vs the JAX sweep {fmt(rel_jax)} (tol "
          f"{OMEGA_RTOL:.0e}) | peak device memory {peak / 2**20:.1f} MiB | "
          f"launches, plain calls {counts}", flush=True)
    check(all(f == 0 for f in fl), f"H4 flags {fl}")
    check(n_steps >= 1, f"H4: {n_steps} batched device steps")
    check(max(rel_h1) <= OMEGA_RTOL and max(rel_jax) <= OMEGA_RTOL,
          f"H4 omega off by {max(rel_h1):.3e} (H1), {max(rel_jax):.3e} "
          "(JAX sweep)")
    check(all(c == (0, 0) for c in counts.values()),
          f"H4 launched a kernel or its plain version: {counts}")
    del sw, Ab

    # H5: the 984-DOF cell through the dense engine and K2
    _, L984 = _bloch_family(3, 3, 40, unit=True)
    check(L984.size == 984, f"path H5 cell n={L984.size}")
    L984.params["b"] = 1.0
    with _kept_inputs(fused_local, "dense_gmres", last=False) as k2_in:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        sol, n_it, flag, st, po = _fused_mslp(
            L984, 426.0, "H5", fused_local.FusedPencilSolver)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    rel5 = _rel(sol.params["ω"], BLOCH_984_OMEGA)
    N = L984._fused_solver[1].N
    print(f"main path H5 (dense engine, b=1) on {card}: n={L984.size}, "
          f"K2 at N={N} | wall {wall:.3f} s ({st} fused device steps, {po} "
          f"polish steps) | iterations {n_it} flag {flag} | "
          f"{sol.params['ω'].real / 2 / np.pi!r} Hz, omega rel err "
          f"{rel5:.3e} (tol {OMEGA_RTOL:.0e}) | launches, plain calls "
          f"{counts}", flush=True)
    check(flag == 0, f"H5 flag {flag}")
    check(rel5 <= OMEGA_RTOL, f"H5 omega off by {rel5:.3e}")
    check(counts["dense_gmres"][0] > 0, "H5 never launched dense_gmres")
    check(all(t == 0 for _, t in counts.values()),
          f"H5 ran a plain kernel version: {counts}")
    P, b, m, cycles = k2_in[0]
    check(N == 1024 and tuple(b.shape) == (2, 1024),
          f"H5 K2 input {tuple(b.shape)}")
    out["dense"] = (counts, _compare_k2(P, b, m, cycles, K2_MAIN_RTOL,
                                        "path H5 first launch", exact=True))
    return out


def _flame(kind, *tail):
    """The active Rijke's Flame descriptor of ``kind`` with the data
    ``tail`` after (γ, ρ, Q02U0, x_ref, n_ref)."""
    from wavesandeigenvalues_jl_tpu_torch.models.rijke import (GAMMA, Q02U0,
                                                               RHO)
    return (kind, (GAMMA, RHO, Q02U0, [0.0, 0.0, -0.0101], [0.0, 0.0, 1.0])
            + tail)


def _ntau_ftf(n, tau):
    """Tutorial 08's custom FTF: the n–τ flame as a ScalarFunc."""
    from wavesandeigenvalues_jl_tpu_torch.nlevp.algebra import (ScalarFunc,
                                                                exp_delay)

    class NTauFTF(ScalarFunc):
        nargs = 1

        def eval(self, values, orders):
            (z,), (k,) = values, orders
            return n * exp_delay.eval((z, tau), (k, 0))

        def symbol(self, names):
            return f"FTF({names[0]})"

    return NTauFTF()


def _driven(module, name, fn, last=True):
    """fn() with the counters set to 0 just before it and read just after,
    the wrapper ``module.name`` keeping its first (and last) inputs.
    Returns (fn's result, wall s, counts, kept inputs, peak MiB)."""
    with _kept_inputs(module, name, last) as kept:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    return out, wall, counts, kept, torch.cuda.max_memory_allocated() / 2**20


def _check_launched(label, counts, kernel):
    check(counts[kernel][0] > 0, f"{label} never launched {kernel}")
    check(all(t == 0 for _, t in counts.values()),
          f"{label} ran a plain kernel version: {counts}")


def _k3_pair(label, kept, shape):
    """K3 against its plain version (complex128-held, as path H2) on the
    first and the last of a part's own inputs; the worse record."""
    check(len(kept) == 2 and tuple(kept[0][1].shape) == shape,
          f"{label} K3 inputs {[tuple(k[1].shape) for k in kept]}, "
          f"expected {shape}")
    return max((_compare_k3(st, b, f"{label} {w} launch", exact=True)
                for w, (st, b) in zip(("first", "last"), kept)),
               key=lambda r: r["max_abs_err"])


def _phases():
    """The fused engine's phases of the last mslp (seconds)."""
    from wavesandeigenvalues_jl_tpu_torch.utils import timing
    rep = timing.report()
    return ", ".join(
        f"{k.split('.')[-1]} {rep.get(k, {'total_s': 0.0})['total_s']:.3f} s"
        for k in ("fused_local.setup", "fused_local.device_step",
                  "fused_local.polish_step"))


def _slab_line(label, card, L, res, wall, counts, peak, extra):
    """Print one slab-engine mslp line of path I and check flag 0."""
    sol, n_it, flag, st, po = res
    solver = L._fused_solver[1]
    print(f"main path {label} on {card}: n={L.size} nnz={L._stack().nnz} "
          f"{type(solver).__name__}, slab partition m={solver.part.m} "
          f"smax={solver.part.smax}, K3 at (2, {solver.m}, {solver.s}), "
          f"stream {2 * 2 * solver.m * solver.s ** 2 * 8 / 1e9:.3f} GB | "
          f"wall {wall:.3f} s ({st} fused device steps, {po} polish steps) "
          f"| iterations {n_it} flag {flag} | {extra} | peak device memory "
          f"{peak:.1f} MiB | launches, plain calls {counts}", flush=True)
    check(flag == 0, f"{label} flag {flag}")


def phase_frontends_path(card):
    """Path I: every front-end on the card, each part driven with the
    counters set to 0 just before it and read just after.  I1: the new
    coefficient functions (scalar and list fancyflame, tutorial 08's custom
    FTF) on the 7,259-DOF active Rijke through the slab engine and K3; I2:
    the Hermite active Rijke (19,674 DOF) through the slab engine and K3,
    and the point getters on its eigenvector; I3: the APE duct (12,532
    DOF) with its Hermite potential flow, through the slab engine and K3;
    I4: tutorial 12's networks through the dense engine and K2, and Beyn's
    dense backend; I5: the 1,369-DOF shape sensitivities (householder
    order 2 and the finite-difference re-solves through DeviceLU).  Each
    against pinned JAX host values; K3 against its plain version on the
    first and the last of I1's, I2's and I3's own inputs, K2 on I4's
    first.  Returns {part: (counts, record)}."""
    from wavesandeigenvalues_jl_tpu_torch.fem import get_n_grad_p, get_p
    from wavesandeigenvalues_jl_tpu_torch.mesh import box_mesh, rijke_mesh
    from wavesandeigenvalues_jl_tpu_torch.models import (
        ape, compute_potflow_field, discretize, discretize_network)
    from wavesandeigenvalues_jl_tpu_torch.models.rijke import \
        active_rijke_setup
    from wavesandeigenvalues_jl_tpu_torch.nlevp import (beyn, fused_local,
                                                        fused_slab)
    Slab = fused_slab.FusedSlabPencilSolver
    out = {}

    # I1: the new coefficient functions at the slab path's width
    mesh = rijke_mesh(n_rings=4, nz_cold=58, nz_hot=58)
    dscrp, c = active_rijke_setup(mesh)
    t0 = time.perf_counter()
    fams = [(name, discretize(mesh, dict(dscrp, Flame=flame), c), ref)
            for name, flame, ref in (
                ("fancyflame", _flame("fancyflame", "n", "τ", "a", 1.0,
                                      1e-3, -1e-8), OMEGA_7259_FANCY),
                ("custom FTF", _flame("flame", _ntau_ftf(1.0, 1e-3)),
                 OMEGA_7259),
                ("fancyflame list", _flame("fancyflame", *FANCY_LIST),
                 OMEGA_7259_FANCY_LIST))]
    build = time.perf_counter() - t0
    res, wall, counts, kept, peak = _driven(
        fused_slab, "slab_thomas",
        lambda: [_fused_mslp(L, Z0, f"I1 {name}", Slab, I1_KW)
                 for name, L, _ in fams])
    for (name, L, ref), r in zip(fams, res):
        rel = _rel(r[0].params["ω"], ref)
        check(L.size == 7259, f"I1 {name} n={L.size}")
        _slab_line(f"I1 ({name}, mslp)", card, L, r, wall, counts,
                   peak, f"omega {r[0].params['ω']!r} rel err {rel:.3e} (tol "
                   f"{OMEGA_RTOL:.0e}) | three families' discretize "
                   f"{build:.2f} s, their mslp walls together")
        check(rel <= OMEGA_RTOL, f"I1 {name} omega off by {rel:.3e}")
    _check_launched("I1", counts, "slab_thomas")
    out["I1"] = (counts, _k3_pair("path I1", kept, (2, 60, 256)))
    del fams, kept, res

    # I2: Hermite elements and the point getters
    mesh = rijke_mesh(n_rings=3, nz_cold=17, nz_hot=17)
    t0 = time.perf_counter()
    L = discretize(mesh, *active_rijke_setup(mesh), order="herm")
    build = time.perf_counter() - t0
    check(L.size == 19674, f"I2 n={L.size}")
    r, wall, counts, kept, peak = _driven(
        fused_slab, "slab_thomas",
        lambda: _fused_mslp(L, Z0, "I2", Slab, I2_KW))
    sol = r[0]
    rel = _rel(sol.params["ω"], OMEGA_HERM_19674)
    x_ref, n_ref = [0.0, 0.0, -0.0101], [0.0, 0.0, 1.0]
    t0 = time.perf_counter()
    pn = get_p(mesh, sol.v, X_NORM)
    pts = (get_p(mesh, sol.v, x_ref) / pn,
           get_n_grad_p(mesh, sol.v, x_ref, n_ref) / pn)
    prel = [_rel(a, b) for a, b in zip(pts, HERM_19674_POINT)]
    solver = L._fused_solver[1]
    _slab_line("I2 (Hermite active Rijke, mslp)", card, L, r, wall,
               counts, peak, f"{_phases()} | discretize {build:.2f} s | "
               f"omega {sol.params['ω']!r} rel err {rel:.3e} (tol "
               f"{OMEGA_RTOL:.0e}) | p(x_ref)/p(x_norm) {complex(pts[0])!r}, "
               f"n.grad p(x_ref)/p(x_norm) {complex(pts[1])!r}: rel err "
               f"{prel[0]:.3e} {prel[1]:.3e} (tol {POINT_RTOL:.0e}), getters "
               f"{time.perf_counter() - t0:.3f} s")
    check(rel <= OMEGA_RTOL, f"I2 omega off by {rel:.3e}")
    check(max(prel) <= POINT_RTOL, f"I2 point values off by {max(prel):.3e}")
    check((solver.part.m, solver.s) == (20, 1280),
          f"I2 slab partition m={solver.part.m} s={solver.s}, JAX's 20, "
          "1280")
    _check_launched("I2", counts, "slab_thomas")
    out["I2"] = (counts, _k3_pair("path I2", kept, (2, 20, 1280)))
    del L, kept, sol, r

    # I3: APE with the Hermite potential flow
    mesh = box_mesh(lx=0.25, ly=0.25, lz=1.0, nx=4, ny=4, nz=24)
    mesh.collect_lines()
    bc = {"Zmin": APE_Q, "Zmax": -APE_Q}
    t0 = time.perf_counter()
    U = compute_potflow_field(mesh, bc, order="lin")
    t_flow = time.perf_counter() - t0
    L = ape.discretize(mesh, bc, U=U)
    build = time.perf_counter() - t0
    check(L.size == 12532, f"I3 n={L.size}")
    cbar = np.sqrt(ape.AMBIENT_GAMMA * ape.AMBIENT_P / ape.AMBIENT_RHO)
    r, wall, counts, kept, peak = _driven(
        fused_slab, "slab_thomas",
        lambda: _fused_mslp(L, 1j * np.pi * cbar * 1.05, "I3", Slab, I3_KW))
    rel = _rel(r[0].params["s"], S_APE)
    solver = L._fused_solver[1]
    _slab_line("I3 (APE duct with mean flow, mslp)", card, L, r, wall,
               counts, peak, f"{_phases()} | potential flow (Hermite, host "
               f"SuperLU) {t_flow:.2f} s, U_z {U[2].mean():.6f} +- "
               f"{U[2].std():.2e} m/s, + discretize {build:.2f} s | s {r[0].params['s']!r} rel "
               f"err {rel:.3e} (tol {OMEGA_RTOL:.0e})")
    check(rel <= OMEGA_RTOL, f"I3 s off by {rel:.3e}")
    check((solver.part.m, solver.s) == (24, 640),
          f"I3 slab partition m={solver.part.m} s={solver.s}, JAX's 24, 640")
    _check_launched("I3", counts, "slab_thomas")
    out["I3"] = (counts, _k3_pair("path I3", kept, (2, 24, 640)))
    del L, kept, r

    # I4: the networks through the dense engine and K2, and Beyn
    C, A = NET_C, NET_A
    nets = {
        "duct": [("unode", (C, A)), ("duct", (1.0, C, A)), ("pnode", (C, A))],
        "rijke": [("unode", (C, A)), ("duct", (0.5, C, A)),
                  ("flame", (C, 2 * C, A)), ("duct", (0.5, 2 * C, A)),
                  ("pnode", (2 * C, A))],
        "damper": [("unode", (C, A)), ("duct", (0.5, C, A)),
                   ("helmholtz", (1e-4, 0.02, 0.005, C, A)),
                   ("duct", (0.5, C, A)), ("pnode", (C, A))]}
    Ls = {k: discretize_network(v) for k, v in nets.items()}
    Ls["rijke"].params.update({"n": 0.0, "τ": 1e-3})
    Dense = fused_local.FusedPencilSolver

    def networks():
        sols = {"duct": _fused_mslp(Ls["duct"], 2 * np.pi * 80.0, "I4 duct",
                                    Dense, dict(maxiter=30, tol=1e-10))}
        sols["rijke n=0"] = _fused_mslp(Ls["rijke"], 2 * np.pi * 150.0,
                                        "I4 rijke n=0", Dense,
                                        dict(maxiter=40, tol=1e-10))
        Ls["rijke"].params["n"] = 0.3
        sols["rijke n=0.3"] = _fused_mslp(
            Ls["rijke"], sols["rijke n=0"][0].params["ω"], "I4 rijke n=0.3",
            Dense, dict(maxiter=40, tol=1e-10))
        sols["damper"] = _fused_mslp(Ls["damper"], 2 * np.pi * 90.0,
                                     "I4 damper", Dense,
                                     dict(maxiter=50, tol=1e-9))
        return sols

    sols, wall, counts, kept, peak = _driven(fused_local, "dense_gmres",
                                             networks, last=False)
    refs = {"duct": NET_DUCT, "rijke n=0": NET_RIJKE_N0,
            "rijke n=0.3": NET_RIJKE_N03, "damper": NET_DAMPER}
    rels = {k: _rel(v[0].params["ω"], refs[k]) for k, v in sols.items()}
    f1 = sols["duct"][0].params["ω"].real / 2 / np.pi
    f1_rel = abs(f1 - C / 4) / (C / 4)
    Ns = {k: L._fused_solver[1].N for k, L in Ls.items()}
    print(f"main path I4 (networks, mslp) on {card}: sizes "
          f"{ {k: L.size for k, L in Ls.items()} }, K2 at N {Ns} | wall "
          f"{wall:.3f} s | "
          + "; ".join(f"{k}: {v[1]} iterations ({v[3]} device, {v[4]} polish "
                      f"steps) flag {v[2]} omega {v[0].params['ω']!r} rel err "
                      f"{rels[k]:.3e}" for k, v in sols.items())
          + f" (tol {OMEGA_RTOL:.0e}) | duct f1 {f1!r} Hz against c/4L rel "
          f"{f1_rel:.3e} (tol {NET_F1_RTOL:.0e}) | peak device memory "
          f"{peak:.1f} MiB | launches, plain calls {counts}", flush=True)
    check(all(v[2] == 0 for v in sols.values()),
          f"I4 flags {[v[2] for v in sols.values()]}")
    check(max(rels.values()) <= OMEGA_RTOL,
          f"I4 omega off by {max(rels.values()):.3e}")
    check(f1_rel <= NET_F1_RTOL, f"I4 duct f1 {f1} Hz")
    check(all(N == 128 for N in Ns.values()), f"I4 K2 at N {Ns}")
    _check_launched("I4", counts, "dense_gmres")
    P, b, m, cycles = kept[0]
    check(tuple(b.shape) == (2, 128), f"I4 K2 input {tuple(b.shape)}")
    out["I4"] = (counts, _compare_k2(P, b, m, cycles, K2_MAIN_RTOL,
                                     "path I4 first launch"))
    reset_counts()
    t0 = time.perf_counter()
    Om, _ = beyn(Ls["duct"], NET_GAMMA, l=6, K=2, N=64, res_tol=1e-6,
                 backend="dense")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    a, b_ = np.sort_complex(np.asarray(Om)), np.sort_complex(
        np.asarray(NET_DUCT_BEYN))
    brel = (np.abs(a - b_) / np.abs(b_)).max() if len(a) == len(b_) \
        else np.inf
    print(f"main path I4 (duct, Beyn dense backend, 256 nodes) on {card}: "
          f"wall {wall:.3f} s | {len(Om)} modes (JAX host {len(b_)}): Hz "
          + ", ".join(f"{w.real / 2 / np.pi:.6f}" for w in a)
          + f" | max rel err {brel:.3e} (tol {OMEGA_RTOL:.0e}) | launches, "
          f"plain calls {counts}", flush=True)
    check(len(a) == len(b_), f"I4 Beyn found {len(a)} modes, JAX {len(b_)}")
    check(brel <= OMEGA_RTOL, f"I4 Beyn modes off by {brel:.3e}")
    check(all(c_ == (0, 0) for c_ in counts.values()),
          f"I4 Beyn launched a kernel or its plain version: {counts}")

    out["I5"] = phase_shape_part(card)
    return out


def phase_shape_part(card):
    """Path I5: the shape sensitivities of the 1,369-DOF active Rijke.
    householder(order=2) from Z0 on the "device" backend (DeviceLU), the
    discrete-adjoint sensitivity over every surface point (host re-assembly
    of each point's neighbourhood), and the finite differences at six
    points picked as tests/test_shape.py:40 picks them (each re-solve a
    householder(nev=3, order=3) through DeviceLU).  No kernel: the
    counters must read 0.  Returns the counts of the FD re-solves."""
    from wavesandeigenvalues_jl_tpu_torch.mesh import rijke_mesh
    from wavesandeigenvalues_jl_tpu_torch.models import (
        discrete_adjoint_shape_sensitivity, discretize,
        forward_finite_differences_shape_sensitivity,
        get_surface_point_masks)
    from wavesandeigenvalues_jl_tpu_torch.models.rijke import \
        active_rijke_setup
    from wavesandeigenvalues_jl_tpu_torch.nlevp import householder
    from wavesandeigenvalues_jl_tpu_torch.utils import timing

    mesh = rijke_mesh(n_rings=3, nz_cold=17, nz_hot=17)
    dscrp, c = active_rijke_setup(mesh)
    L = discretize(mesh, dscrp, c)
    check(L.size == 1369, f"I5 n={L.size}")
    reset_timing()
    reset_counts()
    t0 = time.perf_counter()
    sol, n_it, flag = householder(L, Z0, maxiter=20, tol=1e-11, order=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    factors, factor_s = _report_sum(timing.report(), "device_solve.factor")
    rel = _rel(sol.params["ω"], OMEGA_1369_H2)
    print(f"main path I5 (shape, householder order 2, DeviceLU) on {card}: "
          f"n={L.size} | wall {wall:.3f} s, {factors} DeviceLU "
          f"factorizations {factor_s:.3f} s | iterations {n_it} flag {flag} "
          f"| omega {sol.params['ω']!r} rel err {rel:.3e} (tol "
          f"{OMEGA_RTOL:.0e}) | launches, plain calls {counts}", flush=True)
    check(flag == 0, f"I5 householder flag {flag}")
    check(rel <= OMEGA_RTOL, f"I5 omega off by {rel:.3e}")
    check(factors > 0, "I5: no DeviceLU factorization")
    check(all(c_ == (0, 0) for c_ in counts.values()),
          f"I5 launched a kernel or its plain version: {counts}")

    surf, tri_mask, tet_mask = get_surface_point_masks(mesh)
    t0 = time.perf_counter()
    sens = discrete_adjoint_shape_sensitivity(mesh, dscrp, c, surf,
                                              tri_mask, tet_mask, L, sol,
                                              h=1e-8)
    wall_da = time.perf_counter() - t0
    pick = np.linspace(0, len(surf) - 1, 6).astype(int)
    outlet = np.unique(mesh.triangles[mesh.domains["Outlet"]["simplices"]])
    smax = sens.ravel()[np.argmax(np.abs(sens).ravel())]
    sout = sens[2, outlet].sum()
    picked = sens[:, surf[pick]]
    ref_picked = np.array(SENS_PICKED).T
    prel = np.abs(picked - ref_picked).max() / np.abs(ref_picked).max()
    rels = (_rel(smax, SENS_MAX), _rel(sout, SENS_OUTLET_Z))

    reset_timing()
    reset_counts()
    t0 = time.perf_counter()
    fd = forward_finite_differences_shape_sensitivity(
        mesh, dscrp, c, surf[pick], [tri_mask[i] for i in pick],
        [tet_mask[i] for i in pick], L, sol, h=1e-6)
    torch.cuda.synchronize()
    wall_fd = time.perf_counter() - t0
    counts = read_counts()
    factors, factor_s = _report_sum(timing.report(), "device_solve.factor")
    f = fd[:, surf[pick]]
    da_fd = np.abs(picked - f).max() / np.abs(f).max()
    jax_fd = [(k, np.abs(f[:, k] - np.array(r)).max() / np.abs(r).max())
              for k, r in enumerate(FD_PICKED) if r is not None]
    print(f"main path I5 (shape sensitivities) on {card}: DA over "
          f"{len(surf)} surface points {wall_da:.3f} s (host) | largest "
          f"entry {complex(smax)!r}, outlet z-sum {complex(sout)!r}: rel "
          f"err {rels[0]:.3e} {rels[1]:.3e} (tol {SENS_RTOL:.0e}), six "
          f"picked points' entries {prel:.3e} of the largest (tol "
          f"{PICKED_RTOL:.0e}) | FD at the six points {wall_fd:.3f} s, "
          f"{factors} DeviceLU factorizations {factor_s:.3f} s: |DA − FD| / "
          f"max|FD| {da_fd:.3e} (tol {DA_FD_RTOL:.0e}); against JAX host's "
          f"FD where it returns (at the others it raises IndexError, "
          f"ROADMAP.md Queue 3 F6): "
          + ", ".join(f"point {surf[pick[k]]} {e:.3e}" for k, e in jax_fd)
          + f" | launches, plain calls {counts}", flush=True)
    check(max(rels) <= SENS_RTOL, f"I5 DA off by {max(rels):.3e}")
    check(prel <= PICKED_RTOL, f"I5 DA picked entries off by {prel:.3e}")
    check(np.isfinite(f).all() and da_fd <= DA_FD_RTOL,
          f"I5 |DA - FD| {da_fd:.3e}")
    check(factors > 0, "I5 FD: no DeviceLU factorization")
    check(all(c_ == (0, 0) for c_ in counts.values()),
          f"I5 FD launched a kernel or its plain version: {counts}")
    return counts


def _element_groups(mesh):
    """[(dim, gmsh type, elements, sorted domain names)]: the mesh's
    lines, triangles and tetrahedra grouped by the set of domains each
    belongs to (domains overlap: "Interior" holds every tetrahedron)."""
    groups = []
    for dim, etype, elems in ((1, 1, mesh.lines), (2, 2, mesh.triangles),
                              (3, 4, mesh.tetrahedra)):
        member = [[] for _ in range(len(elems))]
        for name, dd in mesh.domains.items():
            if dd["dimension"] == dim:
                for i in np.asarray(dd["simplices"], np.int64):
                    member[i].append(name)
        sets = {}
        for i, names in enumerate(member):
            sets.setdefault(tuple(sorted(names)), []).append(i)
        for names, idx in sets.items():
            groups.append((dim, etype, elems[np.asarray(idx)], names))
    return groups


def write_gmsh41(path, mesh):
    """Write ``mesh`` as a gmsh v4.1 ASCII file: one entity per set of
    domains, carrying every physical tag of its set; coordinates by
    ``repr``, so the file holds them exactly."""
    tags = {name: i + 1 for i, name in enumerate(mesh.domains)}
    groups = _element_groups(mesh)
    pts = mesh.points
    out = ["$MeshFormat", "4.1 0 8", "$EndMeshFormat", "$PhysicalNames",
           str(len(tags))]
    out += [f'{mesh.domains[n]["dimension"]} {t} "{n}"'
            for n, t in tags.items()]
    out += ["$EndPhysicalNames", "$Entities"]
    counts = [0, 0, 0, 0]
    ent_lines, ent_tag = [], []
    for dim, _, elems, names in groups:
        counts[dim] += 1
        ent_tag.append(counts[dim])
        lo = pts[:, elems.ravel()].min(axis=1)
        hi = pts[:, elems.ravel()].max(axis=1)
        ent_lines.append(" ".join(
            [str(counts[dim])] + [repr(float(x)) for x in (*lo, *hi)]
            + [str(len(names))] + [str(tags[n]) for n in names] + ["0"]))
    out.append(" ".join(str(c) for c in counts))
    # the entity lines go out by dimension, as the counts line announces
    order = sorted(range(len(groups)), key=lambda g: groups[g][0])
    out += [ent_lines[g] for g in order]
    n = mesh.n_points
    out += ["$EndEntities", "$Nodes", f"1 {n} 1 {n}", f"3 1 0 {n}"]
    out += [str(i + 1) for i in range(n)]
    out += [" ".join(repr(float(x)) for x in pts[:, i]) for i in range(n)]
    n_el = sum(len(g[2]) for g in groups)
    out += ["$EndNodes", "$Elements", f"{len(groups)} {n_el} 1 {n_el}"]
    tag = 0
    for g in order:
        dim, etype, elems, _ = groups[g]
        out.append(f"{dim} {ent_tag[g]} {etype} {len(elems)}")
        for e in elems:
            tag += 1
            out.append(" ".join([str(tag)] + [str(int(v) + 1) for v in e]))
    out.append("$EndElements")
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")


def write_gmsh22(path, mesh):
    """Write ``mesh`` as a gmsh v2.2 ASCII file: an element of several
    domains once per physical tag (the reader's ``Mesh.from_raw`` merges
    the copies), one of none once with physical tag 0."""
    tags = {name: i + 1 for i, name in enumerate(mesh.domains)}
    pts = mesh.points
    out = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat", "$PhysicalNames",
           str(len(tags))]
    out += [f'{mesh.domains[n]["dimension"]} {t} "{n}"'
            for n, t in tags.items()]
    n = mesh.n_points
    out += ["$EndPhysicalNames", "$Nodes", str(n)]
    out += [" ".join([str(i + 1)] + [repr(float(x)) for x in pts[:, i]])
            for i in range(n)]
    out += ["$EndNodes", "$Elements"]
    body = []
    for ent, (dim, etype, elems, names) in enumerate(_element_groups(mesh),
                                                     start=1):
        for phys in [tags[nm] for nm in names] or [0]:
            for e in elems:
                body.append(" ".join(
                    [str(len(body) + 1), str(etype), "2", str(phys),
                     str(ent)] + [str(int(v) + 1) for v in e]))
    out += [str(len(body))] + body + ["$EndElements"]
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")


def _read_vtu_complex(path, key):
    """The complex point field ``key`` of a VTU file written by vtk_write
    (ascii or inline base64 binary), parsed with xml.etree."""
    import base64
    import xml.etree.ElementTree as ET
    arrays = {}
    for da in ET.parse(path).getroot().iter("DataArray"):
        if da.get("format") == "ascii":
            arrays[da.get("Name")] = np.array(da.text.split(), np.float64)
        else:
            raw = base64.b64decode(da.text.strip())
            nbytes = int(np.frombuffer(raw[:4], np.uint32)[0])
            arrays[da.get("Name")] = np.frombuffer(raw[4:4 + nbytes],
                                                   np.float64)
    return arrays[key + ".real"] + 1j * arrays[key + ".imag"]


def _same_mesh(a, b):
    """True when two meshes hold equal arrays and domains."""
    return (all(np.array_equal(getattr(a, k), getattr(b, k))
                for k in ("points", "lines", "triangles", "tetrahedra"))
            and a.domains.keys() == b.domains.keys()
            and all(a.domains[k]["dimension"] == b.domains[k]["dimension"]
                    and np.array_equal(a.domains[k]["simplices"],
                                       b.domains[k]["simplices"])
                    for k in a.domains))


def _same_terms(a, b):
    """True when two families hold equal params and term matrices."""
    return (list(a.params) == list(b.params)
            and all(a.params[k] == b.params[k]
                    or (np.isnan(a.params[k]) and np.isnan(b.params[k]))
                    for k in a.params)
            and len(a.terms) == len(b.terms)
            and all(s.symbol == t.symbol and s.params == t.params
                    and all(np.array_equal(getattr(s.coeff, k),
                                           getattr(t.coeff, k))
                            for k in ("indptr", "indices", "data"))
                    for s, t in zip(a.terms, b.terms)))


def _k3_trace_launches(path):
    """Launches of K3's kernel (symbol ``slab_thomas_kernel``) among the
    kernel events of a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sum(1 for e in events if e.get("cat") == "kernel"
               and "slab_thomas_kernel" in e.get("name", ""))


def phase_io_path(card, L7259, om_slab):
    """Path J: mesh I/O, persistence, fitting and the device trace on the
    card, each solve driven with the counters set to 0 just before it and
    read just after.  J1: the slab path's 7,259-DOF Rijke mesh written as
    gmsh v4.1 and v2.2, read back, discretized and solved through the slab
    engine and K3, its mode written to VTU (ascii and binary) and read
    back; J2: the fitted flame of tests/test_fitting.py at 7,259 DOF
    through the slab engine and K3; J3: the J2 family and the slab path's
    family through save_family/load_family and re-solved, J2's Solution
    through save_solution/read_solution, the slab path's family through
    the reference's TOML dialect (one panel apply through K1 on each), and
    the fitted family refused by the TOML writer; J4: J1's v2.2 mesh
    solved under a torch.profiler device trace, K3's launches counted in
    it.  K3 against its plain version on the first and the last of J1's
    own inputs.  Returns {"J": (counts summed over J's solves, record)}."""
    import tempfile

    from wavesandeigenvalues_jl_tpu_torch.mesh import (Mesh, read_mesh,
                                                       rijke_mesh, vtk_write)
    from wavesandeigenvalues_jl_tpu_torch.models import discretize
    from wavesandeigenvalues_jl_tpu_torch.models.rijke import \
        active_rijke_setup
    from wavesandeigenvalues_jl_tpu_torch.nlevp import (
        fit_state_space, fused_slab, load_family, load_family_toml,
        read_solution, save_family, save_family_toml, save_solution)
    from wavesandeigenvalues_jl_tpu_torch.ops import operator_apply
    from wavesandeigenvalues_jl_tpu_torch.utils import timing
    Slab = fused_slab.FusedSlabPencilSolver
    total = {}

    def drive(label, L, kw, expect, bar, last=True):
        """One slab-engine mslp of path J; checks flag 0 and ω within
        bar·|ω| of ``expect``.  Returns (solution, kept K3 inputs)."""
        r, wall, counts, kept, peak = _driven(
            fused_slab, "slab_thomas",
            lambda: _fused_mslp(L, Z0, label, Slab, kw), last)
        _check_launched(label, counts, "slab_thomas")
        for k, (n, _) in counts.items():
            total[k] = (total.get(k, (0, 0))[0] + n, 0)
        om = r[0].params[r[0].eigval]
        rel = _rel(om, expect)
        _slab_line(label, card, L, r, wall, counts, peak,
                   f"omega {om!r} rel err {rel:.3e} (tol {bar:.0e})")
        check(rel <= bar, f"{label} omega off by {rel:.3e}")
        return r[0], kept

    with tempfile.TemporaryDirectory() as tmp:
        # J1: gmsh v4.1 and v2.2 of the slab path's mesh, read back
        mesh = rijke_mesh(n_rings=4, nz_cold=58, nz_hot=58)
        ref = Mesh.from_raw(mesh.points, mesh.lines, mesh.triangles,
                            mesh.tetrahedra, mesh.domains)
        read = {}
        for ver, writer in (("4.1", write_gmsh41), ("2.2", write_gmsh22)):
            path = os.path.join(tmp, f"rijke_{ver}.msh")
            t0 = time.perf_counter()
            writer(path, mesh)
            t1 = time.perf_counter()
            read[ver] = read_mesh(path)
            t2 = time.perf_counter()
            print(f"J1 gmsh v{ver}: {mesh.n_points} points, "
                  f"{len(mesh.tetrahedra)} tetrahedra, "
                  f"{os.path.getsize(path) / 2**20:.1f} MiB written in "
                  f"{t1 - t0:.2f} s, read_mesh {t2 - t1:.2f} s", flush=True)
            check(_same_mesh(read[ver], ref),
                  f"J1 gmsh v{ver} read back differs from the generated "
                  "mesh")
        t0 = time.perf_counter()
        L1 = discretize(read["4.1"], *active_rijke_setup(read["4.1"]))
        print(f"J1 discretize of the read mesh {time.perf_counter() - t0:.2f}"
              " s", flush=True)
        check(L1.size == 7259, f"J1 n={L1.size}")
        kw1 = dict(maxiter=30, tol=1e-11)
        sol1, kept = drive("J1 (gmsh v4.1 mesh, mslp)", L1, kw1, OMEGA_7259,
                           OMEGA_RTOL)
        om1 = sol1.params["ω"]
        rel = _rel(om1, om_slab)
        print(f"J1 omega against the slab path's {om_slab!r}: rel "
              f"{rel:.3e} (tol {J_SAME_RTOL:.0e})", flush=True)
        check(rel <= J_SAME_RTOL, f"J1 omega off the slab path's by {rel}")
        # the read mesh's simplices are in Mesh.from_raw's order, so the
        # flame's reference point may fall in another of the tetrahedra
        # that share it: the pattern, and the partition, can differ from
        # the slab path's
        solver = L1._fused_solver[1]
        record = _k3_pair("path J1", kept, (2, solver.m, solver.s))
        del kept
        for fmt in ("ascii", "binary"):
            t0 = time.perf_counter()
            files = vtk_write(os.path.join(tmp, f"mode_{fmt}"), read["4.1"],
                              {"p": sol1.v}, fmt=fmt)
            back = _read_vtu_complex(files[0], "p")
            err = float(np.abs(np.abs(back) - np.abs(sol1.v)).max())
            print(f"J1 vtk_write {fmt}: {os.path.basename(files[0])} "
                  f"{os.path.getsize(files[0]) / 2**20:.2f} MiB, written and "
                  f"parsed in {time.perf_counter() - t0:.2f} s, max ||p| - "
                  f"|v|| {err:.3e}", flush=True)
            check(len(files) == 1 and np.array_equal(back, sol1.v),
                  f"J1 vtk {fmt}: the mode read back differs by {err}")

        # J2: the fitted flame (tests/test_fitting.py:47-72) at 7,259 DOF
        data = np.exp(-1j * 2 * np.pi * FIT_FREQS * FIT_TAU)
        t0 = time.perf_counter()
        ss, fitted = fit_state_space(FIT_FREQS, data, order=FIT_ORDER)
        fit_s = time.perf_counter() - t0
        fit_err = float(np.abs(fitted - data).max())
        c = mesh.generate_field(lambda x, y, z: np.where(
            z < 0, np.sqrt(1.4 * 287.05 * 300.0),
            np.sqrt(1.4 * 287.05 * 1200.0)))
        dscrp = dict(active_rijke_setup(mesh)[0])
        dscrp["Flame"] = ("flame", dscrp["Flame"][1][:3]
                          + (FIT_X_REF, [0.0, 0.0, 1.0], ss))
        t0 = time.perf_counter()
        L2 = discretize(mesh, dscrp, c)
        print(f"J2 fit: order {FIT_ORDER} in {fit_s:.3f} s, max error "
              f"{fit_err:.3e} (tol {FIT_ERR:.0e}) | discretize "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        check(fit_err <= FIT_ERR, f"J2 fit error {fit_err:.3e}")
        kw2 = dict(maxiter=20, tol=1e-10)
        sol2, _ = drive("J2 (fitted flame, mslp)", L2, kw2, OMEGA_7259_FITTED,
                        OMEGA_RTOL, last=False)
        om2 = sol2.params["ω"]
        rel = _rel(om2, OMEGA_7259_FIT_NTAU)
        print(f"J2 omega against JAX host's n-tau flame "
              f"{OMEGA_7259_FIT_NTAU!r}: rel {rel:.3e} (tol "
              f"{FIT_NTAU_RTOL:.0e})", flush=True)
        check(rel <= FIT_NTAU_RTOL, f"J2 off the n-tau flame by {rel}")

        # J3: persistence
        for label, L, om, kw in (("J3 fitted", L2, om2, kw2),
                                 ("J3 slab path", L7259, om_slab, kw1)):
            path = os.path.join(tmp, "family.npz")
            t0 = time.perf_counter()
            save_family(path, L)
            t1 = time.perf_counter()
            Lr = load_family(path)
            print(f"{label} family npz: save_family {t1 - t0:.2f} s, "
                  f"load_family {time.perf_counter() - t1:.2f} s, "
                  f"{os.path.getsize(path) / 2**20:.1f} MiB", flush=True)
            check(_same_terms(Lr, L), f"{label}: loaded family differs")
            drive(f"{label} (reloaded npz, mslp)", Lr, kw, om,
                  J_RELOAD_RTOL, last=False)
        path = os.path.join(tmp, "solution.npz")
        save_solution(path, sol2)
        back = read_solution(path)
        check(back.params == sol2.params and np.array_equal(back.v, sol2.v)
              and np.array_equal(back.v_adj, sol2.v_adj),
              "J3 save_solution/read_solution differs")
        path = os.path.join(tmp, "family.toml")
        t0 = time.perf_counter()
        save_family_toml(path, L7259)
        t1 = time.perf_counter()
        Lt = load_family_toml(path)
        t2 = time.perf_counter()
        check(_same_terms(Lt, L7259), "J3 TOML family differs")
        X = np.random.default_rng(12).standard_normal(
            (L7259.size, 128)).astype(np.complex64)
        Y, Yt = (operator_apply(L, OMEGA_APPLY, X) for L in (L7259, Lt))
        err = float(np.abs(Yt - Y).max() / np.abs(Y).max())
        print(f"J3 slab path family TOML: save_family_toml {t1 - t0:.2f} s, "
              f"load_family_toml {t2 - t1:.2f} s, "
              f"{os.path.getsize(path) / 2**20:.1f} MiB; panel apply through"
              f" K1 of the two families: rel {err:.3e} (tol "
              f"{J_RELOAD_RTOL:.0e})", flush=True)
        check(err <= J_RELOAD_RTOL, f"J3 TOML apply differs by {err}")
        path = os.path.join(tmp, "fitted.toml")
        try:
            save_family_toml(path, L2)
        except ValueError as e:
            print(f"J3 fitted family to TOML refused: {e}", flush=True)
        else:
            fail("J3: the fitted family was written to TOML")
        check(not os.path.exists(path), "J3: refused TOML file was written")

        # J4: the device trace of J1's v2.2 mesh solve
        L4 = discretize(read["2.2"], *active_rijke_setup(read["2.2"]))
        logdir = os.path.join(tmp, "trace")
        timing.start_device_trace(logdir)
        n_before = total["slab_thomas"][0]
        try:
            drive("J4 (gmsh v2.2 mesh, mslp, traced)", L4, kw1, om1,
                  J_SAME_RTOL, last=False)
        finally:
            trace = timing.stop_device_trace()
        counted = total["slab_thomas"][0] - n_before
        traced = _k3_trace_launches(trace)
        print(f"J4 trace {os.path.basename(trace)} "
              f"{os.path.getsize(trace) / 2**20:.1f} MiB: "
              f"slab_thomas_kernel {traced} launches in the trace, "
              f"{counted} counted by the wrapper", flush=True)
        check(traced == counted > 0, f"J4: the trace holds {traced} K3 "
              f"launches, the wrapper counted {counted}")
        print("J4 phases of the traced solve:\n" + timing.format_report(),
              flush=True)
    return {"J": (total, record)}


def phase_dist_path(card, large, panel):
    """Path K: the distributed layer (``parallel/``) on the card, with the
    counters set to 0 just before it and read just after (plain PyTorch
    and collectives: no kernel of the port runs here, so they must read
    0).  K0: ``init_multihost`` on NCCL, a one-rank world (the card's
    machine has one GPU and NCCL takes one rank a GPU), a (1 × 1)
    ("shift", "row") DeviceMesh and one NCCL all_reduce.  K1: path C's
    57,210-DOF family at OMEGA_APPLY, row-partitioned into K_ROW_PARTS
    parts on the one rank (halos between them real), ``make_dist_spmm``
    on path C's 128-column panel against the complex128 CSR product
    (row-wise ≤ K1_ROW_RTOL) and path C's window-kernel Y (global ≤
    LARGE_GLOBAL_RTOL); one ``make_dist_spmv`` vector and ``dist_dot``.
    K2: ``beyn_dist`` on path F's 55,401-DOF family and MultiGrid at the
    JAX package's solver defaults (bs 32, tol 1e-10, GMRES(80), 40
    restarts), one mesh-wide solve a node, against OMEGA_55K.  K3:
    ``beyn_batched`` on the 437-DOF passive family with the shift axis
    given, against the unsharded "dense" backend (≤ K3_DENSE_RTOL·|ω|)
    and OMEGA_437_PASSIVE.  The process group is destroyed at the end."""
    import socket

    import scipy.sparse as sp
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from wavesandeigenvalues_jl_tpu_torch.mesh.generate import rijke_mesh
    from wavesandeigenvalues_jl_tpu_torch.models import discretize
    from wavesandeigenvalues_jl_tpu_torch.models.rijke import \
        passive_rijke_setup
    from wavesandeigenvalues_jl_tpu_torch.nlevp import beyn
    from wavesandeigenvalues_jl_tpu_torch.parallel import (
        beyn_batched, beyn_dist, dist_dot, init_multihost, make_dist_spmm,
        make_dist_spmv, partition_stack)
    from wavesandeigenvalues_jl_tpu_torch.parallel.scaling import \
        gmres_comm_accounting
    fmt = lambda xs: "[" + ", ".join(f"{x:.3e}" for x in xs) + "]"  # noqa
    t_path = time.perf_counter()
    reset_counts()

    # K0: the one-rank NCCL world and its mesh
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    multi = init_multihost(coordinator=f"127.0.0.1:{port}", num_processes=1,
                           process_id=0, timeout=300)
    try:
        check(dist.is_initialized() and not multi, "K0: no one-rank world")
        backend = dist.get_backend()
        check(backend == "nccl", f"K0: backend {backend}, not nccl")
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("shift", "row"))
        t = torch.full((8,), 1 + 2j, dtype=torch.complex128, device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        check(bool((t == 1 + 2j).all()), f"K0: all_reduce gave {t}")
        print(f"main path K0 (world) on {card}: backend {backend}, world "
              f"size {dist.get_world_size()}, NCCL "
              f"{'.'.join(map(str, torch.cuda.nccl.version()))}, mesh "
              f"{mesh.mesh_dim_names} {tuple(mesh.shape)} on "
              f"{mesh.device_type}, store tcp://127.0.0.1:{port} | "
              f"init + mesh + one all_reduce {time.perf_counter() - t0:.3f} "
              "s", flush=True)

        # K1: the row-sharded apply of path C's family and panel
        L, X, Y_window = large
        L.params[L.eigval] = OMEGA_APPLY
        coeffs = L.coefficients({})
        A = L.assemble({})
        As = sp.csr_matrix((A.data, A.indices, A.indptr), shape=A.shape)
        t0 = time.perf_counter()
        part = partition_stack(L._stack(), K_ROW_PARTS)
        part_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        spmm, shard, unshard = make_dist_spmm(part, mesh)
        Xs = shard(X)
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            Ys = spmm(Xs, coeffs)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        Y = unshard(Ys)
        row, glob = _rowwise_scipy(Y, As, X)
        vs_window = float(np.linalg.norm(Y - Y_window)
                          / np.linalg.norm(Y_window))
        spmv, vshard, vunshard = make_dist_spmv(part, mesh)
        x = X[:, 0].astype(np.complex128)
        ys = spmv(vshard(x), coeffs)
        y_row, _ = _rowwise_scipy(vunshard(ys)[:, None], As, x[:, None])
        y_ref = As @ x
        dot = complex(dist_dot(vshard(x), ys, mesh))
        dot_ref = np.vdot(x, y_ref)
        dot_rel = abs(dot - dot_ref) / abs(dot_ref)
        hops = -(-part.halo // part.m)
        print(f"main path K1 (row-sharded apply) on {card}: n={L.size} "
              f"r={X.shape[1]}, {K_ROW_PARTS} row parts of m={part.m} on "
              f"rank 0, halo H={part.halo} rows ({hops} hop(s) a side, "
              f"ELL width {part.cols.shape[2]}), partition_stack "
              f"{part_s:.2f} s | make_dist_spmm wall first call "
              f"{walls[0]:.4f} s, next {walls[1]:.4f} s | max "
              f"|Y−Y_ref|/(|A||X|) {row:.3e} (tol {K1_ROW_RTOL:.0e}), "
              f"‖Y−Y_ref‖/‖Y_ref‖ {glob:.3e}, against path C's window "
              f"kernel {vs_window:.3e} (tol {LARGE_GLOBAL_RTOL:.0e}) | "
              f"make_dist_spmv row-wise {y_row:.3e}, dist_dot rel "
              f"{dot_rel:.3e} | peak device memory {peak / 2**20:.1f} MiB",
              flush=True)
        check(Y.shape == X.shape and np.isfinite(Y).all(), "K1: bad Y")
        check(row <= K1_ROW_RTOL, f"K1: row-wise error {row:.3e}")
        check(vs_window < LARGE_GLOBAL_RTOL,
              f"K1: off path C's window kernel by {vs_window:.3e}")
        check(y_row <= K1_ROW_RTOL, f"K1: spmv row-wise error {y_row:.3e}")
        check(dot_rel <= K1_ROW_RTOL, f"K1: dist_dot off by {dot_rel:.3e}")
        del Xs, Ys, spmm, spmv, ys

        # K2: the row-sharded contour on path F's family
        L2, mg = panel
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        Om, P, info = beyn_dist(L2, CONTOUR, mesh, K_ROW_PARTS, coarse=mg,
                                return_info=True, **CONTOUR_KW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        f, f_ref = _hz(Om), _hz(OMEGA_55K)
        rel = (np.abs(f - f_ref) / f_ref if len(f) == len(f_ref)
               else np.full(len(f_ref), np.inf))
        tm = info["timings"]
        acc = gmres_comm_accounting(L2.size, K_ROW_PARTS, info["halo"],
                                    CONTOUR_KW["l"], 80, 40)
        print(f"main path K2 (row-sharded contour) on {card}: n={L2.size}, "
              f"{K_ROW_PARTS} row parts of m={info['m']}, halo "
              f"{info['halo']} rows, MultiGrid levels n={mg.levels[0][5]} "
              f"and n={mg.n_coarse} | {4 * CONTOUR_KW['N']} nodes x "
              f"l={CONTOUR_KW['l']} in {info['solves']} mesh-wide solves "
              f"(bs 32, tol 1e-10, GMRES(80), 40 restarts) | modes Hz "
              f"{', '.join(f'{x:.8f}' for x in f)} rel err {fmt(rel)} (tol "
              f"{CONTOUR_RTOL:.0e}) | eigenpair residuals "
              f"{fmt(info['residuals'])} | max preconditioned relres "
              f"{info['max_res']:.3e} | wall {wall:.3f} s (solves "
              f"{info['seconds']:.3f} s: host prep {tm['prep_s']:.3f}, "
              f"GMRES {tm['gmres_s']:.3f}, gathers {tm['gather_s']:.3f}; "
              f"{tm['restarts']} GMRES cycles summed over the columns of "
              f"{tm['solves']} solves) | peak device memory "
              f"{peak / 2**20:.1f} MiB | comm accounting {json.dumps(acc)}",
              flush=True)
        check(len(Om) == len(OMEGA_55K),
              f"K2 found {len(Om)} modes, JAX host {len(OMEGA_55K)}")
        check(rel.max() <= CONTOUR_RTOL, f"K2 modes off by {rel.max():.3e}")
        check(P.shape == (L2.size, len(Om)) and np.isfinite(P).all(),
              "K2 eigenvectors not finite")

        # K3: the shift-split dense contour at 437 DOF
        m437 = rijke_mesh(n_rings=2, nz_cold=10, nz_hot=10)
        L3 = discretize(m437, *passive_rijke_setup(m437))
        t0 = time.perf_counter()
        Om3, P3 = beyn_batched(L3, CONTOUR, mesh=mesh, axis="shift",
                               **CONTOUR_KW)
        torch.cuda.synchronize()
        wall3 = time.perf_counter() - t0
        Om_d, _ = beyn(L3, CONTOUR, backend="dense", **CONTOUR_KW)
        Om3, Om_d = np.sort_complex(Om3), np.sort_complex(Om_d)
        same = (np.abs(Om3 - Om_d) / np.abs(Om_d)
                if len(Om3) == len(Om_d) else np.full(len(Om_d), np.inf))
        f3 = _hz(Om3)
        hz = (np.abs(f3 - _hz(OMEGA_437_PASSIVE)).max()
              if len(f3) == len(OMEGA_437_PASSIVE) else np.inf)
        print(f"main path K3 (shift-split dense contour) on {card}: "
              f"n={L3.size}, {4 * CONTOUR_KW['N']} nodes over the shift "
              f"axis of {mesh.shape[0]} rank(s), moments summed by "
              f"all_reduce | modes Hz {', '.join(f'{x:.8f}' for x in f3)} | "
              f"against the unsharded dense backend {fmt(same)} x |ω| (tol "
              f"{K3_DENSE_RTOL:.0e}), against JAX host max |Δf| {hz:.3e} Hz "
              f"(tol {SMALL_HZ_ATOL:.0e}) | wall {wall3:.3f} s", flush=True)
        check(same.max() <= K3_DENSE_RTOL,
              f"K3 off the unsharded contour by {same.max():.3e}")
        check(hz <= SMALL_HZ_ATOL, f"K3 modes off JAX host by {hz:.3e} Hz")
        check(np.isfinite(P3).all(), "K3 eigenvectors not finite")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    counts = read_counts()
    check(not dist.is_initialized(), "path K left its process group")
    print(f"main path K (distributed layer) on {card}: K0–K3 passed in "
          f"{time.perf_counter() - t_path:.2f} s, process group destroyed "
          f"| launches, plain calls {counts}", flush=True)
    check(all(c == (0, 0) for c in counts.values()),
          f"path K launched a kernel or its plain version: {counts}")


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
    slab, om_slab = phase_slab_path(L7259)
    dense, _ = phase_dense_path(L1369)
    apply_counts, A = phase_apply_path(L7259)
    k1 = phase_compare_k1(A)
    t0 = time.perf_counter()
    large_counts, L57k, plan, X57k, Y57k = phase_large_path()
    k45 = phase_compare_k45(L57k, plan, warp_row)
    t_d = time.perf_counter()
    phase_contour_path(L57k, card)
    phase_contour_small(card)
    # path K applies the host family again; its device plan goes now
    del L57k._window_plan, plan
    t_e = time.perf_counter()
    phase_general_engine(card, L7259)
    t_f = time.perf_counter()
    _, L55k, mg55k = phase_panel_path(card)
    t_g = time.perf_counter()
    param_counts, k3_g = phase_param_path(card)
    t_h = time.perf_counter()
    bloch = phase_bloch_path(card)
    t_i = time.perf_counter()
    front = phase_frontends_path(card)
    t_j = time.perf_counter()
    front.update(phase_io_path(card, L7259, om_slab))
    t_k = time.perf_counter()
    phase_dist_path(card, (L57k, X57k, Y57k), (L55k, mg55k))
    del L57k, X57k, Y57k, L55k, mg55k
    t_end = time.perf_counter()
    print(f"path C phases: {t_d - t0:.2f} s, path D phases: "
          f"{t_e - t_d:.2f} s, path E phases: {t_f - t_e:.2f} s, path F: "
          f"{t_g - t_f:.2f} s, path G: {t_h - t_g:.2f} s, path H: "
          f"{t_i - t_h:.2f} s, path I: {t_j - t_i:.2f} s, path J: "
          f"{t_k - t_j:.2f} s, path K: {t_end - t_k:.2f} s of the run's "
          f"{t_end - t_start:.2f} s", flush=True)

    launches_c = large_counts["window_spmm"][0]
    rows = [
        ("slab_thomas", "slab_thomas", "pallas_thomas.py:49",
         k3[K3_SHAPES[0]], slab["slab_thomas"][0]),
        ("slab_thomas/path G", "slab_thomas", "pallas_thomas.py:49", k3_g,
         param_counts["slab_thomas"][0]),
        ("slab_thomas/path H unit", "slab_thomas", "pallas_thomas.py:49",
         bloch["unit"][1], bloch["unit"][0]["slab_thomas"][0]),
        ("slab_thomas/path H full", "slab_thomas", "pallas_thomas.py:49",
         bloch["full"][1], bloch["full"][0]["slab_thomas"][0]),
        ("dense_gmres", "dense_gmres", "pallas_gmres.py:50",
         k2[(2, 1408, 80, 1)], dense["dense_gmres"][0]),
        ("dense_gmres/path H", "dense_gmres", "pallas_gmres.py:50",
         bloch["dense"][1], bloch["dense"][0]["dense_gmres"][0]),
        ("slab_thomas/path I1", "slab_thomas", "pallas_thomas.py:49",
         front["I1"][1], front["I1"][0]["slab_thomas"][0]),
        ("slab_thomas/path I2 Hermite", "slab_thomas", "pallas_thomas.py:49",
         front["I2"][1], front["I2"][0]["slab_thomas"][0]),
        ("slab_thomas/path I3 APE", "slab_thomas", "pallas_thomas.py:49",
         front["I3"][1], front["I3"][0]["slab_thomas"][0]),
        ("dense_gmres/path I4 networks", "dense_gmres", "pallas_gmres.py:50",
         front["I4"][1], front["I4"][0]["dense_gmres"][0]),
        ("slab_thomas/path J", "slab_thomas", "pallas_thomas.py:49",
         front["J"][1], front["J"][0]["slab_thomas"][0]),
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
