#!/usr/bin/env python3
"""The slab engine's block-Thomas factor recursion on one CUDA device:
which inverse of Dt_i it can take, eagerly and inside a CUDA graph, and
what the engine's factor costs before and after it became one graph.

    python3 tools/slab_factor_probe.py [--m 59] [--s 256] [--out FILE]

1. Inverse candidates, each in the whole m-step recursion on seeded band
   panels [2, m, 3, s, s] complex64: ``torch.linalg.solve`` batched (the
   engine's loop before the graph), ``lu_factor_ex`` + ``lu_solve`` a side
   (the engine's now), the same with one batched ``lu_solve``,
   ``inv_ex`` a side, ``inv_ex`` and ``lu_factor_ex`` batched, and the
   per-side LU with the sides on two streams.  For each: the device time
   of one recursion from CUDA events (median of 5, after a warm-up) over
   m, and whether a CUDA graph captures it; if it does, its replay's time
   the same way and its largest distance to the batched solve's result.
   The candidates that may refuse capture (MAGMA's batched routines
   allocate outside PyTorch's allocator) come last.
2. The engine itself on the 7,259-DOF Rijke family at (2, 59, 256): its
   factor (``FusedSlabPencilSolver._factor``) against the loop it replaced
   on the same solve data, by events and by host wall; both loops' largest
   distance to the replaced loop run in complex128; the memory its
   static buffers and graph hold; and the runtime calls of one factor of
   each in a ``torch.profiler`` trace.

Prints one line per measurement and a JSON summary as the last line,
also written to ``--out`` where given.  Needs one CUDA device.
"""
import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from wavesandeigenvalues_jl_tpu_torch.models.rijke import \
    active_rijke_family  # noqa: E402
from wavesandeigenvalues_jl_tpu_torch.nlevp.fused_slab import \
    FusedSlabPencilSolver  # noqa: E402
from wavesandeigenvalues_jl_tpu_torch.nlevp.pencil import \
    _pad0  # noqa: E402
from wavesandeigenvalues_jl_tpu_torch.utils.config import \
    DEVICE_CDTYPE  # noqa: E402

Z0 = 340 * 2 * np.pi
#: the rijke_mesh arguments of a 7,259-DOF family whose partition is the
#: benchmark cell's (2, 59, 256)
MESH_59 = (4, 59, 57)
#: runtime calls counted in the factor's trace
CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch",
         "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMalloc",
         "cudaFree", "cudaMemcpyAsync")


def panels(m, s, seed=0):
    """Seeded band panels [2, m, 3, s, s] complex64 with a dominant
    diagonal block, so that every Dt_i is well conditioned."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    blk = torch.randn((2, m, 3, s, s), dtype=torch.complex64, device="cuda",
                      generator=g) * (0.3 / s ** 0.5)
    blk[:, :, 1] += torch.eye(s, dtype=torch.complex64, device="cuda")
    return blk


def inv_solve(Dt, eye, out):
    out.copy_(torch.linalg.solve(Dt, eye.expand_as(Dt)))


def inv_lu_side(Dt, eye, out):
    for side in range(2):
        LU, piv, _ = torch.linalg.lu_factor_ex(Dt[side])
        torch.linalg.lu_solve(LU, piv, eye, out=out[side])


def inv_lu_side_solve2(Dt, eye, out):
    LU, piv = torch.empty_like(Dt), Dt.new_empty((2, Dt.shape[-1]),
                                                  dtype=torch.int32)
    for side in range(2):
        lu, p, _ = torch.linalg.lu_factor_ex(Dt[side])
        LU[side], piv[side] = lu, p
    torch.linalg.lu_solve(LU, piv, eye.expand_as(Dt), out=out)


def inv_ex_side(Dt, eye, out):
    for side in range(2):
        out[side] = torch.linalg.inv_ex(Dt[side])[0]


def inv_ex_2(Dt, eye, out):
    out.copy_(torch.linalg.inv_ex(Dt)[0])


def inv_lu_2(Dt, eye, out):
    LU, piv, _ = torch.linalg.lu_factor_ex(Dt)
    torch.linalg.lu_solve(LU, piv, eye.expand_as(Dt), out=out)


def two_streams(streams):
    def inv(Dt, eye, out):
        cur = torch.cuda.current_stream()
        for side, st in enumerate(streams):
            st.wait_stream(cur)
            Dt.record_stream(st)
            with torch.cuda.stream(st):
                LU, piv, _ = torch.linalg.lu_factor_ex(Dt[side])
                torch.linalg.lu_solve(LU, piv, eye, out=out[side])
        for st in streams:
            cur.wait_stream(st)
    return inv


def recursion(inv, blk, DT, stream):
    """The engine's recursion with the inverse ``inv``."""
    m, s = blk.shape[1], blk.shape[-1]
    eye = torch.eye(s, dtype=blk.dtype, device=blk.device)
    C = blk.new_zeros(2, s, s)
    for i in range(m):
        Lb, Db, Ub = blk[:, i, 0], blk[:, i, 1], blk[:, i, 2]
        inv(Db - Lb @ C, eye, DT[:, i])
        Dtinv = DT[:, i]
        C = Dtinv @ Ub
        stream[:, i] = (Dtinv @ Lb).transpose(1, 2)
        stream[:, 2 * m - 1 - i] = C.transpose(1, 2)


def events_ms(fn, reps=5):
    """Median device time of one call of ``fn`` (ms) from CUDA events,
    each call synchronised, after one warm-up call; and the median host
    wall of the calls."""
    fn()
    torch.cuda.synchronize()
    dev, wall = [], []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        dev.append(e0.elapsed_time(e1))
    return statistics.median(dev), statistics.median(wall)


def capture(fn):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def rel(a, b):
    return float((a.to(b.dtype) - b).abs().max() / b.abs().max())


def candidates(m, s, out):
    blk = panels(m, s)
    DT = torch.empty(2, m, s, s, dtype=torch.complex64, device="cuda")
    stream = torch.empty(2, 2 * m, s, s, dtype=torch.complex64,
                         device="cuda")
    recursion(inv_solve, blk, DT, stream)
    ref = (DT.clone(), stream.clone())
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    cands = [("lu_side", inv_lu_side), ("lu_side_solve2", inv_lu_side_solve2),
             ("inv_ex_side", inv_ex_side),
             ("lu_side_2streams", two_streams(streams)),
             ("solve", inv_solve), ("inv_ex_2", inv_ex_2),
             ("lu_2", inv_lu_2)]
    for name, inv in cands:
        run = lambda: recursion(inv, blk, DT, stream)       # noqa: E731
        dev, wall = events_ms(run)
        row = {"eager_ms_per_step": dev / m, "eager_wall_ms": wall,
               "err": max(rel(DT, ref[0]), rel(stream, ref[1]))}
        print(f"{name}: eager {dev / m:.4f} ms a step, wall {wall:.2f} ms",
              flush=True)
        out["candidates"][name] = row
    for name, inv in cands:
        row = out["candidates"][name]
        DT.zero_()
        stream.zero_()
        try:
            graph = capture(lambda: recursion(inv, blk, DT, stream))
        except Exception as exc:                   # capture refused
            row["captures"] = False
            row["capture_error"] = f"{type(exc).__name__}: {exc}"[:300]
            print(f"{name}: capture refused: {row['capture_error']}",
                  flush=True)
            torch.cuda.synchronize()
            continue
        dev, wall = events_ms(graph.replay)
        row.update(captures=True, graph_ms_per_step=dev / m,
                   graph_wall_ms=wall,
                   graph_err=max(rel(DT, ref[0]), rel(stream, ref[1])))
        print(f"{name}: graph {dev / m:.4f} ms a step, wall {wall:.2f} ms,"
              f" err {row['graph_err']:.2e}", flush=True)
        del graph


def old_factor(solver, g, dtype=DEVICE_CDTYPE):
    """The engine's factor before the graph: equilibrate, scatter into new
    zeroed panels and the batched ``torch.linalg.solve`` loop; in
    ``dtype`` after the panels' rounding to complex64."""
    m, s = solver.m, solver.s
    rm = solver._ell(_pad0(g.abs())).amax(-1)
    scale = 1.0 / torch.where(rm == 0, 1.0, rm)
    gs = (g * scale.gather(1, solver.rows2)).to(DEVICE_CDTYPE).to(dtype)
    blk = gs.new_zeros(2 * m * 3 * s * s)
    blk.index_put_((solver.dest2.view(-1),), gs.view(-1))
    blk = blk.view(2, m, 3, s, s)
    eye = torch.eye(s, dtype=blk.dtype, device=blk.device).expand(2, s, s)
    pad = solver.pad.to(dtype)
    DT = blk.new_empty(2, m, s, s)
    stream = blk.new_empty(2, 2 * m, s, s)
    C = blk.new_zeros(2, s, s)
    for i in range(m):
        Lb, Db, Ub = blk[:, i, 0], blk[:, i, 1], blk[:, i, 2]
        Dt = Db - Lb @ C + torch.diag(pad[i])
        Dtinv = torch.linalg.solve(Dt, eye)
        C = Dtinv @ Ub
        DT[:, i] = Dtinv
        stream[:, i] = (Dtinv @ Lb).transpose(1, 2)
        stream[:, 2 * m - 1 - i] = C.transpose(1, 2)
    return DT, stream


def runtime_calls(fn):
    """Counts of the runtime calls in CALLS during one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    got = {k.key: k.count for k in prof.key_averages() if k.key in CALLS}
    return {c: got.get(c, 0) for c in CALLS}


def engine(out):
    L = active_rijke_family(*MESH_59)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    solver = FusedSlabPencilSolver(L, "cuda")
    held = torch.cuda.memory_allocated()
    c, _ = solver.coefficients(complex(Z0))
    _, g = solver.solve_data(torch.from_numpy(c).cuda(),
                             torch.zeros((), dtype=torch.complex128,
                                         device="cuda"))
    torch.cuda.reset_peak_memory_stats()
    solver._factor(g)
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    row = {"shape": [2, solver.m, solver.s], "n": solver.n,
           "buffers_bytes": held - base, "graph_bytes": after - held,
           "reserved_bytes": torch.cuda.memory_reserved()}
    DT_old, st_old = old_factor(solver, g)
    DT_128, st_128 = old_factor(solver, g, torch.complex128)
    DT, st, _ = solver._factor(g)
    row["err"] = max(rel(DT, DT_old), rel(st, st_old))
    row["err_to_c128"] = {"old": [rel(DT_old, DT_128), rel(st_old, st_128)],
                          "graph": [rel(DT, DT_128), rel(st, st_128)]}
    del DT_128, st_128
    new = lambda: solver._factor(g)                          # noqa: E731
    old = lambda: old_factor(solver, g)                      # noqa: E731
    for label, fn in (("old", old), ("graph", new), ("graph", new),
                      ("old", old)):
        dev, wall = events_ms(fn)
        row.setdefault(f"{label}_ms", []).append(dev)
        row.setdefault(f"{label}_wall_ms", []).append(wall)
    row["old_calls"] = runtime_calls(old)
    row["graph_calls"] = runtime_calls(new)
    print(f"engine {row['shape']}: old {row['old_ms']} ms, graph "
          f"{row['graph_ms']} ms, err {row['err']:.2e} "
          f"(to complex128 {row['err_to_c128']}), buffers "
          f"{row['buffers_bytes']} B, graph {row['graph_bytes']} B",
          flush=True)
    print(f"  old calls {row['old_calls']}", flush=True)
    print(f"  graph calls {row['graph_calls']}", flush=True)
    out["engine"] = row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=59)
    ap.add_argument("--s", type=int, default=256)
    ap.add_argument("--out", help="also write the JSON summary here")
    args = ap.parse_args()
    out = {"device": torch.cuda.get_device_name(0),
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "m": args.m, "s": args.s, "candidates": {}}
    try:
        engine(out)
    except Exception as exc:
        out["engine_error"] = f"{type(exc).__name__}: {exc}"[:500]
        print(f"engine: {out['engine_error']}", flush=True)
        torch.cuda.synchronize()
    candidates(args.m, args.s, out)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
