"""One run of one cell: set-up, warm-up, the measured window, the check
against the reference, and the result line.

Everything is found by name.  ``BENCHMARK.json`` gives the cell's
configuration, traffic mix and metrics; the configuration file
(``configs/<name>.json``) names its problem (``problems/<problem>.py``:
the mesh, the program's family, the reference's family); the mix
(``traffic/<mix>.json``) names its entry (``entries/<entry>.py``: how a
request drives the program and how its answers are judged), the fields
the generator draws and the ``engine`` every request has to run through
(a request answered by another counts as failed, and ``off_path``, their
number, is compared with the limit 0); ``limits/<workload>.json`` holds
the limit of each compared number; ``metrics/<metric>.py`` reads one
metric from the run.  A later cell or metric adds files and entries and
edits none.
"""
from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import sys
import tempfile
import time
import traceback
from types import SimpleNamespace

import numpy as np

from . import requests as gen
from .trace import REQUEST_RANGE, summarize

PKG = os.path.dirname(os.path.abspath(__file__))
#: top-level module names that no process of a run may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "wavesandeigenvalues_jl_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, workload: str):
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"({sorted(cells)})")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return cell, cfg_entry


def metric_reader(name: str):
    path = os.path.join(PKG, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, workload: str, trace: bool) -> list:
    """The metrics this cell reports in a run of this kind."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def context(root: str, workload: str, device: str, cfg=None, mix=None):
    """(bench, cell, ctx) with the configuration, the mix, the problem and
    entry modules and the limits of the cell; ``cfg``/``mix`` replace the
    files' (the tests run small sizes)."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cell, cfg_entry = find_cell(bench, workload)
    cfg = cfg or load_json(os.path.join(root, cfg_entry["file"]))
    mix = mix or load_json(os.path.join(PKG, "traffic",
                                        f"{cell['traffic']}.json"))
    limits = load_json(os.path.join(PKG, "limits", f"{workload}.json"))
    ctx = SimpleNamespace(
        cfg=cfg, mix=mix, limits=limits, device=device, L=None, R=None,
        problem=importlib.import_module(f"portbench.problems."
                                        f"{cfg['problem']}"),
        entry=importlib.import_module(f"portbench.entries.{mix['entry']}"))
    return bench, cell, ctx


def _sync(device):
    if str(device).startswith("cuda"):
        import torch
        torch.cuda.synchronize()


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", root: str = ".", t_start=None,
             cfg=None, mix=None) -> dict:
    """One run; returns the result dict (``checks`` last), with the
    number of judged answers under ``"_checked"``, one line for each
    under ``"_judged"`` and every request's latency under
    ``"_latencies"``."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench, cell, ctx = context(root, workload, device, cfg, mix)
    import torch
    from wavesandeigenvalues_jl_tpu_torch.utils import timing

    # ---- set-up: mesh, the program's family, one warm request ----------
    raw = ctx.problem.mesh(ctx.cfg)
    t0 = time.perf_counter()
    ctx.L = ctx.problem.port_family(raw, ctx.cfg)
    assembly_s = time.perf_counter() - t0
    ctx.entry.warm(ctx, gen.warm_request(ctx.mix, seed))
    _sync(device)
    setup_s = time.perf_counter() - t_start

    # ---- the window: one closed-loop client ----------------------------
    n_traced = int(ctx.mix.get("trace_requests", 1)) if trace else 0
    trace_dir = os.path.join(tempfile.gettempdir(), "portbench_trace")
    trace_path = None
    records = []
    engine = ctx.mix["engine"]
    timing.reset()
    w0 = time.perf_counter()
    deadline = w0 + seconds
    for i, req in enumerate(gen.requests(ctx.mix, seed)):
        if i == 0 and n_traced:
            timing.start_device_trace(trace_dir)
        span = (torch.profiler.record_function(REQUEST_RANGE)
                if i < n_traced else contextlib.nullcontext())
        r0 = time.perf_counter()
        try:
            with span:
                rec = ctx.entry.run(ctx, req)
                _sync(device)
        except Exception:                      # a request that raises fails
            traceback.print_exc(file=sys.stderr)
            rec = {"ok": False, "modes": 0, "error": True}
        r1 = time.perf_counter()
        if not rec.get("error") and rec["engine"] != engine:
            rec["ok"] = False                  # off the cell's named path
        rec.update(request=req, latency_s=r1 - r0)
        records.append(rec)
        if i + 1 == n_traced:
            trace_path = timing.stop_device_trace()
        if r1 >= deadline:
            break
    window_s = time.perf_counter() - w0
    if n_traced and trace_path is None:
        trace_path = timing.stop_device_trace()
    report = timing.report()

    device_info = {"platform": "gpu" if str(device).startswith("cuda")
                   else str(device), "count": int(cell["chips"])}
    if str(device).startswith("cuda"):
        device_info["kind"] = torch.cuda.get_device_name(0)
        device_info["memory_peak_bytes"] = max(
            torch.cuda.max_memory_allocated(d)
            for d in range(int(cell["chips"])))
    else:
        device_info.update(kind="cpu", memory_peak_bytes=0)

    run = SimpleNamespace(setup_s=setup_s, window_s=window_s,
                          records=records, report=report, trace=None,
                          assembly_s=assembly_s, ctx=ctx)
    if trace_path is not None:
        run.trace = summarize(trace_path)
        os.remove(trace_path)
        device_info.update(busy_s=run.trace.busy_s,
                           window_s=run.trace.window_s)

    # ---- per-layer or end-to-end metrics --------------------------------
    metrics = {}
    for m in cell_metrics(bench, workload, trace):
        value = metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # ---- the check: on the host, after the device peak was read -------
    ctx.R = ctx.problem.reference_family(raw, ctx.cfg)
    rng = np.random.default_rng([int(seed) % 2 ** 64, 2])
    numbers = ctx.entry.judge(ctx, records, rng)
    checked = numbers.pop("_checked")
    judged = numbers.pop("_rows", [])
    checks = {k: {"value": numbers[k], "limit": ctx.limits[k]}
              for k in ctx.entry.NUMBERS}
    # requests that answered through another engine than the mix names
    checks["off_path"] = {"value": sum(
        1 for r in records if not r.get("error") and r["engine"] != engine),
        "limit": 0}
    correct = checked > 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())

    result = {"correct": bool(correct), "attempted": len(records),
              "failed": sum(not r["ok"] for r in records),
              "metrics": metrics, "device": device_info}
    if run.trace is not None:
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = checks
    result["_checked"] = checked
    result["_judged"] = judged
    result["_latencies"] = [r["latency_s"] for r in records]
    return result


__all__ = ["run_cell", "context", "forbidden_modules", "cell_metrics",
           "metric_reader"]
