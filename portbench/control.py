"""The control of a cell: what its comparison must refuse.

    python3 -m portbench.control --workload <name> --seeds 1 2 3 \
        [--requests K] [--device cuda|cpu]

Draws each seed's first K requests (by default as many as a run
checks), answers them with the entry's control in the program's place —
for a local solve the reference in complex64 — and prints, one JSON
line a seed, the compared numbers the cell's judge reads on those
answers beside the cell's limits.  The
benchmark's runs never run it; a limit is set below the smallest reading
it gives.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time

import numpy as np

from . import requests as gen
from .harness import context


def control_numbers(workload: str, seeds, n_requests=None, *,
                    device: str = "cuda", root: str = ".", cfg=None,
                    mix=None) -> list:
    _, _, ctx = context(root, workload, device, cfg, mix)
    raw = ctx.problem.mesh(ctx.cfg)
    ctx.R = ctx.problem.reference_family(raw, ctx.cfg)
    matrix = ctx.entry.control_matrix(ctx)
    if matrix is None:                 # the control runs the program
        ctx.L = ctx.problem.port_family(raw, ctx.cfg)
    k = n_requests or ctx.mix["check"]["sample"]
    out = []
    for seed in seeds:
        records = []
        for req in itertools.islice(gen.requests(ctx.mix, seed), k):
            t0 = time.perf_counter()
            rec = ctx.entry.control(ctx, req)
            rec["latency_s"] = time.perf_counter() - t0
            records.append(rec)
        rng = np.random.default_rng([int(seed) % 2 ** 64, 2])
        numbers = ctx.entry.judge(ctx, records, rng, matrix=matrix)
        checked = numbers.pop("_checked")
        numbers.pop("_rows", None)
        out.append({"seed": seed, "checked": checked,
                    "answered": sum(r["ok"] for r in records),
                    "numbers": numbers, "limits": ctx.limits})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for row in control_numbers(args.workload, args.seeds, args.requests,
                               device=args.device, root=os.getcwd()):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
