"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Set-up (the program's assembly, one warm
request), then a closed-loop window of ``--seconds`` (the last request
that ends after it closes the window), then the check of the answers
against the plain reference.  The last line of standard output is the
result: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` (with ``--trace 1`` also ``busy_s`` and ``window_s`` of the
traced requests), ``breakdown`` (``--trace 1``) and last ``checks``: each
compared number beside its limit, also printed as the last lines of
standard error.

Exit codes: 0 a result was printed; 3 no card, or fewer cards than the
cell asks for; 4 a JAX module or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.getcwd()
PKG = os.path.dirname(os.path.abspath(__file__))
#: build and kernel caches of the program, inside the checkout
CACHE = os.path.join(ROOT, ".portbench_cache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    # the mix's environment (thread counts) before numpy and torch load
    with open(os.path.join(PKG, "traffic",
                           f"{cells[args.workload]['traffic']}.json")) as f:
        os.environ.update(json.load(f).get("env", {}))
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} card(s); "
              f"torch sees {torch.cuda.device_count()} (cuda available: "
              f"{torch.cuda.is_available()})", file=sys.stderr)
        return 3

    from .harness import forbidden_modules, run_cell
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), device="cuda", root=ROOT,
                      t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 4
    result.pop("_checked")
    print("latencies_s " + " ".join(f"{t:.4f}" for t in
                                     result.pop("_latencies")),
          file=sys.stderr)
    for row in result.pop("_judged"):
        print(f"judged {row}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
