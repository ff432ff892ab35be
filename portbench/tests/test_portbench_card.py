"""The command as BENCHMARK.json gives it: without a card it prints no result
and exits 3; with one (marker ``cuda``) every cell prints a correct
result line at a short window."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench.harness import load_json

from .conftest import ROOT

BENCH = load_json(os.path.join(ROOT, "BENCHMARK.json"))


def _run(cwd, workload, seconds=3, trace=0):
    cmd = BENCH["command"] + ["--workload", workload, "--seed",
                              str(2 ** 31 + 1), "--seconds", str(seconds),
                              "--trace", str(trace)]
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                          timeout=900)


def test_no_result_without_a_card(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    out = _run(ROOT, BENCH["workloads"][0]["name"])
    assert out.returncode == 3 and out.stdout == ""


def test_no_result_from_the_benchmark_files_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    for p in BENCH["paths"]:
        shutil.copytree(os.path.join(ROOT, p), tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(str(tmp_path), BENCH["workloads"][0]["name"])
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_on_the_card(card, workload):
    out = _run(ROOT, workload)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
