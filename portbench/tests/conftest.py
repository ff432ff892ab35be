"""Shared fixtures of the benchmark's tests: small configurations of the
cells (CPU sizes), and the card marker."""
import os

import pytest

from portbench.harness import load_json

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PKG = os.path.join(ROOT, "portbench")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where torch sees none")


@pytest.fixture
def card():
    """Skip unless torch sees a card (decided here, not at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device visible to torch")


def small(workload: str):
    """(cfg, mix) of a cell at a CPU size: the 437-DOF Rijke tube, where
    the program's fused local engine takes its dense solver."""
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = {w["name"]: w for w in bench["workloads"]}[workload]
    cfg_file = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = load_json(os.path.join(ROOT, cfg_file["file"]))
    mix = load_json(os.path.join(PKG, "traffic", f"{cell['traffic']}.json"))
    cfg["mesh"].update(n_rings=2, nz_cold=10, nz_hot=10)
    mix["engine"] = "FusedPencilSolver"
    mix["check"]["sample"] = min(mix["check"]["sample"], 3)
    return cfg, mix
