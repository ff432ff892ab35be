"""BENCHMARK.json and the files it names, against the rules of its format:
keys, name and unit characters, lengths, every configuration, mix,
metric reader and limit found by its name, and the result line."""
import ast
import json
import os
import re

import pytest

from portbench.harness import cell_metrics, load_json, metric_reader

from .conftest import PKG, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection",
               "head", "expansion")
BENCH = load_json(os.path.join(ROOT, "BENCHMARK.json"))


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s
    cells = 24
    assert (2 + 14 * cells) * (BENCH["run_seconds"] + 60) \
        + cells * 2 * 90 + 1200 <= 43200


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("portbench/") and c["file"] not in files
        files.add(c["file"])
        cfg = load_json(os.path.join(ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key)
            assert not key.endswith(("_dim", "_rank"))
            assert not any(w in key for w in WIDTH_WORDS)
        # the problem module is found by name
        assert os.path.exists(os.path.join(PKG, "problems",
                                           f"{cfg['problem']}.py"))


def test_workloads():
    ws = BENCH["workloads"]
    assert 1 <= len(ws) <= 24
    names = [w["name"] for w in ws]
    assert len(set(names)) == len(names)
    pairs = [(w["config"], w["traffic"]) for w in ws]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in ws) <= max(1, len(ws) // 4)
    for w in ws:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        mix = load_json(os.path.join(PKG, "traffic", f"{w['traffic']}.json"))
        assert os.path.exists(os.path.join(PKG, "entries",
                                           f"{mix['entry']}.py"))
        limits = load_json(os.path.join(PKG, "limits", f"{w['name']}.json"))
        assert limits and all(v > 0 for v in limits.values())


def test_metrics():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and "setup_s" in e2e
    assert 1 <= len(BENCH["per_layer"]) <= 128
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        moved = e2e[m["moves"]].get("workloads", sorted(cells))
        assert set(m["workloads"]) <= set(moved)
        if m["name"].endswith("_roofline") or "roofline" in m["name"]:
            assert m["unit"] == "%"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        # every metric's reader is a file of its own, found by name
        assert callable(metric_reader(m["name"]))
    for w in cells:
        e = [m["name"] for m in cell_metrics(BENCH, w, False)]
        assert "setup_s" in e and len(e) >= 2
        assert cell_metrics(BENCH, w, True)


def test_every_file_is_named_from_name_characters():
    for dirpath, dirnames, files in os.walk(PKG):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert all(NAME.match(part) for part in rel.split("/")), rel


def test_result_line_keys_in_order():
    """A CPU run's result has its keys in order, ``checks`` last."""
    from portbench.harness import run_cell

    from .conftest import small
    cfg, mix = small("rijke7259.mslp_map")
    r = run_cell("rijke7259.mslp_map", 2 ** 31 + 7, 0.1, False,
                 device="cpu", root=ROOT, cfg=cfg, mix=mix)
    r.pop("_checked")
    assert r.pop("_judged")
    assert len(r.pop("_latencies")) == r["attempted"]
    assert list(r) == ["correct", "attempted", "failed", "metrics",
                       "device", "checks"]
    assert r["correct"] is True and r["attempted"] >= 1
    assert set(r["metrics"]) == {"modes_per_s", "setup_s"}
    for v in r["metrics"].values():
        assert set(v) == {"value", "unit"} and v["value"] > 0
    assert json.loads(json.dumps(r)) == r
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())


def test_modules_import_nothing_at_import_time():
    """No module of the benchmark imports the program at its top level
    (the card check comes first)."""
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py") or "tests" in dirpath:
                continue
            tree = ast.parse(open(os.path.join(dirpath, f)).read())
            for node in tree.body:
                if isinstance(node, (ast.Import, ast.ImportFrom)):
                    mods = ([a.name for a in node.names]
                            if isinstance(node, ast.Import)
                            else [node.module or ""])
                    assert not any(m.split(".")[0].startswith(
                        "wavesandeigenvalues") for m in mods), (f, mods)


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_per_layer_readers_give_nothing_without_a_trace(workload):
    from types import SimpleNamespace
    run = SimpleNamespace(trace=None, report={}, records=[], window_s=1.0,
                          setup_s=1.0, assembly_s=1.0,
                          ctx=SimpleNamespace(L=None))
    for m in cell_metrics(BENCH, workload, True):
        if m["source"] == "device_trace":
            assert metric_reader(m["name"])(run) is None
