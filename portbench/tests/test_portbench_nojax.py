"""No JAX and no JAX package in what a run loads, top-level names
compared whole (the program's name begins with the JAX package's), and
no program code in the reference."""
import ast
import os
import subprocess
import sys

from portbench.harness import FORBIDDEN

from .conftest import PKG, ROOT


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(PKG, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_top_level_names_compared_whole():
    assert "wavesandeigenvalues_jl_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "wavesandeigenvalues_jl_tpu" in FORBIDDEN


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        for mod in _imports(path):
            assert mod.split(".")[0] not in FORBIDDEN, (path, mod)


def test_reference_imports_nothing_of_either_package():
    for path in _sources("reference"):
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert not top.startswith("wavesandeigenvalues"), (path, mod)
            assert top in ("numpy", "scipy", "__future__"), (path, mod)


def test_a_cpu_run_loads_no_jax():
    code = (
        "import sys\n"
        "from portbench.harness import run_cell, forbidden_modules\n"
        "from portbench.tests.conftest import small\n"
        "cfg, mix = small('rijke7259.mslp_map')\n"
        "r = run_cell('rijke7259.mslp_map', 3, 0.1, False, device='cpu',"
        " root='.', cfg=cfg, mix=mix)\n"
        "print(r['correct'], forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "True []"
