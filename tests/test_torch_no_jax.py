"""The port never imports jax.  The test process itself has jax loaded
(tests/conftest.py), so the check runs in a fresh interpreter."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "wavesandeigenvalues_jl_tpu_torch",
    "wavesandeigenvalues_jl_tpu_torch.utils.config",
    "wavesandeigenvalues_jl_tpu_torch.utils.timing",
    "wavesandeigenvalues_jl_tpu_torch.mesh",
    "wavesandeigenvalues_jl_tpu_torch.mesh.refine",
    "wavesandeigenvalues_jl_tpu_torch.fem",
    "wavesandeigenvalues_jl_tpu_torch.models",
    "wavesandeigenvalues_jl_tpu_torch.nlevp",
    "wavesandeigenvalues_jl_tpu_torch.ops",
    "wavesandeigenvalues_jl_tpu_torch.ops.cuda_build",
    "wavesandeigenvalues_jl_tpu_torch.ops.gmres",
    "wavesandeigenvalues_jl_tpu_torch.ops.device_solve",
    "wavesandeigenvalues_jl_tpu_torch.ops.refine",
    "wavesandeigenvalues_jl_tpu_torch.ops.dense_gmres",
    "wavesandeigenvalues_jl_tpu_torch.ops.device",
    "wavesandeigenvalues_jl_tpu_torch.ops.reorder",
    "wavesandeigenvalues_jl_tpu_torch.ops.bsr_spmm",
    "wavesandeigenvalues_jl_tpu_torch.ops.window_spmm",
    "wavesandeigenvalues_jl_tpu_torch.nlevp.pencil",
    "wavesandeigenvalues_jl_tpu_torch.nlevp.fused_local",
    "wavesandeigenvalues_jl_tpu_torch.nlevp.fused_slab",
    "wavesandeigenvalues_jl_tpu_torch.nlevp.perturbation",
    "wavesandeigenvalues_jl_tpu_torch.nlevp.gallery",
    "wavesandeigenvalues_jl_tpu_torch.nlevp.eigs",
    "wavesandeigenvalues_jl_tpu_torch.ops.slab_solve",
    "wavesandeigenvalues_jl_tpu_torch.ops.panel_solve",
    "wavesandeigenvalues_jl_tpu_torch.nlevp.pade",
    "wavesandeigenvalues_jl_tpu_torch.nlevp.continuation",
    "wavesandeigenvalues_jl_tpu_torch.parallel",
    "wavesandeigenvalues_jl_tpu_torch.parallel.dist_beyn",
    "chip_smoke",
]


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        f"for m in {MODULES!r}:\n"
        "    __import__(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m.split('.')[0] == 'wavesandeigenvalues_jl_tpu')\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "assert torch.get_float32_matmul_precision() == 'highest'\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
