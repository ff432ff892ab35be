"""Build a copy of one of the port's kernel sources with one line changed,
for design measurements (``k1_floor.py``, ``k3_cluster_size.py``,
``k2_step_profile.py``, ``k45_floor.py``).  The copy and its library go to
the git-ignored ``_build/``; the port's own builds are untouched.  Needs
nvcc.
"""
import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from wavesandeigenvalues_jl_tpu_torch.ops import cuda_build  # noqa: E402


def build_patched(name: str, old, new, tag: str, src: str | None = None):
    """ctypes library of ``csrc/<name>.cu`` (or of ``src``) with the line
    ``old`` (found exactly once) replaced by ``new`` (or each line of a
    list by its counterpart; two empty lists build the source as it is),
    built as ``_build/<name>_<tag>``."""
    with open(src or cuda_build.source(name)) as f:
        text = f.read()
    pairs = zip(old, new) if isinstance(old, (list, tuple)) else [(old, new)]
    for a, b in pairs:
        if text.count(a) != 1:
            raise RuntimeError(f"{name}.cu holds {text.count(a)} copies of "
                               f"{a!r}, expected 1")
        text = text.replace(a, b)
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(cuda_build.BUILD_DIR, f"{name}_{tag}.cu")
    with open(path, "w") as f:
        f.write(text)
    so = path[:-3] + ".so"
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", so,
                    path], check=True, capture_output=True)
    return ctypes.CDLL(so)
