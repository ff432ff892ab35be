"""Build a copy of one of the port's kernel sources with one line changed,
for design measurements (``k1_floor.py``, ``k3_cluster_size.py``,
``k2_step_profile.py``).  The copy and its library go to the git-ignored
``_build/``; the port's own builds are untouched.  Needs nvcc.
"""
import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from wavesandeigenvalues_jl_tpu_torch.ops import cuda_build  # noqa: E402


def build_patched(name: str, old: str, new: str, tag: str):
    """ctypes library of ``csrc/<name>.cu`` with the line ``old`` (found
    exactly once) replaced by ``new``, built as ``_build/<name>_<tag>``."""
    with open(cuda_build.source(name)) as f:
        src = f.read()
    if src.count(old) != 1:
        raise RuntimeError(f"{name}.cu holds {src.count(old)} copies of "
                           f"{old!r}, expected 1")
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(cuda_build.BUILD_DIR, f"{name}_{tag}.cu")
    with open(path, "w") as f:
        f.write(src.replace(old, new))
    so = path[:-3] + ".so"
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", so,
                    path], check=True, capture_output=True)
    return ctypes.CDLL(so)
