#!/usr/bin/env python3
"""Where kernel K1 (``csrc/bsr_spmm.cu``) spends its time: the kernel as it
is against a copy of its source whose rows hold no nonzeros, so that it only
stages the X window and writes zeros, on the reordered 7,259-DOF operator
at ω = 2π·300 and a 128-column panel, at bs 32, 64 and 128.  Device time
per launch from CUDA-graph replays:

    python3 tools/k1_floor.py

Needs one CUDA device and nvcc; the copy builds into the git-ignored
``_build/``.
"""
import ctypes
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from patched_kernel import build_patched  # noqa: E402
from wavesandeigenvalues_jl_tpu_torch.models.rijke import \
    active_rijke_family  # noqa: E402
from wavesandeigenvalues_jl_tpu_torch.ops.bsr_spmm import (  # noqa: E402
    BsrSpmm, build, random_panel)
from wavesandeigenvalues_jl_tpu_torch.ops.device import \
    BsrOperator  # noqa: E402
from wavesandeigenvalues_jl_tpu_torch.ops.reorder import (  # noqa: E402
    cuthill_mckee, permute_csr)
from wavesandeigenvalues_jl_tpu_torch.utils.timing import \
    device_ms  # noqa: E402

#: the staging-only copy ends every row where it starts
ROW_END = "const int end = __ldg(row_ptr + row + 1);"
EMPTY_ROW = "const int end = __ldg(row_ptr + row);"


def main():
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        sys.exit(1)
    staging = build_patched("bsr_spmm", ROW_END, EMPTY_ROW,
                            "staging_only").bsr_spmm_c64
    staging.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    staging.restype = ctypes.c_int
    fns = {"kernel": build()["lib"].bsr_spmm_c64,
           "staging only": staging}
    L = active_rijke_family(n_rings=4, nz_cold=58, nz_hot=58)
    L.params[L.eigval] = 2 * np.pi * 300.0
    A = L.assemble({})
    Ar = permute_csr(A, cuthill_mckee(A))
    X = random_panel(A.shape[0], 128)
    for bs in (32, 64, 128):
        op = BsrSpmm(BsrOperator.from_csr(Ar, bs=bs), "cuda")
        Xp = op.panel(X)
        Y = torch.empty_like(Xp)
        ptrs = [t.data_ptr() for t in (op.row_ptr, op.lcol, op.vals,
                                       op.block_cols, Xp, Y)]
        for name, fn in fns.items():
            def run(fn=fn):
                code = fn(*ptrs, op.nbr, op.maxb, bs, 128,
                          torch.cuda.current_stream().cuda_stream)
                if code:
                    raise RuntimeError(f"launch failed: {code}")
            print(f"K1 bs={bs} {name}: {device_ms(run):.4f} ms", flush=True)


if __name__ == "__main__":
    main()
