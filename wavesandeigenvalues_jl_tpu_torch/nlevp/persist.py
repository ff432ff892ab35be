"""Loader of the operator-family npz container.

This is how state crosses from the JAX package to the port: the JAX
package's ``save_family`` writes sparse COO triplets per term plus a JSON
header of parameters and coefficient-function descriptors
(``nlevp/persist.py`` there), and :func:`load_family` rebuilds the port's
:class:`.family.OperatorFamily` from those numpy arrays alone.  It reads
every function kind the JAX writer emits (``Pow``, ``ExpAz``,
``ExpDelay``, ``ExpPM``, ``ExpAZ2MZIT``, ``SumYExpIKX``, ``StateSpace``,
``ZTimesG``, ``Product``, ``OneMinus``).  The writers (``save_family``,
``save_solution``, ``read_solution``) are not ported yet (ROADMAP.md
Queue 1, persistence and fitting).
"""
from __future__ import annotations

import json

import numpy as np

from ..ops.sparse import CSR
from . import algebra
from .family import OperatorFamily, Term


def _l2c(x):
    return np.asarray(x[0]) + 1j * np.asarray(x[1])


def _desc_to_func(d) -> algebra.ScalarFunc:
    k = d["kind"]
    if k == "Pow":
        return algebra.Pow(d["a"])
    if k == "ExpAz":
        return algebra.ExpAz(complex(d["a"][0], d["a"][1]))
    if k == "ExpDelay":
        return algebra.exp_delay
    if k == "ExpPM":
        return algebra.ExpPM(d["s"])
    if k == "ExpAZ2MZIT":
        return algebra.exp_az2mzit
    if k == "SumYExpIKX":
        return algebra.SumYExpIKX([complex(a, b) for a, b in d["y"]])
    if k == "StateSpace":
        return algebra.StateSpace(_l2c(d["A"]), _l2c(d["B"]), _l2c(d["C"]),
                                  _l2c(d["D"]))
    if k == "ZTimesG":
        return algebra.ZTimesG(_desc_to_func(d["g"]))
    if k == "Product":
        return algebra.Product(_desc_to_func(d["g"]), _desc_to_func(d["h"]))
    if k == "OneMinus":
        return algebra.OneMinus(_desc_to_func(d["g"]))
    raise ValueError(f"unknown function kind {k}")


def load_family(fname: str) -> OperatorFamily:
    with np.load(fname, allow_pickle=False) as z:
        header = json.loads(str(z["header"]))
        L = OperatorFamily(["λ"])
        L.terms = []
        L.params = {k: complex(v[0], v[1]) for k, v in header["params"].items()}
        L.eigval = header["eigval"]
        L.auxval = header["auxval"]
        L.active = list(header["active"])
        L.mode = header["mode"]
        for idx, td in enumerate(header["terms"]):
            coeff = CSR.from_coo(z[f"t{idx}_rows"], z[f"t{idx}_cols"],
                                 z[f"t{idx}_vals"], tuple(td["shape"]))
            funcs = tuple(_desc_to_func(d) for d in td["funcs"])
            L.terms.append(Term(coeff, funcs,
                                tuple(tuple(p) for p in td["params"]),
                                td["symbol"], td["operator"]))
        return L


__all__ = ["load_family"]
