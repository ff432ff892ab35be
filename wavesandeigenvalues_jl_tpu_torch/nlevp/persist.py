"""Persistence for operator families and solutions: the npz container.

Host numpy, copied from the JAX package's ``nlevp/persist.py``, so files
cross between the two packages in both directions.  It replaces the
reference's Julia-enriched, ``eval``-based TOML format (LinOpFam.jl:196-294,
save.jl, toml.jl — the loader there calls ``eval`` on every right-hand
side; :mod:`.toml_compat` reads and writes that dialect safely) with a
safe npz container: sparse COO triplets per term plus a JSON header
describing parameters and coefficient-function signatures.  The
descriptors cover every function kind of :mod:`.algebra` that has one
(``Pow``, ``ExpAz``, ``ExpDelay``, ``ExpPM``, ``ExpAZ2MZIT``,
``SumYExpIKX``, ``StateSpace``, ``ZTimesG``, ``Product``, ``OneMinus``);
custom callables are not persistable.
"""
from __future__ import annotations

import json
from typing import Dict

import numpy as np

from ..ops.sparse import CSR
from . import algebra
from .family import OperatorFamily, Solution, Term


def _func_to_desc(f: algebra.ScalarFunc):
    sig = f.signature()
    name = sig[0]
    if name == "Pow":
        return {"kind": "Pow", "a": f.a}
    if name == "ExpAz":
        return {"kind": "ExpAz", "a": [f.a.real, f.a.imag]}
    if name == "ExpDelay":
        return {"kind": "ExpDelay"}
    if name == "ExpPM":
        return {"kind": "ExpPM", "s": f.s}
    if name == "ExpAZ2MZIT":
        return {"kind": "ExpAZ2MZIT"}
    if name == "SumYExpIKX":
        return {"kind": "SumYExpIKX",
                "y": [[c.real, c.imag] for c in f.y]}
    if name == "StateSpace":
        return {"kind": "StateSpace",
                "A": _c2l(f.A), "B": _c2l(f.B), "C": _c2l(f.C), "D": _c2l(f.D)}
    if name == "ZTimesG":
        return {"kind": "ZTimesG", "g": _func_to_desc(f.g)}
    if name == "Product":
        return {"kind": "Product", "g": _func_to_desc(f.g),
                "h": _func_to_desc(f.h)}
    if name == "OneMinus":
        return {"kind": "OneMinus", "g": _func_to_desc(f.g)}
    raise ValueError(f"cannot serialize coefficient function {name}; "
                     "custom callables are not persistable")


def _c2l(a):
    a = np.asarray(a)
    return [a.real.tolist(), a.imag.tolist()]


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


def save_family(fname: str, L: OperatorFamily):
    header = {
        "version": 1,
        "eigval": L.eigval,
        "auxval": L.auxval,
        "active": L.active,
        "mode": L.mode,
        "params": {k: [v.real, v.imag] for k, v in L.params.items()},
        "terms": [],
    }
    arrays: Dict[str, np.ndarray] = {}
    for idx, t in enumerate(L.terms):
        header["terms"].append({
            "funcs": [_func_to_desc(f) for f in t.funcs],
            "params": [list(p) for p in t.params],
            "symbol": t.symbol,
            "operator": t.operator,
            "shape": list(t.coeff.shape),
        })
        rows, cols, vals = t.coeff.to_coo()
        arrays[f"t{idx}_rows"] = rows
        arrays[f"t{idx}_cols"] = cols
        arrays[f"t{idx}_vals"] = vals
    np.savez_compressed(fname, header=json.dumps(header), **arrays)


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


def save_solution(fname: str, sol: Solution):
    """Persist a Solution including Taylor/Padé coefficient dictionaries
    (save.jl:2-67)."""
    header = {
        "version": 1,
        "eigval": sol.eigval,
        "auxval": sol.auxval,
        "params": {k: [v.real, v.imag] for k, v in sol.params.items()},
        "eigval_pert_keys": [],
        "v_pert_keys": [],
    }
    arrays: Dict[str, np.ndarray] = {}
    if sol.v is not None:
        arrays["v"] = sol.v
    if sol.v_adj is not None:
        arrays["v_adj"] = sol.v_adj
    for i, (k, val) in enumerate(sol.eigval_pert.items()):
        header["eigval_pert_keys"].append(k)
        if isinstance(val, tuple):
            arrays[f"ep{i}_a"], arrays[f"ep{i}_b"] = val
        else:
            arrays[f"ep{i}_a"] = np.asarray(val)
    for i, (k, val) in enumerate(sol.v_pert.items()):
        header["v_pert_keys"].append(k)
        if isinstance(val, tuple):
            arrays[f"vp{i}_a"], arrays[f"vp{i}_b"] = val
        else:
            arrays[f"vp{i}_a"] = np.asarray(val)
    np.savez_compressed(fname, header=json.dumps(header), **arrays)


def read_solution(fname: str) -> Solution:
    with np.load(fname, allow_pickle=False) as z:
        header = json.loads(str(z["header"]))
        params = {k: complex(v[0], v[1]) for k, v in header["params"].items()}
        v = z["v"] if "v" in z else None
        v_adj = z["v_adj"] if "v_adj" in z else None
        sol = Solution(params, v, v_adj, header["eigval"], header["auxval"])
        for i, k in enumerate(header["eigval_pert_keys"]):
            if f"ep{i}_b" in z:
                sol.eigval_pert[k] = (z[f"ep{i}_a"], z[f"ep{i}_b"])
            else:
                sol.eigval_pert[k] = z[f"ep{i}_a"]
        for i, k in enumerate(header["v_pert_keys"]):
            if f"vp{i}_b" in z:
                sol.v_pert[k] = (z[f"vp{i}_a"], z[f"vp{i}_b"])
            else:
                sol.v_pert[k] = z[f"vp{i}_a"]
        return sol


__all__ = ["save_family", "load_family", "save_solution", "read_solution"]
