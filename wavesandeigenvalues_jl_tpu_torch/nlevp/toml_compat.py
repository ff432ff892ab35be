"""Interop with the reference's Julia-enriched TOML persistence.

Host Python, copied from the JAX package's ``nlevp/toml_compat.py``; a
family the port cannot write raises before anything is written (the JAX
writer raises with the same message after writing the terms before it).
WavesAndEigenvalues.jl saves operator families and solutions as a
Julia-flavored TOML dialect (save, LinOpFam.jl:231-294; save.jl:2-80;
parser toml.jl:10-63).  Users migrating from the reference have model
files in that format on disk; this module reads them — with a *safe*
recursive-descent parser for the Julia literal subset the writer emits
(symbols, tuples, typed arrays, complex numbers), never ``eval`` — and
writes files the reference's own loader can read back, so models can
move in both directions.

The framework's native persistence remains :mod:`.persist` (npz/json);
this is a compatibility layer.  Only the *named* coefficient functions
of the reference's algebra round-trip (pow0/pow1/pow2, exp_delay,
exp_az2mzit) — exactly the set a Julia user can round-trip too, since
closures print as gensyms there (algebra.jl:78-105).  Every family
produced by ``Helmholtz.discretize`` without state-space admittance
falls in this set.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from ..ops.sparse import CSR
from ..utils.config import CDTYPE
from . import algebra
from .family import OperatorFamily, Solution, Term

# ---------------------------------------------------------------------------
# Julia-literal value parser (the safe replacement of toml.jl:52's eval)

_CLOSERS = {"[": "]", "(": ")"}


class _Parser:
    def __init__(self, s: str):
        self.s = s
        self.i = 0

    def _ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def parse_value(self):
        self._ws()
        if self.i >= len(self.s):
            return None
        c = self.s[self.i]
        if c in "[(":
            return self._sequence(c)
        if c == ":":
            self.i += 1
            return self._ident()
        if c == '"':
            return self._string()
        tok = self._raw_token()
        if tok.endswith(("[", "(")):  # typed prefix, e.g. Complex{Float64}[
            open_c = tok[-1]
            self.i -= 1
            return self._sequence(open_c)
        return _atom(tok)

    def _sequence(self, open_c: str):
        close_c = _CLOSERS[open_c]
        self.i += 1  # consume opener
        items: List[object] = []
        while True:
            self._ws()
            if self.i >= len(self.s):
                raise ValueError(f"unterminated '{open_c}' in Julia literal")
            if self.s[self.i] == close_c:
                self.i += 1
                break
            items.append(self.parse_value())
            self._ws()
            if self.i < len(self.s) and self.s[self.i] == ",":
                self.i += 1
        return tuple(items) if open_c == "(" else list(items)

    def _ident(self) -> str:
        j = self.i
        while j < len(self.s) and (self.s[j].isalnum() or self.s[j] in "_²"
                                   or not self.s[j].isascii()):
            j += 1
        name = self.s[self.i:j]
        self.i = j
        return name

    def _string(self) -> str:
        j = self.s.index('"', self.i + 1)
        out = self.s[self.i + 1:j]
        self.i = j + 1
        return out

    def _raw_token(self) -> str:
        """Maximal run up to an unparenthesized ',', ')' or ']' — numbers may
        contain spaces ('NaN + NaN*im') and type prefixes contain '{}'."""
        j = self.i
        while j < len(self.s) and self.s[j] not in ",)]":
            j += 1
            if self.s[j - 1] in "[(":  # typed-array prefix hit its opener
                break
        tok = self.s[self.i:j]
        self.i = j
        return tok.strip()


def _atom(tok: str):
    s = tok.replace(" ", "").replace("*", "")
    if s == "":
        return ""
    try:
        return int(s)
    except ValueError:
        pass
    f = _float_or_none(s)
    if f is not None:
        return f
    if s.endswith("im"):
        return _complex_from(s[:-2])
    return tok  # bare identifier (function name)


def _float_or_none(s: str):
    t = s.replace("NaN", "nan").replace("Inf", "inf")
    try:
        return float(t)
    except ValueError:
        return None


def _complex_from(mant: str) -> complex:
    """'1.0+2.5' / '-1.0-2.5' / 'NaN+NaN' / '2.5' (pure imaginary) → complex."""
    split = -1
    for k in range(1, len(mant)):
        if mant[k] in "+-" and mant[k - 1] not in "eE":
            split = k
    if split < 0:
        im = _float_or_none(mant) if mant not in ("", "+", "-") else \
            (-1.0 if mant == "-" else 1.0)
        return complex(0.0, im)
    re = _float_or_none(mant[:split])
    im_s = mant[split:]
    im = (-1.0 if im_s == "-" else 1.0) if im_s in ("+", "-") else \
        _float_or_none(im_s)
    if re is None or im is None:
        raise ValueError(f"cannot parse Julia complex literal {mant!r}im")
    return complex(re, im)


def read_toml(fname: str) -> Dict:
    """Parse a file in the reference's Julia-enriched TOML dialect into a
    nested dict with '/'-prefixed section keys, mirroring the structure the
    reference's own parser produces (read_toml, toml.jl:10-63) — but without
    evaluating anything."""
    D: Dict = {}
    entry = D
    in_section = False
    var, data, multi = "", "", False
    with open(fname, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or (not multi and line.startswith("#")):
                continue
            if not multi and line[0] == "[":
                entry = D
                for tag in line[1:-1].split("."):
                    entry = entry.setdefault("/" + tag, {})
                in_section = True
                continue
            if not multi and (line[0].isalpha() or line[0] == "_"):
                eq = line.index("=")
                var = line[:eq].strip()
                data = line[eq + 1:].strip()
                multi = data.endswith(",")
            elif multi:
                data += line
                multi = data.endswith(",")
            else:
                continue  # stray lines (the reference writer emits one after v)
            if not multi and data:
                target = entry if in_section else D
                target[var] = _Parser(data).parse_value()
                data = ""
    return D


# ---------------------------------------------------------------------------
# operator families (LinOpFam.jl:196-294)

_JL_FUNCS = {
    "pow0": algebra.pow0,
    "pow1": algebra.pow1,
    "pow2": algebra.pow2,
    "exp_delay": algebra.exp_delay,
    "exp_az2mzit": algebra.exp_az2mzit,
}


def _func_to_jl_name(f) -> str:
    for name, obj in _JL_FUNCS.items():
        if obj is f:
            return name
    sig = f.signature()
    if sig[0] == "Pow" and f.a in (0, 1, 2):
        return f"pow{f.a}"
    raise ValueError(
        f"coefficient function {sig[0]} has no named Julia counterpart in the "
        "reference format (its closures do not round-trip there either, "
        "algebra.jl:78-105); use the native npz persistence instead")


def load_family_toml(fname: str) -> OperatorFamily:
    """Load an operator family saved by the reference's
    ``save(fname, L::LinearOperatorFamily)`` (LinOpFam.jl:196-225 loader)."""
    D = read_toml(fname)
    pairs = [(str(sym), complex(val)) for sym, val in D["params"]]
    L = OperatorFamily([p for p, _ in pairs] or ["λ"],
                       [v for _, v in pairs] or None)
    L.eigval = str(D["eigval"])
    L.auxval = str(D.get("auxval", ""))
    L.active = [L.eigval]
    terms = D.get("/terms", {})
    for idx in range(1, len(terms) + 1):
        t = terms[f"/{idx}"]
        sm = t["/sparse_matrix"]
        m, n = t["size"]
        rows = np.asarray(sm["I"], dtype=np.int64) - 1
        cols = np.asarray(sm["J"], dtype=np.int64) - 1
        vals = np.asarray(sm["V"], dtype=CDTYPE)
        coeff = CSR.from_coo(rows, cols, vals, (int(m), int(n)))
        names = t["functions"]
        if isinstance(names, str):
            names = (names,) if names else ()
        funcs = []
        for name in names:
            if name not in _JL_FUNCS:
                raise ValueError(f"unknown coefficient function {name!r} in "
                                 f"{fname}; only the reference's named "
                                 "algebra functions are loadable")
            funcs.append(_JL_FUNCS[name])
        params = t["params"]
        if params and isinstance(params[0], str):
            params = (params,)
        params = tuple(tuple(str(p) for p in pp) for pp in params)
        L.push(Term(coeff, tuple(funcs), params, str(t["symbol"]),
                    str(t["operator"])))
    return L


def _jl_float(x: float) -> str:
    if math.isnan(x):
        return "NaN"
    if math.isinf(x):
        return "Inf" if x > 0 else "-Inf"
    return repr(float(x))


def _jl_complex(v: complex) -> str:
    # '*im' (not bare 'im') so non-finite components stay parseable by the
    # reference's eval-based loader (toml.jl:52): Julia reads 'NaN*im' and
    # 'Inf*im' but 'NaNim'/'Infim' are undefined identifiers.  Fresh families
    # carry ω=NaN+NaN*im, so this is the common case, not a corner.
    re, im = _jl_float(v.real), _jl_float(v.imag)
    if im.startswith("-"):
        return f"{re}{im}*im"
    return f"{re}+{im}*im"


def _jl_vector(V) -> str:
    vals = np.asarray(V).ravel()
    if len(vals) == 0:
        # no trailing comma: 'Complex{Float64}[,]' is a Julia syntax error
        return "Complex{Float64}[]"
    return ("Complex{Float64}["
            + ",".join(_jl_complex(complex(v)) for v in vals)
            + ",]")


def save_family_toml(fname: str, L: OperatorFamily):
    """Write an operator family in the reference's TOML dialect
    (save, LinOpFam.jl:231-294) so WavesAndEigenvalues.jl can load it.
    Raises ValueError, before writing, on a coefficient function that has
    no named Julia counterpart."""
    names = [[_func_to_jl_name(fn) for fn in t.funcs] for t in L.terms]
    with open(fname, "w", encoding="utf-8") as f:
        f.write("# LinearOperatorFamily version 0\n")
        f.write("# written by wavesandeigenvalues_jl_tpu_torch\n")
        f.write("params=[")
        for key, value in L.params.items():
            f.write(f"(:{key},{_jl_complex(complex(value))}),\n")
        f.write("]\n")
        f.write(f"eigval=:{L.eigval}\n")
        f.write(f"auxval=:{L.auxval}\n")
        f.write("[terms]\n")
        for idx, (t, fnames) in enumerate(zip(L.terms, names), start=1):
            f.write(f"\t[terms.{idx}]\n")
            f.write("\tfunctions=(" + "".join(n + "," for n in fnames)
                    + ")\n")
            f.write(f'\tsymbol="{t.symbol}"\n')
            f.write("\tparams=("
                    + "".join("(" + "".join(f":{p}," for p in pp) + "),"
                              for pp in t.params)
                    + ")\n")
            f.write(f'\toperator="{t.operator}"\n')
            m, n = t.coeff.shape
            f.write(f"\tsize=[{m},{n}]\n")
            f.write(f"\t\t[terms.{idx}.sparse_matrix]\n")
            rows, cols, vals = t.coeff.to_coo()
            f.write("\t\tI=[" + ",".join(str(i + 1) for i in rows) + ",]\n")
            f.write("\t\tJ=[" + ",".join(str(j + 1) for j in cols) + ",]\n")
            f.write("\t\tV=" + _jl_vector(vals) + "\n\n")


# ---------------------------------------------------------------------------
# solutions (save.jl:2-80, read_sol save.jl:86-135)


def load_solution_toml(fname: str) -> Solution:
    """Load a Solution saved by the reference's ``save(fname, sol)``."""
    D = read_toml(fname)
    params = {str(sym): complex(val) for sym, val in D["params"]}
    v = _opt_vector(D.get("v"))
    v_adj = _opt_vector(D.get("v_adj"))
    sol = Solution(params, v, v_adj, str(D["eigval"]))
    for key, value in D.get("/eigval_pert", {}).items():
        num = np.asarray(value["num"], dtype=CDTYPE)
        if "den" in value:
            sol.eigval_pert[key[1:]] = (num, np.asarray(value["den"], CDTYPE))
        else:
            sol.eigval_pert[key[1:]] = num
    for key, value in D.get("/v_pert", {}).items():
        num = _read_vec_block(value["/num"])
        if "/den" in value:
            sol.v_pert[key[1:]] = (num, _read_vec_block(value["/den"]))
        else:
            sol.v_pert[key[1:]] = num
    return sol


def _opt_vector(x):
    """Empty vectors (None, [], or [''] from legacy '[,]' files) → None —
    solutions from inveriter/lancaster/picard have no adjoint vector."""
    if x is None or len(x) == 0 or x == [""]:
        return None
    return np.asarray(x, dtype=CDTYPE)


def _read_vec_block(block: Dict) -> List[np.ndarray]:
    return [np.asarray(block[f"/{i}"]["v"], dtype=CDTYPE)
            for i in range(1, len(block) + 1)]


def save_solution_toml(fname: str, sol: Solution):
    """Write a Solution in the reference's TOML dialect (save.jl:2-80)."""
    with open(fname, "w", encoding="utf-8") as f:
        f.write("# Solution version 0\n")
        f.write("# written by wavesandeigenvalues_jl_tpu_torch\n")
        f.write("params=[")
        for key, value in sol.params.items():
            f.write(f"(:{key},{_jl_complex(complex(value))}),\n")
        f.write("]\n")
        f.write(f"eigval=:{sol.eigval}\n")
        f.write("v=" + _jl_vector(sol.v if sol.v is not None else []) + "\n")
        f.write("v_adj="
                + _jl_vector(sol.v_adj if sol.v_adj is not None else [])
                + "\n")
        f.write("[eigval_pert]\n")
        for key, value in sol.eigval_pert.items():
            f.write(f"\t[eigval_pert.{key}]\n")
            if isinstance(value, tuple):
                f.write("\t\tnum=" + _jl_vector(value[0]) + "\n")
                f.write("\t\tden=" + _jl_vector(value[1]) + "\n")
            else:
                f.write("\t\tnum=" + _jl_vector(value) + "\n")
        f.write("[v_pert]\n")
        for key, value in sol.v_pert.items():
            f.write(f"\t[v_pert.{key}]\n")
            if isinstance(value, tuple):
                for part, vecs in zip(("num", "den"), value):
                    f.write(f"\t\t[v_pert.{key}.{part}]\n")
                    _write_vec_block(f, f"v_pert.{key}.{part}", vecs)
            else:
                f.write(f"\t\t[v_pert.{key}.num]\n")
                _write_vec_block(f, f"v_pert.{key}.num", value)


def _write_vec_block(f, tag: str, vecs):
    for idx, vec in enumerate(vecs, start=1):
        f.write(f"\t\t\t[{tag}.{idx}]\n")
        f.write("\t\t\tv=" + _jl_vector(vec) + "\n")


__all__ = ["read_toml", "load_family_toml", "save_family_toml",
           "load_solution_toml", "save_solution_toml"]
