"""The one request generator: draws a traffic mix's requests from a seed.

A mix (``traffic/<name>.json``) lists the fields of a request under
``draw``, in order, each with one rule:

* ``{"value": x}`` — the same x in every request;
* ``{"uniform": [a, b]}`` — uniform on [a, b], stratified: within each
  block of ``block`` requests every one of ``block`` equal strata of
  [a, b] gets one draw, in a random order.

Stratifying by blocks gives every seed the same spread of sizes in
another order, so the work of a window changes little from seed to seed.
The warm-up request is drawn from a stream of its own.
"""
from __future__ import annotations

import numpy as np

WARM_STREAM = 1


def _rng(seed: int, stream: int = 0):
    return np.random.default_rng([int(seed) % 2 ** 64, stream])


def _block(draw: dict, size: int, rng) -> list:
    reqs = [{} for _ in range(size)]
    for name, rule in draw.items():
        if "value" in rule:
            vals = [rule["value"]] * size
        elif "uniform" in rule:
            a, b = rule["uniform"]
            u = (rng.permutation(size) + rng.random(size)) / size
            vals = list(a + (b - a) * u)
        else:
            raise ValueError(f"field {name}: unknown rule {rule}")
        for r, v in zip(reqs, vals):
            r[name] = float(v)
    return reqs


def requests(mix: dict, seed: int):
    """The mix's requests for ``seed``, an endless iterator of dicts."""
    rng = _rng(seed)
    size = int(mix.get("block", 1))
    while True:
        yield from _block(mix["draw"], size, rng)


def warm_request(mix: dict, seed: int) -> dict:
    return _block(mix["draw"], 1, _rng(seed, WARM_STREAM))[0]


__all__ = ["requests", "warm_request"]
