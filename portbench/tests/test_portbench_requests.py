"""The request generator: the same seed gives the same requests, and
every seed the same strata of each drawn range in another order."""
import os

import numpy as np

from portbench.harness import load_json
from portbench.requests import requests, warm_request

from .conftest import PKG

MIX = load_json(os.path.join(PKG, "traffic", "mslp_map.json"))
SEEDS = (2 ** 31 + 11, 2 ** 31 + 12)


def _first(seed, k):
    it = requests(MIX, seed)
    return [next(it) for _ in range(k)]


def test_same_seed_same_requests():
    assert _first(SEEDS[0], 16) == _first(SEEDS[0], 16)
    assert warm_request(MIX, SEEDS[0]) == warm_request(MIX, SEEDS[0])
    assert _first(SEEDS[0], 16) != _first(SEEDS[1], 16)


def test_each_block_holds_every_stratum_once():
    block = MIX["block"]
    for seed in SEEDS:
        reqs = _first(seed, 2 * block)
        for name, rule in MIX["draw"].items():
            vals = np.array([r[name] for r in reqs])
            if "value" in rule:
                assert np.all(vals == rule["value"])
                continue
            a, b = rule["uniform"]
            for blk in vals.reshape(2, block):
                strata = np.floor((blk - a) / (b - a) * block).astype(int)
                assert sorted(strata) == list(range(block))
