"""The generators make the same inputs from the same seed, other inputs
from another, and take seeds past 32 bits."""

import json
from pathlib import Path

import pytest

from portbench.gen.chain import Chain
from portbench.gen.valset import PRECOMMIT, PREVOTE, ValsetPool

CONFIGS = Path(__file__).parents[1] / "configs"


def _cfg(name, **kw):
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    cfg.update(kw)
    return cfg


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5, -(2 ** 31), 2 ** 33 + 1])
def test_valset_pool_is_a_function_of_the_seed(seed):
    cfg = _cfg("valset10k", validators=12)
    a = ValsetPool(cfg, seed, 2, (PREVOTE, PRECOMMIT), True)
    b = ValsetPool(cfg, seed, 2, (PREVOTE, PRECOMMIT), True)
    c = ValsetPool(cfg, seed + 1, 2, (PREVOTE, PRECOMMIT), True)
    assert a.vals == b.vals and a.heights == b.heights
    assert a.vals != c.vals
    # the same sizes whatever the seed
    assert [len(m) for _, _, m, _ in a.heights[0]["votes"][PREVOTE]] == \
        [len(m) for _, _, m, _ in c.heights[0]["votes"][PREVOTE]]
    assert [v[0] for v in a.heights[0]["votes"][PRECOMMIT]] == list(range(12))
    assert [v[2] for v in a.vals] == sorted(v[2] for v in a.vals)


@pytest.mark.parametrize("txs", [0, 20])
def test_chain_is_a_function_of_the_seed(txs):
    cfg = _cfg("fastsync64", validators=4, key_space=8)
    a, b = Chain(cfg, 2 ** 35, 5, txs), Chain(cfg, 2 ** 35, 5, txs)
    c = Chain(cfg, 2 ** 35 + 1, 5, txs)
    assert a.wire == b.wire and a.app_hash == b.app_hash
    assert a.wire != c.wire
    assert [len(w) for w in a.wire] == [len(w) for w in c.wire]


def test_a_chain_that_would_write_a_key_twice_is_refused():
    cfg = _cfg("fastsync64", validators=4, key_space=4)
    with pytest.raises(ValueError):
        Chain(cfg, 1, 5, 3)
