"""The port's canonical JSON (types/encoding.cdumps on the native codec,
csrc/codec.cpp) against its own specification path (`_pure_cdumps`) and
the JAX package's `cdumps` (its native codec), on the CPU, tolerance 0:
equal bytes, or equal exception classes, on a few thousand seeded random
objects (nested dicts, lists and tuples; bytes; big and negative ints;
bool and None; strings with NUL, controls, quotes, backslashes,
non-ASCII and astral characters and a lone surrogate; a non-str dict
key; a float; an object with to_obj). The codec's Fallback shapes are
counted by `encoding.stats()`.
"""

import random

import pytest

from tendermint_tpu.types import encoding as jenc
from tendermint_tpu_torch import native
from tendermint_tpu_torch.types import encoding

CHARS = ["a", "Z", "0", " ", "\x00", "\x01", "\x1f", "\x7f", '"', "\\",
         "/", "\n", "\t", "\r", "\b", "\f", "é", "ß", "€", "中", "😀",
         "\U0010ffff", " ", "﻿"]


class _ToObj:
    def __init__(self, obj):
        self.obj = obj

    def to_obj(self):
        return self.obj


def _string(rng: random.Random) -> str:
    s = "".join(rng.choice(CHARS) for _ in range(rng.randint(0, 12)))
    if rng.random() < 0.02:
        s += "\ud800"  # a lone surrogate: the codec refuses it
    return s


def _int(rng: random.Random) -> int:
    return rng.choice([0, 1, -1, 2 ** 31, -2 ** 63, 2 ** 64 + 5,
                       10 ** 30, -(10 ** 25), rng.randint(-1000, 1000)])


def _obj(rng: random.Random, depth: int = 0):
    r = rng.random()
    if depth < 4 and r < 0.25:
        d = {}
        for _ in range(rng.randint(0, 5)):
            key = _string(rng)
            if rng.random() < 0.03:
                key = rng.randint(0, 9)   # a non-str key: Fallback
            d[key] = _obj(rng, depth + 1)
        return d
    if depth < 4 and r < 0.40:
        seq = [_obj(rng, depth + 1) for _ in range(rng.randint(0, 5))]
        return tuple(seq) if rng.random() < 0.3 else seq
    if depth < 4 and r < 0.43:
        return _ToObj(_obj(rng, depth + 1))
    if r < 0.58:
        return _string(rng)
    if r < 0.70:
        return _int(rng)
    if r < 0.80:
        return rng.randbytes(rng.randint(0, 40))
    if r < 0.85:
        return bytearray(rng.randbytes(rng.randint(0, 8)))
    if r < 0.93:
        return rng.choice([True, False, None])
    if r < 0.935:
        return 1.5   # floats are refused on every path
    return _string(rng)


def _outcome(fn, obj):
    try:
        return fn(obj)
    except Exception as e:   # compared by class
        return type(e)


@pytest.mark.parametrize("seed", range(4))
def test_random_objects_match_spec_and_jax(seed):
    rng = random.Random(20261017 + seed)
    codec = native.codec()
    fallbacks = 0
    before = encoding.stats()
    for _ in range(1000):
        obj = _obj(rng)
        got = _outcome(encoding.cdumps, obj)
        assert got == _outcome(encoding._pure_cdumps, obj), obj
        assert got == _outcome(jenc.cdumps, obj), obj
        try:
            codec.canonical_dumps(obj)
        except codec.Fallback:
            fallbacks += 1
        except Exception:
            pass
    after = encoding.stats()
    assert after["fallback"] - before["fallback"] == fallbacks
    assert after["native"] - before["native"] > 900 - fallbacks
    assert fallbacks > 0


@pytest.mark.parametrize("obj,why", [
    ({1: "a"}, "non-str dict key"),
    ("\udc80", "lone surrogate"),
    ({"k": "x\ud800y"}, "lone surrogate in a value"),
])
def test_fallback_shapes_take_the_spec_and_are_counted(obj, why):
    before = encoding.stats()
    got = _outcome(encoding.cdumps, obj)
    assert got == _outcome(encoding._pure_cdumps, obj) == \
        _outcome(jenc.cdumps, obj), why
    after = encoding.stats()
    assert after["fallback"] == before["fallback"] + 1, why


def test_refusals_match_the_spec():
    for obj in (1.5, {"a": [2.0]}, _ToObj(0.1)):
        assert _outcome(encoding.cdumps, obj) is TypeError
        assert _outcome(jenc.cdumps, obj) is TypeError


def test_a_results_object_matches_the_spec():
    """A block's responses object of 5,000 per-tx results, the shape the
    apply path persists, in one call."""
    res = {"deliver_txs": [
        {"code": 0, "data": "", "log": "",
         "tags": {"app.key": f"key{i:05d}"}} for i in range(5000)],
        "end_block": {"validator_updates": [], "tags": {},
                      "consensus_param_updates": None}}
    want = encoding._pure_cdumps(res)
    assert encoding.cdumps(res) == want == jenc.cdumps(res)
    assert encoding.chash(res) == jenc.chash(res)
