"""The port's dispatch coalescer (models/coalescer.py) and the coalescing
BatchVerifier against the JAX package's, on the CPU, tolerance 0
(verdicts and dispatch sizes equal, exceptions of the same class).

- The scenarios of tests/test_coalescer.py on the same items through both
  packages' DispatchCoalescer: merge while a dispatch is held busy (the
  second dispatch merges every call queued meanwhile, each caller gets
  its own slice), error isolation (one poisoned call raises its own
  TypeError, every other caller gets verdicts), close drains the queue
  and refuses later submits.
- A VerifierError of a merged dispatch (its launch or its wait) reaches
  every caller of the merge, in both packages' coalescers; nothing is
  retried off the device path.
- BatchVerifier: threaded single-vote callers with mixed ed25519 /
  secp256k1 keys and forged signatures get their own verdicts through a
  coalescing verifier of each package (the port's on "auto", "python"
  and "cuda" on the CPU), the stats account for every submission
  (calls = direct calls + merged dispatches + the calls the fallbacks
  re-dispatched, and the calls of the merges sum to the submissions),
  and coalesce "off" builds no coalescer and gives the direct path's
  verdicts byte for byte. Bad settings raise as the JAX verifier's do.
"""

import threading

import numpy as np
import pytest

from tendermint_tpu.models.coalescer import DispatchCoalescer as JCoalescer
from tendermint_tpu.models.verifier import BatchVerifier as JVerifier
from tendermint_tpu.utils import ed25519_ref as ref
from tendermint_tpu_torch.models import verifier as tverifier
from tendermint_tpu_torch.models.coalescer import \
    DispatchCoalescer as TCoalescer

COALESCERS = {"port": TCoalescer, "jax": JCoalescer}
WAIT_S = 10.0


def _ed_item(i: int, valid: bool = True, msg: bytes = None):
    seed = (i + 1).to_bytes(32, "little")
    m = msg if msg is not None else b"coalesce-vote-%d" % i
    sig = ref.sign(seed, m) if valid else bytes(64)
    return (ref.public_key(seed), m, sig)


def _secp_item(i: int, valid: bool = True):
    from tendermint_tpu_torch.types.keys import Secp256k1PrivKey
    k = Secp256k1PrivKey.generate((0x5EC0 + i).to_bytes(32, "big"))
    m = b"coalesce-secp-%d" % i
    sig = k.sign(m) if valid else b"\x30\x06\x02\x01\x01\x02\x01\x01"
    return (k.pubkey.secp256k1, m, sig)


def _gated(fn_verdicts, raise_for=None):
    """A dispatch whose first call holds on a gate; -> (dispatch, entered,
    gate, sizes)."""
    entered, gate, sizes = threading.Event(), threading.Event(), []

    def dispatch(items):
        sizes.append(len(items))
        if len(sizes) == 1:
            entered.set()
            assert gate.wait(WAIT_S)
        if raise_for is not None:
            raise_for(items)
        arr = fn_verdicts(items)
        return lambda: arr
    return dispatch, entered, gate, sizes


def _merge_while_busy(cls):
    dispatch, entered, gate, sizes = _gated(
        lambda items: np.array([x % 2 == 0 for x in items], np.bool_))
    c = cls(dispatch, max_batch=4096, max_wait_s=0.002)
    try:
        r0 = c.submit([0])
        assert entered.wait(WAIT_S)
        rs = [c.submit([i, i + 1]) for i in range(1, 21, 2)]
        gate.set()
        out = [r0().tolist()] + [r().tolist() for r in rs]
        return out, list(sizes)
    finally:
        c.close()


def test_merge_while_busy_matches_jax():
    port, jax = (_merge_while_busy(COALESCERS[k]) for k in ("port", "jax"))
    assert port == jax
    out, sizes = port
    assert sizes == [1, 20]     # 10 calls x 2 items in ONE dispatch
    assert out[0] == [True]
    for i, got in zip(range(1, 21, 2), out[1:]):
        assert got == [i % 2 == 0, (i + 1) % 2 == 0]


def _error_isolation(cls):
    def poison(items):
        if any(not isinstance(x, int) for x in items):
            raise TypeError("bad item")
    dispatch, entered, gate, sizes = _gated(
        lambda items: np.ones(len(items), np.bool_), raise_for=poison)
    c = cls(dispatch, max_batch=4096, max_wait_s=0.002)
    try:
        r0 = c.submit([1])
        assert entered.wait(WAIT_S)
        good = [c.submit([i]) for i in range(4)]
        bad = c.submit(["poison"])
        good2 = [c.submit([i]) for i in range(4)]
        gate.set()
        out = [r0().tolist()] + [r().tolist() for r in good + good2]
        with pytest.raises(TypeError) as e:
            bad()
        return out, str(e.value), list(sizes)
    finally:
        c.close()


def test_error_isolation_matches_jax():
    port, jax = (_error_isolation(COALESCERS[k]) for k in ("port", "jax"))
    assert port == jax
    out, err, sizes = port
    assert out == [[True]] * 9 and err == "bad item"
    # the merge of 9, then each of its calls alone
    assert sizes == [1, 9] + [1] * 9


def test_port_stats_count_merges_and_fallbacks():
    dispatch, entered, gate, _ = _gated(
        lambda items: np.ones(len(items), np.bool_),
        raise_for=lambda items: None)
    c = TCoalescer(dispatch, max_batch=4096, max_wait_s=0.002)
    try:
        r0 = c.submit([1])
        assert entered.wait(WAIT_S)
        rs = [c.submit([i, i]) for i in range(6)]
        gate.set()
        assert all(r().all() for r in [r0] + rs)
        st = c.snapshot()
        assert st["submissions"] == st["merged_calls"] == 7
        assert st["dispatches"] == 2 and st["calls_max"] == 6
        assert st["items_max"] == 12
        assert st["fallbacks"] == st["isolated_calls"] == 0
        assert st["queue_max"] >= 1
    finally:
        c.close()


def _close_drains(cls):
    def dispatch(items):
        arr = np.ones(len(items), np.bool_)
        return lambda: arr
    c = cls(dispatch, max_batch=64, max_wait_s=0.001)
    rs = [c.submit([i]) for i in range(5)]
    c.close()
    out = [r().tolist() for r in rs]
    with pytest.raises(RuntimeError) as e:
        c.submit([1])
    return out, str(e.value)


def test_close_drains_queue_matches_jax():
    port, jax = (_close_drains(COALESCERS[k]) for k in ("port", "jax"))
    assert port == jax == ([[True]] * 5, "coalescer is closed")


@pytest.mark.parametrize("where", ["launch", "wait"])
@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_device_error_of_a_merge_reaches_every_caller(pkg, where):
    """A merged dispatch whose launch (or wait) fails with VerifierError:
    the isolation re-runs each call on the same failing path, so every
    caller of the merge sees VerifierError."""
    err = tverifier.VerifierError

    def fail(items):
        if where == "launch":
            raise err("verify dispatch failed on cuda:0: 719")

        def resolve():
            raise err("verify failed on cuda:0: illegal memory access")
        return resolve
    dispatch, entered, gate, sizes = _gated(lambda items: None)

    def gated_fail(items):
        dispatch(items)
        return fail(items)
    c = COALESCERS[pkg](gated_fail, max_batch=4096, max_wait_s=0.002)
    try:
        r0 = c.submit([0])
        assert entered.wait(WAIT_S)
        rs = [c.submit([i]) for i in range(1, 6)]
        gate.set()
        for r in [r0] + rs:
            with pytest.raises(err):
                r()
        # r0's dispatch and the merge of the other 5, each followed by
        # one re-run a call on the same dispatch
        assert sorted(sizes) == [1] * 7 + [5]
    finally:
        c.close()


CASES = [(_ed_item(0), True), (_ed_item(1, valid=False), False),
         (_secp_item(0), True), (_ed_item(2), True),
         (_secp_item(1, valid=False), False),
         (_ed_item(3, msg=b"other"), True), (_ed_item(4, valid=False), False),
         (_ed_item(5), True)]


def _threaded_callers(v):
    results = {}

    def worker(i):
        item, want = CASES[i % len(CASES)]
        results[i] = ([bool(v.verify([item])[0]) for _ in range(3)], want)

    ths = [threading.Thread(target=worker, args=(i,))
           for i in range(len(CASES) * 2)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(60)
    return results


@pytest.mark.parametrize("backend", ["auto", "python", "cuda"])
def test_threaded_single_vote_callers_get_their_own_verdicts(backend):
    kw = {"device": "cpu"} if backend != "python" else {}
    t = tverifier.BatchVerifier(backend, coalesce="on",
                                coalesce_wait_ms=4.0, **kw)
    j = JVerifier("python" if backend == "python" else "auto",
                  coalesce="on", coalesce_wait_ms=4.0)
    try:
        got = _threaded_callers(t)
        want = _threaded_callers(j)
        assert got == want
        assert len(got) == len(CASES) * 2
        for i, (verdicts, expect) in got.items():
            assert verdicts == [expect] * 3, i
        st, cs = dict(t.stats), t.coalescer_stats()
        n = len(CASES) * 2 * 3
        assert st["coalesced_calls"] == cs["submissions"] == n
        assert st["direct_calls"] == 0
        assert cs["merged_calls"] == n
        assert st["calls"] == (st["direct_calls"] + cs["dispatches"]
                               + cs["isolated_calls"])
        assert st["coalesced_dispatches"] == (cs["dispatches"]
                                              + cs["isolated_calls"])
        assert st["sigs"] == n == j.stats["sigs"]
        assert 1 <= cs["dispatches"] <= n and cs["calls_max"] >= 1
        assert st["wait_s"] > 0 and st["loop_waits"] == 0
    finally:
        t.close()
        j.close()


def test_coalesce_off_is_the_direct_path():
    items = [_ed_item(0), _ed_item(1, valid=False), _secp_item(0)]
    off = tverifier.BatchVerifier("auto", device="cpu", coalesce="off")
    on = tverifier.BatchVerifier("auto", device="cpu")
    try:
        out_off = off.verify(items)
        assert off._coalescer is None
        assert off.stats["coalesced_calls"] == 0
        assert off.stats["direct_calls"] == off.stats["calls"] == 1
        assert on.coalesce == "auto"
        out_on = on.verify(items)
        assert on._coalescer is not None
        assert on.stats["coalesced_calls"] == 1
        assert out_off.dtype == out_on.dtype
        assert out_off.tobytes() == out_on.tobytes()
        assert out_off.tolist() == [True, False, True]
        # above the threshold: direct, whatever the setting
        big = [_ed_item(i % 3) for i in range(on.auto_threshold + 1)]
        on.verify(big)
        assert on.stats["direct_calls"] == 1
    finally:
        off.close()
        on.close()
    assert tverifier.default_verifier.__doc__
    for bad in ("sometimes", "maybe"):
        with pytest.raises(ValueError) as te:
            tverifier.BatchVerifier("python", coalesce=bad)
        with pytest.raises(ValueError) as je:
            JVerifier("python", coalesce=bad)
        assert str(te.value) == str(je.value)
