"""TM_CUDA_NO_NATIVE: the operator's choice of the port's pure host
routes (the counterpart of the JAX package's TM_TPU_NO_NATIVE), on the
CPU, tolerance 0.

- With the knob set, the codec, the kv core, verify prep, the two sign
  phases, SHA-256 and the Merkle roots and proofs, the part-set build,
  the front door's writes and the frame AEAD take their pure routes,
  counted where the route has a count, and give the bytes the native
  routes give (and the JAX package's, where a JAX function is on hand).
- A native function called with the knob set raises NativeDisabled from
  its loader, naming it: a caller without a pure route fails at its
  first use. The knob is read once a process.
- TM_TPU_NO_NATIVE changes nothing in the port.
"""

import hashlib

import numpy as np
import pytest

from tendermint_tpu.types import encoding as jenc
from tendermint_tpu_torch import native
from tendermint_tpu_torch.abci.apps import kvstore
from tendermint_tpu_torch.ops import ed25519, merkle
from tendermint_tpu_torch.p2p.conn import secret as tsecret
from tendermint_tpu_torch.types import encoding
from tendermint_tpu_torch.types.part_set import PartSet, build_stats


@pytest.fixture
def no_native(monkeypatch):
    """(on, off): set or unset TM_CUDA_NO_NATIVE, as a process started
    with or without it reads it (`native.disabled()` reads it once a
    process)."""
    monkeypatch.delenv("TM_TPU_NO_NATIVE", raising=False)

    def on():
        monkeypatch.setenv("TM_CUDA_NO_NATIVE", "1")
        monkeypatch.setattr(native, "_no_native", None)

    def off():
        monkeypatch.delenv("TM_CUDA_NO_NATIVE", raising=False)
        monkeypatch.setattr(native, "_no_native", None)
    off()
    return on, off


def _items(n, seed=3):
    from tendermint_tpu_torch.types.keys import PrivKey
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        key = PrivKey.generate(rng.bytes(32))
        msg = rng.bytes(int(rng.randint(0, 90)))
        sig = key.sign(msg)
        if i % 5 == 1:
            sig = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
        out.append((key.pubkey.ed25519, msg, sig))
    return out


def test_tm_tpu_no_native_changes_nothing(monkeypatch, no_native):
    monkeypatch.setenv("TM_TPU_NO_NATIVE", "1")
    assert not native.disabled()
    assert native.codec() is not None
    monkeypatch.setenv("TM_CUDA_NO_NATIVE", "0")   # set means on
    assert not native.disabled()   # read once a process
    monkeypatch.setattr(native, "_no_native", None)
    assert native.disabled()


def test_codec_takes_the_specification_path(no_native):
    on, off = no_native
    objs = [{"b": b"\x01\xff", "a": [1, None, "xé"]}, [], {"k": -3}]
    want = [encoding.cdumps(o) for o in objs]
    on()
    before = encoding.stats()
    got = [encoding.cdumps(o) for o in objs]
    after = encoding.stats()
    assert got == want == [jenc.cdumps(o) for o in objs]
    assert after["pure"] - before["pure"] == len(objs)
    assert after["native"] == before["native"]


def test_kvstore_takes_the_pure_route_with_the_same_hashes(no_native):
    on, off = no_native
    txs = [b"k%d=v%d" % (i, i) for i in range(40)] + [b"plain"]

    def run():
        app = kvstore.KVStoreApp()
        hashes = []
        for h in range(1, 4):
            app.begin_block(b"", {"height": h})
            for tx in txs[h::3]:
                app.deliver_tx(tx)
            app.end_block(h)
            hashes.append(app.commit())
        return app._kvmod is None, hashes

    native_mod, want = run()
    on()
    pure, got = run()
    assert not native_mod and pure
    assert got == want


def test_prep_and_sign_phases_take_hashlib(no_native):
    on, off = no_native
    items = _items(12)
    pk, msgs, sigs = ([it[i] for it in items] for i in range(3))
    want = ed25519.prepare_batch_bytes(pk, msgs, sigs)
    prefixes = b"".join(hashlib.sha512(it[0]).digest()[32:]
                        for it in items)
    want1 = ed25519.sign_phase1(prefixes, msgs)
    on()
    assert ed25519.prep_items(items) is None
    before = ed25519.prep_stats()
    got = ed25519.prepare_batch_bytes(pk, msgs, sigs)
    assert ed25519.prep_stats()["plain"] - before["plain"] == len(items)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    assert ed25519.sign_phase1(prefixes, msgs) == want1
    r_enc = b"".join(it[2][:32] for it in items)
    rs = want1
    a_cat = bytes(32 * len(items))
    pk_cat = b"".join(pk)
    got2 = ed25519.sign_phase2(r_enc, pk_cat, msgs, rs, a_cat)
    off()
    assert got2 == ed25519.sign_phase2(r_enc, pk_cat, msgs, rs, a_cat)


@pytest.mark.parametrize("n", [0, 1, 7, 64])
def test_merkle_and_part_sets_take_hashlib(no_native, n):
    on, off = no_native
    items = [b"leaf-%d" % i * (i % 3 + 1) for i in range(n)]
    digests = [merkle.leaf_hash(it) for it in items]
    data = bytes(range(256)) * (n + 1)

    def run():
        out = [merkle.root_host(items),
               merkle.root_from_digests_host(digests),
               merkle.root_from_digests_host(b"".join(digests)),
               merkle.tree_proofs_host(items),
               merkle.sha256_many_host(items)]
        if n:
            out.append(merkle.proof_host(items, n - 1))
        ps = PartSet.from_data(data, 100)
        out.append((ps.root, [p.proof for p in ps.parts]))
        return out

    want = run()
    on()
    before = build_stats()
    assert run() == want
    assert build_stats()["python"] == before["python"] + 1


def test_secret_connection_seals_frame_by_frame(monkeypatch, no_native):
    """Under the knob a burst link seals and opens each frame alone (the
    per-frame AEAD), and its wire bytes equal the JAX burst link's."""
    from test_torch_loop import _wire
    on, off = no_native
    on()
    before = tsecret.frame_stats.snapshot()
    port = _wire("port-loop", monkeypatch, True, 5)
    after = tsecret.frame_stats.snapshot()
    off()
    jax = _wire("jax-loop", monkeypatch, True, 5)
    assert port == jax
    assert after["sealed_burst"] == before["sealed_burst"]
    assert after["sealed_frame"] > before["sealed_frame"]


def test_front_door_writes_in_python_with_the_jax_answers(monkeypatch,
                                                          no_native):
    """Native, the front door writes each loop tick through tm_sendmany;
    under the knob it writes in Python, and every answer is still the
    JAX front door's."""
    from test_torch_aserver import CLIENTS, Served, _run_clients
    on, off = no_native
    real = native.hostops_lib
    calls = []

    def counted(*a, **k):
        calls.append(a)
        return real(*a, **k)
    monkeypatch.setattr(native, "hostops_lib", counted)
    results, writes = {}, {}
    for name, knob in (("port", False), ("port", True), ("jax", False)):
        if knob:
            on()
        sv = Served(name)
        del calls[:]
        try:
            port = sv.serve()
            results[(name, knob)] = {c: _run_clients(CLIENTS[c], port)
                                     for c in CLIENTS}
        finally:
            sv.stop()
            off()
        writes[(name, knob)] = len(calls)
    assert results[("port", True)] == results[("port", False)] == \
        results[("jax", False)]
    assert writes[("port", False)] > 0 and writes[("port", True)] == 0


@pytest.mark.parametrize("fn,args,loader", [
    ("sha512_impl", (), "module"), ("codec", (), "codec"), ("kv", (), "kv"),
    ("module", (), "module"), ("lib", (), "lib"),
    ("hostops_lib", (), "hostops_lib"), ("aead_lib", (), "aead_lib"),
    ("merkle_root", ([b"a"],), "hostops_lib"),
    ("sign_phase1", (b"", []), "module")])
def test_a_native_function_raises_naming_itself(no_native, fn, args, loader):
    """A native function raises at its first use, from its loader, which
    the message names."""
    on, off = no_native
    on()
    with pytest.raises(native.NativeDisabled, match=f"native.{loader}: "):
        getattr(native, fn)(*args)
