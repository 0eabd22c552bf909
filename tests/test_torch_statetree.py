"""The port's authenticated state tree (tendermint_tpu_torch/statetree/)
against the JAX package's (tests/test_statetree.py), on the CPU,
tolerance 0: roots, proofs, proof bytes, verdicts, exception classes and
messages.

- Each of the eleven scenarios of tests/test_statetree.py runs on both
  packages and their results are held equal: insertion-order
  independence, incremental commits against a rebuild under churn, the
  bit helpers, copy-on-write versions, empty and single-key trees, the
  forged-proof matrix, the codec's round trip and its refusals, the
  kvstore's tree backend (the JAX app under TM_TPU_STATE_TREE, the
  port's under TM_CUDA_STATE_TREE; both differ from the bucket backend),
  the snapshot stream and its restore, and a crash at each statetree.*
  fail point of a single-validator node.
- Proofs cross: the JAX verify accepts the port's proof bytes and the
  port's verify the JAX package's.
- sha256_many_host routes as the JAX function does: a device batch for
  >= 512 payloads of one length (here `device="cpu"`: the plain PyTorch
  SHA-256, the JAX side its jnp one), else the native batch, else
  hashlib; digests and merkle_sha_batches_total{impl} move alike.
"""

import copy
import hashlib
import os
import random

import numpy as np
import pytest

from tendermint_tpu import native as jnative
from tendermint_tpu import statetree as jst
from tendermint_tpu import telemetry as jtel
from tendermint_tpu.abci.apps import KVStoreApp as JKVStoreApp
from tendermint_tpu.ops import merkle as jmerkle
from tendermint_tpu.statetree import tree as jtree
from tendermint_tpu.utils import fail as jfail
from tendermint_tpu_torch import statetree as tst
from tendermint_tpu_torch import telemetry as ttel
from tendermint_tpu_torch.abci.apps import KVStoreApp as TKVStoreApp
from tendermint_tpu_torch.ops import merkle as tmerkle
from tendermint_tpu_torch.statetree import tree as ttree
from tendermint_tpu_torch.utils import fail as tfail
from test_torch_fail_points import JAX, PORT, _commit_to, _gen, _inject

SEED = 20261016


def jtree_of():
    return jst.StateTree()


def ttree_of(**kw):
    return tst.StateTree(device="cpu", **kw)


TREES = (("jax", jst, jtree_of), ("port", tst, ttree_of))


def _fill(tree, pairs):
    for k, v in pairs:
        tree.set(k, v)


def _pairs(n, tag=b"v"):
    return [(b"key/%d" % i, tag + b"%d" % i) for i in range(n)]


def _raised(fn):
    """(class name, message) of what fn raises, or None."""
    try:
        fn()
    except Exception as e:  # the verdicts compared across packages
        return type(e).__name__, str(e)
    return None


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("TM_TPU_STATE_TREE", "TM_CUDA_STATE_TREE"):
        monkeypatch.delenv(k, raising=False)
    yield
    for f in (jfail, tfail):
        f.clear_callback()
        f.set_target(None)
        f.disarm_all()
        f.reset()


# ------------------------------------------------------------ structure --

def test_root_is_insertion_order_independent():
    pairs = _pairs(400)
    shuffled = pairs[:]
    random.Random(13).shuffle(shuffled)
    roots = []
    for _, _, make in TREES:
        t1, t2 = make(), make()
        _fill(t1, pairs)
        _fill(t2, shuffled)
        r = t1.commit(1)
        assert r == t2.commit(1)
        roots.append(r)
    assert roots[0] == roots[1]


def test_incremental_equals_rebuild_under_churn():
    """Random set/update/delete churn over several commits lands on the
    root of a fresh tree over the surviving state, in both packages and
    equal between them at every version."""
    out = []
    for _, _, make in TREES:
        rng = random.Random(29)
        tree = make()
        model, roots = {}, []
        for version in range(1, 6):
            for _ in range(300):
                k = b"churn/%d" % rng.randrange(500)
                if rng.random() < 0.6 or k not in model:
                    v = b"val-%d" % rng.randrange(10 ** 6)
                    tree.set(k, v)
                    model[k] = v
                else:
                    assert tree.delete(k)
                    del model[k]
            root = tree.commit(version)
            rebuilt = make()
            _fill(rebuilt, sorted(model.items()))
            assert rebuilt.commit(1) == root
            assert len(tree) == len(model)
            roots.append(root)
        assert dict(tree.items_at(5)) == model
        out.append((roots, list(tree.items_at(5))))
    assert out[0] == out[1]


def test_bit_helpers():
    kh = bytes([0b10110000] + [0] * 31)
    other = bytes([0b10100000] + [0] * 31)
    rng = np.random.RandomState(SEED)
    pairs = [(rng.bytes(32), rng.bytes(32)) for _ in range(64)]
    for mod in (jtree, ttree):
        assert [mod._bit(kh, i) for i in range(4)] == [1, 0, 1, 1]
        assert mod._first_diff_bit(kh, other) == 3
        with pytest.raises(ValueError):
            mod._first_diff_bit(kh, kh)
    assert [ttree._first_diff_bit(a, b) for a, b in pairs] == \
        [jtree._first_diff_bit(a, b) for a, b in pairs]
    assert [ttree._bit(a, i) for a, _ in pairs for i in range(0, 256, 7)] \
        == [jtree._bit(a, i) for a, _ in pairs for i in range(0, 256, 7)]


def test_copy_on_write_versions_stay_provable():
    out = []
    for _, st, _ in TREES:
        make = (lambda: st.StateTree(retain=3)) if st is jst else \
            (lambda: st.StateTree(retain=3, device="cpu"))
        tree = make()
        _fill(tree, _pairs(50))
        r1 = tree.commit(1)
        tree.set(b"key/7", b"seven")
        tree.delete(b"key/9")
        r2 = tree.commit(2)
        # version 1 unchanged under the mutation: old value still proves
        v, p = tree.prove(b"key/7", 1)
        assert v == b"v7"
        st.verify(p, b"key/7", v, r1)
        v9, p9 = tree.prove(b"key/9", 1)
        st.verify(p9, b"key/9", v9, r1)
        # version 2 sees the new world
        v2, p2 = tree.prove(b"key/7", 2)
        assert v2 == b"seven"
        st.verify(p2, b"key/7", v2, r2)
        va, pa = tree.prove(b"key/9", 2)
        assert va is None and not pa.present
        st.verify(pa, b"key/9", None, r2)
        # retention: the registry keeps the newest `retain` versions
        tree.commit(3)
        tree.commit(4)
        err = _raised(lambda: tree.prove(b"key/7", 1))
        assert tree.store.versions() == [2, 3, 4]
        out.append((r1, r2, [st.proof_to_bytes(x) for x in (p, p9, p2, pa)],
                    err))
    assert out[0] == out[1]
    assert out[1][3][0] == "KeyError"


def test_empty_and_single_key_trees():
    out = []
    for _, st, make in TREES:
        tree = make()
        r0 = tree.commit(1)
        v, p = tree.prove(b"ghost", 1)
        assert v is None and p.n_keys == 0
        st.verify(p, b"ghost", None, r0)
        tree.set(b"only", b"one")
        r1 = tree.commit(2)
        assert r1 != r0
        v1, p1 = tree.prove(b"only", 2)
        assert v1 == b"one" and p1.steps == []
        st.verify(p1, b"only", v1, r1)
        va, pa = tree.prove(b"ghost", 2)
        assert not pa.present and pa.other_key_hash == \
            hashlib.sha256(b"only").digest()
        st.verify(pa, b"ghost", None, r1)
        # deleting the last key returns to the (size-bound) empty root
        assert tree.delete(b"only")
        assert tree.commit(3) == r0
        out.append((r0, r1, [st.proof_to_bytes(x) for x in (p, p1, pa)]))
    assert out[0] == out[1]


# --------------------------------------------------------------- proofs --

def _forgeries(good, value):
    def variant(mutate):
        p = copy.deepcopy(good)
        mutate(p)
        return p

    return {
        "tampered value": (good, b"evil-value"),
        "truncated path": (variant(
            lambda p: setattr(p, "steps", p.steps[:-1])), value),
        "extended path": (variant(
            lambda p: p.steps.append((255, b"\x11" * 32))), value),
        "sibling swap": (variant(
            lambda p: p.steps.__setitem__(
                0, (p.steps[0][0], b"\x22" * 32))), value),
        "step reorder": (variant(
            lambda p: setattr(p, "steps", list(reversed(p.steps)))),
            value),
        "wrong n_keys (root binding)": (variant(
            lambda p: setattr(p, "n_keys", p.n_keys + 1)), value),
        "absence claim for present key": (variant(
            lambda p: (setattr(p, "present", False),
                       setattr(p, "other_key_hash", b"\x01" * 32),
                       setattr(p, "other_value_hash", b"\x02" * 32))),
            None),
    }


def test_forged_proofs_raise():
    """The forgery matrix: every tampering of a valid proof raises
    ProofError, with the JAX package's message, in both packages."""
    out = []
    for _, st, make in TREES:
        tree = make()
        _fill(tree, _pairs(200))
        root = tree.commit(1)
        value, good = tree.prove(b"key/55", 1)
        st.verify(good, b"key/55", value, root)
        verdicts = {}
        for name, (proof, val) in _forgeries(good, value).items():
            with pytest.raises(st.ProofError) as e:
                st.verify(proof, b"key/55", val, root)
            verdicts[name] = str(e.value)
        with pytest.raises(st.ProofError) as e:
            st.verify(good, b"key/56", value, root)
        verdicts["wrong key"] = str(e.value)
        with pytest.raises(st.ProofError) as e:
            st.verify(good, b"key/55", value, b"\x00" * 32)
        verdicts["wrong root"] = str(e.value)
        _, absent = tree.prove(b"not-there", 1)
        bad = copy.deepcopy(absent)
        bad.other_key_hash = hashlib.sha256(b"not-there").digest()
        with pytest.raises(st.ProofError) as e:
            st.verify(bad, b"not-there", None, root)
        verdicts["own leaf"] = str(e.value)
        out.append((root, st.proof_to_bytes(good), verdicts))
    assert out[0] == out[1]


MALFORMED = (b"", b"not json", b"[]", b'{"n_keys": -1}',
             b'{"n_keys": 1, "key_hash": "zz"}',
             b'{"n_keys": 1, "key_hash": "ab", "steps": 3}',
             b'{"n_keys": 1, "key_hash": "' + b"ab" * 32 +
             b'", "steps": [[256, "' + b"ab" * 32 + b'"]]}',
             b'{"n_keys": true, "key_hash": "ab"}',
             b'{"n_keys": 1, "key_hash": "' + b"ab" * 32 +
             b'", "steps": [[1, 5]]}',
             b'\xff\xfe')


def test_codec_round_trip_and_malformed_rejection():
    out = []
    for _, st, make in TREES:
        tree = make()
        _fill(tree, _pairs(30))
        root = tree.commit(1)
        blobs = []
        for key in (b"key/3", b"nope"):
            value, proof = tree.prove(key, 1)
            raw = st.proof_to_bytes(proof)
            decoded = st.proof_from_bytes(raw)
            st.verify(decoded, key, value, root)
            assert st.proof_to_bytes(decoded) == raw
            assert st.proof_to_obj(st.proof_from_obj(
                st.proof_to_obj(proof))) == st.proof_to_obj(proof)
            blobs.append(raw)
        refusals = []
        for blob in MALFORMED:
            with pytest.raises(st.ProofError) as e:
                st.proof_from_bytes(blob)
            refusals.append(str(e.value))
        out.append((root, blobs, refusals))
    assert out[0] == out[1]


def test_proofs_cross_between_packages():
    """The JAX verify accepts the port's proof bytes and the reverse,
    for present and absent keys; a flipped value fails on both."""
    pairs = _pairs(120)
    jt, tt = jtree_of(), ttree_of()
    _fill(jt, pairs)
    _fill(tt, pairs)
    root = jt.commit(1)
    assert tt.commit(1) == root
    for key in (b"key/0", b"key/77", b"absent/1", b"absent/2"):
        jv, jp = jt.prove(key, 1)
        tv, tp = tt.prove(key, 1)
        assert jv == tv
        jraw, traw = jst.proof_to_bytes(jp), tst.proof_to_bytes(tp)
        assert jraw == traw
        jst.verify(jst.proof_from_bytes(traw), key, tv, root)
        tst.verify(tst.proof_from_bytes(jraw), key, jv, root)
        if jv is not None:
            bad = jv + b"!"
            assert _raised(lambda: jst.verify(
                jst.proof_from_bytes(traw), key, bad, root)) == _raised(
                lambda: tst.verify(tst.proof_from_bytes(jraw), key, bad,
                                   root))


# --------------------------------------------------- sha256_many_host --

def _payloads():
    """One set that hits every route: 600 seeded 65-byte payloads (the
    device route), 40 of mixed lengths (native or hashlib), 512 of two
    lengths (not one length: native or hashlib)."""
    rng = np.random.RandomState(SEED)
    same = [rng.bytes(65) for _ in range(600)]
    mixed = [rng.bytes(int(n)) for n in rng.randint(0, 200, 40)]
    two = [rng.bytes(65 if i % 2 else 64) for i in range(512)]
    return same, mixed, two


def _sha_counts(tel, labels=("device", "native", "host")):
    return {k: tel.value("merkle_sha_batches_total", {"impl": k}) or 0
            for k in labels}


@pytest.fixture
def both_registries_on():
    from tendermint_tpu.telemetry import registry as jreg
    from tendermint_tpu_torch.telemetry import registry as treg
    saved = [m._state.enabled for m in (jreg, treg)]
    jreg.set_enabled(True)
    treg.set_enabled(True)
    yield
    for m, on in zip((jreg, treg), saved):
        m._state.enabled = on


def test_sha256_many_host_routes_and_labels_match_jax(monkeypatch,
                                                      both_registries_on):
    same, mixed, two = _payloads()
    j0, t0 = _sha_counts(jtel), _sha_counts(ttel)
    got, want = [], []
    for batch in (same, mixed, two):
        want.append(jmerkle.sha256_many_host(batch))
        got.append(tmerkle.sha256_many_host(batch, device="cpu"))
    # the hashlib route: the JAX package's when its native library is
    # absent, the port's when the caller turns the native batch off
    monkeypatch.setattr(jnative, "sha256_batch", lambda items: None)
    for batch in (mixed, two):
        want.append(jmerkle.sha256_many_host(batch))
        got.append(tmerkle.sha256_many_host(batch, device="cpu",
                                            native_lib=False))
    assert got == want
    flat = [p for batch in (same, mixed, two, mixed, two) for p in batch]
    assert [d for out in got for d in out] == \
        [hashlib.sha256(p).digest() for p in flat]
    jd = {k: v - j0[k] for k, v in _sha_counts(jtel).items()}
    td = {k: v - t0[k] for k, v in _sha_counts(ttel).items()}
    assert td == jd == {"device": 1, "native": 2, "host": 2}
    assert tmerkle.sha256_many_host([], device="cpu") == []


def test_tree_waves_take_the_device_route_on_its_device(both_registries_on):
    """A commit of 700 fresh keys hashes its leaf wave (700 payloads of
    65 bytes) on the tree's device; the root is the JAX tree's."""
    pairs = [(b"wave/%d" % i, b"%08d" % i) for i in range(700)]
    t0 = _sha_counts(ttel)
    tt, jt = ttree_of(), jtree_of()
    _fill(tt, pairs)
    _fill(jt, pairs)
    assert tt.commit(1) == jt.commit(1)
    d = {k: v - t0[k] for k, v in _sha_counts(ttel).items()}
    assert d["device"] >= 2 and d["host"] == 0   # values and leaves
    hashlib_tree = ttree_of(native_lib=False)
    _fill(hashlib_tree, pairs)
    assert hashlib_tree.commit(1) == jt.commit(2)


# -------------------------------------------------------- app backend --

def test_kvstore_tree_backend_proves_and_ab_hashes_diverge(monkeypatch):
    out = []
    for name, st, app_of in (
            ("jax", jst, lambda: JKVStoreApp()),
            ("port", tst, lambda: TKVStoreApp(device="cpu"))):
        monkeypatch.setenv("TM_TPU_STATE_TREE" if name == "jax"
                           else "TM_CUDA_STATE_TREE", "on")
        app = app_of()
        assert app._tree is not None and app._kvmod is None
        for i in range(40):
            app.deliver_tx(b"ab/%d=w%d" % (i, i))
        r1 = app.commit()
        app.deliver_tx(b"ab/7=updated")
        r2 = app.commit()
        res = app.query("", b"ab/7", 0, True)
        assert res.value == b"updated" and res.height == 2
        st.verify(st.proof_from_bytes(res.proof), b"ab/7", res.value, r2)
        # the previous version still proves (the header-binding seam)
        res1 = app.query("", b"ab/7", 1, True)
        assert res1.value == b"w7"
        st.verify(st.proof_from_bytes(res1.proof), b"ab/7", res1.value, r1)
        resa = app.query("", b"ab/404", 0, True)
        pf = st.proof_from_bytes(resa.proof)
        assert not pf.present and resa.value == b""
        st.verify(pf, b"ab/404", None, r2)
        # the unproven query shape is untouched
        resu = app.query("", b"ab/7", 0, False)
        assert resu.value == b"updated" and resu.proof == b""
        # an unretained version is a soft error, not a crash
        for _ in range(12):
            app.commit()
        soft = app.query("", b"ab/7", 1, True)
        assert soft.code == 1
        monkeypatch.delenv("TM_TPU_STATE_TREE", raising=False)
        monkeypatch.delenv("TM_CUDA_STATE_TREE", raising=False)
        # A/B: the bucket backend over the same txs hashes differently
        bucket = app_of()
        assert bucket._tree is None
        for i in range(40):
            bucket.deliver_tx(b"ab/%d=w%d" % (i, i))
        rb = bucket.commit()
        assert rb != r1
        assert bucket.query("", b"ab/7", 0, True).proof == b""
        out.append((r1, r2, [(r.code, r.key, r.value, r.proof, r.height,
                              r.log) for r in (res, res1, resa, resu, soft)],
                    rb, app.info().data))
    assert out[0] == out[1]


def test_state_tree_knob_is_the_port_own(monkeypatch):
    """TM_TPU_STATE_TREE changes nothing in the port; TM_CUDA_STATE_TREE
    turns the JAX package's tree on nowhere."""
    monkeypatch.setenv("TM_TPU_STATE_TREE", "on")
    assert TKVStoreApp(device="cpu")._tree is None
    monkeypatch.delenv("TM_TPU_STATE_TREE")
    monkeypatch.setenv("TM_CUDA_STATE_TREE", "on")
    assert JKVStoreApp()._tree is None
    assert TKVStoreApp(device="cpu")._tree.device.type == "cpu"


def test_kvstore_tree_snapshot_streams_and_restores(monkeypatch):
    out = []
    for name, st, app_of in (
            ("jax", jst, lambda: JKVStoreApp()),
            ("port", tst, lambda: TKVStoreApp(device="cpu"))):
        monkeypatch.setenv("TM_TPU_STATE_TREE" if name == "jax"
                           else "TM_CUDA_STATE_TREE", "on")
        app = app_of()
        for i in range(60):
            app.deliver_tx(b"sn/%d=p%d" % (i, i))
        r1 = app.commit()
        items = app.snapshot_items()
        # streamed, not materialized: a generator over tree nodes
        assert not isinstance(items, (list, tuple))
        consumed = []
        it = iter(items)
        for _ in range(10):
            consumed.append(next(it))
        # copy-on-write keeps the in-flight stream consistent across a
        # later commit that mutates half the state
        for i in range(0, 60, 2):
            app.deliver_tx(b"sn/%d=MUT" % i)
        r_mut = app.commit()
        consumed.extend(it)
        assert dict(consumed) == {b"sn/%d" % i: b"p%d" % i
                                  for i in range(60)}
        # the restore replays into a fresh tree and lands on r1 exactly
        app2 = app_of()
        assert app2.restore_items(consumed, 1, None) == r1
        assert app2.height == 1
        v, p = app2._tree.prove(b"sn/5", 1)
        st.verify(p, b"sn/5", v, r1)
        out.append((r1, r_mut, consumed, st.proof_to_bytes(p)))
        monkeypatch.delenv("TM_TPU_STATE_TREE", raising=False)
        monkeypatch.delenv("TM_CUDA_STATE_TREE", raising=False)
    assert out[0] == out[1]


# ------------------------------------------------- crash-recovery sweep --

class _Crash(BaseException):
    """A simulated process death at a fail point (BaseException: nothing
    between the fail point and the test may swallow it)."""


STATETREE_POINTS = ("statetree.before_root_flush",
                    "statetree.after_node_write")
WAVE_A = [b"st/a%d=v%d" % (i, i) for i in range(1, 4)]
WAVE_B = [b"st/b%d=w%d" % (i, i) for i in range(1, 4)]


def _tree_node(P, home, gen, key):
    pv_path = os.path.join(home, "priv_validator.json")
    if os.path.exists(pv_path):
        pv = P.pv.PrivValidatorFile.load(pv_path)
    else:
        pv = P.pv.PrivValidatorFile(pv_path, key)
        pv._persist()
    cfg = P.config.test_config(home)
    if P is PORT:
        cfg.base.verifier_backend = "python"
        app = P.app(device="cpu")
    else:
        app = P.app()
    node = P.node.Node(cfg, gen, priv_validator=pv, app=app)
    node.consensus.ticker.stop()
    node.consensus.ticker = P.ticker(node.consensus._on_timeout_fire)
    return node


def _sweep(P, root, monkeypatch):
    """The control's app hash, then for each statetree point: the crashed
    node's height, and the recovered node's app hash and proof bytes."""
    from tendermint_tpu_torch import pipeline as tpipeline
    monkeypatch.setattr(tpipeline, "_configured", "auto")
    monkeypatch.setenv("TM_TPU_STATE_TREE" if P is JAX
                       else "TM_CUDA_STATE_TREE", "on")
    st = jst if P is JAX else tst
    target = 3
    gen, key = _gen(P, "st-sweep")
    control = _tree_node(P, os.path.join(root, "control"), gen, key)
    control.start()
    _inject(control, WAVE_A)
    _commit_to(control, 1)
    _inject(control, WAVE_B)
    _commit_to(control, target)
    control_hash = control.consensus.state.app_hash
    control.stop()
    assert control_hash
    rows = []
    for point in STATETREE_POINTS:
        home = os.path.join(root, point.replace(".", "_"))
        node = _tree_node(P, home, gen, key)
        node.start()
        _inject(node, WAVE_A)
        _commit_to(node, 1)

        def crash(name):
            raise _Crash(name)

        P.fail.arm(point, crash)
        with pytest.raises(_Crash):
            _inject(node, WAVE_B)
            _commit_to(node, target)
        P.fail.disarm_all()
        crashed_at = node.height
        node.consensus._stopped = True
        try:
            node.stop()
        except Exception:  # a crashed node's stop may fail; the files stay
            pass
        node2 = _tree_node(P, home, gen, key)   # the handshake's replay
        node2.start()                           # the WAL catchup
        assert node2.height >= crashed_at
        _inject(node2, WAVE_B)
        _commit_to(node2, target)
        assert node2.consensus.state.app_hash == control_hash, point
        # the replayed tree still serves verifiable proofs
        res = node2.app.query("", b"st/a1", 0, True)
        st.verify(st.proof_from_bytes(res.proof), b"st/a1", res.value,
                  node2.app.app_hash)
        rows.append((point, crashed_at, node2.consensus.state.app_hash,
                     res.proof))
        node2.stop()
    monkeypatch.delenv("TM_TPU_STATE_TREE", raising=False)
    monkeypatch.delenv("TM_CUDA_STATE_TREE", raising=False)
    return control_hash, rows


def test_crash_at_statetree_points_recovers_control_root(tmp_path,
                                                         monkeypatch):
    """Kill a tree-backed node at each statetree fail point mid-commit:
    the handshake replay and the WAL catchup rebuild the control's root,
    and the recovered tree still proves; the port's sweep equals the JAX
    package's, point for point."""
    jax = _sweep(JAX, str(tmp_path / "jax"), monkeypatch)
    port = _sweep(PORT, str(tmp_path / "port"), monkeypatch)
    assert port == jax
