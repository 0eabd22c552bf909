"""The port's native host prep (csrc/prep.cpp, csrc/ed25519_host.h,
`tendermint_tpu_torch.native`) against the JAX package's native functions
and against the port's own hashlib versions, byte for byte (tolerance 0):

- prep_items on seeded batches with the edge items of the JAX package's
  own prep test (short pk, short sig, s = L, a 700-byte message, a key
  that is not a point), and the batches it declines (a secp256k1 key, a
  bytearray member, a 2-tuple); the empty batch;
- tm_ed25519_prepare, and prepare_batch_bytes on its native and its
  hashlib route (prep_stats() says which ran);
- sign_phase1 / sign_phase2, empty and 1000-byte messages included, and
  their ValueError / TypeError refusals, word for word;
- BatchVerifier's prep on the native route;
- a failed build raises with the compiler's output.
"""

import hashlib
import sysconfig

import numpy as np
import pytest
import torch

from tendermint_tpu import native as jnative
from tendermint_tpu.ops import ed25519 as jed
from tendermint_tpu_torch import native
from tendermint_tpu_torch.models.verifier import BatchVerifier as TVerifier
from tendermint_tpu_torch.ops import _build
from tendermint_tpu_torch.ops import ed25519 as ted
from tendermint_tpu_torch.utils import ed25519_fast
from tendermint_tpu_torch.utils import ed25519_ref as ref

torch.set_num_threads(1)


def _items(n, seed):
    """n signed items over seeded keys and messages (0-399 bytes), with
    the edge items at fixed positions when the batch is long enough."""
    rng = np.random.RandomState(seed)
    keys = []
    for _ in range(8):
        a, prefix = ref.secret_expand(rng.bytes(32))
        keys.append((a, prefix, ref.point_compress(ed25519_fast._mul_base(a))))
    items = []
    for i in range(n):
        a, prefix, pk = keys[i % 8]
        m = rng.bytes(int(rng.randint(0, 400)))
        items.append((pk, m, ed25519_fast.sign_expanded(a, prefix, pk, m)))
    edges = {
        5: lambda it: (it[0][:31], it[1], it[2]),                 # short pk
        7: lambda it: (it[0], it[1], it[2][:63]),                 # short sig
        9: lambda it: (it[0], it[1],                              # s = L
                       it[2][:32] + ref.L.to_bytes(32, "little")),
        11: lambda it: (it[0], b"\x55" * 700, it[2]),             # long msg
        13: lambda it: (b"\x00" * 32, it[1], it[2]),              # not a point
    }
    for i, f in edges.items():
        if i < n:
            items[i] = f(items[i])
    return items


def _cols(items):
    return ([it[0] for it in items], [it[1] for it in items],
            [it[2] for it in items])


def _assert_equal(got, want):
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        assert g.shape == w.shape


@pytest.mark.parametrize("n,seed", [(1, 1), (16, 2), (64, 3), (300, 4)])
def test_prep_items_matches_jax_native_and_plain(n, seed):
    items = _items(n, seed)
    got = native.prep_items(items)
    _assert_equal(got, jnative.prep_items(items))
    _assert_equal(got, ted.prepare_batch_bytes_plain(*_cols(items)))
    # one writable array a buffer (torch.from_numpy warns on read-only)
    assert all(a.flags.writeable for a in got)
    if n > 13:
        pre = got[4]
        assert not pre[5] and not pre[7] and not pre[9] and pre[11] \
            and pre[13]


def test_prep_items_declines_what_jax_declines():
    ok = _items(4, 5)
    cases = {
        "secp256k1": ok + [(b"\x02" + b"\x01" * 32, b"m", b"s" * 64)],
        "bytearray": ok + [(bytearray(32), b"m", b"s" * 64)],
        "2-tuple": ok + [(b"a" * 32, b"m")],
    }
    for what, items in cases.items():
        assert jnative.prep_items(items) is None, what
        assert native.prep_items(items) is None, what
        assert ted.prep_items(items) is None, what
    empty = native.prep_items([])
    _assert_equal(empty, jnative.prep_items([]))
    assert empty[0].shape == (0, 32) and empty[4].shape == (0,)


@pytest.mark.parametrize("n,seed", [(1, 6), (64, 7)])
def test_ed25519_prepare_matches_jax(n, seed):
    items = _items(n, seed)
    # canonical lengths only: the layout the C call takes
    items = [(p if len(p) == 32 else p + b"\x00", m,
              s if len(s) == 64 else s + b"\x00") for p, m, s in items]
    pk_cat = b"".join(it[0] for it in items)
    sg_cat = b"".join(it[2] for it in items)
    msgs = [it[1] for it in items]
    h, pre = native.ed25519_prepare(pk_cat, sg_cat, msgs)
    jh, jpre = jnative.ed25519_prepare(pk_cat, sg_cat, msgs)
    np.testing.assert_array_equal(h, jh)
    np.testing.assert_array_equal(pre, jpre)
    for i, (p, m, s) in enumerate(items):
        want = int.from_bytes(hashlib.sha512(s[:32] + p + m).digest(),
                              "little") % ref.L
        below = int.from_bytes(s[32:], "little") < ref.L
        assert bool(pre[i]) == below
        assert bytes(h[i]) == (want if below else 0).to_bytes(32, "little")
    with pytest.raises(ValueError, match="ed25519_prepare: 1 msgs need"):
        native.ed25519_prepare(pk_cat[:32], sg_cat[:63], msgs[:1])


@pytest.mark.parametrize("malformed", [False, True])
def test_prepare_batch_bytes_matches_jax_and_counts_its_route(malformed):
    items = _items(64, 8)
    if not malformed:
        items = [(p if len(p) == 32 else b"\x01" * 32, m,
                  s if len(s) == 64 else b"\x02" * 64) for p, m, s in items]
    cols = _cols(items)
    before = ted.prep_stats()
    got = ted.prepare_batch_bytes(*cols)
    after = ted.prep_stats()
    _assert_equal(got, jed.prepare_batch_bytes(*cols))
    _assert_equal(got, ted.prepare_batch_bytes_plain(*cols))
    route = "plain" if malformed else "native"
    assert {k: after[k] - before[k] for k in ("native", "plain")} == \
        {"native": 0, "plain": 0, route: 64}


def test_verifier_prep_takes_the_native_route():
    items = _items(24, 9)
    before = ted.prep_stats()
    got = TVerifier("cuda", device="cpu").verify(items)
    after = ted.prep_stats()
    assert after["native"] - before["native"] == 24
    assert after["plain"] == before["plain"]
    want = [ref.verify(*it) for it in items]
    assert got.tolist() == want


def _sign_inputs(n, seed):
    rng = np.random.RandomState(seed)
    msgs = [b"", rng.bytes(1000), rng.bytes(1), rng.bytes(137)]
    seeds = [rng.bytes(32) for _ in range(3)]
    params = [ted.signing_params(seeds[i % 3]) for i in range(n)]
    return ([msgs[i % 4] for i in range(n)],
            b"".join(p[0] for p in params), b"".join(p[1] for p in params),
            b"".join(p[2] for p in params))


@pytest.mark.parametrize("n", [0, 1, 9])
def test_sign_phases_match_jax_native_and_plain(n):
    msgs, a_cat, pre_cat, pk_cat = _sign_inputs(n, 10 + n)
    mod = jnative._prep()
    r_cat = native.sign_phase1(pre_cat, msgs)
    assert r_cat == mod.sign_phase1(pre_cat, msgs)
    assert r_cat == ted.sign_phase1_plain(pre_cat, msgs)
    assert r_cat == ted.sign_phase1(pre_cat, msgs)
    renc = b"".join(ref.point_compress(ref.point_mul(
        int.from_bytes(r_cat[32 * i:32 * i + 32], "little"), ref.BASE))
        for i in range(n))
    sigs = native.sign_phase2(renc, pk_cat, msgs, r_cat, a_cat)
    assert sigs == mod.sign_phase2(renc, pk_cat, msgs, r_cat, a_cat)
    assert sigs == ted.sign_phase2_plain(renc, pk_cat, msgs, r_cat, a_cat)
    for i in range(n):
        assert ref.verify(pk_cat[32 * i:32 * i + 32], msgs[i],
                          sigs[64 * i:64 * i + 64])


_REFUSALS = [
    ("phase1 prefixes", 1, lambda m, a, p, k: (p[:-1], m),
     ValueError, "prefixes must be n*32 bytes"),
    ("phase1 msgs", 1, lambda m, a, p, k: (p, m[:-1] + ["str"]),
     TypeError, "msgs must be bytes"),
    ("phase2 blobs", 2, lambda m, a, p, k: (k, k, m, a[:-1], a),
     ValueError, "scalar blobs must be n*32"),
    ("phase2 msgs", 2, lambda m, a, p, k: (k, k, m[:-1] + [bytearray(b"x")],
                                           a, a),
     TypeError, "msgs must be bytes"),
]


@pytest.mark.parametrize("what,phase,args,exc,msg", _REFUSALS,
                         ids=[r[0] for r in _REFUSALS])
def test_sign_phase_refusals_word_for_word(what, phase, args, exc, msg):
    msgs, a_cat, pre_cat, pk_cat = _sign_inputs(3, 20)
    a = args(msgs, a_cat, pre_cat, pk_cat)
    mod = jnative._prep()
    fns = {1: (native.sign_phase1, mod.sign_phase1, ted.sign_phase1_plain),
           2: (native.sign_phase2, mod.sign_phase2, ted.sign_phase2_plain)}
    for fn in fns[phase]:
        with pytest.raises(exc) as e:
            fn(*a)
        assert str(e.value) == msg, fn


def test_sha512_impl_names_the_route():
    assert native.sha512_impl() in ("openssl", "portable")
    assert native.sha512_impl() == jnative._prep().sha512_impl


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "prep.cpp"
    bad.write_text("#include <Python.h>\nthis is not C++;\n")
    monkeypatch.setattr(native, "PREP_SRC", bad)
    with pytest.raises(RuntimeError, match="building prep.cpp failed"):
        native.build()
    monkeypatch.setattr(sysconfig, "get_paths",
                        lambda: {"include": str(tmp_path)})
    with pytest.raises(RuntimeError, match="Python.h not found"):
        native.build()
    # the good build is untouched
    monkeypatch.undo()
    assert native.build().parent == _build.BUILD_DIR
