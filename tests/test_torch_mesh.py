"""The port's device mesh (tendermint_tpu_torch/parallel/mesh.py and its
routes in models/verifier.py and ops/merkle.py) against the JAX
package's, on the CPU at tolerance 0.

- The spec grammar and the device-count resolution give the JAX
  package's values and raise its errors.
- BatchVerifier(mesh=2/4/8) on the CPU, with TM_CUDA_MESH_FORCE_DEVICES=8
  laying eight logical devices over it, gives the JAX verifier's
  verdicts on a batch with tampered lanes (the JAX side unsharded:
  tests/test_mesh.py holds its sharded verdicts equal to those), one
  plain-verify call a shard, the bucket floor max(8, N) and one
  mesh_dispatch_total{kind="verify"} a chunk.
- Merged coalescer dispatches pad to sizes the mesh divides.
- The sharded Merkle root at 2 / 4 / 8 and at 63-65, 127-129 and 1000
  leaves equals the JAX `sharded_merkle_root` on conftest's eight
  virtual CPU devices and the host root; `root_host` and
  `root_from_digests_host` route through the mesh at an explicit
  TM_CUDA_MESH=N and count `merkle_roots_total{impl="mesh"}`.
- `merkle._mesh_root_kernel`'s cases: "auto" and "off" native, an
  explicit N (from the knob, or a node's `configure_mesh`, the knob
  winning) sharded, N above the devices raising.
- `verify_step` and a fast-sync window drained through a verifier that
  `node.build_verifier` builds from `base.verifier_mesh`.
"""

import numpy as np
import pytest
import torch

from tendermint_tpu.models import verifier as jverifier
from tendermint_tpu.parallel import mesh as jmesh
from tendermint_tpu.utils import ed25519_ref as jref
from tendermint_tpu_torch import convert, telemetry
from tendermint_tpu_torch.config import BaseConfig, Config, validate
from tendermint_tpu_torch.models import verifier as tverifier
from tendermint_tpu_torch.node import build_verifier
from tendermint_tpu_torch.ops import ed25519 as ted
from tendermint_tpu_torch.ops import merkle
from tendermint_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)
TAMPER = (1, 7, 14, 29)


def _signed(n: int, seed: int = 41):
    """n (pub, msg, sig) triples signed by the JAX package's RFC 8032
    oracle from seeded keys; TAMPER's lanes get a flipped s byte."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        key = rng.bytes(32)
        msg = b"mesh test %d" % i
        sig = jref.sign(key, msg)
        if i in TAMPER:
            sig = sig[:32] + bytes([sig[32] ^ 1]) + sig[33:]
        out.append((jref.public_key(key), msg, sig))
    return out


ITEMS = _signed(32)
LEAVES = {n: [bytes(np.random.RandomState(n).bytes(1 + i % 37))
              for i in range(n)] for n in (63, 64, 65, 127, 128, 129, 1000)}


@pytest.fixture(scope="module")
def jax_verdicts():
    return jverifier.BatchVerifier("python", coalesce="off").verify(ITEMS)


@pytest.fixture
def force8(monkeypatch):
    monkeypatch.setenv("TM_CUDA_MESH_FORCE_DEVICES", "8")
    monkeypatch.delenv("TM_CUDA_MESH", raising=False)
    monkeypatch.setattr(merkle, "_mesh_state", None)
    monkeypatch.setattr(merkle, "_mesh_config", "auto")


@pytest.fixture
def registry_on():
    was = telemetry.enabled()
    telemetry.set_enabled(True)
    yield
    telemetry.set_enabled(was)


# ---------------------------------------------------------- spec grammar --

SPECS = ["auto", "", " AUTO ", "off", "0", "1", "none", "2", "4", "8",
         "16", 2, 8, "3", "6", "-2", "bogus", "2.0", None]


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("spec", SPECS, ids=repr)
def test_parse_mesh_spec_as_jax(spec):
    assert _outcome(pmesh.parse_mesh_spec, spec) == \
        _outcome(jmesh.parse_mesh_spec, spec)


@pytest.mark.parametrize("spec", ["off", "auto", 2, 4, 8])
@pytest.mark.parametrize("n_avail", [1, 2, 3, 4, 7, 8])
def test_resolve_mesh_size_as_jax(spec, n_avail):
    assert _outcome(pmesh.resolve_mesh_size, spec, n_avail) == \
        _outcome(jmesh.resolve_mesh_size, spec, n_avail)


def test_verifier_and_config_validate_the_spec_eagerly():
    for bad in ("3", "bogus"):
        with pytest.raises(ValueError):
            tverifier.BatchVerifier("cuda", device="cpu", mesh=bad)
        with pytest.raises(ValueError):
            jverifier.BatchVerifier("jax", mesh=bad)
        cfg = Config()
        cfg.base.verifier_mesh = bad
        with pytest.raises(ValueError):
            validate(cfg)
    assert BaseConfig().verifier_mesh == "auto"
    # only the device count is lazy, and it raises RuntimeError
    with pytest.raises(RuntimeError):
        tverifier.BatchVerifier("cuda", device="cpu",
                                mesh="64")._resolve_mesh()


def test_auto_is_unsharded_on_one_device(monkeypatch):
    monkeypatch.delenv("TM_CUDA_MESH_FORCE_DEVICES", raising=False)
    v = tverifier.BatchVerifier("cuda", device="cpu", mesh="auto")
    v._resolve_mesh()
    assert v._mesh_resolved and v.mesh_devices == 0
    assert v._min_bucket == 8 and v._mesh_kernel is None
    with pytest.raises(RuntimeError):
        tverifier.BatchVerifier("cuda", device="cpu",
                                mesh="2")._resolve_mesh()
    # the python backend has no device and never resolves a mesh
    assert tverifier.BatchVerifier("python", mesh="8")._mesh_resolved


# ---------------------------------------------------------- sharded verify --

@pytest.mark.parametrize("k", [2, 4, 8])
def test_batch_verifier_mesh_verdicts_equal_jax(k, force8, jax_verdicts,
                                                registry_on, monkeypatch):
    calls = []
    inner = ted.verify_prepared_async

    def counted(pk, *a, **kw):
        calls.append(pk.shape[0])
        return inner(pk, *a, **kw)

    monkeypatch.setattr(ted, "verify_prepared_async", counted)
    d0 = telemetry.value("mesh_dispatch_total", {"kind": "verify"}) or 0
    v = tverifier.BatchVerifier("cuda", device="cpu", mesh=str(k),
                                coalesce="off")
    assert v.mesh_devices == 0          # lazy until the first dispatch
    got = v.verify(ITEMS)
    assert got.tolist() == jax_verdicts.tolist()
    assert got.tolist() == [i not in TAMPER for i in range(len(ITEMS))]
    assert v.mesh_devices == k and v._min_bucket == max(8, k)
    assert telemetry.value("verifier_mesh_devices") == k
    assert telemetry.value("mesh_dispatch_total", {"kind": "verify"}) \
        == d0 + 1
    # one plain call a contiguous shard of the padded batch
    assert calls == [ted._bucket(len(ITEMS), min_size=max(8, k)) // k] * k


def test_coalesced_batches_pad_mesh_divisible(force8, jax_verdicts,
                                              monkeypatch):
    """Calls merged by the coalescer go through the same sharded
    dispatch: every padded chunk divides by the mesh."""
    from concurrent.futures import ThreadPoolExecutor
    shapes = []
    v = tverifier.BatchVerifier("cuda", device="cpu", mesh="4",
                                coalesce="on", coalesce_wait_ms=25.0)
    v._resolve_mesh()
    assert v.mesh_devices == 4 and v._min_bucket == 8
    inner = v._mesh_kernel

    def recording(pk, *a, **kw):
        out = inner(pk, *a, **kw)
        shapes.append(out.host.shape[0])
        return out

    v._mesh_kernel = recording
    items = ITEMS[:8]
    try:
        with ThreadPoolExecutor(max_workers=2) as pool:
            futs = [pool.submit(v.verify, items[:4]),
                    pool.submit(v.verify, items[4:])]
            first, second = futs[0].result(), futs[1].result()
    finally:
        v.close()
    assert first.tolist() + second.tolist() == jax_verdicts.tolist()[:8]
    assert v.stats["coalesced_calls"] == 2
    assert shapes and all(s % 4 == 0 and s >= 8 for s in shapes), shapes


def test_sharded_kernel_of_one_device_is_the_plain_route():
    pk, rb, sb, hb, pre = ted.prepare_batch_bytes(*zip(*ITEMS[:8]))
    one = pmesh.make_mesh(1, "cpu")
    got = pmesh.sharded_verify_kernel(one)(pk, rb, sb, hb)
    want = ted.verify_prepared_async(pk, rb, sb, hb, device="cpu")
    assert np.array_equal(got.result(), want.numpy())
    assert got.events == []


# ------------------------------------------------------------ Merkle root --

@pytest.fixture(scope="module")
def jax_roots():
    """The JAX sharded root of each leaf set on the 8-device virtual CPU
    mesh (one compile a padded shape)."""
    import jax.numpy as jnp
    from tendermint_tpu.ops import merkle as jmerkle
    kern = jmesh.sharded_merkle_root(jmesh.make_mesh(8))
    out = {}
    for n, leaves in LEAVES.items():
        rows = np.stack([np.frombuffer(jmerkle.leaf_hash(x), np.uint8)
                         for x in leaves])
        out[n] = np.asarray(kern(jnp.asarray(jmerkle.pad_digests(rows)),
                                 n)).tobytes()
    return out


def _rows(leaves):
    return np.stack([np.frombuffer(merkle.leaf_hash(x), np.uint8)
                     for x in leaves])


@pytest.mark.parametrize("n", sorted(LEAVES))
def test_sharded_merkle_root_equals_jax_and_host(n, force8, jax_roots):
    leaves = LEAVES[n]
    want = merkle.root_plain(leaves)
    assert jax_roots[n] == want == merkle.root_host(leaves)
    padded = merkle.pad_digests(_rows(leaves))
    for k in (2, 4, 8):
        root = pmesh.sharded_merkle_root(pmesh.make_mesh(k, "cpu"))
        assert root(padded, n).numpy().tobytes() == want, k


def test_root_host_mesh_dispatch_bit_equality(force8, monkeypatch,
                                              registry_on):
    leaves = LEAVES[129]
    digests = [merkle.leaf_hash(x) for x in leaves]
    want = merkle.root_plain(leaves)
    monkeypatch.setenv("TM_CUDA_MESH", "8")
    r0 = telemetry.value("merkle_roots_total", {"impl": "mesh"}) or 0
    d0 = telemetry.value("mesh_dispatch_total", {"kind": "merkle"}) or 0
    assert merkle.root_host(leaves) == want
    assert merkle._mesh_state[1] == 8
    assert merkle.root_from_digests_host(digests) == want
    assert merkle.root_from_digests_host(b"".join(digests)) == want
    assert telemetry.value("merkle_roots_total", {"impl": "mesh"}) == r0 + 3
    assert telemetry.value("mesh_dispatch_total", {"kind": "merkle"}) \
        == d0 + 3
    # below the threshold, and trees narrower than the mesh, stay native
    small = LEAVES[63]
    assert merkle.root_host(small) == merkle.root_plain(small)
    assert telemetry.value("merkle_roots_total", {"impl": "mesh"}) == r0 + 3
    assert merkle._mesh_root_from_digest_rows(_rows(small), 63) is None


def test_merkle_mesh_resolution(force8, monkeypatch):
    """Roots shard only at an explicit width: "auto" (CUDA initialized
    or not) and "off" resolve native at once and cache it; an explicit N
    from TM_CUDA_MESH, or from configure_mesh (a node's
    base.verifier_mesh) with the knob unset, shards; the knob wins over
    the configured spec; N above the devices raises, as the JAX
    package's TM_TPU_MESH does."""
    for init in (False, True):
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: init)
        monkeypatch.setattr(merkle, "_mesh_state", None)
        assert merkle._mesh_root_kernel() == (None, 1)   # auto: native
        assert merkle._mesh_state == (None, 1)
    leaves = LEAVES[128]
    want = merkle.root_plain(leaves)
    was = telemetry.enabled()
    telemetry.set_enabled(True)
    try:
        r0 = telemetry.value("merkle_roots_total", {"impl": "mesh"}) or 0
        assert merkle.root_host(leaves) == want
        assert (telemetry.value("merkle_roots_total", {"impl": "mesh"})
                or 0) == r0
    finally:
        telemetry.set_enabled(was)
    monkeypatch.setenv("TM_CUDA_MESH", "off")
    monkeypatch.setattr(merkle, "_mesh_state", None)
    assert merkle._mesh_root_kernel() == (None, 1)
    assert merkle._mesh_state == (None, 1)
    for spec, want_n in (("4", 4), ("16", RuntimeError)):
        monkeypatch.setattr(merkle, "_mesh_state", None)
        monkeypatch.setenv("TM_CUDA_MESH", spec)
        if want_n is RuntimeError:
            with pytest.raises(RuntimeError):
                merkle.root_host(leaves)
        else:
            assert merkle.root_host(leaves) == want
            assert merkle._mesh_state[1] == want_n
    # a node's base.verifier_mesh: configure_mesh, which the knob beats
    monkeypatch.delenv("TM_CUDA_MESH")
    merkle.configure_mesh("2")
    assert merkle._mesh_state is None
    assert merkle._mesh_root_kernel()[1] == 2
    assert merkle.root_host(leaves) == want
    merkle.configure_mesh("off")
    assert merkle._mesh_root_kernel() == (None, 1)
    monkeypatch.setenv("TM_CUDA_MESH", "8")
    merkle.configure_mesh("2")
    assert merkle._mesh_root_kernel()[1] == 8
    with pytest.raises(ValueError):
        merkle.configure_mesh("3")
    # the JAX package resolves and refuses the same way
    from tendermint_tpu.ops import merkle as jmerkle
    for spec, want in (("8", 8), ("64", RuntimeError)):
        monkeypatch.setenv("TM_TPU_MESH", spec)
        monkeypatch.setattr(jmerkle, "_mesh_state", None)
        if want is RuntimeError:
            with pytest.raises(RuntimeError):
                jmerkle._mesh_root_kernel()
        else:
            assert jmerkle._mesh_root_kernel()[1] == want
    monkeypatch.setattr(jmerkle, "_mesh_state", None)


def test_verify_step(force8, jax_verdicts):
    items = ITEMS[:16]
    leaves = [m for _, m, _ in items]
    pk, rb, sb, hb, pre = ted.prepare_batch_bytes(*zip(*items))
    step = pmesh.verify_step(pmesh.make_mesh(2, "cpu"))
    ok, root = step(pk, rb, sb, hb, merkle.pad_digests(_rows(leaves)),
                    len(leaves))
    assert (ok[:16] & pre).tolist() == jax_verdicts.tolist()[:16]
    assert root.numpy().tobytes() == merkle.root_plain(leaves)


# ------------------------------------------------------ fast-sync window --

def test_fast_sync_window_verifies_through_mesh(force8):
    """A 16-block window of the JAX package's chain drained by a port
    node whose verifier node.build_verifier builds from
    base.verifier_mesh: the same states as the JAX node's drain."""
    from tests.test_torch_state import JAX, Chain
    from tests.test_torch_sync import PKG, _node, _sync
    n_blocks, window = 16, 16
    c = Chain(JAX, 4, chain_id="mesh-window")
    for h in range(1, n_blocks + 2):
        c.next([b"mw%d.%d=v" % (h, i) for i in range(3)])
    verifier, owned = build_verifier(
        BaseConfig(verifier_backend="cuda", verifier_mesh="4"), device="cpu")
    assert owned and verifier.mesh == 4
    jnode = _node(PKG["jax"], c.gen, None, window)
    tnode = _node(PKG["port"], convert.genesis_from_jax(c.gen.to_obj()),
                  verifier, window)
    _sync(jnode, c.blocks, n_blocks)
    _sync(tnode, [convert.block_from_jax(b.to_obj()) for b in c.blocks],
          n_blocks)
    verifier.close()
    assert verifier.mesh_devices == 4
    assert verifier.stats["cuda_sigs"] == n_blocks * 4
    assert tnode.bs.height() == jnode.bs.height() == n_blocks
    assert tnode.seen == jnode.seen
    assert tnode.app.app_hash == jnode.app.app_hash == \
        c.states[n_blocks].app_hash
