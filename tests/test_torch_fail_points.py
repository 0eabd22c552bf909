"""The port's fail points (tendermint_tpu_torch.utils.fail) against the
JAX package's (tests/test_fail_points.py), on the CPU.

- The catalogs equal the JAX module's, name for name.
- One commit of a single-validator node passes the points in catalog
  order on both paths, in both packages: COMMIT_POINTS with the
  pipeline on (the default) and SERIAL_COMMIT_POINTS with it off, each
  without the state-tree points (both packages fire them only with the
  state tree on; tests/test_torch_statetree.py crashes at them).
- set_target / set_callback and arm keep the JAX module's semantics.
- The crash sweep: for each of the ten pipelined points that fire
  without the state tree, a port node crashed at that point of its
  third height's commit, rebuilt from its stores and WAL, reaches the
  app hash of an uncrashed JAX node.

The hooks of both modules are reset after every test by this file's
autouse fixture.
"""

import os
from dataclasses import replace

import pytest

from tendermint_tpu import config as jconfig
from tendermint_tpu import node as jnode
from tendermint_tpu.abci.apps import kvstore as jkv
from tendermint_tpu.consensus import MockTicker as JMockTicker
from tendermint_tpu.types import genesis as jgen
from tendermint_tpu.types import keys as jkeys
from tendermint_tpu.types import priv_validator as jpv
from tendermint_tpu.utils import fail as jfail
from tendermint_tpu_torch import config as tconfig
from tendermint_tpu_torch import node as tnode
from tendermint_tpu_torch import pipeline as tpipeline
from tendermint_tpu_torch.abci.apps import kvstore as tkv
from tendermint_tpu_torch.consensus import MockTicker as TMockTicker
from tendermint_tpu_torch.types import genesis as tgen
from tendermint_tpu_torch.types import keys as tkeys
from tendermint_tpu_torch.types import priv_validator as tpv
from tendermint_tpu_torch.utils import fail as tfail


class _Pkg:
    def __init__(self, name, config, node, app, gen, keys, pv, ticker,
                 fail):
        self.name, self.config, self.node, self.app = name, config, node, app
        self.gen, self.keys, self.pv = gen, keys, pv
        self.ticker, self.fail = ticker, fail


JAX = _Pkg("jax", jconfig, jnode, jkv.KVStoreApp, jgen, jkeys, jpv,
           JMockTicker, jfail)
PORT = _Pkg("port", tconfig, tnode, tkv.KVStoreApp, tgen, tkeys, tpv,
            TMockTicker, tfail)
NO_TREE = lambda points: [p for p in points
                          if not p.startswith("statetree.")]


class _Crash(BaseException):
    """A simulated process death: nothing between the fail point and the
    test may swallow it."""


@pytest.fixture(autouse=True)
def _reset_hooks(monkeypatch):
    monkeypatch.delenv("TM_TPU_STATE_TREE", raising=False)
    # a port Node configures the process's pipeline mode: restored after
    monkeypatch.setattr(tpipeline, "_configured", "auto")
    yield
    for f in (jfail, tfail):
        f.clear_callback()
        f.set_target(None)
        f.disarm_all()
        f.reset()


def _gen(P, chain_id):
    key = P.keys.PrivKey.generate(b"\x0a" * 32)
    gen = P.gen.GenesisDoc(
        chain_id=chain_id, genesis_time_ns=1,
        validators=[P.gen.GenesisValidator(key.pubkey.ed25519, 10)])
    return gen, key


def _make_node(P, home, gen, key, pipeline="auto"):
    pv_path = os.path.join(home, "priv_validator.json")
    if os.path.exists(pv_path):
        pv = P.pv.PrivValidatorFile.load(pv_path)
    else:
        pv = P.pv.PrivValidatorFile(pv_path, key)
        pv._persist()
    cfg = P.config.test_config(home)
    if P is PORT:
        cfg.base.verifier_backend = "python"
        cfg.base.pipeline = pipeline
    node = P.node.Node(cfg, gen, priv_validator=pv, app=P.app())
    node.consensus.ticker.stop()
    node.consensus.ticker = P.ticker(node.consensus._on_timeout_fire)
    return node


WAVE_A = [b"fp/a%d=v%d" % (i, i) for i in range(1, 4)]
WAVE_B = [b"fp/b%d=w%d" % (i, i) for i in range(1, 4)]


def _inject(node, txs):
    """Duplicate-tolerant: after a restart the mempool WAL replays
    pending txs; kvstore sets are idempotent."""
    for tx in txs:
        try:
            node.mempool.check_tx(tx)
        except Exception:
            pass


def _commit_to(node, target_height, max_ticks=400):
    for _ in range(max_ticks):
        if node.height >= target_height:
            return
        node.consensus.ticker.fire_next()
    raise AssertionError(f"stuck at height {node.height}")


def _drain(node, max_ticks=200):
    for _ in range(max_ticks):
        if node.mempool.size() == 0:
            return
        node.consensus.ticker.fire_next()
    raise AssertionError(f"mempool never drained ({node.mempool.size()})")


def test_catalogs_equal_jax():
    assert tfail.COMMIT_POINTS == jfail.COMMIT_POINTS
    assert tfail.SERIAL_COMMIT_POINTS == jfail.SERIAL_COMMIT_POINTS
    assert tfail.RECOVERY_POINTS == jfail.RECOVERY_POINTS


def _order(P, home, pipeline_on: bool, monkeypatch):
    if pipeline_on:
        monkeypatch.delenv("TM_TPU_PIPELINE", raising=False)
    else:
        monkeypatch.setenv("TM_TPU_PIPELINE", "off")
    seen = []
    for name in P.fail.COMMIT_POINTS:
        P.fail.arm(name, seen.append)
    gen, key = _gen(P, "fp-order")
    node = _make_node(P, home, gen, key,
                      pipeline="auto" if pipeline_on else "off")
    node.start()
    _inject(node, WAVE_A)
    _commit_to(node, 1)
    node.stop()
    P.fail.disarm_all()
    return seen


@pytest.mark.parametrize("pipeline_on", [True, False],
                         ids=["pipelined", "serial"])
def test_commit_points_fire_in_catalog_order(tmp_path, monkeypatch,
                                             pipeline_on):
    want = NO_TREE(tfail.COMMIT_POINTS if pipeline_on
                   else tfail.SERIAL_COMMIT_POINTS)
    port = _order(PORT, str(tmp_path / "port"), pipeline_on, monkeypatch)
    jax = _order(JAX, str(tmp_path / "jax"), pipeline_on, monkeypatch)
    assert port == want
    assert jax == want
    assert len(want) == (10 if pipeline_on else 8)


def test_set_target_and_callback_and_clear():
    for f in (tfail, jfail):
        f.reset()
        hits = []
        f.set_callback(hits.append)
        f.set_target(2)
        for name in ("a", "b", "c"):
            f.fail_point(name)
        assert hits == [2], f.__name__   # only the target index fires
        f.clear_callback()
        f.set_target(None)
        f.reset()
        f.fail_point("d")   # no target: a no-op, not os._exit


def test_arm_is_one_shot_and_name_scoped():
    for f in (tfail, jfail):
        fired = []
        f.arm("consensus.before_save_block", fired.append)
        f.fail_point("execution.after_save_state")   # another name
        assert fired == []
        f.fail_point("consensus.before_save_block")
        f.fail_point("consensus.before_save_block")  # disarmed after one
        assert fired == ["consensus.before_save_block"], f.__name__


def _control_hash(P, home, gen, key, pipeline, monkeypatch):
    if pipeline == "off":
        monkeypatch.setenv("TM_TPU_PIPELINE", "off")
    node = _make_node(P, home, gen, key, pipeline=pipeline)
    monkeypatch.delenv("TM_TPU_PIPELINE", raising=False)
    node.start()
    _inject(node, WAVE_A)
    _commit_to(node, 2)
    _inject(node, WAVE_B)
    _commit_to(node, 4)
    _drain(node)
    out = node.consensus.state.app_hash
    node.stop()
    return out


def test_crash_at_every_index_recovers_the_jax_apphash(tmp_path,
                                                       monkeypatch):
    """tests/test_fail_points.py::test_crash_at_every_index_recovers_
    same_apphash on the port: each of the ten pipelined points crashes
    the third height's commit; the node rebuilt from its files (the
    handshake's replay and the WAL catchup) reaches the app hash of an
    uncrashed JAX node (and of an uncrashed port node on the serial
    path)."""
    target = 4
    jgen_, jkey = _gen(JAX, "fp-sweep")
    control = _control_hash(JAX, str(tmp_path / "jax"), jgen_, jkey, "off",
                            monkeypatch)
    gen, key = _gen(PORT, "fp-sweep")
    assert _control_hash(PORT, str(tmp_path / "port"), gen, key, "off",
                         monkeypatch) == control
    points = NO_TREE(tfail.COMMIT_POINTS)
    flushes = tpipeline.stats()["group_flushes"]
    for index in range(1, len(points) + 1):
        home = str(tmp_path / f"crash{index}")
        node = _make_node(PORT, home, gen, key)
        assert node.consensus._pipeline
        node.start()
        _inject(node, WAVE_A)
        _commit_to(node, 2)
        hit = []

        def crash(i):
            hit.append(i)
            raise _Crash(f"index {i}")

        # armed before wave B: its injection may commit inline, and the
        # first commit after arming is the one that dies at `index`
        tfail.reset()
        tfail.set_callback(crash)
        tfail.set_target(index)
        with pytest.raises(_Crash):
            _inject(node, WAVE_B)
            _commit_to(node, target)
        tfail.set_target(None)
        tfail.clear_callback()
        assert hit == [index]
        crashed_at = node.height
        node.consensus._stopped = True
        try:
            node.stop()
        except Exception:
            pass

        node2 = _make_node(PORT, home, gen, key)   # handshake replay
        node2.start()                              # WAL catchup replay
        assert node2.height >= crashed_at, points[index - 1]
        _inject(node2, WAVE_B)
        _commit_to(node2, target)
        _drain(node2)
        assert node2.consensus.state.app_hash == control, (
            f"index {index} ({points[index - 1]}): the recovered app hash "
            f"differs")
        assert node2.app.height == node2.block_store.height()
        node2.stop()
    assert tpipeline.stats()["group_flushes"] > flushes
