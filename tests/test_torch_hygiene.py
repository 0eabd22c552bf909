"""Import and device hygiene of the port (tendermint_tpu_torch).

- Importing every module of the port (lite/, storage/, state/ with the
  tx indexer, abci/ with the socket client and server, blockchain/, p2p/
  with its conn/, pex/ and socknet, consensus/ with its reactor,
  mempool/ and evidence/ with theirs, rpc/ with the async front door,
  the event loop, the coalescer, UPnP, node, cli, __main__, procnet,
  the pipeline, the fail points, snapshots, state sync, the telemetry
  planes, the knob catalog, the divergence plane, the state tree, the
  gRPC surfaces with their proto module, the lite proxy, the chaos
  plane with its link fuzzer and the lock-order watchdog, the shard
  plane, the edge serving plane, the device mesh and the static-analysis
  checkers included), and chip_smoke.py
  as a module, in a fresh interpreter loads neither jax nor any
  tendermint_tpu module.
- No source of the port (nor chip_smoke.py) imports them (AST check).
- No C++/CUDA source of the port's csrc/ includes a file outside csrc/
  (system headers aside).
- The modules of the node's default plane (config, the event loop, the
  coalescer and verifier, the async front door and RPC core, UPnP, the
  node, the pipeline, the snapshot store and manager, state sync, the
  telemetry planes, the state tree, the gRPC surfaces, the lite proxy,
  the chaos plane, the link fuzzer, the lock-order watchdog, the shard
  plane, the serving plane, the device mesh and the Merkle plane's mesh
  route, the static-analysis engine, its checkers and its runner) read
  no environment variable themselves: their
  settings are config fields and constructor arguments, and the
  observability planes' TM_CUDA_* knobs are read through the catalog
  (utils/knobs.py).
- An entry point given no device raises when no CUDA device is present:
  the port never moves to the CPU quietly. `python -m
  tendermint_tpu_torch.cli node` without a card and without `--device
  cpu` exits non-zero with the device's message; so do a StateTree and a
  tree-backed kvstore given no device, and `cli lite` without `--device`;
  and run_chaos without a device; and a ShardSet, `cli shardset` and
  `cli replica` without one.
"""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "tendermint_tpu_torch"
# the package's own sources; _build/ holds build outputs, not sources
PORT_SOURCES = sorted(p for p in PORT.rglob("*.py")
                      if "_build" not in p.relative_to(PORT).parts)
SOURCES = PORT_SOURCES + [REPO / "chip_smoke.py"]


def test_walk_covers_every_subpackage():
    mods = set(_modules())
    for pkg in ("ops", "types", "models", "utils", "lite", "storage",
                "state", "abci", "abci.apps", "blockchain", "p2p",
                "p2p.conn", "consensus", "mempool", "evidence", "rpc",
                "p2p.pex", "node", "cli", "statesync", "telemetry",
                "analysis", "statetree", "rpc.proto", "chaos", "shard",
                "serving", "parallel", "analysis.checkers"):
        assert f"tendermint_tpu_torch.{pkg}" in mods, pkg
    assert "tendermint_tpu_torch.lite.certifier" in mods
    assert "tendermint_tpu_torch.native" in mods
    for mod in ("ops.sha256", "ops.merkle", "types.block", "types.part_set",
                "types.vote_set", "types.evidence", "types.params",
                "types.genesis", "types.proposal", "types.priv_validator",
                "convert", "storage.db", "storage.block_store",
                "storage.state_store", "state.state", "state.validation",
                "state.execution", "abci.types", "abci.app", "abci.client",
                "abci.proxy", "abci.apps.kvstore", "p2p.conn.flowrate",
                "blockchain.pool", "blockchain.reactor",
                "blockchain.builder", "config", "storage.wal",
                "types.events", "consensus.rstate", "consensus.ticker",
                "consensus.state", "consensus.replay",
                "consensus.wal_generator", "mempool.clist",
                "mempool.mempool", "evidence.store", "evidence.pool",
                "abci.apps.counter", "utils.log", "p2p.base_reactor",
                "p2p.key", "p2p.netaddress", "p2p.node_info", "p2p.trust",
                "p2p.peer", "p2p.switch", "p2p.test_util", "p2p.socknet",
                "p2p.conn.purecrypto", "p2p.conn.burst", "p2p.conn.secret",
                "p2p.conn.mconn", "consensus.compact", "consensus.reactor",
                "mempool.reactor", "evidence.reactor", "abci.server",
                "state.txindex", "p2p.pex.addrbook", "p2p.pex.pex_reactor",
                "rpc.server", "rpc.core", "rpc.client", "__main__",
                "procnet", "models.coalescer", "p2p.conn.loop",
                "p2p.upnp", "rpc.aserver", "pipeline", "utils.fail",
                "storage.snapshot", "statesync.reactor", "utils.knobs",
                "telemetry.registry", "telemetry.trace", "telemetry.causal",
                "telemetry.merge", "telemetry.profile", "telemetry.queues",
                "telemetry.slo", "analysis.divergence", "statetree.store",
                "statetree.proof", "statetree.tree", "statetree.codec",
                "rpc.proto.tmtpu_pb2", "rpc.grpc_service", "rpc.grpc_util",
                "abci.grpc_app", "lite.proxy", "lite.provider",
                "chaos.schedule", "chaos.ticker", "chaos.byzantine",
                "chaos.monitor", "chaos.runner", "chaos.wire",
                "chaos.hostile", "p2p.fuzz", "analysis.lockwatch",
                "shard.router", "shard.reads", "shard.set",
                "serving.topology", "serving.edge", "serving.loadgen",
                "serving.deploy", "parallel.mesh", "analysis.engine",
                "analysis.flowgraph", "analysis.lint",
                "analysis.checkers.ambient", "analysis.checkers.asyncblock",
                "analysis.checkers.determinism",
                "analysis.checkers.exceptions", "analysis.checkers.knobs",
                "analysis.checkers.locks", "analysis.checkers.metrics",
                "analysis.checkers.taint"):
        assert f"tendermint_tpu_torch.{mod}" in mods, mod


CSRC = PORT / "csrc"
CSRC_SOURCES = sorted(p for p in CSRC.iterdir()
                      if p.suffix in (".h", ".cuh", ".cpp", ".cu"))


@pytest.mark.parametrize("path", CSRC_SOURCES, ids=lambda p: p.name)
def test_csrc_includes_nothing_outside_csrc(path):
    """Quoted includes name a file of csrc/ itself; angle includes are
    system and toolkit headers, never a path into the repository."""
    for ln in path.read_text().splitlines():
        m = re.match(r'\s*#\s*include\s*([<"])([^>"]+)[>"]', ln)
        if not m:
            continue
        name = m.group(2)
        assert "tendermint_tpu" not in name and ".." not in name, (path, ln)
        if m.group(1) == '"':
            assert "/" not in name and (CSRC / name).is_file(), (path, ln)


def _modules():
    for p in PORT_SOURCES:
        rel = p.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib") or top == "tendermint_tpu"


def test_port_imports_no_jax_in_a_fresh_interpreter():
    mods = list(_modules()) + ["chip_smoke"]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'tendermint_tpu'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_port_source_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


PLANE_SOURCES = [PORT / m for m in (
    "config.py", "p2p/conn/loop.py", "models/coalescer.py",
    "models/verifier.py", "rpc/aserver.py", "rpc/core.py", "p2p/upnp.py",
    "p2p/switch.py", "p2p/peer.py", "node.py", "cli.py", "pipeline.py",
    "storage/snapshot.py", "statesync/__init__.py", "statesync/reactor.py",
    "telemetry/__init__.py", "telemetry/registry.py", "telemetry/trace.py",
    "telemetry/causal.py", "telemetry/merge.py", "telemetry/profile.py",
    "telemetry/queues.py", "telemetry/slo.py", "statetree/tree.py",
    "rpc/grpc_util.py", "rpc/grpc_service.py", "abci/grpc_app.py",
    "lite/proxy.py", "chaos/__init__.py", "chaos/schedule.py",
    "chaos/ticker.py", "chaos/byzantine.py", "chaos/monitor.py",
    "chaos/runner.py", "chaos/wire.py", "chaos/hostile.py", "p2p/fuzz.py",
    "analysis/lockwatch.py", "shard/__init__.py", "shard/router.py",
    "shard/reads.py", "shard/set.py", "serving/__init__.py",
    "serving/topology.py", "serving/edge.py", "serving/loadgen.py",
    "serving/deploy.py", "parallel/__init__.py", "parallel/mesh.py",
    "ops/merkle.py", "analysis/__init__.py", "analysis/engine.py",
    "analysis/flowgraph.py", "analysis/lint.py",
    "analysis/checkers/__init__.py", "analysis/checkers/ambient.py",
    "analysis/checkers/asyncblock.py", "analysis/checkers/determinism.py",
    "analysis/checkers/exceptions.py", "analysis/checkers/knobs.py",
    "analysis/checkers/locks.py", "analysis/checkers/metrics.py",
    "analysis/checkers/taint.py", "native.py", "consensus/compact.py",
    "consensus/reactor.py", "p2p/conn/burst.py", "p2p/conn/secret.py",
    "p2p/socknet.py", "types/keys.py", "types/encoding.py",
    "types/part_set.py", "utils/ed25519_fast.py", "abci/apps/kvstore.py",
    "ops/ed25519.py", "scripts/__init__.py", "scripts/trace_merge.py",
    "scripts/slo_report.py", "scripts/profile_merge.py",
    "scripts/check_metrics.py")]


@pytest.mark.parametrize("path", PLANE_SOURCES,
                         ids=lambda p: str(p.relative_to(PORT)))
def test_plane_modules_read_no_environment_variable(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        name = (node.attr if isinstance(node, ast.Attribute) else
                node.id if isinstance(node, ast.Name) else None)
        assert name not in ("environ", "getenv", "putenv"), \
            (path, getattr(node, "lineno", None))


@pytest.fixture
def no_cuda(monkeypatch):
    """This machine has no card; on one that has, pretend it has none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_without_device_raise(no_cuda):
    from tendermint_tpu_torch import convert
    from tendermint_tpu_torch.models import verifier
    from tendermint_tpu_torch.ops import ed25519, ladder

    with pytest.raises(RuntimeError, match="no CUDA device"):
        verifier.BatchVerifier()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        verifier.BatchVerifier("cuda")
    saved = verifier._default
    verifier.set_default_verifier(None)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            verifier.default_verifier()
    finally:
        verifier.set_default_verifier(saved)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ed25519.verify_batch([b"\x00" * 32], [b""], [b"\x00" * 64])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.state_from_jax(*ladder.tables())
    # the scalar backend needs no device
    assert verifier.BatchVerifier("python").verify([]).shape == (0,)


def test_device_merkle_without_device_raises(no_cuda):
    from tendermint_tpu_torch.ops import merkle

    for items in ([b"a", b"b"], []):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            merkle.root(items)
    # the host half needs no device
    assert merkle.root_host([b"a", b"b"]) == merkle.root([b"a", b"b"],
                                                          device="cpu")


def test_sign_batch_without_device_raises(no_cuda):
    from tendermint_tpu_torch.ops import ed25519

    with pytest.raises(RuntimeError, match="no CUDA device"):
        ed25519.sign_batch([b"\x01" * 32], [b"m"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ed25519.sign_batch_async([b"\x01" * 32], [b"m"])


def test_sync_entry_points_without_device_raise(no_cuda):
    from tendermint_tpu_torch.blockchain.builder import ChainBuilder
    from tendermint_tpu_torch.models import verifier
    from tendermint_tpu_torch.state.execution import BlockExecutor

    saved = verifier._default
    verifier.set_default_verifier(None)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            BlockExecutor(None, None)
    finally:
        verifier.set_default_verifier(saved)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ChainBuilder(2, 1)


def test_consensus_entry_points_without_device_raise(no_cuda, tmp_path):
    from tendermint_tpu_torch.consensus.testnet import Testnet
    from tendermint_tpu_torch.consensus.wal_generator import wal_with_n_blocks
    from tendermint_tpu_torch.models import verifier

    saved = verifier._default
    verifier.set_default_verifier(None)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Testnet()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            wal_with_n_blocks(1, str(tmp_path / "wal"))
    finally:
        verifier.set_default_verifier(saved)
    # the host verifier needs no device
    net = Testnet(verifier_of=lambda i: verifier.BatchVerifier("python"))
    net.close()


def test_socket_net_without_device_raises(no_cuda):
    from tendermint_tpu_torch.models import verifier
    from tendermint_tpu_torch.p2p.socknet import SockNet

    saved = verifier._default
    verifier.set_default_verifier(None)
    net = SockNet()
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            net.start()
        assert net.nodes == []
    finally:
        net.close()
        verifier.set_default_verifier(saved)


def test_state_tree_and_cli_lite_without_device_raise(no_cuda, tmp_path,
                                                     monkeypatch, capsys):
    from tendermint_tpu_torch import cli
    from tendermint_tpu_torch.abci.apps import KVStoreApp
    from tendermint_tpu_torch.ops import merkle
    from tendermint_tpu_torch.statetree import StateTree

    with pytest.raises(RuntimeError, match="no CUDA device"):
        StateTree()
    monkeypatch.setenv("TM_CUDA_STATE_TREE", "on")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KVStoreApp()
    # the device route of a batch resolves its device; the host ones
    # need none
    with pytest.raises(RuntimeError, match="no CUDA device"):
        merkle.sha256_many_host([b"\x00" * 65] * 512)
    assert len(merkle.sha256_many_host([b"\x00" * 65] * 511)) == 511
    assert StateTree(device="cpu").commit(1)
    code = cli.main(["--home", str(tmp_path / "lite"), "lite",
                     "--node-addr", "http://127.0.0.1:9",
                     "--max-seconds", "1"])
    err = capsys.readouterr().err
    assert code == 1 and "no CUDA device is available" in err, err


def test_chaos_run_without_device_raises(no_cuda, tmp_path):
    from tendermint_tpu_torch.chaos.runner import SMOKE_SPEC, run_chaos
    from tendermint_tpu_torch.models import verifier
    from tendermint_tpu_torch.telemetry import causal

    saved, trace = verifier._default, causal._configured
    verifier.set_default_verifier(None)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_chaos(spec=SMOKE_SPEC, workdir=str(tmp_path / "w"))
        assert causal._configured == trace
        assert not (tmp_path / "w").exists()
    finally:
        verifier.set_default_verifier(saved)


def test_cli_node_without_a_card_exits_with_the_device_error(tmp_path):
    home = str(tmp_path / "h")
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    run = [sys.executable, "-m", "tendermint_tpu_torch.cli", "--home", home]
    subprocess.run(run + ["init", "--chain-id", "nocard"], check=True,
                   env=env, cwd=tmp_path, capture_output=True, timeout=120)
    proc = subprocess.run(run + ["node", "--max-height", "1"], env=env,
                          cwd=tmp_path, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr, proc.stderr
    assert "committed height" not in proc.stdout


def test_shard_and_serving_entry_points_without_device_raise(
        no_cuda, tmp_path, capsys):
    from tendermint_tpu_torch import cli
    from tendermint_tpu_torch.models import verifier
    from tendermint_tpu_torch.shard import ShardSet

    saved = verifier._default
    verifier.set_default_verifier(None)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardSet(2)
        code = cli.main(["--home", str(tmp_path / "ss"), "shardset",
                         "--laddr", "tcp://127.0.0.1:0",
                         "--max-seconds", "1"])
        err = capsys.readouterr().err
        assert code == 1 and "no CUDA device is available" in err, err
    finally:
        verifier.set_default_verifier(saved)
    # `cli replica` configures the process's logging: a process of its own
    home = str(tmp_path / "rep")
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    run = [sys.executable, "-m", "tendermint_tpu_torch.cli", "--home", home]
    subprocess.run(run + ["init"], check=True, env=env, cwd=tmp_path,
                   capture_output=True, timeout=120)
    os.unlink(os.path.join(home, "config", "priv_validator.json"))
    proc = subprocess.run(run + ["replica", "--rpc-laddr",
                                 "tcp://127.0.0.1:0", "--max-seconds", "1"],
                          env=env, cwd=tmp_path, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "no CUDA device is available" in proc.stderr, proc.stderr
