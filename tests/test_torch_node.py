"""The port's node (node.py) and CLI (cli.py) against the JAX package's,
on the CPU, tolerance 0.

- An in-memory single-validator Node of each package, on one genesis and
  key, with the same 12 txs in its mempool before it starts (5 a block,
  create_empty_blocks off, so the chain settles at a fixed height), on a
  clock that reads T0 + (height + 1) s, stores the same block bytes,
  seen commits and app hashes at every height. The JAX side runs its
  pipeline off (the serial path the port has). `single_node` is the
  harness test_torch_rpc.py drives its route parity on.
- A port node with a home resumes at its height after stop and start,
  replays nothing twice, and goes on committing.
- The CLI: init, show_validator, show_node_id, gen_validator,
  unsafe_reset_priv_validator, unsafe_reset_all, version and replay give
  the JAX CLI's output and files on the same homes.
- Trees across packages: a JAX-written `cli testnet` tree builds a port
  node and a port-written tree a JAX node, with the same peers, ports
  and settings; the JAX `base` keys for the frame bursts, `compact` and
  `vote_agg` reach the port's P2PConfig / ConsensusConfig fields, and the
  port's save_config writes them back for the JAX loader, once each: an
  edit of such a key in a port-written tree, or the port's own field set
  in its section, reaches the node.
- A node given no device on a machine without a card raises the
  device's error unless its backend is "python"; a launch or a wait
  that fails on the card raises VerifierError, and a node halts on it
  (ConsensusState.fatal_error).
"""

import contextlib
import hashlib
import io
import json
import os
import shutil
import time
from dataclasses import replace
from types import SimpleNamespace

import pytest
import torch

from tendermint_tpu import cli as jcli
from tendermint_tpu import config as jconfig
from tendermint_tpu import node as jnode
from tendermint_tpu.types import encoding as jenc
from tendermint_tpu.types import genesis as jgen
from tendermint_tpu.types import keys as jkeys
from tendermint_tpu.types import priv_validator as jpv
from tendermint_tpu.utils import clock as jclock
from tendermint_tpu_torch import cli as tcli
from tendermint_tpu_torch import config as tconfig
from tendermint_tpu_torch import node as tnode
from tendermint_tpu_torch import procnet
from tendermint_tpu_torch.consensus.rstate import Step
from tendermint_tpu_torch.types import encoding as tenc
from tendermint_tpu_torch.types import genesis as tgen
from tendermint_tpu_torch.types import keys as tkeys
from tendermint_tpu_torch.types import priv_validator as tpv
from tendermint_tpu_torch.utils import clock as tclock

T0 = 1_700_000_000 * 10 ** 9
CHAIN = "node-parity"
KEY_SEED = b"\x21" * 32
TXS = [b"k%02d=v%d" % (i, i * i) for i in range(12)] + [b"opaque-tx"]

JAX = SimpleNamespace(name="jax", node=jnode, config=jconfig, enc=jenc,
                      gen=jgen, keys=jkeys, pv=jpv, clock=jclock, cli=jcli)
PORT = SimpleNamespace(name="port", node=tnode, config=tconfig, enc=tenc,
                       gen=tgen, keys=tkeys, pv=tpv, clock=tclock, cli=tcli)
PKGS = (JAX, PORT)


@pytest.fixture(autouse=True)
def _jax_serial(monkeypatch):
    monkeypatch.setenv("TM_TPU_PIPELINE", "off")
    yield
    for P in PKGS:
        P.clock.set_source(None)


def node_config(P, home=""):
    c = P.config.test_config(home)
    c.consensus = replace(c.consensus, create_empty_blocks=False,
                          max_block_size_txs=5)
    c.base.verifier_backend = "python"
    c.base.chain_id = CHAIN
    c.tx_index.index_all_tags = True
    return c


def genesis(P):
    key = P.keys.PrivKey.generate(KEY_SEED)
    return key, P.gen.GenesisDoc(
        chain_id=CHAIN, genesis_time_ns=T0 - 10 ** 9,
        validators=[P.gen.GenesisValidator(key.pubkey.ed25519, 10)])


def settle(node, timeout_s: float = 60.0) -> int:
    """Wait until the chain has stopped (create_empty_blocks off): the
    mempool is empty, the last block left the app hash as it found it,
    so neither a tx block nor a proof block is due, and the state
    machine waits for txs in the next height's NewRound step."""
    t0 = time.monotonic()
    while True:
        h = node.height
        meta = node.block_store.load_block_meta(h) if h else None
        rs = node.consensus.rs
        if meta is not None and not node.mempool.size() and \
                node.block_store.height() == h and \
                meta.header.app_hash == node.consensus.state.app_hash and \
                (rs.height, rs.round, rs.step) == (h + 1, 0,
                                                   Step.NEW_ROUND):
            return h
        assert time.monotonic() - t0 < timeout_s, f"stuck at {h}"
        time.sleep(0.02)


def height_clock(P, holder):
    """T0 + (last block height + 1) s: the same value at the same step of
    either package's state machine, whatever the number of reads."""
    P.clock.set_source(
        lambda: T0 + (holder[0].consensus.state.last_block_height + 1)
        * 10 ** 9 if holder else T0)


def single_node(P, txs=TXS, home="", **kw):
    """A started single-validator node of package P with `txs` in its
    mempool before the start; returns it settled."""
    key, gen = genesis(P)
    holder = []
    height_clock(P, holder)
    if home:
        path = os.path.join(home, "pv.json")
        if not os.path.exists(path):
            P.pv.PrivValidatorFile(path, key)._persist()
        pv = P.pv.PrivValidatorFile.load(path)
    else:
        pv = P.pv.PrivValidator(P.pv.LocalSigner(key))
    node = P.node.Node(node_config(P, home), gen, priv_validator=pv,
                       in_memory=not home, **kw)
    holder.append(node)
    # preloaded with the txs-available hook off: its submit would run
    # the state machine inline before the start
    hook = node.mempool.txs_available_hook
    node.mempool.txs_available_hook = lambda: None
    for tx in txs:
        node.mempool.check_tx(tx)
    node.mempool.txs_available_hook = hook
    # read before the start: a fresh node may commit blocks before
    # start() returns, and a notification then makes an extra block
    restarted = node.height > 0
    node.start()
    if restarted and txs:
        # a restarted node waits for txs (no proof block is due): the
        # notification the preload held back
        hook()
    settle(node)
    return node


def chain_rows(P, node):
    bs = node.block_store
    return [(P.enc.cdumps(bs.load_block(h).to_obj()),
             P.enc.cdumps(bs.load_block_meta(h).to_obj()),
             P.enc.cdumps(bs.load_seen_commit(h).to_obj()))
            for h in range(1, bs.height() + 1)]


def test_in_memory_node_stores_the_jax_blocks_and_app_hashes():
    nodes = {P.name: single_node(P) for P in PKGS}
    try:
        rows = {P.name: chain_rows(P, nodes[P.name]) for P in PKGS}
        assert len(rows["port"]) >= 4
        assert rows["port"] == rows["jax"]
        assert nodes["port"].consensus.state.app_hash == \
            nodes["jax"].consensus.state.app_hash != b""
        committed = [tx for h in range(1, nodes["port"].height + 1)
                     for tx in nodes["port"].block_store.load_block(
                         h).data.txs]
        assert committed == TXS
    finally:
        for n in nodes.values():
            n.stop()


def test_node_with_a_home_resumes_at_its_height(tmp_path):
    home = str(tmp_path / "n")
    node = single_node(PORT, home=home)
    h0, app0 = node.height, node.consensus.state.app_hash
    node.stop()
    node = single_node(PORT, txs=[b"late=1"], home=home)
    try:
        assert node.height > h0
        blocks = [node.block_store.load_block(h) for h in
                  range(1, node.height + 1)]
        txs = [tx for b in blocks for tx in b.data.txs]
        assert txs == TXS + [b"late=1"]
        assert blocks[h0].header.app_hash == app0
        late = node.tx_indexer.get(hashlib.sha256(b"late=1").digest())
        assert late["height"] > h0
    finally:
        node.stop()


# --------------------------------------------------------------------- CLI

def run_cli(P, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = P.cli.main(argv)
    return rc, out.getvalue()


def _norm(text, *homes):
    for h in homes:
        text = text.replace(str(h), "<home>")
    return text


def test_cli_commands_match_jax(tmp_path):
    jhome, thome = tmp_path / "j", tmp_path / "t"
    rc, out = run_cli(JAX, ["--home", str(jhome), "init",
                            "--chain-id", "cli-chain"])
    assert rc == 0
    run_cli(JAX, ["--home", str(jhome), "show_node_id"])  # writes the key
    shutil.copytree(jhome, thome)
    outs = {}
    for P, home in ((JAX, jhome), (PORT, thome)):
        outs[P.name] = [_norm(run_cli(P, ["--home", str(home)] + argv)[1],
                              home)
                        for argv in (["init", "--chain-id", "x"],
                                     ["show_validator"], ["show_node_id"],
                                     ["version"])]
    assert outs["port"] == outs["jax"]
    assert "genesis already exists" in outs["port"][0]
    # gen_validator: a fresh key pair each run, in the JAX shape, that
    # both packages read back
    for P in PKGS:
        obj = json.loads(run_cli(P, ["gen_validator"])[1])
        assert set(obj) == {"priv_key", "pub_key"}
        for Q in PKGS:
            k = Q.keys.PrivKey.from_obj(obj["priv_key"])
            assert k.pubkey.to_obj() == obj["pub_key"]
    # a port-written init reads the same in the JAX CLI
    phome = tmp_path / "p"
    run_cli(PORT, ["--home", str(phome), "init", "--chain-id", "p"])
    assert run_cli(JAX, ["--home", str(phome), "show_validator"])[1] == \
        run_cli(PORT, ["--home", str(phome), "show_validator"])[1]
    assert jgen.GenesisDoc.load(str(phome / "config" / "genesis.json")
                                ).chain_id == "p"


def _run_home(P, home):
    """A node of package P with a file home, settled and stopped."""
    node = single_node(P, home=str(home))
    node.stop()
    P.clock.set_source(None)


def test_unsafe_resets_match_jax(tmp_path):
    for P in PKGS:
        _run_home(P, tmp_path / P.name)
        pv = tmp_path / P.name / "pv.json"
        cfg = tmp_path / P.name / "config"
        cfg.mkdir(exist_ok=True)
        shutil.copy(pv, cfg / "priv_validator.json")
    outs = {}
    for P in PKGS:
        home = tmp_path / P.name
        before = json.loads((home / "config" /
                             "priv_validator.json").read_text())
        assert before["last_height"] > 0
        rc1, o1 = run_cli(P, ["--home", str(home),
                              "unsafe_reset_priv_validator"])
        after = (home / "config" / "priv_validator.json").read_bytes()
        rc2, o2 = run_cli(P, ["--home", str(home), "unsafe_reset_all"])
        outs[P.name] = (rc1, _norm(o1, home), after, rc2, _norm(o2, home),
                        (home / "data").exists())
    assert outs["port"] == outs["jax"]
    assert json.loads(outs["port"][2])["last_height"] == 0
    assert not outs["port"][5]


@pytest.mark.parametrize("cmd", ["replay", "replay_console"])
def test_replay_matches_jax(tmp_path, monkeypatch, cmd):
    """The WAL of a JAX node's home replays through both CLIs with the
    same lines (the port's node reads the JAX home's files); the console
    takes ENTER for each message."""
    prompts = []
    monkeypatch.setattr("builtins.input",
                        lambda prompt="": prompts.append(prompt) or "")
    home = tmp_path / "j"
    _run_home(JAX, home)
    (home / "config").mkdir(exist_ok=True)
    key, gen = genesis(JAX)
    gen.save(str(home / "config" / "genesis.json"))
    jconfig.save_config(node_config(JAX, str(home)))
    outs = {}
    for P in PKGS:
        copy = tmp_path / f"replay-{P.name}"
        shutil.copytree(home, copy)
        argv = ["--home", str(copy), cmd] + (
            ["--device", "cpu"] if P is PORT else [])
        rc, out = run_cli(P, argv)
        outs[P.name] = (rc, _norm(out, copy), prompts[:])
        prompts.clear()
    assert outs["port"] == outs["jax"]
    assert outs["port"][0] == 0 and "replayed" in outs["port"][1]
    assert bool(outs["port"][2]) == (cmd == "replay_console")


# ------------------------------------------------------------------ trees

def _tree(P, out, base_port):
    rc, _ = run_cli(P, ["testnet", "--n", "4", "--output", str(out),
                        "--base-port", str(base_port), "--chain-id", "tree"])
    assert rc == 0


def _view(cfg):
    return (cfg.p2p.laddr, cfg.rpc.laddr, cfg.p2p.persistent_peers,
            cfg.p2p.addr_book_strict, cfg.p2p.pex, cfg.base.fast_sync,
            cfg.consensus.timeout_propose, cfg.mempool.size)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_testnet_tree_builds_the_other_packages_node(tmp_path, writer):
    W, R = (JAX, PORT) if writer == "jax" else (PORT, JAX)
    base = procnet.free_block(8)
    _tree(W, tmp_path, base)
    home = str(tmp_path / "node1")
    assert _view(R.config.default_config(home)) == \
        _view(W.config.default_config(home))
    cfg = json.load(open(os.path.join(home, "config", "config.json")))
    cfg["base"]["verifier_backend"] = "python"
    json.dump(cfg, open(os.path.join(home, "config", "config.json"), "w"))
    node = R.node.default_node(home, with_p2p=True)
    try:
        node.start()
        gen = R.gen.GenesisDoc.load(os.path.join(home, "config",
                                                 "genesis.json"))
        assert len(gen.validators) == 4 and gen.chain_id == "tree"
        assert str(node.switch.listen_address).endswith(f":{base + 2}")
        assert node.pex_reactor is not None and node.switch.addr_book
    finally:
        node.stop()
        R.clock.set_source(None)


def test_jax_base_keys_reach_the_port_settings(tmp_path):
    _tree(JAX, tmp_path, 47500)
    home = str(tmp_path / "node0")
    path = os.path.join(home, "config", "config.json")
    cfg = tconfig.default_config(home)
    assert (cfg.p2p.burst, cfg.p2p.burst_max, cfg.consensus.compact,
            cfg.consensus.vote_agg) == (True, 64, True, True)
    obj = json.load(open(path))
    obj["base"].update(p2p_burst="off", compact="off", vote_agg="off",
                       telemetry=False, pipeline="off", reactor="threads")
    json.dump(obj, open(path, "w"))
    cfg = tconfig.default_config(home)
    assert (cfg.p2p.burst, cfg.consensus.compact,
            cfg.consensus.vote_agg) == (False, False, False)
    obj["base"].update(p2p_burst="16", compact="on")
    json.dump(obj, open(path, "w"))
    cfg = tconfig.default_config(home)
    assert (cfg.p2p.burst, cfg.p2p.burst_max, cfg.consensus.compact) == \
        (True, 16, True)
    # the port writes the JAX keys back
    cfg.p2p.burst, cfg.consensus.vote_agg = False, False
    tconfig.save_config(cfg)
    j = jconfig.default_config(home)
    assert (j.base.p2p_burst, j.base.compact, j.base.vote_agg,
            j.p2p.persistent_peers) == ("off", "on", "off",
                                        cfg.p2p.persistent_peers)


@pytest.mark.parametrize("edit", ["jax_keys", "port_fields"])
def test_edited_settings_of_a_port_written_tree_reach_the_node(tmp_path,
                                                               edit):
    """A port-written tree holds each of the four settings once, under
    its JAX `base` key; an edit of that key, or the port's own field
    written into its section, reaches the node's switch and reactor."""
    _tree(PORT, tmp_path, procnet.free_block(8))
    home = str(tmp_path / "node2")
    path = os.path.join(home, "config", "config.json")
    obj = json.load(open(path))
    assert not {"burst", "burst_max"} & set(obj["p2p"])
    assert not {"compact", "vote_agg"} & set(obj["consensus"])
    assert (obj["base"]["p2p_burst"], obj["base"]["compact"]) == ("on", "on")
    obj["base"]["verifier_backend"] = "python"
    if edit == "jax_keys":
        obj["base"].update(p2p_burst="off", p2p_burst_max=8, compact="off",
                           vote_agg="off")
    else:
        obj["p2p"].update(burst=False, burst_max=8)
        obj["consensus"].update(compact=False, vote_agg=False)
    json.dump(obj, open(path, "w"))
    node = tnode.default_node(home, with_p2p=True)
    try:
        node.start()
        assert node.switch.burst.resolve() == (False, 1)
        assert node.switch.burst.max_packets == 8
        assert (node.consensus_reactor._compact,
                node.consensus_reactor._voteagg) == (False, False)
    finally:
        node.stop()
        tclock.set_source(None)


def test_node_without_a_device_raises_unless_python(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from tendermint_tpu_torch.models import verifier
    saved = verifier._default
    verifier.set_default_verifier(None)
    try:
        for backend in ("auto", "cuda"):
            cfg = node_config(PORT)
            cfg.base.verifier_backend = backend
            with pytest.raises(RuntimeError, match="no CUDA device"):
                tnode.Node(cfg, genesis(PORT)[1], in_memory=True)
    finally:
        verifier.set_default_verifier(saved)
    node = tnode.Node(node_config(PORT), genesis(PORT)[1], in_memory=True)
    assert node.verifier.backend == "python"
    node.stop()


# the halting error propagates in the thread that fed the state machine
# (here the timeout ticker's), as ConsensusState.submit re-raises it
@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_a_failed_device_verify_halts_the_node(monkeypatch):
    """A launch or a wait that fails on the card raises VerifierError
    (no fallback to the plain versions), and the node's state machine
    halts on it through fatal_error, as `cli node` reads it."""
    from tendermint_tpu_torch.models import verifier as tverifier
    v = tverifier.BatchVerifier("cuda", device="cpu")
    items = [(b"\x00" * 32, b"m", b"\x00" * 64)] * 3

    def failing_launch(*a):
        raise RuntimeError("tm_ladder_verify launch failed: 719")
    monkeypatch.setattr(v, "_stream", object())
    monkeypatch.setattr(v, "_dispatch_cuda", failing_launch)
    with pytest.raises(tverifier.VerifierError, match="launch failed"):
        v.verify(items)

    def failing_wait(*a):
        def resolve():
            raise RuntimeError("CUDA error: an illegal memory access")
        return resolve
    monkeypatch.setattr(v, "_dispatch_cuda", failing_wait)
    resolve = v.verify_async(items)
    with pytest.raises(tverifier.VerifierError, match="illegal memory"):
        resolve()

    key, gen = genesis(PORT)
    node = tnode.Node(node_config(PORT), gen, in_memory=True,
                      priv_validator=tpv.PrivValidator(tpv.LocalSigner(key)))

    def failing(items):
        raise tverifier.VerifierError("verify failed on cuda:0")
    monkeypatch.setattr(node.verifier, "verify_async", failing)
    try:
        try:
            node.start()      # the first height's own votes verify here
        except tverifier.VerifierError:
            pass
        t0 = time.monotonic()
        while node.consensus.fatal_error is None:
            assert time.monotonic() - t0 < 10
            time.sleep(0.01)
    finally:
        node.stop()
    assert isinstance(node.consensus.fatal_error, tverifier.VerifierError)
    assert node.height == 0


# ------------------------------------------------------ the socket plane

def _plane_net(reactor: str, coalesce: str):
    """Two port validators in one process, in-memory, on `reactor`, the
    second dialling the first."""
    keys = [tkeys.PrivKey.generate(bytes([0x31 + i]) * 32) for i in range(2)]
    gen = tgen.GenesisDoc(
        chain_id="plane", genesis_time_ns=T0,
        validators=[tgen.GenesisValidator(k.pubkey.ed25519, 10)
                    for k in keys])
    nodes = []
    for k in keys:
        cfg = tconfig.test_config()
        cfg.base.verifier_backend = "python"
        cfg.base.reactor = reactor
        cfg.base.verifier_coalesce = coalesce
        cfg.p2p.laddr = "tcp://127.0.0.1:0"
        cfg.p2p.pex = False
        nodes.append(tnode.Node(
            cfg, gen, priv_validator=tpv.PrivValidator(tpv.LocalSigner(k)),
            in_memory=True, with_p2p=True))
    return nodes


@pytest.mark.parametrize("reactor,coalesce", [("auto", "auto"),
                                              ("threads", "off")])
def test_two_node_net_runs_the_configured_plane(reactor, coalesce):
    """The default plane ("auto") runs one tm-reactor-loop thread a node
    and no per-peer thread (mconn-, gossip-, mempool-bcast-), with every
    peer a LoopMConnection and a coalescing verifier; "threads" with
    coalescing off is the plane before the event loop: no loop, threaded
    MConnections and gossip threads, every verify a direct call."""
    import threading
    from tendermint_tpu_torch.p2p.conn.loop import LoopMConnection
    from tendermint_tpu_torch.p2p.conn.mconn import MConnection
    # the Thread objects, not their idents: the OS reuses the ident of a
    # thread that ended, and a new loop thread could take one of them
    before = set(threading.enumerate())
    nodes = _plane_net(reactor, coalesce)
    try:
        for n in nodes:
            n.start()
        nodes[1].switch.dial_peer(nodes[0].switch.listen_address)
        t0 = time.monotonic()
        while min(n.height for n in nodes) < 3:
            assert time.monotonic() - t0 < 60, [n.height for n in nodes]
            time.sleep(0.02)
        new = [t.name for t in threading.enumerate()
               if t not in before]
        per_peer = [x for x in new
                    if x.startswith(("mconn-", "gossip-", "mempool-bcast-"))]
        loops = [x for x in new if x.startswith("tm-reactor-loop")]
        for n in nodes:
            peer = n.switch.peers.list()[0]
            v = n.verifier.stats
            if reactor == "auto":
                assert n.reactor == "loop" and n.loop.running
                assert type(peer.mconn) is LoopMConnection
                assert n.verifier.coalesce == "auto"
                assert v["coalesced_calls"] > 0
                st = n.verifier.coalescer_stats()
                assert st["merged_calls"] <= st["submissions"] == \
                    v["coalesced_calls"]
            else:
                assert n.reactor == "threads" and n.loop is None
                assert type(peer.mconn) is MConnection
                assert v["coalesced_calls"] == 0
                assert v["calls"] == v["direct_calls"] > 0
        if reactor == "auto":
            assert per_peer == [] and len(loops) == 2, new
        else:
            assert loops == [] and len(per_peer) >= 2 * 5, new
        assert tcli.thread_census()["tm-reactor-loop"] >= len(loops)
    finally:
        for n in nodes:
            n.stop()
    assert all(n.loop is None or not n.loop.running for n in nodes)


def test_plane_settings_of_a_jax_tree_reach_the_port_node(tmp_path):
    """`reactor` and `verifier_coalesce*` are the JAX `base` keys; a
    value outside their sets refuses the config at load, as the JAX
    node refuses it when it builds its loop and its verifier."""
    _tree(JAX, tmp_path, 47700)
    home = str(tmp_path / "node0")
    path = os.path.join(home, "config", "config.json")
    cfg = tconfig.default_config(home)
    assert (cfg.base.reactor, cfg.base.verifier_coalesce,
            cfg.base.verifier_coalesce_wait_ms,
            cfg.base.verifier_coalesce_max_batch) == ("auto", "auto", 2.0, 0)
    obj = json.load(open(path))
    obj["base"].update(reactor="threads", verifier_coalesce="off",
                       verifier_coalesce_wait_ms=3.5,
                       verifier_coalesce_max_batch=64,
                       verifier_backend="python")
    json.dump(obj, open(path, "w"))
    cfg = tconfig.default_config(home)
    j = jconfig.default_config(home)
    assert (cfg.base.reactor, cfg.base.verifier_coalesce,
            cfg.base.verifier_coalesce_wait_ms,
            cfg.base.verifier_coalesce_max_batch) == \
        (j.base.reactor, j.base.verifier_coalesce,
         j.base.verifier_coalesce_wait_ms,
         j.base.verifier_coalesce_max_batch) == ("threads", "off", 3.5, 64)
    node = tnode.default_node(home, with_p2p=True)
    try:
        assert node.reactor == "threads" and node.loop is None
        assert node.verifier.coalesce == "off"
        assert node._owns_verifier
    finally:
        node.stop()
    for key, bad in (("reactor", "fibers"), ("verifier_coalesce", "maybe"),
                     ("verifier_coalesce_wait_ms", -1)):
        obj2 = json.loads(json.dumps(obj))
        obj2["base"][key] = bad
        json.dump(obj2, open(path, "w"))
        with pytest.raises(ValueError):
            tconfig.default_config(home)


def _restart_after_a_crash_before_the_update(P, home):
    """A node of package P whose last stored block holds txs that its tx
    WAL still holds, as after a SIGKILL between the block's save and the
    mempool's update: the rebuilt node's pending txs, and the block's."""
    single_node(P, home=home).stop()
    P.clock.set_source(None)
    key, gen = genesis(P)
    pv_path = os.path.join(home, "pv.json")
    holder = []
    height_clock(P, holder)
    node = P.node.Node(node_config(P, home), gen,
                       priv_validator=P.pv.PrivValidatorFile.load(pv_path))
    holder.append(node)
    inner = node.mempool.update
    crash_txs = [b"crash=1"]

    def update(height, txs):
        inner(height, txs)
        if crash_txs[0] in txs:
            # the state machine ends with this block: no proof block
            node.consensus._stopped = True
    node.mempool.update = update
    for tx in crash_txs:
        node.mempool.check_tx(tx)
    try:
        node.start()
        t0 = time.monotonic()
        while not node.consensus._stopped:
            assert time.monotonic() - t0 < 30
            time.sleep(0.01)
        top = node.block_store.height()
        txs = list(node.block_store.load_block(top).data.txs)
    finally:
        node.stop()
        P.clock.set_source(None)
    with open(os.path.join(home, "data", "mempool.wal", "wal"), "ab") as f:
        for tx in txs:                  # the WAL as the crash left it
            f.write(len(tx).to_bytes(4, "big") + tx)
    node = P.node.Node(node_config(P, home), gen,
                       priv_validator=P.pv.PrivValidatorFile.load(pv_path))
    try:
        return [bytes(t) for t in node.mempool.reap(-1)], txs
    finally:
        node.stop()


def test_a_crash_before_the_mempool_update_does_not_replay_the_block(
        tmp_path):
    """A fault of the reference the port fixes (ROADMAP Queue 3): the
    tx WAL is rewritten by the mempool's update after each commit, and
    replayed at start; a SIGKILL between a block's save and that update
    leaves the block's txs in the WAL, so the restarted JAX node holds
    them pending again and proposes them at its next turn (committed
    twice). The port's node drops its last stored block's txs after
    the replay."""
    port, txs = _restart_after_a_crash_before_the_update(
        PORT, str(tmp_path / "port"))
    jax, jtxs = _restart_after_a_crash_before_the_update(
        JAX, str(tmp_path / "jax"))
    assert txs == jtxs == [b"crash=1"]
    assert port == []
    assert jax == txs
