"""CLI (cmd/tendermint): the port's copy of `tendermint_tpu/cli.py`.

    python -m tendermint_tpu_torch.cli --home <h> init
    python -m tendermint_tpu_torch.cli testnet --n 4 --output <dir>
    python -m tendermint_tpu_torch.cli --home <h> node --p2p \\
        --rpc-laddr tcp://127.0.0.1:<port>

Commands: init, node, testnet, lite, replica, shardset, show_validator,
show_node_id, gen_validator, unsafe_reset_all,
unsafe_reset_priv_validator, version, replay, replay_console and
probe_upnp. `node`, `lite`, `replica`, `shardset` and the replays
take `--device` (cuda, cuda:N or cpu), the device of the BatchVerifier
(and of the kvstore's state tree, with TM_CUDA_STATE_TREE on): without
it the node runs on the card and, with no card, exits non-zero unless
the config's `verifier_backend` is "python" (and the tree is off). A
node serves the gRPC BroadcastAPI when config.json's `rpc.grpc_laddr`
is set. `node` runs the
socket plane of `base.reactor` (the event loop by default, "threads" for
the thread plane). At each committed height and when it stops it prints
`node kernels {...}`: its kernel launches (ops/ladder.launches), its
verifier's and coalescer's counts, the RPC front door's tx batcher and
the process's threads by name prefix, with the event loop's busy share,
the pipeline's counts (`pipeline.stats()`) and the native host cores'
routes (part sets built natively or in Python, canonical-JSON calls and
their fallbacks, kvstore blocks on the kv core and on the per-tx route)
and the recovery plane's counts (`Node.recovery_counts`: the state-sync
restore, snapshots published, heights pruned, the base of both stores),
the verifier's metric families read at the same moment, and the state
tree's commits (`statetree`: SHA-256 batches by route, commits and
their seconds, dirty leaves).
`node --state-sync` turns `base.state_sync` on: a node at height 0 with
fast sync joins by a snapshot restore over p2p (after `unsafe_reset_all`,
say); the JAX CLI exports TM_TPU_STATE_SYNC for the same.

`node` with TM_CUDA_NODE_PROFILE=<path> samples every thread's frame
with SIGPROF and writes the top frames there on exit (the JAX CLI's
TM_NODE_PROFILE).

`lite` is the light-client proxy (cmd lite.go): it trusts the node's
commit at `--trust-height` (or its latest), certifies every block,
commit, validator set and tx it serves on `--laddr` through an
InquiringCertifier over CacheProvider(MemProvider, FileProvider(<home>/lite),
HTTPProvider) on a BatchVerifier("cuda") of `--device`, proxies the six
routes it cannot verify, and before it exits prints `lite kernels {...}`:
its kernel launches, its verifier's counts and its certifications.

`replica` runs an edge read replica (serving/edge.py): a node with NO
validator key following the chain over p2p (`--state-sync` joins by a
snapshot), serving reads only through its continuous certifier, on
`--rpc-laddr`; it refuses a home that holds a priv_validator.json and
prints `replica kernels {...}` (the node's kernel line with the
follower's status) at each certified height and when it stops.
`shardset` runs N chains behind one front door (serving/deploy.py
run_shardset) on `--laddr` and prints `shardset kernels {...}`; without
`--shards` it runs TM_CUDA_SHARDS > base.shards > 2 chains. Both take
`--device`; without a card and without `--device cpu` they exit 1.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time


def cmd_init(args) -> int:
    """Write genesis + priv validator + config skeleton (cmd init.go:48)."""
    from tendermint_tpu_torch.types.genesis import (GenesisDoc,
                                                    GenesisValidator)
    from tendermint_tpu_torch.types.priv_validator import PrivValidatorFile
    home = args.home
    cfg_dir = os.path.join(home, "config")
    os.makedirs(cfg_dir, exist_ok=True)
    pv_path = os.path.join(cfg_dir, "priv_validator.json")
    pv = PrivValidatorFile.load_or_generate(pv_path)
    gen_path = os.path.join(cfg_dir, "genesis.json")
    if not os.path.exists(gen_path):
        gen = GenesisDoc(
            chain_id=args.chain_id or f"test-chain-{int(time.time())}",
            genesis_time_ns=time.time_ns(),
            validators=[GenesisValidator(pv.pubkey.ed25519, 10)])
        gen.save(gen_path)
        print(f"initialized genesis at {gen_path}")
    else:
        print(f"genesis already exists at {gen_path}")
    print(f"priv validator at {pv_path}")
    return 0


#: thread-name prefixes of the census in `node kernels` lines
THREAD_PREFIXES = ("tm-reactor-loop", "mconn-", "gossip-", "mempool-bcast-",
                   "tm-rpc-", "tm-verify-coalesce")


def thread_census() -> dict:
    """Live threads of the process by name prefix, and all of them."""
    import threading
    names = [t.name for t in threading.enumerate()]
    out = {p: sum(1 for n in names if n.startswith(p))
           for p in THREAD_PREFIXES}
    out["total"] = len(names)
    return out


def _kernel_line(node, threads=None) -> str:
    """The process's kernel launches, its predecompression cache routes,
    the node verifier's and coalescer's counts, the tx batcher's, the
    thread census (`threads`: one taken before the node stopped), the
    event loop's, the pipeline's and the native routes' counts, at the
    node's height."""
    from tendermint_tpu_torch import pipeline
    from tendermint_tpu_torch.abci.apps import kvstore
    from tendermint_tpu_torch.ops import ed25519, ladder
    from tendermint_tpu_torch.types import encoding, part_set
    routes = ed25519.predecomp_stats()
    with node.verifier._stats_lock:
        vstats = dict(node.verifier.stats)
    batcher = getattr(node.rpc_core, "tx_batcher", None)
    loop = node.loop
    return json.dumps({
        "height": node.height, "launches": dict(ladder.launches),
        "routes": {k: routes[k] for k in ("full", "fill", "hit")},
        "verifier": vstats,
        "coalescer": node.verifier.coalescer_stats(),
        "device": str(node.verifier.device), "reactor": node.reactor,
        "tx_batcher": batcher.snapshot() if batcher is not None else None,
        "threads": threads or thread_census(),
        "loop": None if loop is None else {
            **loop.stats, "busy_share": loop.busy_share(),
            "fds": loop.n_fds, "tasks": loop.n_tasks},
        "pipeline": pipeline.stats(),
        "native": {"partsets": part_set.build_stats(),
                   "codec": encoding.stats(),
                   "kvstore": kvstore.route_stats()},
        "recovery": node.recovery_counts(),
        "telemetry": _telemetry_reading(),
        "statetree": _statetree_reading()})


def _statetree_reading() -> dict:
    """The state tree's families: the SHA-256 batches of its commits by
    route, its commits (the root refresh) and their dirty leaves."""
    from tendermint_tpu_torch import telemetry
    out = {"sha_batches": {
        impl: telemetry.value("merkle_sha_batches_total", {"impl": impl})
        or 0 for impl in ("device", "native", "host")}}
    for key, name in (("commits", "statetree_root_refresh_seconds"),
                      ("dirty_leaves", "statetree_dirty_leaves_per_commit")):
        v = telemetry.value(name) or {"count": 0, "sum": 0.0}
        out[key] = {"count": v["count"], "sum": v["sum"]}
    return out


def _telemetry_reading() -> dict:
    """The verifier's families as the registry holds them now (read
    beside the plain counts above, so that a stopped node's line holds
    both at one moment), by backend."""
    from tendermint_tpu_torch import telemetry
    out = {"enabled": telemetry.enabled(),
           "namespace": telemetry.namespace()}
    for key, name in (("calls", "verifier_calls_total"),
                      ("sigs", "verifier_sigs_total"),
                      ("dispatch", "verifier_dispatch_seconds")):
        out[key] = {}
        for backend in ("cuda", "python"):
            v = telemetry.value(name, {"backend": backend})
            if key == "dispatch":
                v = v or {"count": 0, "sum": 0.0}
                out[key][backend] = {"count": v["count"], "sum": v["sum"]}
            else:
                out[key][backend] = v or 0
    return out


def _maybe_node_profile() -> None:
    """TM_CUDA_NODE_PROFILE=<path>: a sampling profiler over EVERY
    thread (SIGPROF at ~97 Hz of CPU time, sys._current_frames) — the
    profiling story for multi-process nets, where each node samples
    itself and writes its top frames on exit. Parked threads surface as
    wait/accept/select rows (thread residency); the remaining rows are
    the CPU story. A thread blocked in a CUDA wait sits in C and is
    charged to its caller's frame."""
    from tendermint_tpu_torch.utils import knobs
    prof_path = knobs.knob_spec("TM_CUDA_NODE_PROFILE")
    if not prof_path:
        return
    import atexit
    import collections
    import signal as _signal
    samples = collections.Counter()

    def _sample(signum, frame):
        for fr in sys._current_frames().values():
            # leaf frame + its caller: enough to attribute cost
            co = fr.f_code
            caller = fr.f_back.f_code if fr.f_back else None
            samples[(co.co_filename, co.co_name,
                     caller.co_name if caller else "")] += 1

    _signal.signal(_signal.SIGPROF, _sample)
    _signal.setitimer(_signal.ITIMER_PROF, 0.0103, 0.0103)

    def _dump():
        _signal.setitimer(_signal.ITIMER_PROF, 0)
        total = sum(samples.values()) or 1
        with open(prof_path, "w") as f:
            f.write(f"# {total} samples (CPU time, all threads)\n")
            for (fn, name, caller), c in samples.most_common(60):
                f.write(f"{100*c/total:6.2f}% {name} <- {caller} "
                        f"({fn})\n")

    atexit.register(_dump)


def cmd_node(args) -> int:
    """Run a node (cmd run_node.go). With --p2p it listens, dials
    configured peers and serves RPC; otherwise it is a self-contained
    single-process validator."""
    from tendermint_tpu_torch.abci.apps import CounterApp, KVStoreApp
    from tendermint_tpu_torch.config import default_config
    from tendermint_tpu_torch.node import default_node
    from tendermint_tpu_torch.utils.log import setup_logging
    setup_logging(default_config(args.home).base.log_level)
    _maybe_node_profile()
    try:
        app = (KVStoreApp(device=args.device or None)
               if args.app == "kvstore" else CounterApp())
        node = default_node(args.home, app=app, with_p2p=args.p2p,
                            fast_sync=(args.fast_sync if args.p2p else False),
                            device=args.device or None,
                            state_sync=args.state_sync)
    except RuntimeError as e:
        # no card and no --device cpu: the node never moves to the CPU
        print(f"cannot start the node: {e}", file=sys.stderr, flush=True)
        return 1
    if args.p2p_laddr:
        node.config.p2p.laddr = args.p2p_laddr
    if args.rpc_laddr:
        node.config.rpc.laddr = args.rpc_laddr
        node.with_rpc = True
    if args.persistent_peers:
        node.config.p2p.persistent_peers = args.persistent_peers
    node.start()
    if node.switch is not None:
        print(f"p2p listening on {node.switch.listen_address}", flush=True)
    if node.rpc_address is not None:
        print(f"rpc listening on {node.rpc_address[0]}:"
              f"{node.rpc_address[1]}", flush=True)
    store_h, state_h = node.handshake_heights
    print(f"node started: chain={node.gen_doc.chain_id} "
          f"store_height={store_h} state_height={state_h} "
          f"height={node.height} handshake_s={node.handshake_s:.3f} "
          f"replayed={node.handshake_blocks}", flush=True)
    try:
        last = -1
        deadline = time.time() + args.max_seconds if args.max_seconds else None
        while True:
            time.sleep(0.2)
            fatal = node.consensus.fatal_error or getattr(
                getattr(node, "blockchain_reactor", None), "sync_error",
                None) or getattr(node.statesync_reactor, "restore_error",
                                 None)
            if fatal is not None:
                # consensus, fast sync or a state-sync restore halted
                # unrecoverably (the reference panics; a failed kernel
                # launch lands here too): die loudly rather than sit at
                # a frozen height
                print(f"CONSENSUS FAILURE: {fatal!r}", flush=True)
                census = thread_census()
                node.stop()
                print(f"node kernels {_kernel_line(node, census)}",
                      flush=True)
                return 1
            if node.height != last:
                last = node.height
                print(f"committed height={last} "
                      f"app_hash={node.consensus.state.app_hash.hex()[:16]}",
                      flush=True)
                # the counts so far: a process killed without its stop
                # line leaves these behind
                print(f"node kernels {_kernel_line(node)}", flush=True)
            if deadline and time.time() > deadline:
                break
            if args.max_height and node.height >= args.max_height:
                break
    except KeyboardInterrupt:
        pass
    # the census of the running node: its stop joins the threads
    census = thread_census()
    node.stop()
    print(f"node stopped at height {node.height}", flush=True)
    print(f"node kernels {_kernel_line(node, census)}", flush=True)
    return 0


def cmd_show_validator(args) -> int:
    from tendermint_tpu_torch.types.priv_validator import PrivValidatorFile
    pv = PrivValidatorFile.load(
        os.path.join(args.home, "config", "priv_validator.json"))
    print(json.dumps(pv.pubkey.to_obj()))
    return 0


def cmd_gen_validator(args) -> int:
    from tendermint_tpu_torch.types.keys import PrivKey
    key = PrivKey.generate()
    print(json.dumps({"priv_key": key.to_obj(),
                      "pub_key": key.pubkey.to_obj()}))
    return 0


def cmd_unsafe_reset_all(args) -> int:
    """Wipe data dir, keep genesis + reset priv validator height state."""
    for line in reset_all(args.home):
        print(line)
    return 0


def reset_all(home: str) -> list:
    """`unsafe_reset_all` on `home`; returns the lines the CLI prints."""
    data = os.path.join(home, "data")
    out = []
    if os.path.isdir(data):
        shutil.rmtree(data)
        out.append(f"removed {data}")
    return out + reset_priv_validator(home)


def cmd_unsafe_reset_priv_validator(args) -> int:
    """Reset ONLY the double-sign protection state (the reference's
    unsafe_reset_priv_validator, cmd reset_priv_validator.go) — for a
    validator that must re-join after losing its state, accepting the
    double-sign risk."""
    for line in reset_priv_validator(args.home):
        print(line)
    return 0


def reset_priv_validator(home: str) -> list:
    """`unsafe_reset_priv_validator` on `home`; returns the lines the CLI
    prints."""
    pv_path = os.path.join(home, "config", "priv_validator.json")
    if not os.path.exists(pv_path):
        return []
    from tendermint_tpu_torch.types.priv_validator import PrivValidatorFile
    pv = PrivValidatorFile.load(pv_path)
    pv.last_height = pv.last_round = pv.last_step = 0
    pv.last_sign_bytes = None
    pv.last_signature = None
    pv._persist()
    return [f"reset priv validator sign state at {pv_path}"]


def cmd_lite(args) -> int:
    """Light-client proxy daemon (cmd lite.go): serve a local RPC whose
    results are certified against the chain before they are returned."""
    from tendermint_tpu_torch.lite import (CacheProvider, FileProvider,
                                           HTTPProvider, InquiringCertifier,
                                           MemProvider, SecureClient)
    from tendermint_tpu_torch.models.verifier import BatchVerifier
    from tendermint_tpu_torch.node import _parse_laddr, prebuild
    from tendermint_tpu_torch.ops import ladder
    from tendermint_tpu_torch.rpc import JSONRPCClient, RPCServer

    try:
        verifier = BatchVerifier("cuda", device=args.device or None)
    except RuntimeError as e:
        # no card and no --device cpu: the proxy never moves to the CPU
        print(f"cannot start the lite proxy: {e}", file=sys.stderr,
              flush=True)
        return 1
    try:
        prebuild(verifier)
        rpc = JSONRPCClient(args.node_addr)
        source = HTTPProvider(rpc)
        trusted = source.get_by_height(args.trust_height) \
            if args.trust_height else source.latest_commit()
        if trusted is None:
            print("cannot fetch a trusted commit from the node")
            return 1
        # the node itself is the outermost provider: bisection must be
        # able to fetch intermediate commits, not only read the cache
        store = CacheProvider(
            MemProvider(), FileProvider(os.path.join(args.home, "lite")),
            source)
        chain_id = args.chain_id or \
            rpc.call("genesis")["genesis"]["chain_id"]
        cert = InquiringCertifier(chain_id, trusted, store,
                                  verifier=verifier)
        sc = SecureClient(rpc, cert)

        server = RPCServer()
        server.register("block", lambda height=0: sc.block(int(height)))
        server.register("commit", lambda height=0: sc.commit(int(height)))
        server.register("validators",
                        lambda height=0: sc.validators(int(height)))
        server.register("status", sc.status)
        server.register("tx", lambda hash=b"", prove=True: sc.tx(hash))
        # the unverifiable routes, proxied straight through
        for route in ("broadcast_tx_sync", "broadcast_tx_async",
                      "broadcast_tx_commit", "abci_info", "net_info",
                      "genesis"):
            server.register(
                route, (lambda r: lambda **kw: rpc.call(r, **kw))(route))
        host, port = server.serve(*_parse_laddr(args.laddr))
        print(f"lite proxy serving on {host}:{port} "
              f"(trusting height {cert.last_height})", flush=True)
        deadline = time.time() + args.max_seconds if args.max_seconds \
            else None
        try:
            while deadline is None or time.time() < deadline:
                time.sleep(0.5)
        except KeyboardInterrupt:
            pass
        server.stop()
        with verifier._stats_lock:
            vstats = dict(verifier.stats)
        print("lite kernels " + json.dumps({
            "launches": dict(ladder.launches), "verifier": vstats,
            "certify": dict(sc.stats), "trusted_height": trusted.height,
            "last_height": cert.last_height,
            "device": str(verifier.device)}), flush=True)
        return 0
    finally:
        verifier.close()


def cmd_replica(args) -> int:
    """Run an edge read replica (serving/edge.py): a follower node with
    NO validator key serving lite-certified reads."""
    from tendermint_tpu_torch.serving.edge import run_replica
    return run_replica(args)


def cmd_shardset(args) -> int:
    """Run one sharded front-door process (serving/deploy.py)."""
    from tendermint_tpu_torch.serving.deploy import run_shardset
    return run_shardset(args)


def cmd_version(args) -> int:
    from tendermint_tpu_torch import __version__
    print(__version__)
    return 0


def cmd_probe_upnp(args) -> int:
    """cmd/tendermint/commands/probe_upnp.go: discover an IGD and report
    its capabilities as JSON."""
    from tendermint_tpu_torch.p2p import upnp
    try:
        report = upnp.probe(timeout=args.timeout)
    except upnp.UPnPError as e:
        print(json.dumps({"ok": False, "error": str(e)}))
        return 1
    print(json.dumps({"ok": True, "capabilities": report}))
    return 0


def cmd_show_node_id(args) -> int:
    from tendermint_tpu_torch.p2p import NodeKey
    nk = NodeKey.load_or_generate(
        os.path.join(args.home, "config", "node_key.json"))
    print(nk.id())
    return 0


def cmd_testnet(args) -> int:
    """Emit an N-validator testnet file tree (cmd testnet.go:97)."""
    out = args.output or args.home
    chain_id = args.chain_id or f"testnet-{int(time.time())}"
    write_testnet(out, args.n, chain_id, args.base_port)
    print(f"wrote {args.n}-node testnet (chain {chain_id}) under {out}")
    return 0


def write_testnet(out: str, n: int, chain_id: str, base_port: int) -> None:
    """`cli testnet`'s tree under `out`: a shared genesis listing every
    validator, per-node priv_validator + node_key + config.json with
    persistent_peers wired to all other nodes (process k on ports
    base_port + 2k and + 2k + 1)."""
    from tendermint_tpu_torch.config import default_config, save_config
    from tendermint_tpu_torch.p2p import NodeKey
    from tendermint_tpu_torch.types.genesis import (GenesisDoc,
                                                    GenesisValidator)
    from tendermint_tpu_torch.types.priv_validator import PrivValidatorFile

    pvs, node_keys = [], []
    for i in range(n):
        home = os.path.join(out, f"node{i}")
        cfg_dir = os.path.join(home, "config")
        os.makedirs(cfg_dir, exist_ok=True)
        pvs.append(PrivValidatorFile.load_or_generate(
            os.path.join(cfg_dir, "priv_validator.json")))
        node_keys.append(NodeKey.load_or_generate(
            os.path.join(cfg_dir, "node_key.json")))
    gen = GenesisDoc(
        chain_id=chain_id, genesis_time_ns=time.time_ns(),
        validators=[GenesisValidator(pv.pubkey.ed25519, 10) for pv in pvs])
    for i in range(n):
        home = os.path.join(out, f"node{i}")
        gen.save(os.path.join(home, "config", "genesis.json"))
        cfg = default_config(home)
        cfg.p2p.laddr = f"tcp://127.0.0.1:{base_port + 2 * i}"
        cfg.rpc.laddr = f"tcp://127.0.0.1:{base_port + 2 * i + 1}"
        cfg.p2p.addr_book_strict = False
        cfg.p2p.persistent_peers = ",".join(
            f"{node_keys[j].id()}@127.0.0.1:{base_port + 2 * j}"
            for j in range(n) if j != i)
        save_config(cfg)


def cmd_replay(args, console: bool = False) -> int:
    """Step through the consensus WAL against a fresh state machine
    (consensus/replay_file.go:32 RunReplayFile). --console pauses for
    ENTER between messages and accepts 'quit'."""
    from tendermint_tpu_torch.config import default_config
    from tendermint_tpu_torch.consensus.replay import (replay_messages,
                                                       wal_tail_for)
    from tendermint_tpu_torch.node import Node
    from tendermint_tpu_torch.storage import WALCorruptionError
    from tendermint_tpu_torch.types.genesis import GenesisDoc

    config = default_config(args.home)
    gen_doc = GenesisDoc.load(
        os.path.join(args.home, "config", "genesis.json"))
    # readonly WAL: a writable open would trim a live writer's
    # in-flight frame and corrupt the log. NOTE this protects the WAL
    # only — the node handshake still opens the state/block stores
    # writable (as the reference's replay_file does), so the tool is
    # for stopped nodes / copied data dirs, not a running node's home.
    print("replay: do not run against a RUNNING node's data dir "
          "(stores open writable; the WAL itself is opened read-only)",
          file=sys.stderr)
    node = Node(config, gen_doc, priv_validator=None, wal_readonly=True,
                device=args.device or None)
    cs, wal = node.consensus, node.wal
    height = cs.state.last_block_height
    # same tail selection as node-start catchup (incl. the legacy
    # genesis fallback) so this debugging tool reproduces the node
    try:
        tail = wal_tail_for(wal, height)
    except (ValueError, WALCorruptionError) as e:
        print(f"cannot replay: {e}")
        node.stop()
        return 1
    if tail is None:
        print(f"WAL has no messages after height {height}")
        node.stop()
        return 1

    def before_submit(msg):
        if console:
            cmdline = input(
                f"> next: {msg.get('type')} (ENTER to apply, q to quit) ")
            if cmdline.strip().lower() in ("q", "quit"):
                return False
        return True

    def after_submit(msg):
        print(f"replayed {msg.get('type')} -> "
              f"H/R/S {cs.rs.height}/{cs.rs.round}/{int(cs.rs.step)}")

    # the feed loop itself is replay_messages — the SAME code node
    # startup runs, so what this tool shows is what recovery does
    n = replay_messages(cs, tail, before_submit=before_submit,
                        after_submit=after_submit)
    print(f"replayed {n} messages; final height {cs.rs.height}")
    node.stop()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tendermint_tpu_torch")
    p.add_argument("--home",
                   default=os.path.expanduser("~/.tendermint_tpu"))
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("init", help="initialize genesis + priv validator")
    sp.add_argument("--chain-id", default="")
    sp.set_defaults(fn=cmd_init)

    device_help = ("the verifier's device: cuda, cuda:N or cpu (default: "
                   "the current CUDA device; without one only the "
                   "python backend runs)")
    sp = sub.add_parser("node", help="run a node")
    sp.add_argument("--app", default="kvstore",
                    choices=["kvstore", "counter"])
    sp.add_argument("--max-height", type=int, default=0)
    sp.add_argument("--max-seconds", type=float, default=0)
    sp.add_argument("--p2p", action="store_true",
                    help="run the networking stack")
    sp.add_argument("--no-fast-sync", dest="fast_sync",
                    action="store_false", default=True)
    sp.add_argument("--p2p-laddr", default="",
                    help="override p2p listen address")
    sp.add_argument("--rpc-laddr", default="",
                    help="serve RPC on this address")
    sp.add_argument("--persistent-peers", default="",
                    help="comma-separated id@host:port")
    sp.add_argument("--state-sync", action="store_true",
                    help="join via p2p snapshot restore (fresh nodes); "
                    "sets base.state_sync")
    sp.add_argument("--device", default="", help=device_help)
    sp.set_defaults(fn=cmd_node)

    sp = sub.add_parser("testnet",
                        help="write an N-validator testnet file tree")
    sp.add_argument("--n", type=int, default=4)
    sp.add_argument("--output", default="")
    sp.add_argument("--chain-id", default="")
    sp.add_argument("--base-port", type=int, default=46656)
    sp.set_defaults(fn=cmd_testnet)

    sp = sub.add_parser("replay", help="replay the consensus WAL")
    sp.add_argument("--device", default="", help=device_help)
    sp.set_defaults(fn=cmd_replay)

    sp = sub.add_parser("replay_console",
                        help="interactively replay the consensus WAL")
    sp.add_argument("--device", default="", help=device_help)
    sp.set_defaults(fn=lambda a: cmd_replay(a, console=True))

    sp = sub.add_parser("replica",
                        help="run an edge read replica (keyless "
                             "follower + lite-certified reads)")
    sp.add_argument("--app", default="kvstore",
                    choices=["kvstore", "counter"])
    sp.add_argument("--rpc-laddr", default="",
                    help="serve the replica RPC surface here")
    sp.add_argument("--persistent-peers", default="",
                    help="validators to follow (id@host:port,...)")
    sp.add_argument("--max-lag", type=int, default=0,
                    help="healthz staleness threshold in heights "
                         "(0 = TM_CUDA_EDGE_MAX_LAG / default)")
    sp.add_argument("--max-seconds", type=float, default=0)
    sp.add_argument("--state-sync", action="store_true",
                    help="bootstrap from a peer snapshot before "
                         "tailing via fast sync")
    sp.add_argument("--device", default="", help=device_help)
    sp.set_defaults(fn=cmd_replica)

    sp = sub.add_parser("shardset",
                        help="run N chains behind one sharded RPC "
                             "front door in this process")
    sp.add_argument("--shards", type=int, default=0,
                    help="chains (0: TM_CUDA_SHARDS > base.shards > 2)")
    sp.add_argument("--laddr", default="tcp://127.0.0.1:46657",
                    help="front-door RPC listen address")
    sp.add_argument("--max-seconds", type=float, default=0)
    sp.add_argument("--device", default="", help=device_help)
    sp.set_defaults(fn=cmd_shardset)

    sp = sub.add_parser("lite", help="light-client RPC proxy")
    sp.add_argument("--node-addr", default="http://127.0.0.1:46657")
    sp.add_argument("--laddr", default="tcp://127.0.0.1:8888")
    sp.add_argument("--chain-id", default="")
    sp.add_argument("--trust-height", type=int, default=0)
    sp.add_argument("--max-seconds", type=float, default=0)
    sp.add_argument("--device", default="",
                    help="the certifier's verifier device: cuda, cuda:N or "
                    "cpu (default: the current CUDA device)")
    sp.set_defaults(fn=cmd_lite)

    sub.add_parser("version").set_defaults(fn=cmd_version)

    sp = sub.add_parser("probe_upnp",
                        help="probe the local network for a UPnP IGD")
    sp.add_argument("--timeout", type=float, default=3.0)
    sp.set_defaults(fn=cmd_probe_upnp)
    sub.add_parser("show_validator").set_defaults(fn=cmd_show_validator)
    sub.add_parser("show_node_id").set_defaults(fn=cmd_show_node_id)
    sub.add_parser("gen_validator").set_defaults(fn=cmd_gen_validator)
    sub.add_parser("unsafe_reset_all").set_defaults(fn=cmd_unsafe_reset_all)
    sub.add_parser("unsafe_reset_priv_validator").set_defaults(
        fn=cmd_unsafe_reset_priv_validator)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
