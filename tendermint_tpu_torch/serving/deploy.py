"""Deployment driver: the port's copy of `tendermint_tpu/serving/deploy.py`.

Materialize a ``Topology`` into per-node homes, spawn one OS process a
node (``python -m tendermint_tpu_torch.cli``), supervise them (a process
that dies during the run is RESTARTED with the same argv, up to
``max_restarts`` times — the edge tier's processes are cattle),
optionally shape the validator WAN with the chaos WireProxy, and tear
the net down leak-clean.

Nodes are real OS processes over real TCP sockets, which is what the
open-loop harness (serving/loadgen.py) must be pointed at for its
numbers to say anything about a deployment.

``free_port_block`` and ``node_child_env`` are procnet's ``free_block``
and ``child_env`` (the JAX module takes its pair from ``bench_util``):
the child environment is this process's with the package's directory
first on PYTHONPATH, then ``topo.env``, ``child_env`` and the per-kind
overlay. ``stop()`` sends SIGINT first, so each CLI prints its last
kernel line, and SIGKILLs what is left after ``STOP_S`` (the JAX driver
sends SIGTERM).
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

from tendermint_tpu_torch import telemetry
from tendermint_tpu_torch.procnet import child_env as node_child_env
from tendermint_tpu_torch.procnet import free_block as free_port_block
from tendermint_tpu_torch.procnet import print_log_tail
from tendermint_tpu_torch.serving.topology import (ProcSpec, Topology,
                                                   materialize)

_m_restarts = telemetry.counter(
    "deploy_restarts_total",
    "Deployment-driver process restarts after a crash, by node kind",
    ("kind",))
_m_procs = telemetry.gauge(
    "deploy_procs", "Processes currently supervised by the driver")

STOP_S = 20.0   # stop()'s wait for the SIGINTed processes


class Deployment:
    """Spawn, supervise and tear down one materialized topology.

    Lifecycle: ``start()`` -> (run / crash-restart under supervision)
    -> ``stop()``. ``clients()`` hands back one JSONRPCClient per
    process; ``wait(pred, ...)`` is the standard boot/progress gate. A
    process that exits non-zero unasked (a signal included; not one
    ``kill()`` ended) has the last lines of its log printed to stdout
    before it is respawned or its directory removed.
    """

    def __init__(self, topo: Topology, out_dir: str,
                 child_env: Optional[dict] = None,
                 kind_env: Optional[Dict[str, dict]] = None,
                 max_restarts: int = 3):
        if topo.base_port <= 0:
            topo.base_port = free_port_block(2 * topo.n_processes())
        self.topo = topo
        self.out_dir = out_dir
        self.specs: List[ProcSpec] = materialize(topo, out_dir)
        self.env = node_child_env(topo.env)
        self.env.update(child_env or {})
        # per-kind env overlays, e.g. an admission envelope
        # (TM_CUDA_RPC_RATE) on replica processes only
        self.kind_env = kind_env or {}
        self.max_restarts = max_restarts
        self.restarts: Dict[str, int] = {}
        self.dead: Dict[str, int] = {}       # name -> exit code, gave up
        self._procs: Dict[str, subprocess.Popen] = {}
        self._logs: Dict[str, object] = {}
        self._killed: set = set()   # pids killed on purpose
        self._proxy = None
        self._stopping = False
        self._supervisor: Optional[threading.Thread] = None

    # ------------------------------------------------------- lifecycle

    def start(self) -> "Deployment":
        if self.topo.wire and self.topo.kind == "validators":
            self._wire_up()
        for spec in self.specs:
            self._spawn(spec)
        _m_procs.set(len(self._procs))
        self._supervisor = threading.Thread(
            target=self._supervise, daemon=True, name="tm-deploy-sup")
        self._supervisor.start()
        return self

    def _spawn(self, spec: ProcSpec) -> None:
        log = self._logs.get(spec.name)
        if log is None:
            log = open(os.path.join(spec.home, "node.log"), "a+")
            self._logs[spec.name] = log
        env = self.env
        if spec.kind in self.kind_env:
            env = dict(env)
            env.update(self.kind_env[spec.kind])
        self._procs[spec.name] = subprocess.Popen(
            spec.argv, env=env, stdout=log, stderr=subprocess.STDOUT,
            cwd=self.out_dir)

    def _wire_up(self) -> None:
        """Route every validator<->validator p2p link through the chaos
        WireProxy so the configured fault spec is the WAN shape BETWEEN
        processes; replicas keep dialing validators' real listeners
        (they model co-located edge boxes)."""
        from tendermint_tpu_torch.chaos.wire import proxy_for_testnet
        from tendermint_tpu_torch.p2p import NodeKey
        n = self.topo.n_validators
        self._proxy, _ = proxy_for_testnet(
            self.topo.wire, self.topo.wire_seed, n,
            p2p_port=lambda j: self.specs[j].p2p_port)
        keys = [NodeKey.load_or_generate(os.path.join(
            self.specs[j].home, "config", "node_key.json"))
            for j in range(n)]
        for i in range(n):
            cfg_path = os.path.join(self.specs[i].home, "config",
                                    "config.json")
            with open(cfg_path) as f:
                cfg = json.load(f)
            cfg["p2p"]["persistent_peers"] = ",".join(
                f"{keys[j].id()}@127.0.0.1:{self._proxy.ports[(i, j)]}"
                for j in range(n) if j != i)
            # PEX would learn the direct addresses and route around
            # the proxy
            cfg["p2p"]["pex"] = False
            with open(cfg_path, "w") as f:
                json.dump(cfg, f)
        self._proxy.start()

    def _supervise(self) -> None:
        """Crash/restart loop: a process that exits while the deployment
        is live is respawned with its own argv (bounded per process);
        exhausted processes are recorded in ``dead``."""
        by_name = {s.name: s for s in self.specs}
        while not self._stopping:
            for name, proc in list(self._procs.items()):
                rc = proc.poll()
                if rc is None or self._stopping:
                    continue
                if name in self.dead:
                    continue
                self._print_failed(name, proc)
                n = self.restarts.get(name, 0)
                if n >= self.max_restarts:
                    self.dead[name] = rc
                    continue
                self.restarts[name] = n + 1
                _m_restarts.labels(by_name[name].kind).inc()
                self._spawn(by_name[name])
            _m_procs.set(sum(1 for p in self._procs.values()
                             if p.poll() is None))
            time.sleep(0.5)

    def stop(self, cleanup: bool = True) -> None:
        self._stopping = True
        if self._supervisor is not None:
            self._supervisor.join(timeout=5)
        for proc in self._procs.values():
            if proc.poll() is None:
                proc.send_signal(signal.SIGINT)
        deadline = time.monotonic() + STOP_S
        for proc in self._procs.values():
            try:
                proc.wait(max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
        for name, proc in self._procs.items():
            self._print_failed(name, proc)
        if self._proxy is not None:
            self._proxy.stop()
            self._proxy = None
        for log in self._logs.values():
            log.close()
        self._logs.clear()
        _m_procs.set(0)
        if cleanup:
            shutil.rmtree(self.out_dir, ignore_errors=True)

    # --------------------------------------------------------- access

    def spec(self, name: str) -> ProcSpec:
        for s in self.specs:
            if s.name == name:
                return s
        raise KeyError(name)

    def alive(self, name: str) -> bool:
        p = self._procs.get(name)
        return p is not None and p.poll() is None

    def kill(self, name: str) -> None:
        """Hard-kill one process (the supervisor will restart it)."""
        self._killed.add(self._procs[name].pid)
        self._procs[name].kill()

    def _print_failed(self, name: str, proc) -> None:
        """The log tail of a process that exited non-zero unasked (a
        signal included), before the supervisor respawns it into the
        same log or stop() removes the directory."""
        if proc.returncode and proc.pid not in self._killed:
            self._killed.add(proc.pid)   # printed once
            print_log_tail(f"deploy {name} (pid {proc.pid}) exited "
                           f"{proc.returncode}",
                           os.path.join(self.spec(name).home, "node.log"))

    def clients(self, kind: Optional[str] = None) -> list:
        from tendermint_tpu_torch.rpc.client import JSONRPCClient
        return [JSONRPCClient(s.rpc_address) for s in self.specs
                if kind is None or s.kind == kind]

    def log_tail(self, name: str, n: int = 1500) -> str:
        log = self._logs.get(name)
        if log is None:
            return ""
        log.flush()
        log.seek(0)
        return log.read()[-n:]

    # ---------------------------------------------------------- waits

    def wait(self, pred, timeout_s: float, what: str,
             kind: Optional[str] = None) -> None:
        """Wait until pred(client) holds for every process of `kind`
        (all when None). Raises with log tails on timeout or when a
        process dies past its restart budget."""
        from tendermint_tpu_torch.rpc.client import RPCClientError
        clients = self.clients(kind)
        names = [s.name for s in self.specs
                 if kind is None or s.kind == kind]
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.dead:
                break
            try:
                if all(pred(c) for c in clients):
                    return
            except (OSError, ConnectionError, RPCClientError, KeyError):
                pass    # not up yet / route not registered yet
            time.sleep(0.5)
        tails = "\n".join(f"--- {n} ---\n{self.log_tail(n)}"
                          for n in names)
        raise RuntimeError(
            f"{what}: dead={self.dead} restarts={self.restarts}\n{tails}")

    def wait_height(self, h: int, timeout_s: float = 120.0,
                    kind: str = "validator") -> None:
        self.wait(lambda c: c.call("status")["latest_block_height"] >= h,
                  timeout_s, f"no progress to height {h}", kind=kind)


def _shardset_line(ss) -> str:
    """The shard-set process's counts: heights, kernel launches, the
    shared verifier's and its coalescer's counts, and its device."""
    from tendermint_tpu_torch.ops import ladder
    v = ss.verifier
    with v._stats_lock:
        vstats = dict(v.stats)
    return json.dumps({
        "heights": ss.heights(), "launches": dict(ladder.launches),
        "verifier": vstats, "coalescer": v.coalescer_stats(),
        "device": str(v.device)})


def shard_count(shards: Optional[int], home: str = "") -> int:
    """`cli shardset`'s chain count: `--shards` when above 0, else
    TM_CUDA_SHARDS > base.shards of `home`'s config.json > 2 (the
    flag's default in the JAX CLI)."""
    from tendermint_tpu_torch.config import default_config
    from tendermint_tpu_torch.shard import resolve_shards
    return shards or resolve_shards(default_config(home).base.shards) or 2


def run_shardset(args) -> int:
    """`cli shardset`: one process assembling N chains (shard_count)
    behind one front door (shard/set.py) on `--device` (the card by
    default; without one it exits 1). Chains run the test consensus
    profile, with on-disk homes under --home when given. It prints
    `shardset kernels {...}` at most once a second while the frontier
    moves, and when it stops."""
    from tendermint_tpu_torch.node import _parse_laddr
    from tendermint_tpu_torch.shard.set import ShardSet

    try:
        ss = ShardSet(n_shards=shard_count(args.shards, args.home or ""),
                      home=(args.home or None),
                      device=getattr(args, "device", "") or None)
    except RuntimeError as e:
        print(f"cannot start the shard set: {e}", file=sys.stderr,
              flush=True)
        return 1
    ss.start()
    host, port = ss.serve(*_parse_laddr(args.laddr))
    print(f"shardset front door on {host}:{port} "
          f"(chains: {','.join(ss.chains)})", flush=True)
    deadline = (time.time() + args.max_seconds
                if args.max_seconds else None)
    last, printed = -1, 0.0
    try:
        while deadline is None or time.time() < deadline:
            time.sleep(0.5)
            f = ss.frontier()
            if f != last:
                last = f
                print(f"frontier height={f}", flush=True)
                if time.monotonic() - printed >= 1.0:
                    printed = time.monotonic()
                    print(f"shardset kernels {_shardset_line(ss)}",
                          flush=True)
    except KeyboardInterrupt:
        pass
    ss.stop()
    print(f"shardset stopped at frontier {last}", flush=True)
    print(f"shardset kernels {_shardset_line(ss)}", flush=True)
    return 0
