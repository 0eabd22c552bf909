"""A validator net of OS processes: BASELINE config 1 as the socket arm
of `bench_testnet.py` (`run_socket`, :401-540) runs it, on the port's
CLI, each node its own interpreter.

    net = ProcNet(root, base_port=port)
    net.write_tree(chain_id="c")          # cli testnet
    net.configure(bench_settings(verifier_backend="cuda"))
    net.start_all(extra=["--no-fast-sync"])
    net.wait_height(2, timeout_s=60)
    ... feed over net.ws(i) / net.rpc(i) ...
    net.kill(3); net.start(3)             # SIGKILL by pid, restart
    net.kill(3); net.reset(3)             # SIGKILL, cli unsafe_reset_all
    net.start(3, extra=["--state-sync"])  # rejoin by a snapshot restore
    codes = net.stop_all()                # SIGINT; exit codes
    net.kernel_lines(i)                   # counts of node i's processes

The tree comes from `python -m tendermint_tpu_torch.cli testnet` (a
shared genesis of N_NODES validators of power 10, per-node keys and a
config.json with persistent peers wired to all others); each node runs
`python -m <cli_module> --home nodeI node --p2p --rpc-laddr ...` with
its stdout and stderr in `nodeI.log`, the package's directory first on
its PYTHONPATH. `cli_of(i)` names node i's CLI
module, so another package's CLI that reads the same tree can run a
node of the net. Every process is started with subprocess.Popen (a
fresh interpreter, never a fork of one that holds a CUDA context),
killed by its pid only, and every process started is stopped by
stop_all().

Reads go over each node's JSON-RPC: heights from `status`, block hashes
and app hashes from `blockchain` metas, txs from `block`.

A node process that exits non-zero unasked (a signal such as SIGABRT's
-6 included; not one `kill()` ended) has the last TAIL_LINES lines of
its log printed to stdout, under a header naming it, when `wait_for`
finds it dead or `stop_all` reaps it: the caller's output keeps the
child's last words before the caller raises.
"""

from __future__ import annotations

import json
import os
import random
import re
import signal
import socket
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional

from tendermint_tpu_torch.rpc.client import JSONRPCClient, WSClient

PORT_CLI = "tendermint_tpu_torch.cli"
N_NODES = 4      # config 1's validators, one process each
STOP_S = 30.0    # stop_all's wait for the SIGINTed nodes
TAIL_LINES = 40  # log lines printed for a process that exits non-zero
#: the directory that holds the package, put on the nodes' PYTHONPATH
SRC_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def print_log_tail(what: str, path: str, start: int = 0,
                   n: int = TAIL_LINES) -> None:
    """Print the last `n` lines of the log at `path` (from byte `start`)
    to stdout under a header naming `what`."""
    try:
        with open(path, "rb") as f:
            f.seek(start)
            lines = f.read().decode(errors="replace").splitlines()[-n:]
    except OSError as e:
        lines = [f"(no log: {e})"]
    print(f"{what}: the last {len(lines)} lines of {path}:", *lines,
          sep="\n", flush=True)


def free_block(n_ports: int) -> int:
    """A base port whose n_ports consecutive ports are free now, below
    Linux's default ephemeral range (32768-60999): a node restarted on
    its port must not find it taken by an outgoing connection, such as
    a peer's redial to it that the kernel connected to itself."""
    rng = random.Random()
    for _ in range(200):
        base = rng.randrange(20000, 32768 - n_ports, 2)
        socks = []
        try:
            for p in range(base, base + n_ports):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no free block of ports")


def child_env(extra: Optional[dict] = None) -> dict:
    """A child process's environment: this process's, with the
    package's directory first on PYTHONPATH and `extra` over it."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (SRC_ROOT, env.get("PYTHONPATH", "")) if p)
    env.update(extra or {})
    return env


def bench_settings(verifier_backend: str = "auto", reactor: str = "auto",
                   verifier_coalesce: str = "auto",
                   pipeline: str = "auto") -> Dict[str, dict]:
    """Config 1's socket settings (bench_testnet.py run_socket,
    :471-480): propose 400 ms + 100 a round, prevote and precommit
    200 ms + 100, commit 100 ms, 1000 txs a block, a mempool of 4000;
    and the node's verifier backend, plane (`reactor`,
    `verifier_coalesce`) and commit path (`pipeline`), written as the
    JAX `base` keys that both packages read."""
    return {
        "consensus": {"timeout_propose": 400, "timeout_propose_delta": 100,
                      "timeout_prevote": 200, "timeout_prevote_delta": 100,
                      "timeout_precommit": 200,
                      "timeout_precommit_delta": 100,
                      "timeout_commit": 100, "max_block_size_txs": 1000},
        "mempool": {"size": 4000},
        "base": {"verifier_backend": verifier_backend, "reactor": reactor,
                 "verifier_coalesce": verifier_coalesce,
                 "pipeline": pipeline},
    }


class ProcNet:
    __test__ = False  # not a pytest class, whatever the module's importer

    def __init__(self, root: str, base_port: int,
                 cli_of: Callable[[int], str] = lambda i: PORT_CLI,
                 env_of: Callable[[int], Optional[dict]] = lambda i: None):
        self.root = root
        self.n = N_NODES
        self.base_port = base_port
        self.cli_of = cli_of
        self.env_of = env_of
        self.procs: Dict[int, subprocess.Popen] = {}
        self._killed: set = set()   # pids killed on purpose
        self._reported: set = set()  # pids whose log tail was printed
        self._logs: Dict[int, object] = {}
        # node -> the log's length at each of its processes' starts
        self._starts: Dict[int, List[int]] = {}

    # ----------------------------------------------------------------- tree

    def home(self, i: int) -> str:
        return os.path.join(self.root, f"node{i}")

    def log_path(self, i: int) -> str:
        return os.path.join(self.root, f"node{i}.log")

    def rpc_port(self, i: int) -> int:
        return self.base_port + 2 * i + 1

    def _env(self, extra: Optional[dict] = None) -> dict:
        return child_env(extra)

    def write_tree(self, chain_id: str, cli: str = PORT_CLI) -> None:
        """`cli testnet` of `cli`'s package into the root: the port's in
        this process (its `write_testnet`), another package's as a
        process of its CLI."""
        if cli == PORT_CLI:
            from tendermint_tpu_torch.cli import write_testnet
            write_testnet(self.root, self.n, chain_id, self.base_port)
            return
        subprocess.run(
            [sys.executable, "-m", cli, "testnet", "--n", str(self.n),
             "--output", self.root, "--base-port", str(self.base_port),
             "--chain-id", chain_id],
            check=True, capture_output=True, text=True, timeout=120,
            env=self._env(), cwd=self.root)

    def config_path(self, i: int) -> str:
        return os.path.join(self.home(i), "config", "config.json")

    def configure(self, sections: Dict[str, dict], nodes=None) -> None:
        """Overlay `sections` onto each node's config.json."""
        for i in (range(self.n) if nodes is None else nodes):
            with open(self.config_path(i)) as f:
                cfg = json.load(f)
            for name, values in sections.items():
                cfg.setdefault(name, {}).update(values)
            with open(self.config_path(i), "w") as f:
                json.dump(cfg, f, indent=1, sort_keys=True)

    # -------------------------------------------------------------- process

    def start(self, i: int, extra: Optional[List[str]] = None) -> None:
        """Start node i (appending to its log)."""
        if i in self.procs and self.procs[i].poll() is None:
            raise RuntimeError(f"node {i} is running")
        cmd = [sys.executable, "-m", self.cli_of(i), "--home", self.home(i),
               "node", "--p2p", "--rpc-laddr",
               f"tcp://127.0.0.1:{self.rpc_port(i)}", *(extra or [])]
        env = self._env(self.env_of(i))
        if i in self._logs:
            self._logs[i].close()
        log = open(self.log_path(i), "ab")
        self._logs[i] = log
        self._starts.setdefault(i, []).append(log.tell())
        self.procs[i] = subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT, env=env,
            cwd=self.root)

    def reset(self, i: int) -> None:
        """Wipe node i's data with its CLI's `unsafe_reset_all` (the
        stores, WALs and snapshots go; genesis, keys and config stay,
        and the priv validator's sign state is reset)."""
        if i in self.procs and self.procs[i].poll() is None:
            raise RuntimeError(f"node {i} is running")
        if self.cli_of(i) == PORT_CLI:   # the port's, in this process
            from tendermint_tpu_torch.cli import reset_all
            reset_all(self.home(i))
            return
        subprocess.run(
            [sys.executable, "-m", self.cli_of(i), "--home", self.home(i),
             "unsafe_reset_all"],
            check=True, capture_output=True, text=True, timeout=120,
            env=self._env(self.env_of(i)), cwd=self.root)

    def start_all(self, extra: Optional[List[str]] = None) -> None:
        for i in range(self.n):
            self.start(i, extra)

    def kill(self, i: int) -> None:
        """SIGKILL node i by its pid and reap it."""
        p = self.procs[i]
        self._killed.add(p.pid)
        os.kill(p.pid, signal.SIGKILL)
        p.wait(30)

    def early_exits(self) -> Dict[int, int]:
        """Nodes whose process has exited unasked: node -> exit code."""
        return {i: p.returncode for i, p in self.procs.items()
                if p.pid not in self._killed and p.poll() is not None}

    def _print_failed(self, codes: Dict[int, int]) -> None:
        """The log tail of each node whose last process exited non-zero
        unasked, once a process."""
        for i, code in sorted(codes.items()):
            p = self.procs[i]
            if code and p.pid not in self._killed and \
                    p.pid not in self._reported:
                self._reported.add(p.pid)
                print_log_tail(f"procnet node {i} (pid {p.pid}) exited "
                               f"{code}", self.log_path(i),
                               self._starts[i][-1])

    def stop_all(self) -> Dict[int, int]:
        """SIGINT every running node, wait, SIGKILL what is left; returns
        node -> exit code of the last process of each node."""
        for p in self.procs.values():
            if p.poll() is None:
                p.send_signal(signal.SIGINT)
        deadline = time.monotonic() + STOP_S
        codes = {}
        for i, p in self.procs.items():
            try:
                codes[i] = p.wait(max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                codes[i] = p.wait(10)
        for log in self._logs.values():
            log.close()
        self._print_failed(codes)
        return codes

    def log(self, i: int) -> str:
        with open(self.log_path(i), "rb") as f:
            return f.read().decode(errors="replace")

    def kernel_lines(self, i: int) -> List[dict]:
        """For each of node i's processes that printed one, the last of
        its `node kernels {...}` lines: its stop line, or for a process
        killed without one, the line of the last height it committed."""
        with open(self.log_path(i), "rb") as f:
            text = f.read()
        bounds = self._starts.get(i, [0]) + [len(text)]
        out = []
        for lo, hi in zip(bounds, bounds[1:]):
            found = re.findall(rb"^node kernels (\{.*\})$", text[lo:hi],
                               re.M)
            if found:
                out.append(json.loads(found[-1]))
        return out

    # ------------------------------------------------------------------ rpc

    def rpc(self, i: int, timeout: float = 10.0) -> JSONRPCClient:
        return JSONRPCClient(f"http://127.0.0.1:{self.rpc_port(i)}",
                             timeout=timeout)

    def ws(self, i: int, timeout: float = 10.0) -> WSClient:
        return WSClient("127.0.0.1", self.rpc_port(i), timeout=timeout)

    def height(self, i: int) -> int:
        """Node i's store height over RPC; -1 while it does not answer."""
        try:
            return int(self.rpc(i, 2.0).call("status")
                       ["latest_block_height"])
        except Exception:
            return -1

    def heights(self) -> List[int]:
        return [self.height(i) for i in range(self.n)]

    def wait_for(self, cond: Callable[[], bool], timeout_s: float,
                 what: str, poll_s: float = 0.1) -> float:
        t0 = time.monotonic()
        while not cond():
            dead = self.early_exits()
            if dead:
                self._print_failed(dead)
                raise RuntimeError(f"{what}: node processes exited {dead}")
            if time.monotonic() - t0 > timeout_s:
                raise TimeoutError(f"{what}: not within {timeout_s} s; "
                                   f"heights {self.heights()}")
            time.sleep(poll_s)
        return time.monotonic() - t0

    def wait_height(self, h: int, timeout_s: float) -> float:
        return self.wait_for(lambda: min(self.heights()) >= h, timeout_s,
                             f"height {h}")

    def metas(self, i: int, top: int) -> List[dict]:
        """Node i's block metas of heights 1..top, in height order."""
        out: Dict[int, dict] = {}
        c = self.rpc(i)
        hi = top
        while hi >= 1:
            res = c.call("blockchain", min_height=max(1, hi - 19),
                         max_height=hi)
            for m in res["block_metas"]:
                out[m["header"]["height"]] = m
            hi -= 20
        return [out[h] for h in range(1, top + 1)]

    def held_metas(self, i: int, lo: int, hi: int) -> Dict[int, dict]:
        """Node i's block metas of heights lo..hi that its store still
        holds (a pruned or state-synced store lacks those below its
        base): height -> meta."""
        out: Dict[int, dict] = {}
        c = self.rpc(i)
        top = hi
        while top >= lo:
            res = c.call("blockchain", min_height=max(lo, top - 19),
                         max_height=top)
            for m in res["block_metas"]:
                out[m["header"]["height"]] = m
            top -= 20
        return out

    def disagreements(self, top: int) -> List[str]:
        """Heights 1..top at which two nodes hold different block hashes
        or app hashes."""
        nodes = range(self.n)
        with ThreadPoolExecutor(self.n) as pool:
            per = dict(zip(nodes, pool.map(lambda i: self.metas(i, top),
                                           nodes)))
        bad = []
        for h in range(top):
            ids = {per[i][h]["block_id"]["hash"] for i in nodes}
            apps = {per[i][h]["header"]["app_hash"] for i in nodes}
            if len(ids) > 1 or len(apps) > 1:
                bad.append(f"height {h + 1}: {len(ids)} block hashes, "
                           f"{len(apps)} app hashes")
        return bad

    def block_txs(self, i: int, top: int) -> List[List[bytes]]:
        """The txs of node i's blocks 1..top (read four heights at a
        time)."""
        c = self.rpc(i, 30.0)

        def txs(h: int) -> List[bytes]:
            return [bytes.fromhex(t) for t in
                    c.call("block", height=h)["block"]["data"]["txs"]]
        with ThreadPoolExecutor(4) as pool:
            return list(pool.map(txs, range(1, top + 1)))
