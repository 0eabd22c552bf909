"""Deployment topologies: the port's copy of
`tendermint_tpu/serving/topology.py`.

A ``Topology`` is the declarative shape of a multi-process net; a
``materialize`` call turns it into real per-node homes under one output
directory — a shared genesis, per-node priv_validator / node_key,
config.json with persistent_peers wired — plus the argv each process
runs with (``python -m tendermint_tpu_torch.cli``). Two kinds:

- ``validators``: N validator processes (the ``cli testnet`` file tree,
  a full persistent-peer mesh) plus M edge replicas. A replica home
  carries the SAME genesis and its own node_key but NO
  priv_validator.json: an edge process must never be able to sign.
- ``shardset``: one process assembling a ShardSet (N in-process chains
  behind one front door) — the sharded front-door shape the load
  harness sweeps.

``device`` is each child's ``--device`` ("" = the card; "cpu" in the
tests). Ports follow the testnet convention: process k gets (base+2k,
base+2k+1) as (p2p, rpc), so harnesses derive every address from the
base alone.
"""

from __future__ import annotations

import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from tendermint_tpu_torch.procnet import PORT_CLI

#: consensus timeouts of the socket-net profile (the JAX package's
#: e2e-test numbers, procnet.bench_settings' timeouts)
FAST_TIMEOUTS = {
    "timeout_propose": 400, "timeout_propose_delta": 100,
    "timeout_prevote": 200, "timeout_prevote_delta": 100,
    "timeout_precommit": 200, "timeout_precommit_delta": 100,
    "timeout_commit": 100,
}


@dataclass
class Topology:
    kind: str = "validators"        # validators | shardset
    n_validators: int = 3
    n_replicas: int = 0
    n_shards: int = 2               # shardset kind only
    chain_id: str = "serving-net"
    base_port: int = 0              # 0 = caller allocates a free block
    wire: Optional[dict] = None     # WireProxy fault spec between vals
    wire_seed: int = 0
    fast_timeouts: bool = True
    max_seconds: float = 900.0      # child self-destruct deadline
    env: Dict[str, str] = field(default_factory=dict)  # extra child env
    device: str = ""                # each child's --device ("" = card)

    def n_processes(self) -> int:
        if self.kind == "shardset":
            return 1
        return self.n_validators + self.n_replicas


@dataclass
class ProcSpec:
    """One spawnable process of a materialized topology."""
    name: str                        # val0.. / replica0.. / shardset
    kind: str                        # validator | replica | shardset
    home: str
    argv: List[str]
    p2p_port: int                    # 0 for shardset
    rpc_port: int

    @property
    def rpc_address(self) -> str:
        return f"http://127.0.0.1:{self.rpc_port}"


def _device_args(topo: Topology) -> List[str]:
    return ["--device", topo.device] if topo.device else []


def _write_configs(out: str, topo: Topology, base: int,
                   node_keys, n_total: int) -> None:
    from tendermint_tpu_torch.config import default_config, save_config
    for k in range(n_total):
        is_val = k < topo.n_validators
        name = f"val{k}" if is_val else f"replica{k - topo.n_validators}"
        home = os.path.join(out, name)
        cfg = default_config(home)
        cfg.p2p.laddr = f"tcp://127.0.0.1:{base + 2 * k}"
        cfg.rpc.laddr = f"tcp://127.0.0.1:{base + 2 * k + 1}"
        cfg.p2p.addr_book_strict = False
        if is_val:
            # full validator mesh (the testnet shape)
            peers = [f"{node_keys[j].id()}@127.0.0.1:{base + 2 * j}"
                     for j in range(topo.n_validators) if j != k]
        else:
            # replicas dial ONLY validators: edge processes follow the
            # chain, they are not gossip hubs for each other
            peers = [f"{node_keys[j].id()}@127.0.0.1:{base + 2 * j}"
                     for j in range(topo.n_validators)]
        cfg.p2p.persistent_peers = ",".join(peers)
        # the load harness searches txs by tag (app.key); index them
        cfg.tx_index.index_all_tags = True
        save_config(cfg)
        if topo.fast_timeouts:
            _patch_consensus(home, FAST_TIMEOUTS)


def _patch_consensus(home: str, timeouts: dict) -> None:
    path = os.path.join(home, "config", "config.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg.setdefault("consensus", {}).update(timeouts)
    with open(path, "w") as f:
        json.dump(cfg, f)


def materialize(topo: Topology, out: str) -> List[ProcSpec]:
    """Write the file tree for `topo` under `out` and return the
    process specs to spawn. `topo.base_port` must be set (a free
    block of 2 * n_processes ports — procnet.free_block)."""
    base = topo.base_port
    if base <= 0:
        raise ValueError("materialize needs topo.base_port set")
    os.makedirs(out, exist_ok=True)

    if topo.kind == "shardset":
        home = os.path.join(out, "shardset")
        os.makedirs(home, exist_ok=True)
        argv = [sys.executable, "-m", PORT_CLI, "--home", home,
                "shardset",
                "--shards", str(topo.n_shards),
                "--laddr", f"tcp://127.0.0.1:{base + 1}",
                "--max-seconds", str(topo.max_seconds),
                *_device_args(topo)]
        return [ProcSpec("shardset", "shardset", home, argv,
                         p2p_port=0, rpc_port=base + 1)]

    if topo.kind != "validators":
        raise ValueError(f"unknown topology kind {topo.kind!r}")

    from tendermint_tpu_torch.p2p import NodeKey
    from tendermint_tpu_torch.types.genesis import (GenesisDoc,
                                                    GenesisValidator)
    from tendermint_tpu_torch.types.priv_validator import PrivValidatorFile

    n_total = topo.n_validators + topo.n_replicas
    pvs, node_keys = [], []
    for k in range(n_total):
        is_val = k < topo.n_validators
        name = f"val{k}" if is_val else f"replica{k - topo.n_validators}"
        cfg_dir = os.path.join(out, name, "config")
        os.makedirs(cfg_dir, exist_ok=True)
        if is_val:
            # ONLY validators get a signing key on disk
            pvs.append(PrivValidatorFile.load_or_generate(
                os.path.join(cfg_dir, "priv_validator.json")))
        node_keys.append(NodeKey.load_or_generate(
            os.path.join(cfg_dir, "node_key.json")))
    gen = GenesisDoc(
        chain_id=topo.chain_id, genesis_time_ns=time.time_ns(),
        validators=[GenesisValidator(pv.pubkey.ed25519, 10)
                    for pv in pvs])
    for k in range(n_total):
        is_val = k < topo.n_validators
        name = f"val{k}" if is_val else f"replica{k - topo.n_validators}"
        gen.save(os.path.join(out, name, "config", "genesis.json"))
    _write_configs(out, topo, base, node_keys, n_total)

    specs: List[ProcSpec] = []
    for k in range(n_total):
        is_val = k < topo.n_validators
        name = f"val{k}" if is_val else f"replica{k - topo.n_validators}"
        home = os.path.join(out, name)
        rpc = base + 2 * k + 1
        if is_val:
            argv = [sys.executable, "-m", PORT_CLI, "--home", home,
                    "node", "--p2p", "--no-fast-sync",
                    "--rpc-laddr", f"tcp://127.0.0.1:{rpc}",
                    "--max-seconds", str(topo.max_seconds),
                    *_device_args(topo)]
        else:
            argv = [sys.executable, "-m", PORT_CLI, "--home", home,
                    "replica",
                    "--rpc-laddr", f"tcp://127.0.0.1:{rpc}",
                    "--max-seconds", str(topo.max_seconds),
                    *_device_args(topo)]
        specs.append(ProcSpec(
            name, "validator" if is_val else "replica", home, argv,
            p2p_port=base + 2 * k, rpc_port=rpc))
    return specs
