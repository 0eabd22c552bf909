"""ChaosNet — an in-process validator testnet under a FaultSchedule: the
port's copy of `tendermint_tpu/chaos/runner.py`.

Real Node assemblies (stores + WAL + handshake + EventBus + real
EvidencePool) over the deterministic broadcast-relay transport the
consensus tests use, driven by MockTickers — every source of timing is
a runner step, so one seed reproduces one run exactly. The runner owns
the network: each broadcast leaving a node enters a delivery queue
where the schedule decides drop/delay/duplicate/reorder per
destination; cross-partition traffic is buffered until the partition
heals; byzantine nodes' messages pass through their ByzantineAgent
first; crashes arm a utils/fail.py commit point around the victim's
interactions and raise ChaosCrash — the node is torn down mid-commit
and later rebuilt from its home dir (ABCI handshake + WAL catchup
replay are the recovery under test).

Catch-up assist: the broadcast relay has no consensus reactor, so a
node that missed commit-forming messages would stall forever where the
real stack re-gossips old-round votes to lagging peers. The runner
plays that role deterministically: every delivered message is archived
per height, and a node behind the committed frontier gets its next
height's archive re-delivered (votes first, then proposal/parts — the
same order reactor catch-up produces commits in).

run_chaos() is the entry the tests and chip_smoke.py share;
ACCEPTANCE_SPEC is the full scenario (drop/delay/duplicate/reorder +
partition&heal + crash-restart + equivocator + clock skew), scale_spec
the validator-scale one.

Devices, as every entry point of the port: with `device=None` the nodes
and the lite certifier share the process-wide default verifier (the
verify kernels on the card; with no card it raises), as the JAX nodes
share theirs; `device="cpu"` gives each node a verifier of its own on
the CPU (backend "auto", coalescing off) and the certifier another.
Verdicts, and so the trajectory and the fault log, do not depend on the
route that computed them.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

from tendermint_tpu_torch.chaos.byzantine import ByzantineAgent, forget_locks
from tendermint_tpu_torch.chaos.monitor import InvariantMonitor
from tendermint_tpu_torch.chaos.schedule import FaultSchedule
from tendermint_tpu_torch.mempool import MempoolFull, TxAlreadyInCache
from tendermint_tpu_torch.utils import fail

RELAYED = ("proposal", "block_part", "vote")


class ChaosCrash(BaseException):
    """Simulated hard process death at a fail point. BaseException so
    no handler between the fail point and the runner can swallow it —
    the node must die with its disk state exactly as the crash left it
    (the crashing input IS in the WAL: submit() saves before handling)."""


# The artifact scenario: every required fault class in one seeded run.
# Phases are staggered so the net always keeps a live +2/3 of honest
# power: crash-restart of node 2 first, then a partition isolating node
# 0 from the (healing) majority, with node 1 equivocating and node 3's
# clock running at half rate throughout the middle of the run.
ACCEPTANCE_SPEC = {
    "drop": 0.03,
    "delay": 0.08,
    "delay_steps": [1, 3],
    "duplicate": 0.03,
    "reorder": 0.04,
    "partitions": [{"start": 70, "stop": 110,
                    "groups": [[0], [1, 2, 3]]}],
    "crashes": [{"node": 2, "after_height": 3,
                 "point": "consensus.before_save_block",
                 "down_steps": 25}],
    "clock_skew": {"3": 2},
    "byzantine": [{"node": 1, "behavior": "equivocate",
                   "start": 8, "stop": 130}],
}

# Tier-1 smoke scenario: drop + delay + one crash-restart, small enough
# to finish in a few seconds on the 1-core CI host.
SMOKE_SPEC = {
    "drop": 0.02,
    "delay": 0.06,
    "delay_steps": [1, 2],
    "crashes": [{"node": 2, "after_height": 2,
                 "point": "consensus.after_wal_end_height",
                 "down_steps": 12}],
}


def scale_spec(n: int, full_churn: bool = True) -> dict:
    """The validator-scale adversarial scenario for an n-node ChaosNet
    (the JAX package's BENCH_chaos.json scaling curve):
    light link faults + the wan3 geo profile + valset churn through
    real EndBlock deltas + one crash-restart. `full_churn=False` trims
    the churn cycle to join+leave (the 128-validator point, where every
    extra height costs O(n^2) relay deliveries — the 32-validator
    acceptance run keeps the full join/leave/stake cycle). stall_assist
    is on: a WAN-lossy large net relies on the reactor-style
    re-delivery a real network performs (deterministic, step-scheduled
    — same (spec, seed) still reproduces one fault log).

    The wan3 bandwidth caps are calibrated per NODE pair at the 4-node
    shape; the relay's full-mesh traffic grows O(n^2), so the
    per-region-pair caps scale by (n/4)^2 here — the same
    per-node-pair pipe budget at every n. Without this a 128-node
    commit round buries the long-haul pipes 50+ steps deep and the
    net never exits height 1 (measured, not hypothetical)."""
    from tendermint_tpu_torch.chaos.schedule import GEO_PROFILES
    bw_scale = max(1, (n * n) // 16)
    caps = [[c * bw_scale for c in row]
            for row in GEO_PROFILES["wan3"]["bandwidth_msgs"]]
    return {
        "drop": 0.01,
        "delay": 0.03,
        "delay_steps": [1, 2],
        "geo": {"profile": "wan3", "bandwidth_msgs": caps},
        "churn": {
            "start_height": 2,
            "every_heights": 1 if n >= 64 else 2,
            "ops": (["join", "leave", "stake"] if full_churn
                    else ["join", "leave"]),
            "standby": max(2, n // 16),
            "max_events": 3 if full_churn else 2,
            "stake_step": 5,
        },
        "crashes": [{"node": min(2, n - 1), "after_height": 2,
                     "point": "consensus.after_wal_end_height",
                     "down_steps": 10}],
        "stall_assist": True,
    }


class ChaosNet:
    def __init__(self, workdir: str, spec: Optional[dict] = None,
                 seed: int = 0, n: int = 4, chain_id: str = "chaos-net",
                 tx_every: int = 4, assist_every: int = 8,
                 lite: bool = True, device=None):
        from tendermint_tpu_torch.models.verifier import (BatchVerifier,
                                                          default_verifier)
        from tendermint_tpu_torch.types.genesis import (GenesisDoc,
                                                        GenesisValidator)
        from tendermint_tpu_torch.types.keys import PrivKey
        self.workdir = workdir
        self.device = device
        # the certifier's verifier; the nodes build theirs alike
        self.verifier = default_verifier() if device is None else \
            BatchVerifier("auto", device=device, coalesce="off")
        self.n = n
        self.chain_id = chain_id
        self.tx_every = tx_every
        self.assist_every = assist_every
        self.schedule = FaultSchedule(spec, seed)
        self.monitor = InvariantMonitor()
        if n > 255:
            raise ValueError("ChaosNet supports at most 255 nodes")
        self.keys = [PrivKey.generate(bytes([i + 1]) * 32)
                     for i in range(n)]
        # churn: the trailing `standby` nodes run as full (non-
        # validator) nodes from genesis — the join candidates the churn
        # driver rotates INTO the valset through real val: txs
        churn = self.schedule.churn
        standby = min(churn["standby"], n - 2) if churn else 0
        self.n_genesis_validators = n - standby
        self.gen = GenesisDoc(
            chain_id=chain_id, genesis_time_ns=1,
            validators=[GenesisValidator(k.pubkey.ed25519, 10)
                        for k in self.keys[:self.n_genesis_validators]])
        # churn driver state (see _drive_churn)
        self._churn_next_height = churn["start_height"] if churn else 0
        self._churn_op_i = 0
        self._churn_events = 0
        self._churn_last_inject_height = 0
        self._churn_joined: List[int] = []   # standby idx, join order
        self.churn_counts: Dict[str, int] = {}
        self.agents = [ByzantineAgent(i, self.keys[i], chain_id,
                                      self.schedule, self.monitor)
                       for i in range(n)]
        self.t = 0
        self._seq = 0
        self._outbox: List[tuple] = []       # (src, msg)
        self._due: Dict[int, List[tuple]] = {}  # step -> [(seq, src, dst, msg)]
        self._part_buf: List[tuple] = []     # (seq, src, dst, msg)
        self._active_partitions: set = set()
        self._archive: Dict[int, List[tuple]] = {}  # height -> [(src, msg)]
        self._last_assist: Dict[int, int] = {}
        self.assists = 0
        # same-height stall assist (spec key "stall_assist", default
        # OFF): the real consensus reactor re-gossips current-height
        # votes continuously, so a dropped vote is only DELAYED on a
        # live network. The relay's drops are final, which can wedge
        # every node at one height with no timeout pending (each
        # waiting for a vote nobody will resend). When opted in and the
        # frontier stalls, the archived traffic for the height being
        # decided is re-delivered to every live node — deterministic
        # (step-scheduled), and duplicate votes are no-ops. Off by
        # default because re-delivery changes a seeded trajectory
        # (including re-surfacing byzantine twins), and the committed
        # artifact scenarios are pinned to theirs.
        self.stall_assist = bool((spec or {}).get("stall_assist"))
        self._frontier = 0
        self._frontier_step = 0
        self._last_stall_assist = 0
        # gossip dedup: per-destination digests of
        # byte-identical vote/part messages this NODE INCARNATION has
        # provably consumed — re-delivering them (duplicate faults,
        # catch-up/stall assists replaying whole per-height archives)
        # is a no-op in the state machine but dominated the relay's
        # O(n^2) per-step delivery cost at 128 validators. A message is
        # only marked consumed when the machine could actually use it
        # (votes: height <= rs.height at submit; parts: decided height
        # or visibly present in the part set), so assists still
        # re-deliver anything that was dropped or arrived early. Sets
        # clear on crash — a rebuilt node lost its in-memory state.
        # Decisions read only deterministic state and never touch the
        # RNG: the fault log stays byte-identical.
        self._delivered: List[set] = [set() for _ in range(n)]
        self._digest_memo: Dict[int, tuple] = {}
        self.dedup_skips = 0
        self.nodes: List[Optional[object]] = [None] * n
        self._t0 = time.perf_counter()
        for i in range(n):
            self.nodes[i] = self._build_node(i)
        if lite:
            # continuous lite certification as a first-class invariant:
            # the certifier follows the churning valset height by
            # height, reading each height's (header, commit, valset)
            # from a live node's stores — the same data an RPC provider
            # serves a real light client
            from tendermint_tpu_torch.types.validator_set import (
                Validator, ValidatorSet)
            genesis_vals = ValidatorSet(
                [Validator(v.pubkey, v.power)
                 for v in self.gen.validators])
            self.monitor.attach_lite(chain_id, genesis_vals,
                                     self._lite_full_commit,
                                     verifier=self.verifier)

    def _lite_full_commit(self, height: int):
        """FullCommit for `height` from any live node that has it (the
        monitor retries next poll when None — e.g. the only holder is
        mid-crash)."""
        from tendermint_tpu_torch.lite.types import FullCommit, SignedHeader
        for node in self.nodes:
            if node is None:
                continue
            meta = node.block_store.load_block_meta(height)
            if meta is None:
                continue
            commit = node.block_store.load_seen_commit(height) \
                or node.block_store.load_block_commit(height)
            if commit is None:
                continue
            try:
                vals = node.state_store.load_validators(height)
            except (KeyError, ValueError, LookupError):
                continue
            return FullCommit(
                SignedHeader(meta.header, commit, meta.block_id), vals)
        return None

    # --------------------------------------------------------------- assembly

    def _home(self, i: int) -> str:
        return os.path.join(self.workdir, f"node{i}")

    def _build_node(self, i: int):
        """Full Node over the node's (possibly pre-existing) home dir:
        construction runs the ABCI handshake against a FRESH app, so a
        rebuilt node replays its stored chain; start() runs WAL catchup
        for the in-flight height."""
        from tendermint_tpu_torch.abci.apps import KVStoreApp
        from tendermint_tpu_torch.chaos.ticker import StepTicker
        from tendermint_tpu_torch.config import test_config
        from tendermint_tpu_torch.node import Node
        from tendermint_tpu_torch.types.priv_validator import PrivValidatorFile

        home = self._home(i)
        pv_path = os.path.join(home, "priv_validator.json")
        if os.path.exists(pv_path):
            pv = PrivValidatorFile.load(pv_path)
        else:
            pv = PrivValidatorFile(pv_path, self.keys[i])
            pv._persist()
        cfg = test_config(home)
        if self.device is not None:
            # a verifier of the node's own on `device`, no coalescer
            # thread (the runner is single-threaded: nothing to merge)
            cfg.base.verifier_coalesce = "off"
        if self.schedule.geo is not None:
            # WAN-calibrated timeouts, exactly what an operator does:
            # stretch prevote/precommit/propose to cover the profile's
            # worst hop + jitter. Without this, any net where two near
            # regions alone hold >2/3 of the power (e.g. 128 nodes
            # over wan3: 86/128 = 67.2%) reaches +2/3-of-ANY on
            # near-region prevotes, fires the test config's 1-step
            # prevote timeout before the far region's votes can cross
            # the 5-6-step long haul, and nil-precommits every round
            # forever (measured: 40 rounds of livelock at n=128).
            from dataclasses import replace
            g = self.schedule.geo
            worst = max(max(row) for row in g["latency_steps"]) \
                + g["jitter_steps"]
            q_ms = 10  # StepTicker quantum (quantum_s=0.01)
            c = cfg.consensus
            cfg.consensus = replace(
                c,
                timeout_propose=max(c.timeout_propose,
                                    (worst + 4) * q_ms),
                timeout_prevote=max(c.timeout_prevote,
                                    (worst + 2) * q_ms),
                timeout_precommit=max(c.timeout_precommit,
                                      (worst + 2) * q_ms))
        node = Node(cfg, self.gen, priv_validator=pv,
                    app=KVStoreApp(device=self.device), device=self.device)
        node.consensus.ticker.stop()
        node.consensus.ticker = StepTicker(
            node.consensus._on_timeout_fire, clock=lambda: self.t,
            skew=self.schedule.clock_skew.get(i, 1))
        node.consensus.broadcast_hooks.append(
            lambda msg, i=i: self._outbox.append((i, dict(msg)))
            if msg.get("type") in RELAYED else None)
        self.monitor.attach(i, node.event_bus)
        # TM_CUDA_DIVERGENCE=on: the node's BlockExecutor carries a
        # transition-digest recorder — cross-checked per poll as the
        # `divergence` invariant (None when the knob is off)
        self.monitor.attach_divergence(
            i, getattr(node.consensus.block_exec, "divergence", None))
        return node

    def start(self) -> None:
        for node in self.nodes:
            node.start()

    def stop(self) -> None:
        for i, node in enumerate(self.nodes):
            if node is not None:
                try:
                    node.stop()
                except Exception as e:
                    # teardown must not mask the run's verdict, but a
                    # node that cannot stop cleanly is worth seeing
                    self.monitor.note("teardown", f"node {i} stop: {e!r}")
            self.nodes[i] = None

    # ------------------------------------------------------------- interacting

    def _height(self, i: int) -> int:
        node = self.nodes[i]
        return node.consensus.state.last_block_height if node else -1

    def _interact(self, i: int, fn) -> None:
        """Run one interaction (ticker fire / message delivery) against
        node i with its pending crash — if any — armed at the scheduled
        fail point. Armed only for the duration of this interaction:
        the fail-point registry is process-global, and the other nodes'
        commits must pass through it untouched."""
        crash = self.schedule.crash_for(i, self._height(i), self.t)
        if crash is not None:
            point = crash["point"]

            def raiser(name):
                raise ChaosCrash(f"node {i} at {name}")

            fail.arm(point, raiser)
        try:
            fn()
        except ChaosCrash:
            crash["_fired"] = True
            self._on_crash(i, crash)
        finally:
            if crash is not None and not crash.get("_fired"):
                fail.disarm(crash["point"])

    def _on_crash(self, i: int, crash: dict) -> None:
        node = self.nodes[i]
        self.nodes[i] = None
        self.monitor.detach(i)
        self._delivered[i] = set()   # the rebuilt node starts blank
        crash["crash_step"] = self.t
        crash["restart_step"] = self.t + crash["down_steps"]
        self.schedule.record("crash", self.t, node=i,
                             point=crash["point"],
                             height=node.consensus.rs.height)
        # hard-stop: the consensus machine died mid-commit; releasing
        # file handles is the OS's job on a real crash, ours here
        node.consensus._stopped = True
        try:
            node.stop()
        except Exception:
            pass

    def _restart(self, crash: dict) -> None:
        i = crash["node"]
        crash["_restarted"] = True
        self.schedule.record("restart", self.t, node=i,
                             crash_step=crash["crash_step"])
        node = self._build_node(i)
        self.nodes[i] = node
        node.start()  # handshake already ran in the ctor; WAL catchup here

    # --------------------------------------------------------------- stepping

    def step(self) -> None:
        self.t += 1
        t = self.t

        for c in self.schedule.crashes:
            if c.get("_fired") and not c.get("_restarted") and \
                    t >= c["restart_step"]:
                self._restart(c)

        for i, node in enumerate(self.nodes):
            if node is not None and \
                    self.schedule.byzantine_for(i, t) == "amnesia":
                forget_locks(node.consensus, self.schedule, t, i)

        if self.tx_every and t % self.tx_every == 0:
            tx = b"chaos/t%d=v" % t
            for node in self.nodes:
                if node is None:
                    continue
                try:
                    node.mempool.check_tx(tx)
                except (TxAlreadyInCache, MempoolFull):
                    pass  # dup after restart replay / mempool full

        self._drive_churn()

        for i, node in enumerate(self.nodes):
            if node is not None:
                self._interact(
                    i, lambda n=node: n.consensus.ticker.fire_due())

        self._route_outbox()
        self._partition_transitions()
        self._flush_partitions()
        self._deliver_due()
        self._assist()
        self.monitor.poll(t)

    # ----------------------------------------------------------------- churn

    def _frontier_app_valset(self):
        """(pubkey -> power) as the frontier node's APP knows it — the
        authoritative applied-plus-pending view (the app advances its
        set at DeliverTx time), read from the live node with the
        highest committed height (lowest id breaks ties, so the choice
        is deterministic)."""
        best = None
        for i, node in enumerate(self.nodes):
            if node is None:
                continue
            h = self._height(i)
            if best is None or h > best[0]:
                best = (h, node)
        return (best[0], dict(best[1].app._validators)) if best \
            else (0, {})

    def _drive_churn(self) -> None:
        """Rotate the valset through REAL consensus: every
        `every_heights` committed heights, inject one `val:` tx (the
        KVStore valset-change surface) into every live mempool — the
        next proposer includes it, EndBlock returns the delta, and
        update_with_changes applies it on every node. Deterministic:
        target selection reads only the frontier app's applied set and
        fixed orderings."""
        churn = self.schedule.churn
        if not churn or self._churn_events >= churn["max_events"]:
            return
        h, view = self._frontier_app_valset()
        if h < self._churn_next_height:
            return
        ops = churn["ops"]
        op = ops[self._churn_op_i % len(ops)]
        self._churn_op_i += 1
        self._churn_next_height = h + churn["every_heights"]
        standby_range = range(self.n_genesis_validators, self.n)
        tx = None
        if op == "join":
            for i in standby_range:
                pk = self.keys[i].pubkey.ed25519
                if pk not in view:
                    tx = b"val:%s/10" % pk.hex().encode()
                    self._churn_joined.append(i)
                    break
        elif op == "leave":
            # leave the earliest still-active joined standby; fall back
            # to the highest-index genesis validator, never below 3
            target = None
            for i in self._churn_joined:
                if self.keys[i].pubkey.ed25519 in view:
                    target = i
                    break
            if target is None and len(view) > 3:
                for i in reversed(range(self.n_genesis_validators)):
                    if self.keys[i].pubkey.ed25519 in view:
                        target = i
                        break
            if target is not None and len(view) > 1:
                if target in self._churn_joined:
                    self._churn_joined.remove(target)
                pk = self.keys[target].pubkey.ed25519
                tx = b"val:%s/0" % pk.hex().encode()
        else:  # stake change: bump the lowest-address active validator
            pk = min(view) if view else None
            if pk is not None:
                tx = b"val:%s/%d" % (pk.hex().encode(),
                                     view[pk] + churn["stake_step"])
        if tx is None:
            return
        self._churn_events += 1
        self._churn_last_inject_height = h
        kind = f"churn_{op}"
        self.churn_counts[kind] = self.churn_counts.get(kind, 0) + 1
        self.schedule.record(kind, self.t, height=h,
                             tx=tx.decode()[:80])
        for node in self.nodes:
            if node is None:
                continue
            try:
                node.mempool.check_tx(tx)
            except (TxAlreadyInCache, MempoolFull):
                pass

    def _route_outbox(self) -> None:
        outbox, self._outbox = self._outbox, []
        t = self.t
        for src, msg in outbox:
            behavior = self.schedule.byzantine_for(src, t)
            msgs = self.agents[src].transform(t, behavior, msg) \
                if behavior else [msg]
            for m in msgs:
                forged = m is not msg
                self._archive.setdefault(
                    _msg_height(m), []).append((src, m))
                for dst in range(self.n):
                    if dst == src or self.nodes[dst] is None:
                        continue
                    if self.schedule.cross_partition(t, src, dst):
                        self._seq += 1
                        self._part_buf.append((self._seq, src, dst, m))
                        continue
                    # chaos-forged traffic IS the fault — it bypasses
                    # the link faults so the oracle tests the engine's
                    # response to the attack, not the link's luck
                    delays = [0] if forged else \
                        self.schedule.link_deliveries(
                            t, src, dst, m.get("type", "?"))
                    for d in delays:
                        self._seq += 1
                        self._due.setdefault(t + d, []).append(
                            (self._seq, src, dst, m))

    def _partition_transitions(self) -> None:
        t = self.t
        now = {pi for pi, p in enumerate(self.schedule.partitions)
               if p["start"] <= t < p["stop"]}
        for pi in now - self._active_partitions:
            self.schedule.record(
                "partition", t,
                groups=self.schedule.partitions[pi]["groups"])
        for pi in self._active_partitions - now:
            self.schedule.record("heal", t, partition=pi)
        self._active_partitions = now

    def _flush_partitions(self) -> None:
        """Buffered cross-partition traffic whose partition healed is
        released FIFO — a partition delays, it does not destroy (the
        real network retransmits; destruction is the drop fault)."""
        t = self.t
        keep = []
        for item in self._part_buf:
            _, src, dst, m = item
            if self.schedule.cross_partition(t, src, dst):
                keep.append(item)
            else:
                self._due.setdefault(t, []).append(item)
        self._part_buf = keep

    def _msg_digest(self, m: dict) -> bytes:
        """Canonical digest of a relayed message, memoized by object
        identity (one message object fans out to n-1 destinations and
        through every assist replay; the archive pins the object alive,
        so the id key stays valid — the memo holds a reference too)."""
        key = id(m)
        hit = self._digest_memo.get(key)
        if hit is not None and hit[0] is m:
            return hit[1]
        import hashlib
        import json as _json
        d = hashlib.sha256(_json.dumps(
            m, sort_keys=True, default=str).encode()).digest()
        self._digest_memo[key] = (m, d)
        return d

    def _deliver_one(self, dst: int, peer_label: str, m: dict) -> None:
        """Deliver one relayed message to `dst` with gossip dedup:
        byte-identical vote/part messages the destination's CURRENT
        incarnation already consumed are skipped (provable no-ops)."""
        node = self.nodes[dst]
        if node is None:
            return  # the wire to a dead node drops everything
        t = m.get("type")
        digest = None
        if t in ("vote", "block_part"):
            digest = self._msg_digest(m)
            if digest in self._delivered[dst]:
                self.dedup_skips += 1
                return
        self._interact(dst, lambda n=node, mm=m, s=peer_label:
                       n.consensus.submit(dict(mm), peer_id=s))
        if digest is None:
            return
        node = self.nodes[dst]   # the submit may have crashed the node
        if node is None:
            return
        rs = node.consensus.rs
        h = _msg_height(m)
        if t == "vote":
            # consumable heights were consumed; past heights are
            # dropped forever — either way a re-delivery adds nothing
            if h <= rs.height:
                self._delivered[dst].add(digest)
        elif t == "block_part":
            if h < rs.height:
                self._delivered[dst].add(digest)   # decided: useless now
            elif h == rs.height and rs.proposal_block_parts is not None:
                try:
                    idx = m["part"]["index"]
                except (KeyError, TypeError):
                    return
                if rs.proposal_block_parts.get_part(idx) is not None:
                    self._delivered[dst].add(digest)

    def _deliver_due(self) -> None:
        batch = sorted(self._due.pop(self.t, []))
        for _, src, dst, m in batch:
            self._deliver_one(dst, f"node{src}", m)

    def _assist(self) -> None:
        """Reactor-style catch-up for nodes behind the committed
        frontier (see module docstring), plus the same-height stall
        assist for a frontier that stopped moving."""
        t = self.t
        frontier = max((self._height(i) for i in range(self.n)
                        if self.nodes[i] is not None), default=0)
        if frontier > self._frontier:
            self._frontier = frontier
            self._frontier_step = t
        elif self.stall_assist and \
                t - self._frontier_step >= 6 * self.assist_every and \
                t - self._last_stall_assist >= 3 * self.assist_every:
            # last-resort threshold, well past crash downtimes and
            # partition windows
            self._last_stall_assist = t
            msgs = self._archive.get(frontier + 1, [])
            if msgs:
                self.assists += 1
                ordered = ([m for m in msgs if m[1]["type"] == "vote"]
                           + [m for m in msgs
                              if m[1]["type"] == "proposal"]
                           + [m for m in msgs
                              if m[1]["type"] == "block_part"])
                for i, node in enumerate(self.nodes):
                    if node is None:
                        continue
                    for src, m in ordered:
                        if src == i:
                            continue
                        self._deliver_one(i, f"stall{src}", m)
        for i, node in enumerate(self.nodes):
            if node is None or self._height(i) >= frontier:
                continue
            if t - self._last_assist.get(i, -10**9) < self.assist_every:
                continue
            self._last_assist[i] = t
            want = self._height(i) + 1
            msgs = self._archive.get(want, [])
            if not msgs:
                continue
            self.assists += 1
            ordered = ([m for m in msgs if m[1]["type"] == "vote"]
                       + [m for m in msgs if m[1]["type"] == "proposal"]
                       + [m for m in msgs if m[1]["type"] == "block_part"])
            for src, m in ordered:
                if src == i:
                    continue
                self._deliver_one(i, f"assist{src}", m)

    # ----------------------------------------------------------------- driving

    def run(self, target_height: int, max_steps: int = 800,
            settle_steps: int = 60) -> None:
        """Step until every live node reaches `target_height` AND every
        scheduled fault window has opened and healed, then keep going
        `settle_steps` more so late evidence lands in a block."""
        while self.t < max_steps:
            self.step()
            live = [self._height(i) for i in range((self.n))
                    if self.nodes[i] is not None]
            if min(live, default=0) >= target_height and \
                    self._faults_done():
                break
        for _ in range(settle_steps):
            self.step()

    def _faults_done(self) -> bool:
        t = self.t
        if any(not c.get("_restarted") for c in self.schedule.crashes):
            return False
        if any(t < p["stop"] for p in self.schedule.partitions):
            return False
        if any(t < b.get("stop", 0) for b in self.schedule.byzantine):
            return False
        churn = self.schedule.churn
        if churn:
            if self._churn_events < min(churn["max_events"],
                                        len(churn["ops"])):
                return False  # at least one full op cycle must fire
            # ...and the last injected churn tx must have had heights
            # to commit AND take effect (EndBlock delta applies at
            # injection height + 2 at the earliest), so "applied
            # through consensus" is observable before the run stops
            frontier = max((self._height(i) for i in range(self.n)
                            if self.nodes[i] is not None), default=0)
            if frontier < self._churn_last_inject_height + 3:
                return False
        return True

    def report(self, liveness_bound: int = 150) -> dict:
        wall = time.perf_counter() - self._t0
        step_s = wall / max(1, self.t)
        rep = self.monitor.finalize(self.schedule, self.t,
                                    liveness_bound=liveness_bound,
                                    step_seconds=step_s)
        rep["seed"] = self.schedule.seed
        rep["steps"] = self.t
        rep["wall_seconds"] = round(wall, 3)
        rep["step_seconds_mean"] = round(step_s, 5)
        rep["faults_injected"] = dict(self.schedule.counts)
        rep["faults_injected_total"] = sum(self.schedule.counts.values())
        rep["catchup_assists"] = self.assists
        rep["relay_dedup_skips"] = self.dedup_skips
        rep["n_nodes"] = self.n
        rep["n_genesis_validators"] = self.n_genesis_validators
        rep["blocks_per_sec"] = round(rep["max_height"] / wall, 3) \
            if wall > 0 else 0.0
        if self.schedule.churn:
            rep["churn"] = dict(self.churn_counts)
            rep["churn"]["events"] = self._churn_events
        if self.schedule.geo:
            rep["geo_regions"] = self.schedule.geo["regions"]
        # determinism witness: sha256 over the canonical fault log —
        # two runs of one (spec, seed) must produce equal hashes
        # (cheaper to compare/commit than the full log)
        import hashlib
        import json as _json
        rep["fault_log_sha256"] = hashlib.sha256(
            _json.dumps(self.schedule.log, sort_keys=True)
            .encode()).hexdigest()
        return rep


def _msg_height(m: dict) -> int:
    t = m.get("type")
    if t == "proposal":
        return m["proposal"]["height"]
    if t == "vote":
        return m["vote"]["height"]
    return m.get("height", 0)


def run_chaos(spec: Optional[dict] = None, seed: int = 42,
              workdir: Optional[str] = None, n: int = 4,
              target_height: int = 10, max_steps: int = 800,
              trace_path: Optional[str] = None, lite: bool = True,
              settle_steps: int = 60, device=None) -> dict:
    """One seeded chaos run end to end; returns the monitor report
    (plus fault counts). On any violation a replayable trace is dumped
    next to the workdir (or at `trace_path`). `device`: see the module
    docstring."""
    import shutil
    import tempfile

    from tendermint_tpu_torch.models.verifier import default_verifier
    # the nodes' shared verifier, resolved first: without a card and
    # without a device it raises before anything below is changed
    _shared_verifier = default_verifier() if device is None else None
    spec = ACCEPTANCE_SPEC if spec is None else spec
    own_dir = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="chaos-net-")
    # TM_CUDA_LOCKCHECK=on: ChaosNet doubles as a race harness — every
    # lock the nodes allocate below joins the acquisition-order graph,
    # and guarded attributes get runtime descriptors; the report gains
    # a "lockwatch" section (cycles must be empty)
    from tendermint_tpu_torch.analysis import lockwatch
    lockcheck = lockwatch.maybe_install()
    # causal flight recorder: chaos runs trace by default (the span ring
    # is the post-mortem for any violation); an explicit TM_CUDA_TRACE=off
    # in the env still wins inside causal.enabled()
    from tendermint_tpu_torch.telemetry import causal
    trace_prev = causal._configured
    causal.configure("on")
    causal.clear()
    # the runner is SINGLE-THREADED by design (one seed, one
    # trajectory), so the dispatch coalescer can never merge anything
    # here — but every per-vote verify would still pay its cross-thread
    # handoff + linger (measured ~2x step cost at 64 validators).
    # Verdicts are identical either way; restored after the run. A run
    # on a given device builds its verifiers with coalescing off.
    if _shared_verifier is not None:
        coalesce_prev = _shared_verifier.coalesce
        _shared_verifier.coalesce = "off"
    try:
        net = ChaosNet(workdir, spec, seed, n=n, lite=lite, device=device)
    except BaseException:
        if _shared_verifier is not None:
            _shared_verifier.coalesce = coalesce_prev
        causal.configure(trace_prev)
        if own_dir:
            shutil.rmtree(workdir, ignore_errors=True)
        raise
    try:
        net.start()
        net.run(target_height, max_steps=max_steps,
                settle_steps=settle_steps)
        report = net.report()
        if lockcheck:
            report["lockwatch"] = lockwatch.report()
        if report["violations"] or trace_path:
            # never inside a workdir this function is about to delete
            path = trace_path or os.path.join(
                tempfile.gettempdir(), f"chaos_trace_{seed}.json")
            net.monitor.dump_trace(path, net.schedule, report)
            report["trace"] = path
        if report["violations"] and causal.enabled():
            # archive the span ring next to the replayable trace: the
            # violation's timeline (who proposed, when quorum formed,
            # what stalled) outlives the torn-down net
            import json as _json
            rec = (report.get("trace") or os.path.join(
                tempfile.gettempdir(),
                f"chaos_trace_{seed}.json")) + ".timeline.json"
            with open(rec, "w") as f:
                _json.dump(causal.dump(), f)
            report["flight_recorder"] = rec
        return report
    finally:
        net.stop()
        if _shared_verifier is not None:
            _shared_verifier.coalesce = coalesce_prev
        causal.configure(trace_prev)
        if own_dir:
            shutil.rmtree(workdir, ignore_errors=True)
