"""InvariantMonitor — the chaos run's correctness oracle: the port's
copy of `tendermint_tpu/chaos/monitor.py`.

Subscribes to every node's EventBus (the same bus RPC websockets use,
so the monitor observes exactly what a client would) and checks, while
faults fire:

  agreement   no two nodes commit different blocks at one height —
              the ≤1/3-byzantine safety claim, checked per commit.
  validity    per node instance, committed heights strictly increase
              (a node that re-announced or rewrote history trips this;
              the tracker resets on crash-restart because catchup
              replay legitimately re-covers the in-flight height).
  evidence    every injected double-sign eventually appears as
              DuplicateVoteEvidence committed in a block.
  liveness    after every fault episode heals, the chain commits a new
              height within a bounded number of steps.
  certified   every committed height is continuously certified by a
              lite client (lite.ContinuousCertifier) tracking the
              CHURNING valset height by height — sequential
              certify/update across every EndBlock valset delta. A
              commit the light client cannot certify is the loudest
              possible safety failure: the chain's own proof chain
              broke. Enabled by attach_lite(); the certifier advances
              inside poll() as committed heights' data becomes
              readable from a live node's stores (exactly what an RPC
              provider would serve).
  divergence  every node's per-height transition digest (block bytes,
              ABCI responses, validator updates, app_hash — see
              analysis/divergence.py) is bit-identical across the net.
              Strictly stronger than agreement: two nodes can commit
              the same block yet fork on ABCI responses or app_hash,
              and the digest pinpoints the first such height. Enabled
              by attach_divergence() when TM_CUDA_DIVERGENCE is on.

Violations are recorded (never raised mid-run — the runner must keep
driving so the trace shows what happened AFTER the violation) and
dumped as a replayable trace: {seed, spec, fault log, commit log,
violations}. Re-running the runner with the trace's seed+spec
reproduces the identical fault sequence.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from tendermint_tpu_torch import chaos
from tendermint_tpu_torch.chaos.byzantine import double_sign_key
from tendermint_tpu_torch.types.evidence import DuplicateVoteEvidence

INVARIANTS = ("agreement", "validity", "evidence", "liveness",
              "certified", "divergence")


def _percentiles(xs: List[float]) -> dict:
    if not xs:
        return {}
    s = sorted(xs)

    def pct(p):
        return s[min(len(s) - 1, int(p * len(s)))]

    return {"p50": pct(0.50), "p90": pct(0.90), "max": s[-1],
            "n": len(s)}


class InvariantMonitor:
    def __init__(self):
        self._subs: Dict[int, object] = {}
        # height -> {"hash": hex, "first_step": int, "nodes": {id: hex}}
        self.commits: Dict[int, dict] = {}
        self.node_height: Dict[int, int] = {}
        self.commit_steps: List[tuple] = []   # (step, height) of FIRST commit
        self.expected_double_signs: set = set()
        self.committed_evidence: set = set()
        self.violations: List[dict] = []
        self.notes: List[dict] = []
        self.checks: Dict[str, int] = {}
        self.max_height = 0
        # continuous lite certification (attach_lite)
        self.lite = None                      # ContinuousCertifier
        self._lite_provider = None            # height -> FullCommit|None
        self._lite_active = False
        self._lite_stuck_since: Optional[int] = None
        self.lite_valset_sizes: Dict[int, int] = {}
        # transition-digest cross-check (attach_divergence)
        self._div_recorders: Dict[int, object] = {}
        self._div_seen: Dict[int, Dict[int, str]] = {}  # h -> node -> hex
        self._div_ref: Dict[int, str] = {}              # h -> first digest

    # ------------------------------------------------------------ wiring

    def attach(self, node_id: int, event_bus) -> None:
        """(Re-)subscribe to one node's bus. On crash-restart the node
        carries a fresh bus; the validity tracker resets because replay
        may legitimately re-commit the in-flight height."""
        self._subs[node_id] = event_bus.subscribe(
            f"chaos-monitor-{node_id}", "tm.event = 'NewBlock'",
            capacity=4096)
        self.node_height.pop(node_id, None)

    def detach(self, node_id: int) -> None:
        self._subs.pop(node_id, None)

    def attach_lite(self, chain_id: str, genesis_validators,
                    provider, verifier=None) -> None:
        """Turn on continuous lite certification. `provider` is a
        callable height -> FullCommit | None (None = data not readable
        yet — retried every poll). The certifier starts from the
        genesis valset and must cross every EndBlock delta
        sequentially."""
        from tendermint_tpu_torch.lite import ContinuousCertifier
        self.lite = ContinuousCertifier(chain_id, genesis_validators,
                                        verifier=verifier)
        self._lite_provider = provider
        self._lite_active = True

    def attach_divergence(self, node_id: int, recorder) -> None:
        """(Re-)register one node's transition-digest recorder
        (analysis/divergence.DigestRecorder). A crash-restarted node
        carries a fresh recorder whose stream begins at the replayed
        height — re-attach overwrites, and replayed heights are
        re-checked against the net's reference digests."""
        if recorder is not None:
            self._div_recorders[node_id] = recorder

    # ------------------------------------------------------------ checking

    def _check(self, invariant: str) -> None:
        self.checks[invariant] = self.checks.get(invariant, 0) + 1
        chaos.CHECKS.labels(invariant).inc()

    def _violate(self, invariant: str, step: int, **detail) -> None:
        self.violations.append(
            {"invariant": invariant, "step": step, **detail})
        chaos.VIOLATIONS.labels(invariant).inc()

    def note(self, kind: str, msg: str) -> None:
        """Non-violation observation (teardown hiccups, oddities) —
        recorded in the report, never affects the verdict."""
        self.notes.append({"kind": kind, "msg": msg})

    def expect_double_sign(self, key: tuple) -> None:
        self.expected_double_signs.add(key)

    def poll(self, step: int) -> None:
        """Drain every subscription; called once per runner step."""
        for node_id, sub in list(self._subs.items()):
            while True:
                item = sub.get_nowait()
                if item is None:
                    break
                data = item.data
                self._on_commit(step, node_id, data["block"])
        self._advance_lite(step)
        self._check_divergence(step)

    def _check_divergence(self, step: int) -> None:
        """Fold every recorder's new (height, digest) pairs into the
        per-height cross-check: the first digest seen for a height is
        the reference, every other node's digest must match it
        bit-for-bit."""
        for node_id, rec in list(self._div_recorders.items()):
            for height, hexd in rec.stream():
                seen = self._div_seen.setdefault(height, {})
                if seen.get(node_id) == hexd:
                    continue
                seen[node_id] = hexd
                ref = self._div_ref.get(height)
                if ref is None:
                    self._div_ref[height] = hexd
                    continue
                self._check("divergence")
                if hexd != ref:
                    self._violate("divergence", step, height=height,
                                  node=node_id, digest=hexd,
                                  expected=ref)

    def _advance_lite(self, step: int) -> None:
        """Certify every committed height whose (header, commit,
        valset) is readable, strictly in order. A height that FAILS
        certification is a violation and halts the certifier — trust
        cannot legitimately advance past it, and one loud report beats
        a violation per remaining height. A height whose data never
        appears (all its holders crashed) only trips after a patience
        window, as a note, not a violation: that is missing telemetry,
        not broken safety."""
        from tendermint_tpu_torch.lite.types import CertificationError
        if self.lite is None or not self._lite_active:
            return
        while self.lite.next_height <= self.max_height:
            h = self.lite.next_height
            fc = self._lite_provider(h)
            if fc is None:
                if self._lite_stuck_since is None:
                    self._lite_stuck_since = step
                elif step - self._lite_stuck_since > 200:
                    self.note("lite", f"height {h} unreadable for "
                              f"{step - self._lite_stuck_since} steps; "
                              f"certification halted")
                    self._lite_active = False
                return
            self._lite_stuck_since = None
            self._check("certified")
            try:
                self.lite.advance(fc)
            except CertificationError as e:
                self._violate("certified", step, height=h, error=str(e))
                self._lite_active = False
                return
            self.lite_valset_sizes[h] = len(fc.validators)

    def _on_commit(self, step: int, node_id: int, block) -> None:
        h = block.header.height
        hash_hex = block.hash().hex()

        # agreement: same height => same block, across every node
        rec = self.commits.get(h)
        if rec is None:
            rec = self.commits[h] = {"hash": hash_hex, "first_step": step,
                                     "nodes": {}}
            self.commit_steps.append((step, h))
        else:
            self._check("agreement")
            if rec["hash"] != hash_hex:
                self._violate("agreement", step, height=h, node=node_id,
                              hash=hash_hex, expected=rec["hash"])
        rec["nodes"][node_id] = hash_hex

        # validity: per node instance, heights strictly increase
        self._check("validity")
        last = self.node_height.get(node_id, 0)
        if h <= last:
            self._violate("validity", step, node=node_id, height=h,
                          last=last)
        self.node_height[node_id] = h
        self.max_height = max(self.max_height, h)

        # committed evidence harvest (for the evidence invariant)
        for ev in block.evidence.evidence:
            if isinstance(ev, DuplicateVoteEvidence):
                self.committed_evidence.add(double_sign_key(ev.vote_a))

    # ------------------------------------------------------------ finalize

    def finalize(self, schedule, final_step: int,
                 liveness_bound: int = 150,
                 step_seconds: float = 0.0) -> dict:
        """End-of-run checks + report. `step_seconds` (mean wall time
        per runner step) converts step latencies into seconds for the
        recovery histogram."""
        # one last certification sweep: the final heights' commits were
        # saved during the last steps and may not have been readable
        # when their poll ran
        self._advance_lite(final_step)
        self._check_divergence(final_step)
        # evidence: every injected double-sign must be committed
        for key in sorted(self.expected_double_signs):
            self._check("evidence")
            if key not in self.committed_evidence:
                self._violate("evidence", final_step, double_sign=key)

        # liveness + recovery latency per healed fault episode
        firsts = sorted(self.commit_steps)
        latencies = []
        episodes = []
        for ep in schedule.episodes():
            end = ep["end"]
            if end > final_step:
                continue  # episode never healed inside the run
            self._check("liveness")
            after = [s for s, _ in firsts if s >= end]
            lat = (after[0] - end) if after else None
            episodes.append({**ep, "recovery_steps": lat})
            if lat is None or lat > liveness_bound:
                self._violate("liveness", end, episode=ep,
                              recovery_steps=lat,
                              bound=liveness_bound)
            if lat is not None:
                latencies.append(lat)
                if step_seconds > 0:
                    chaos.RECOVERY.observe(lat * step_seconds)

        lat_s = [x * step_seconds for x in latencies] if step_seconds \
            else []
        lite = None
        if self.lite is not None:
            sizes = self.lite_valset_sizes
            lite = {
                "certified_height": self.lite.certified_height,
                "static_certified": self.lite.static_certified,
                "valset_updates": self.lite.updates,
                "final_valset_size": len(self.lite.validators),
                "valset_size_min": min(sizes.values(), default=0),
                "valset_size_max": max(sizes.values(), default=0),
                "active": self._lite_active,
            }
        return {
            "checks": dict(self.checks),
            "checks_total": sum(self.checks.values()),
            "violations": list(self.violations),
            "notes": list(self.notes),
            "heights": dict(self.node_height),
            "max_height": self.max_height,
            "evidence": {
                "injected_double_signs": len(self.expected_double_signs),
                "committed": len(self.committed_evidence
                                 & self.expected_double_signs),
            },
            "recovery": {
                "episodes": episodes,
                "latency_steps": _percentiles([float(x)
                                               for x in latencies]),
                "latency_seconds": _percentiles(
                    [round(x, 4) for x in lat_s]),
            },
            **({"lite": lite} if lite is not None else {}),
            **({"divergence": {
                "nodes": len(self._div_recorders),
                "heights_checked": len(self._div_ref),
                "mismatches": sum(1 for v in self.violations
                                  if v["invariant"] == "divergence"),
            }} if self._div_recorders else {}),
        }

    def dump_trace(self, path: str, schedule, report: Optional[dict] = None
                   ) -> str:
        """Replayable violation trace: everything needed to re-run the
        exact fault sequence (see docs/robustness.md)."""
        doc = {
            "seed": schedule.seed,
            "spec": schedule.spec,
            "fault_log": schedule.log,
            "fault_counts": schedule.counts,
            "commits": {str(h): rec for h, rec in
                        sorted(self.commits.items())},
            "violations": self.violations,
        }
        if report is not None:
            doc["report"] = report
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        return path
