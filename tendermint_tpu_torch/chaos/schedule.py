"""FaultSchedule — seeded, declarative fault orchestration: the port's
copy of `tendermint_tpu/chaos/schedule.py`.

One schedule instance owns ALL randomness of a chaos run: every
decision (drop/delay/duplicate/reorder per message, partition windows,
crash points, clock skew, byzantine windows) is drawn from one seeded
RNG in the deterministic order the single-threaded runner asks for
them, so the same (spec, seed) pair produces an identical fault
sequence — the acceptance contract that makes violation traces
replayable.

Spec (plain dict, JSON-serializable so traces can embed it):

    {
      "drop": 0.05,             # P(drop) per (message, destination)
      "delay": 0.10,            # P(delay) per delivery
      "delay_steps": [1, 4],    # delay range, in runner steps
      "duplicate": 0.03,        # P(second delivery of the same message)
      "reorder": 0.05,          # P(pushed behind later traffic by 1 step)
      "partitions": [           # cross-group traffic buffered until stop
        {"start": 30, "stop": 60, "groups": [[0], [1, 2, 3]]}
      ],
      "crashes": [              # hard-kill at a named commit fail point
        {"node": 2, "after_height": 3,
         "point": "consensus.before_save_block", "down_steps": 20}
      ],
      "clock_skew": {"1": 2},   # node 1's consensus clock runs 2x slow
                                # (chaos.ticker.StepTicker skew factor)
      "byzantine": [            # see chaos.byzantine for behaviors
        {"node": 0, "behavior": "equivocate", "start": 5, "stop": 80}
      ],
      "geo": {"profile": "wan3"},        # named latency/bandwidth/loss
                                # matrices over node pairs (regions
                                # assigned round-robin unless "assign"
                                # maps node -> region); or inline
                                # matrices under the same keys as a
                                # GEO_PROFILES entry
      "churn": {                # validator-set rotation driven by the
        "start_height": 2,      # runner through REAL val: txs (EndBlock
        "every_heights": 2,     # validator_updates — consensus applies
        "ops": ["join", "leave", "stake"],   # the deltas, not a test
        "standby": 2,           # trailing nodes kept OUT of genesis
        "max_events": 8,        # (join candidates); see runner
        "stake_step": 5,
      },
    }

Every field is optional; omitted faults never fire. Crash points must
name a utils/fail.py COMMIT_POINTS or RECOVERY_POINTS entry — a typo would silently never
crash, so the constructor validates them. Geo and churn draw from the
seeded RNG ONLY when configured, so every pre-existing spec's fault
log stays byte-identical.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

from tendermint_tpu_torch.utils.fail import COMMIT_POINTS, RECOVERY_POINTS

_RATE_KEYS = ("drop", "delay", "duplicate", "reorder")

# -- geo profiles -----------------------------------------------------------
# Named WAN shapes: per-region-pair latency (in runner steps — the test
# config's 100ms propose timeout is 10 steps, so a 3-5-step cross-
# region hop is a realistic fraction of a round), jitter, loss
# probability, and a bandwidth cap (messages per step per directed
# region pair; 0 = unlimited — intra-region links are never capped).
# The diagonal is the intra-region link. Matrices need not be
# symmetric (real WAN routes aren't).
GEO_PROFILES = {
    # 3-region WAN: two nearby regions (e.g. us-east/us-west) and one
    # far one (apac) with a lossier, thinner long-haul link
    "wan3": {
        "latency_steps": [[0, 2, 5],
                          [2, 0, 4],
                          [5, 4, 0]],
        "jitter_steps": 1,
        "loss": [[0.0, 0.005, 0.02],
                 [0.005, 0.0, 0.01],
                 [0.02, 0.01, 0.0]],
        "bandwidth_msgs": [[0, 96, 48],
                           [96, 0, 64],
                           [48, 64, 0]],
    },
    # 2-region split: one ocean between two halves of the valset
    "wan2": {
        "latency_steps": [[0, 4],
                          [4, 0]],
        "jitter_steps": 1,
        "loss": [[0.0, 0.01],
                 [0.01, 0.0]],
        "bandwidth_msgs": [[0, 64],
                           [64, 0]],
    },
}

_GEO_KEYS = ("profile", "assign", "latency_steps", "jitter_steps",
             "loss", "bandwidth_msgs")
_CHURN_OPS = ("join", "leave", "stake")
_CHURN_KEYS = ("start_height", "every_heights", "ops", "standby",
               "max_events", "stake_step")


class FaultSchedule:
    def __init__(self, spec: Optional[dict] = None, seed: int = 0):
        spec = dict(spec or {})
        self.seed = int(seed)
        self.spec = spec
        self._rng = random.Random(self.seed)
        self.rates = {k: float(spec.get(k, 0.0)) for k in _RATE_KEYS}
        lo, hi = spec.get("delay_steps", (1, 3))
        self.delay_lo, self.delay_hi = int(lo), int(hi)
        self.partitions = [dict(p) for p in spec.get("partitions", ())]
        for p in self.partitions:
            p["groups"] = [list(g) for g in p["groups"]]
        self.crashes = [dict(c) for c in spec.get("crashes", ())]
        for c in self.crashes:
            point = c.setdefault("point", COMMIT_POINTS[0])
            if point not in COMMIT_POINTS + RECOVERY_POINTS:
                raise ValueError(
                    f"unknown crash point {point!r} "
                    f"(known: {COMMIT_POINTS + RECOVERY_POINTS})")
            c.setdefault("down_steps", 20)
            c.setdefault("after_height", 1)
        self.clock_skew: Dict[int, int] = {
            int(k): int(v) for k, v in spec.get("clock_skew", {}).items()}
        self.byzantine = [dict(b) for b in spec.get("byzantine", ())]
        self.geo = self._resolve_geo(spec.get("geo"))
        self.churn = self._resolve_churn(spec.get("churn"))
        # bandwidth bookkeeping: (src_region, dst_region) -> [step, used]
        self._bw_used: Dict[tuple, list] = {}
        # fault event log: the replayable record (and the determinism
        # witness — two runs with one seed must produce equal logs)
        self.log: List[dict] = []
        self.counts: Dict[str, int] = {}

    # ------------------------------------------------------------ validation

    @staticmethod
    def _resolve_geo(g) -> Optional[dict]:
        """Resolve the geo spec into concrete matrices; None when the
        spec has no geo key. Validates loudly: a typoed profile name or
        a ragged matrix silently injecting nothing would defeat the
        run."""
        if not g:
            return None
        g = dict(g)
        for k in g:
            if k not in _GEO_KEYS:
                raise ValueError(f"unknown geo spec key {k!r} "
                                 f"(known: {_GEO_KEYS})")
        prof = {}
        if "profile" in g:
            name = g.pop("profile")
            if name not in GEO_PROFILES:
                raise ValueError(
                    f"unknown geo profile {name!r} "
                    f"(known: {sorted(GEO_PROFILES)})")
            prof = dict(GEO_PROFILES[name])
        prof.update(g)
        lat = prof.get("latency_steps")
        if not lat:
            raise ValueError("geo spec needs a profile or latency_steps")
        n = len(lat)
        out = {
            "latency_steps": [[int(x) for x in row] for row in lat],
            "jitter_steps": int(prof.get("jitter_steps", 0)),
            "loss": [[float(x) for x in row]
                     for row in prof.get("loss", [[0.0] * n] * n)],
            "bandwidth_msgs": [[int(x) for x in row] for row in
                               prof.get("bandwidth_msgs",
                                        [[0] * n] * n)],
            "assign": {int(k): int(v) for k, v in
                       dict(prof.get("assign") or {}).items()},
            "regions": n,
        }
        for key in ("latency_steps", "loss", "bandwidth_msgs"):
            m = out[key]
            if len(m) != n or any(len(row) != n for row in m):
                raise ValueError(f"geo {key} must be {n}x{n}")
        return out

    @staticmethod
    def _resolve_churn(c) -> Optional[dict]:
        if not c:
            return None
        c = dict(c)
        for k in c:
            if k not in _CHURN_KEYS:
                raise ValueError(f"unknown churn spec key {k!r} "
                                 f"(known: {_CHURN_KEYS})")
        ops = [str(o) for o in c.get("ops", _CHURN_OPS)]
        for o in ops:
            if o not in _CHURN_OPS:
                raise ValueError(f"unknown churn op {o!r} "
                                 f"(known: {_CHURN_OPS})")
        return {
            "start_height": int(c.get("start_height", 2)),
            "every_heights": max(1, int(c.get("every_heights", 2))),
            "ops": ops,
            "standby": int(c.get("standby", 0)),
            "max_events": int(c.get("max_events", 8)),
            "stake_step": int(c.get("stake_step", 5)),
        }

    # ------------------------------------------------------------------- geo

    def region_of(self, node: int) -> int:
        """Node -> region: explicit assignment, else round-robin (which
        spreads every region across the id space, so partitions/crashes
        by node id stay region-diverse)."""
        if self.geo is None:
            return 0
        return self.geo["assign"].get(node, node % self.geo["regions"])

    def _geo_deliveries(self, step: int, src: int, dst: int,
                        msg_type: str, delays: List[int]) -> List[int]:
        """Overlay the geo link on base delivery decisions: loss can
        still drop it, latency+jitter shift every copy, and the
        bandwidth cap spills overflow into later steps. Runs ONLY when
        a geo spec is configured — the RNG stream (and so every pinned
        fault log) is untouched otherwise."""
        g = self.geo
        rs, rd = self.region_of(src), self.region_of(dst)
        if rs == rd and not g["latency_steps"][rs][rd]:
            return delays  # intra-region: free, uncapped
        if g["loss"][rs][rd] and self._rng.random() < g["loss"][rs][rd]:
            self.record("geo_drop", step, src=src, dst=dst,
                        msg=msg_type, link=f"{rs}->{rd}")
            return []
        base = g["latency_steps"][rs][rd]
        if g["jitter_steps"]:
            base += self._rng.randint(0, g["jitter_steps"])
        cap = g["bandwidth_msgs"][rs][rd]
        if cap:
            used = self._bw_used.setdefault((rs, rd), [step, 0])
            if used[0] != step:
                used[0], used[1] = step, 0
            used[1] += len(delays)
            over = (used[1] - 1) // cap
            if over:
                # queueing delay: the k-th capful this step departs k
                # steps later — a thin long-haul pipe, not a drop
                base += over
                self.record("geo_throttle", step, src=src, dst=dst,
                            msg=msg_type, link=f"{rs}->{rd}",
                            spill_steps=over)
        return [d + base for d in delays]

    # ---------------------------------------------------------------- record

    def record(self, kind: str, step: int, **detail) -> None:
        self.counts[kind] = self.counts.get(kind, 0) + 1
        self.log.append({"kind": kind, "step": step, **detail})
        from tendermint_tpu_torch import chaos
        chaos.record_fault(kind)

    # ----------------------------------------------------------- link faults

    def link_deliveries(self, step: int, src: int, dst: int,
                        msg_type: str) -> List[int]:
        """Delivery delays (in steps) for one (message, dst): [] = drop,
        [0] = now, [2] = delayed, [0, 1] = duplicated. Consensus-critical
        and chaos-forged messages alike pass through here — the runner
        decides what to feed."""
        r = self.rates
        if r["drop"] and self._rng.random() < r["drop"]:
            self.record("drop", step, src=src, dst=dst, msg=msg_type)
            return []
        delay = 0
        if r["delay"] and self._rng.random() < r["delay"]:
            delay = self._rng.randint(self.delay_lo, self.delay_hi)
            self.record("delay", step, src=src, dst=dst, msg=msg_type,
                        steps=delay)
        elif r["reorder"] and self._rng.random() < r["reorder"]:
            # pushed behind the traffic of the next step: genuine
            # reordering relative to everything sent after it
            delay = 1
            self.record("reorder", step, src=src, dst=dst, msg=msg_type)
        out = [delay]
        if r["duplicate"] and self._rng.random() < r["duplicate"]:
            out.append(delay + self._rng.randint(0, 2))
            self.record("duplicate", step, src=src, dst=dst, msg=msg_type)
        if self.geo is not None:
            # geo rides UNDER the link faults at the relay — the only
            # delivery path, so no conn (burst or otherwise) bypasses
            # the WAN shape; geo latency is topology, not a fault, so
            # only its losses/throttles enter the fault log
            out = self._geo_deliveries(step, src, dst, msg_type, out)
        return out

    # ------------------------------------------------------------ partitions

    def partition_of(self, step: int, node: int) -> Optional[tuple]:
        """(partition_index, group_index) when `node` sits in an active
        partition at `step`, else None."""
        for pi, p in enumerate(self.partitions):
            if p["start"] <= step < p["stop"]:
                for gi, group in enumerate(p["groups"]):
                    if node in group:
                        return (pi, gi)
        return None

    def cross_partition(self, step: int, src: int, dst: int) -> bool:
        a, b = self.partition_of(step, src), self.partition_of(step, dst)
        if a is None and b is None:
            return False
        return a != b

    # ------------------------------------------------------ crashes/byzantine

    def crash_for(self, node: int, height: int,
                  step: int) -> Optional[dict]:
        """The pending crash event for `node` once it has committed
        `after_height` — one-shot (consumed by the runner)."""
        for c in self.crashes:
            if not c.get("_fired") and c["node"] == node and \
                    height >= c["after_height"]:
                return c
        return None

    def byzantine_for(self, node: int, step: int) -> Optional[str]:
        for b in self.byzantine:
            if b["node"] == node and \
                    b.get("start", 0) <= step < b.get("stop", 1 << 30):
                return b["behavior"]
        return None

    # --------------------------------------------------------------- windows

    def episodes(self) -> List[dict]:
        """Fault windows with known end points, for the monitor's
        liveness/recovery bookkeeping. Crash ends are stamped by the
        runner at restart time (actual step recorded in the event)."""
        out = []
        for p in self.partitions:
            out.append({"kind": "partition", "start": p["start"],
                        "end": p["stop"]})
        for b in self.byzantine:
            if "stop" in b:
                out.append({"kind": f"byzantine:{b['behavior']}",
                            "start": b.get("start", 0), "end": b["stop"]})
        for e in self.log:
            if e["kind"] == "restart":
                out.append({"kind": "crash", "start": e["crash_step"],
                            "end": e["step"], "node": e["node"]})
        return out

    def signature(self) -> List[tuple]:
        """Compact deterministic digest of the fault sequence (the
        same-seed acceptance check compares two of these)."""
        return [tuple(sorted(e.items())) for e in self.log]
