"""The chaos plane — deterministic fault injection and its correctness
oracle: the port's copy of `tendermint_tpu/chaos/`.

  chaos.schedule   FaultSchedule — seeded RNG + declarative spec ->
                   drop/delay/duplicate/reorder, partitions and heals,
                   crash-restart, clock skew, byzantine windows, geo
                   matrices, valset churn. Same seed => identical fault
                   sequence.
  chaos.ticker     StepTicker — consensus timeouts in runner steps.
  chaos.byzantine  adversarial validator behaviors (equivocation via a
                   twin signer, amnesia, withheld/invalid proposals)
                   injected at the broadcast boundary.
  chaos.monitor    InvariantMonitor — subscribes to every node's
                   EventBus, asserts agreement/validity/evidence/
                   liveness/certified/divergence, dumps replayable
                   violation traces.
  chaos.runner     ChaosNet — an in-process N-validator net of real
                   Nodes under the schedule; run_chaos() returns the
                   report.
  chaos.wire       WireProxy — the seeded TCP fault proxy for socket
                   nets, with its plan and the RPC-polling
                   SocketInvariantMonitor.
  chaos.hostile    scripted hostile peers against a node's listener.

This module holds the knobs and the four `chaos_*` families, so the
socket path stays import-light. Resolution order, as in the JAX
package: the TM_CUDA_CHAOS env knob wins, then node.py's configure()
from config.base.chaos / chaos_seed, then "off". A TM_TPU_CHAOS variable
changes nothing here. `off` is a no-op: maybe_wrap_link returns the
link unchanged, so the p2p hot paths run on the existing code.

Spec strings (env/config — link-level faults only; the dict spec of
chaos.schedule is for the in-process runner):

    TM_CUDA_CHAOS=off                              # default
    TM_CUDA_CHAOS=drop=0.05,delay=0.1,delay_ms=30,seed=7
"""

from __future__ import annotations

import random
import zlib

from tendermint_tpu_torch import telemetry
from tendermint_tpu_torch.utils import knobs

# -- telemetry (registered at import; recorded only while enabled) ---------

FAULTS = telemetry.counter(
    "chaos_faults_injected_total",
    "Faults injected by the chaos plane, by kind", ("kind",))
CHECKS = telemetry.counter(
    "chaos_invariant_checks_total",
    "Invariant checks evaluated by the chaos monitor", ("invariant",))
VIOLATIONS = telemetry.counter(
    "chaos_invariant_violations_total",
    "Invariant violations detected by the chaos monitor", ("invariant",))
RECOVERY = telemetry.histogram(
    "chaos_recovery_seconds",
    "Wall time from a fault episode healing to the next committed height")

# -- knobs -----------------------------------------------------------------

_cfg_mode: str = "off"
_cfg_seed: int = 0


def configure(mode: str = "off", seed: int = 0) -> None:
    """Node-level wiring (config.base.chaos / chaos_seed)."""
    global _cfg_mode, _cfg_seed
    _cfg_mode = str(mode or "off").strip()
    _cfg_seed = int(seed or 0)


def parse_spec(s: str) -> dict:
    """'drop=0.05,delay=0.1,delay_ms=30,seed=7' -> dict. Unknown keys
    raise: a typoed fault knob silently injecting nothing would defeat
    the whole point of a chaos run."""
    out: dict = {}
    for part in s.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"bad chaos spec entry {part!r}")
        k, v = part.split("=", 1)
        k = k.strip().lower()
        if k in ("drop", "delay", "duplicate", "reorder"):
            out[k] = float(v)
        elif k in ("delay_ms",):
            out[k] = float(v)
        elif k in ("seed",):
            out[k] = int(v)
        else:
            raise ValueError(f"unknown chaos spec key {k!r}")
    return out


def resolve() -> tuple[bool, dict, int]:
    """-> (enabled, link_spec, seed). Env TM_CUDA_CHAOS wins over the
    configured mode; 'off'/'' disables. Read per call, so a process
    harness flips it through the child's environment."""
    mode = _cfg_mode
    env = knobs.knob_spec("TM_CUDA_CHAOS")
    if env:
        mode = env
    if not mode or mode.lower() in knobs.FALSY:
        return False, {}, 0
    spec = parse_spec(mode) if "=" in mode else {}
    seed = spec.pop("seed", _cfg_seed)
    return True, spec, seed


def maybe_wrap_link(link, peer_id: str = ""):
    """Wrap a p2p link in a schedule-driven FuzzedLink when the chaos
    plane is on; return it UNCHANGED when off. The per-link RNG is
    derived from (seed, peer_id), so a net's fault pattern is stable
    across runs but distinct per link."""
    enabled, spec, seed = resolve()
    if not enabled:
        return link
    from tendermint_tpu_torch.p2p.fuzz import FuzzedLink
    drop_p = float(spec.get("drop", 0.0))
    delay_p = float(spec.get("delay", 0.0))
    delay_s = float(spec.get("delay_ms", 30.0)) / 1e3
    rng = random.Random((seed << 32)
                        ^ zlib.crc32(peer_id.encode() or b"link"))

    def decide(op: str):
        if drop_p and rng.random() < drop_p:
            return "drop"
        if delay_p and rng.random() < delay_p:
            return ("delay", rng.random() * delay_s)
        return None

    return FuzzedLink(link, decider=decide,
                      on_fault=lambda kind: FAULTS.labels(kind).inc())


def record_fault(kind: str) -> None:
    """Count one injected fault (shared by schedule/byzantine/runner)."""
    FAULTS.labels(kind).inc()
