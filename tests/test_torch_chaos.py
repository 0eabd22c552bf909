"""The port's chaos plane (tendermint_tpu_torch/chaos/) against the JAX
package's (tendermint_tpu/chaos/), on the CPU, tolerance 0.

- FaultSchedule: the same decision sequences, fault logs, counts and
  signatures for the pinned specs, the geo profiles, bandwidth spill,
  churn and the partition / skew / crash / byzantine lookups; the same
  exception classes and messages for every invalid spec, and for
  parse_spec.
- The knob: resolve() reads TM_CUDA_CHAOS, env over configure(), and a
  TM_TPU_CHAOS variable changes nothing; maybe_wrap_link's seeded
  decisions equal the JAX ones.
- ByzantineAgent: the forged conflicting vote, the withheld and the
  corrupted proposal are the JAX agent's messages byte for byte, and
  forget_locks records the same amnesia.
- InvariantMonitor fed the same synthetic streams: disagreement, height
  regression, missing evidence, liveness and an uncertifiable commit
  give the same verdicts and reports.
- Whole runs of run_chaos on device="cpu": SMOKE_SPEC, scale_spec(4),
  ACCEPTANCE_SPEC and an equivocator give the JAX package's
  fault_log_sha256, heights, steps, check counts, evidence and lite
  results; chip_smoke.py's phase-17 constants are those live values.
- A run asked for a trace writes it, and the trace's (spec, seed)
  reproduce the fault log; a run with TM_CUDA_LOCKCHECK=on reports no
  lock-order cycle.
"""

import ast
import copy
import json
import types
from pathlib import Path

import pytest

from tendermint_tpu import chaos as jchaos
from tendermint_tpu.chaos import byzantine as jbyz
from tendermint_tpu.chaos import monitor as jmon
from tendermint_tpu.chaos import runner as jrunner
from tendermint_tpu.chaos import schedule as jsched
from tendermint_tpu.chaos import wire as jwire
from tendermint_tpu_torch import chaos as tchaos
from tendermint_tpu_torch.chaos import byzantine as tbyz
from tendermint_tpu_torch.chaos import monitor as tmon
from tendermint_tpu_torch.chaos import runner as trunner
from tendermint_tpu_torch.chaos import schedule as tsched
from tendermint_tpu_torch.chaos import wire as twire

import chip_smoke

REPO = Path(__file__).resolve().parent.parent

RATE_SPEC = {"drop": 0.1, "delay": 0.2, "duplicate": 0.05, "reorder": 0.05}

SPECS = {
    "rates": RATE_SPEC,
    "acceptance": jrunner.ACCEPTANCE_SPEC,
    "smoke": jrunner.SMOKE_SPEC,
    "scale4": jrunner.scale_spec(4),
    "scale32": jrunner.scale_spec(32),
    "scale128": jrunner.scale_spec(128, full_churn=False),
    "wan3_drop": {"geo": {"profile": "wan3"}, "drop": 0.02},
    "wan2_assign": {"geo": {"profile": "wan2",
                            "assign": {0: 1, 1: 1, 2: 0}},
                    "delay": 0.3},
    "thin_pipe": {"geo": {"latency_steps": [[0, 1], [1, 0]],
                          "jitter_steps": 0,
                          "bandwidth_msgs": [[0, 3], [3, 0]]}},
}


def _drive(sched, nodes=6, steps=120):
    """Every decision and lookup of the schedule, in a fixed order."""
    out = []
    for step in range(steps):
        for src in range(nodes):
            for dst in range(nodes):
                if src != dst:
                    out.append(sched.link_deliveries(step, src, dst,
                                                     "vote"))
            out.append((sched.partition_of(step, src),
                        sched.byzantine_for(src, step),
                        sched.region_of(src)))
        out.append(sched.cross_partition(step, 0, 1))
    return out


@pytest.mark.parametrize("name", sorted(SPECS))
def test_schedule_decisions_and_logs_match_jax(name):
    spec = SPECS[name]
    for seed in (11, 42):
        j = jsched.FaultSchedule(copy.deepcopy(spec), seed=seed)
        t = tsched.FaultSchedule(copy.deepcopy(spec), seed=seed)
        assert _drive(t) == _drive(j)
        assert t.log == j.log and t.counts == j.counts
        assert t.signature() == j.signature()
        assert (t.geo, t.churn, t.crashes, t.clock_skew) == \
            (j.geo, j.churn, j.crashes, j.clock_skew)
        for node in range(6):
            for height in range(6):
                assert t.crash_for(node, height, 0) == \
                    j.crash_for(node, height, 0)
        assert t.episodes() == j.episodes()


def test_specs_and_profiles_are_the_jax_ones():
    assert trunner.ACCEPTANCE_SPEC == jrunner.ACCEPTANCE_SPEC
    assert trunner.SMOKE_SPEC == jrunner.SMOKE_SPEC
    for n in (4, 8, 32, 64, 128):
        for full in (True, False):
            assert trunner.scale_spec(n, full) == jrunner.scale_spec(n, full)
    assert tsched.GEO_PROFILES == jsched.GEO_PROFILES


BAD_SPECS = [
    {"crashes": [{"node": 0, "point": "no_such"}]},
    {"geo": {"profile": "atlantis"}},
    {"geo": {"profile": "wan3", "latencey": 1}},
    {"geo": {"latency_steps": [[0, 1], [1]]}},
    {"geo": {"jitter_steps": 1}},
    {"geo": {"latency_steps": [[0, 1], [1, 0]], "loss": [[0.0]]}},
    {"churn": {"ops": ["jion"]}},
    {"churn": {"every": 3}},
]


def _raised(fn, *a, **kw):
    try:
        fn(*a, **kw)
    except Exception as e:
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("spec", BAD_SPECS, ids=range(len(BAD_SPECS)))
def test_schedule_validation_errors_match_jax(spec):
    got = _raised(tsched.FaultSchedule, spec)
    assert got is not None and got == _raised(jsched.FaultSchedule, spec)


@pytest.mark.parametrize("text", [
    "drop=0.1,delay=0.2,delay_ms=25,seed=9", " drop = 0.5 ,, reorder=0.1",
    "duplicate=1", "dorp=0.1", "drop", "seed=x", "delay_ms=abc", ""])
def test_parse_spec_matches_jax(text):
    assert _raised(tchaos.parse_spec, text) == \
        _raised(jchaos.parse_spec, text)
    if _raised(jchaos.parse_spec, text) is None:
        assert tchaos.parse_spec(text) == jchaos.parse_spec(text)


# ------------------------------------------------------------- the knob

@pytest.fixture
def chaos_knob(monkeypatch):
    for k in ("TM_CUDA_CHAOS", "TM_TPU_CHAOS"):
        monkeypatch.delenv(k, raising=False)
    yield monkeypatch
    tchaos.configure("off", 0)
    jchaos.configure("off", 0)


def test_resolve_reads_tm_cuda_chaos_and_ignores_tm_tpu(chaos_knob):
    link = object()
    tchaos.configure("off", 0)
    assert tchaos.resolve() == (False, {}, 0)
    assert tchaos.maybe_wrap_link(link, "peer") is link
    chaos_knob.setenv("TM_TPU_CHAOS", "drop=0.5,seed=3")
    assert tchaos.resolve() == (False, {}, 0)
    assert tchaos.maybe_wrap_link(link, "peer") is link
    chaos_knob.setenv("TM_CUDA_CHAOS", "drop=0.5,seed=3")
    assert tchaos.resolve() == (True, {"drop": 0.5}, 3)
    assert tchaos.maybe_wrap_link(link, "peer") is not link
    # env wins over configure(); off in env beats a configured spec
    tchaos.configure("drop=0.5", 1)
    chaos_knob.setenv("TM_CUDA_CHAOS", "off")
    assert tchaos.maybe_wrap_link(link, "peer") is link
    chaos_knob.delenv("TM_CUDA_CHAOS")
    assert tchaos.resolve() == (True, {"drop": 0.5}, 1)
    tchaos.configure("on", 5)
    assert tchaos.resolve() == (True, {}, 5)


@pytest.mark.parametrize("mode,seed,peer", [
    ("drop=0.3,delay=0.4,delay_ms=5", 7, "ab" * 20),
    ("drop=0.1,seed=9", 0, ""), ("delay=1", 3, "peer")])
def test_link_wrapper_decisions_match_jax(chaos_knob, mode, seed, peer):
    tchaos.configure(mode, seed)
    jchaos.configure(mode, seed)
    tl = tchaos.maybe_wrap_link(object(), peer)
    jl = jchaos.maybe_wrap_link(object(), peer)
    ops = ("write", "read") * 300
    assert [tl.decider(op) for op in ops] == [jl.decider(op) for op in ops]


# ----------------------------------------------------------- byzantine

def _pkg(name):
    """(keys, block, vote) modules of one package."""
    import importlib
    return tuple(importlib.import_module(f"{name}.types.{m}")
                 for m in ("keys", "block", "vote"))


def _vote(pkg, block_hash=b"\x5a" * 32):
    keys, blk, vt = pkg
    key = keys.PrivKey.generate(b"\x07" * 32)
    v = vt.Vote(key.pubkey.address, 1, 5, 2, 123_456, vt.VoteType.PREVOTE,
                blk.BlockID(block_hash, blk.PartSetHeader(3, b"\x33" * 32)))
    v.signature = key.sign(v.sign_bytes("byz-chain"))
    return key, v


def test_agent_messages_match_jax():
    out = {}
    for name, byz, sched_mod in (("tendermint_tpu", jbyz, jsched),
                                 ("tendermint_tpu_torch", tbyz, tsched)):
        pkg = _pkg(name)
        key, v = _vote(pkg)
        _, nil = _vote(pkg, block_hash=b"")
        sched = sched_mod.FaultSchedule()
        expected = []
        agent = byz.ByzantineAgent(
            1, key, "byz-chain", sched,
            monitor=types.SimpleNamespace(
                expect_double_sign=expected.append))
        vote_msg = {"type": "vote", "vote": v.to_obj()}
        prop = {"type": "proposal",
                "proposal": {"height": 5, "signature": "ab" * 64}}
        part = {"type": "block_part", "height": 5, "part": {"index": 0}}
        msgs = [agent.transform(3, "equivocate", vote_msg),
                agent.transform(3, "equivocate",
                                {"type": "vote", "vote": nil.to_obj()}),
                agent.transform(3, "equivocate", prop),
                agent.transform(4, "withhold_proposal", prop),
                agent.transform(4, "withhold_proposal", part),
                agent.transform(4, "withhold_proposal", vote_msg),
                agent.transform(5, "invalid_proposal", prop),
                agent.transform(5, "invalid_proposal", part),
                agent.transform(6, "amnesia", vote_msg)]
        rs = types.SimpleNamespace(locked_block=object(), locked_round=2,
                                   locked_block_parts=object(), height=5,
                                   round=3)
        byz.forget_locks(types.SimpleNamespace(rs=rs), sched, 7, 1)
        byz.forget_locks(types.SimpleNamespace(rs=rs), sched, 8, 1)
        forged = msgs[0][1]["vote"]
        out[name] = (msgs, sched.log, sched.counts, expected,
                     byz.double_sign_key(v), byz.BEHAVIORS,
                     (rs.locked_block, rs.locked_round), forged)
    assert out["tendermint_tpu_torch"] == out["tendermint_tpu"]
    # the forged twin verifies under the validator's key
    _, blk, vt = _pkg("tendermint_tpu_torch")
    key, _ = _vote(_pkg("tendermint_tpu_torch"))
    evil = vt.Vote.from_obj(out["tendermint_tpu_torch"][-1])
    assert evil.block_id.hash == b"\xee" * 32
    assert key.pubkey.verify(evil.sign_bytes("byz-chain"), evil.signature)


# ------------------------------------------------------------ monitor

def _fake_block(height, tag=b"A", evidence=()):
    blk = types.SimpleNamespace()
    blk.header = types.SimpleNamespace(height=height)
    blk.evidence = types.SimpleNamespace(evidence=list(evidence))
    blk.hash = lambda: tag * 32
    return blk


def _monitor_stream(mon_mod, sched_mod):
    m = mon_mod.InvariantMonitor()
    m._on_commit(1, 0, _fake_block(3, b"A"))
    m._on_commit(2, 1, _fake_block(3, b"B"))   # disagreement
    m._on_commit(3, 0, _fake_block(3, b"A"))   # node 0 re-commits 3
    m._on_commit(4, 0, _fake_block(4, b"C"))
    m.expect_double_sign(("ab", 2, 0, 1))      # never committed
    m.expect_double_sign(("cd", 2, 0, 2))
    m.note("teardown", "node 3 stop: x")
    sched = sched_mod.FaultSchedule({
        "partitions": [{"start": 1, "stop": 3, "groups": [[0], [1]]},
                       {"start": 5, "stop": 10, "groups": [[0], [1]]}],
        "byzantine": [{"node": 1, "behavior": "amnesia", "start": 0,
                       "stop": 2}]})
    sched.log.append({"kind": "restart", "step": 4, "node": 2,
                      "crash_step": 2})
    rep = m.finalize(sched, final_step=400, liveness_bound=50,
                     step_seconds=0.01)
    return rep, m.commits, m.commit_steps


def test_monitor_verdicts_match_jax():
    got = _monitor_stream(tmon, tsched)
    want = _monitor_stream(jmon, jsched)
    assert got == want
    kinds = sorted(v["invariant"] for v in got[0]["violations"])
    assert kinds == ["agreement", "evidence", "evidence", "liveness",
                     "validity"]
    assert tmon.INVARIANTS == jmon.INVARIANTS


def _lite_chain(name, n_vals=4):
    """FullCommits of heights 1 and 2 in one package; height 2's
    precommits carry zeroed signatures."""
    import importlib
    keys, blk, vt = _pkg(name)
    vsm = importlib.import_module(f"{name}.types.validator_set")
    lite = importlib.import_module(f"{name}.lite")
    sks = [keys.PrivKey.generate(bytes([i + 1]) * 32) for i in range(n_vals)]
    vs = vsm.ValidatorSet([vsm.Validator(k.pubkey.ed25519, 10) for k in sks])
    by_addr = {k.pubkey.address: k for k in sks}
    fcs = {}
    for h in (1, 2):
        header = blk.Header(chain_id="lite-mon", height=h, time_ns=h,
                            validators_hash=vs.hash(),
                            app_hash=h.to_bytes(32, "big"))
        bid = blk.BlockID(header.hash(), blk.PartSetHeader(1, b"\x22" * 32))
        votes = []
        for idx, val in enumerate(vs.validators):
            v = vt.Vote(val.address, idx, h, 0, h, vt.VoteType.PRECOMMIT,
                        bid)
            v.signature = (by_addr[val.address].sign(v.sign_bytes(
                "lite-mon")) if h == 1 else b"\x00" * 64)
            votes.append(v)
        fcs[h] = lite.FullCommit(
            lite.SignedHeader(header, blk.Commit(bid, votes), bid), vs)
    return vs, fcs


def _lite_verdicts(mon_mod, name, verifier):
    vs, fcs = _lite_chain(name)
    m = mon_mod.InvariantMonitor()
    m.attach_lite("lite-mon", vs, fcs.get, verifier=verifier)
    m._on_commit(1, 0, _fake_block(2))
    m._advance_lite(step=1)
    first = (list(m.violations), dict(m.checks), m.lite.certified_height,
             dict(m.lite_valset_sizes))
    m._advance_lite(step=2)
    return first, dict(m.checks), m._lite_active


def test_monitor_lite_flags_uncertifiable_commit_as_jax():
    from tendermint_tpu.models.verifier import BatchVerifier as JVerifier
    from tendermint_tpu_torch.models.verifier import \
        BatchVerifier as TVerifier
    got = _lite_verdicts(tmon, "tendermint_tpu_torch",
                         TVerifier("auto", device="cpu", coalesce="off"))
    want = _lite_verdicts(jmon, "tendermint_tpu",
                          JVerifier("python", coalesce="off"))
    assert got == want
    (violations, _, certified, _), _, active = got
    assert [v["invariant"] for v in violations] == ["certified"]
    assert violations[0]["height"] == 2 and certified == 1 and not active


# ------------------------------------------------------- whole runs

#: report keys that do not depend on the wall clock
_KEYS = ("fault_log_sha256", "max_height", "steps", "heights", "checks",
         "checks_total", "violations", "evidence", "lite",
         "faults_injected", "faults_injected_total", "catchup_assists",
         "relay_dedup_skips", "n_nodes", "n_genesis_validators", "churn",
         "geo_regions", "seed", "notes")


def _view(rep: dict) -> dict:
    out = {k: rep.get(k) for k in _KEYS}
    rec = rep["recovery"]
    out["episodes"] = rec["episodes"]
    out["latency_steps"] = rec["latency_steps"]
    return out


def _both(**kw):
    want = jrunner.run_chaos(**copy.deepcopy(kw))
    got = trunner.run_chaos(device="cpu", **copy.deepcopy(kw))
    return got, want


def test_smoke_run_matches_jax():
    got, want = _both(spec=jrunner.SMOKE_SPEC, seed=7, target_height=4,
                      max_steps=400)
    assert _view(got) == _view(want)
    assert got["violations"] == [] and min(got["heights"].values()) >= 4
    f = got["faults_injected"]
    assert f.get("drop", 0) > 0 and f.get("delay", 0) > 0
    assert f.get("crash") == 1 and f.get("restart") == 1


def test_scale4_run_matches_jax_and_the_phase_17a_constants():
    c = chip_smoke.CHAOS_SCALE4
    got, want = _both(spec=jrunner.scale_spec(4), seed=chip_smoke.CHAOS_SEED,
                      n=c["n"], target_height=c["target"],
                      max_steps=c["max_steps"], settle_steps=c["settle"])
    assert _view(got) == _view(want)
    assert (got["fault_log_sha256"], got["max_height"], got["steps"]) == \
        (c["digest"], c["heights"], c["steps"])
    assert got["violations"] == []
    assert got["lite"]["certified_height"] == got["max_height"]
    assert set(got["churn"]) >= {"churn_join", "churn_leave", "churn_stake"}


def test_acceptance_run_matches_jax_and_the_phase_17b_constants():
    c = chip_smoke.CHAOS_CLASSIC
    got, want = _both(spec=jrunner.ACCEPTANCE_SPEC,
                      seed=chip_smoke.CHAOS_SEED)
    assert _view(got) == _view(want)
    assert (got["fault_log_sha256"], got["max_height"], got["steps"]) == \
        (c["digest"], c["heights"], c["steps"])
    assert got["violations"] == []
    ev = got["evidence"]
    assert ev["injected_double_signs"] > 0
    assert ev["committed"] == ev["injected_double_signs"]
    crash = [e for e in got["recovery"]["episodes"] if e["kind"] == "crash"]
    assert crash and crash[0]["node"] == 2
    assert jrunner.ACCEPTANCE_SPEC["crashes"][0]["point"] == \
        c["crash_point"]


def test_equivocation_evidence_committed_end_to_end_as_in_jax():
    spec = {"byzantine": [{"node": 1, "behavior": "equivocate",
                           "start": 2, "stop": 40}]}
    got, want = _both(spec=spec, seed=9, target_height=6, max_steps=500)
    assert _view(got) == _view(want)
    ev = got["evidence"]
    assert got["violations"] == [] and ev["injected_double_signs"] >= 1
    assert ev["committed"] == ev["injected_double_signs"]


def test_chip_smoke_scale32_constant_is_the_committed_artifact():
    """17c's digest is the 32-validator point of BENCH_chaos.json (a run
    of ~18 s a package: held on the card, not here)."""
    doc = json.loads((REPO / "BENCH_chaos.json").read_text())
    points = [p for p in doc["scaling_curve"] if p["n_validators"] == 32]
    c = chip_smoke.CHAOS_SCALE32
    assert points and points[0]["fault_log_sha256"] == c["digest"]
    assert (points[0]["blocks"], points[0]["steps"]) == \
        (c["heights"], c["steps"])
    assert points[0]["lite"]["certified_height"] == c["heights"]
    assert points[0]["lite"]["valset_updates"] == c["valset_updates"]


def test_violation_trace_is_written_and_replays(tmp_path):
    """The trace holds what the JAX one holds (block hashes aside: they
    carry the wall clock's vote times), and its (spec, seed) rebuild the
    run's fault log."""
    spec = {"drop": 0.05, "delay": 0.1}
    docs = []
    for run, name in ((trunner.run_chaos, "port"),
                      (jrunner.run_chaos, "jax")):
        path = str(tmp_path / f"{name}.json")
        kw = {"device": "cpu"} if name == "port" else {}
        r = run(spec=spec, seed=3, target_height=3, max_steps=300,
                trace_path=path, **kw)
        assert r["violations"] == [] and r["trace"] == path
        docs.append(json.loads(Path(path).read_text()))
    doc, jdoc = docs
    assert doc["seed"] == 3 and doc["spec"] == spec and doc["commits"]
    for key in ("seed", "spec", "fault_log", "fault_counts", "violations"):
        assert doc[key] == jdoc[key], key
    assert {h: (c["first_step"], sorted(c["nodes"]))
            for h, c in doc["commits"].items()} == \
        {h: (c["first_step"], sorted(c["nodes"]))
         for h, c in jdoc["commits"].items()}
    replay = trunner.run_chaos(spec=doc["spec"], seed=doc["seed"],
                               target_height=3, max_steps=300,
                               device="cpu")
    assert replay["fault_log_sha256"] == \
        doc["report"]["fault_log_sha256"]


def test_lockcheck_run_reports_no_cycle(monkeypatch):
    from tendermint_tpu_torch.analysis import lockwatch
    monkeypatch.setenv("TM_CUDA_LOCKCHECK", "on")
    lockwatch.clear()
    try:
        r = trunner.run_chaos(spec=trunner.SMOKE_SPEC, seed=7,
                              target_height=4, max_steps=400, device="cpu")
        assert r["violations"] == []
        lw = r["lockwatch"]
        assert lw["locks_watched"] > 50      # the watch really ran
        assert lw["edges"]                   # and saw real nesting
        assert lw["cycles"] == []
        assert lw["attr_violations"] == []
    finally:
        lockwatch.uninstall()
        lockwatch.clear()


# --------------------------------------------------------- the wire plan

def _bench_literal(name: str):
    """A literal assignment of bench.py, read without importing it."""
    tree = ast.parse((REPO / "bench.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                any(getattr(t, "id", "") == name for t in node.targets):
            return ast.literal_eval(node.value)
    raise KeyError(name)


def test_chip_smoke_wire_constants_match_bench_and_jax():
    assert chip_smoke.WIRECHAOS_SPEC == _bench_literal("WIRECHAOS_SPEC")
    assert chip_smoke.WIRECHAOS_HOSTILE == \
        _bench_literal("WIRECHAOS_HOSTILE")
    j = jwire.WireSchedule(chip_smoke.WIRECHAOS_SPEC,
                           seed=chip_smoke.CHAOS_SEED, n_nodes=4)
    t = twire.WireSchedule(chip_smoke.WIRECHAOS_SPEC,
                           seed=chip_smoke.CHAOS_SEED, n_nodes=4)
    assert t.plan_digest() == j.plan_digest() == \
        chip_smoke.WIRECHAOS_PLAN_SHA256
