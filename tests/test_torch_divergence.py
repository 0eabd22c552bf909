"""The port's divergence plane (analysis/divergence.py) against the JAX
package's, on the CPU, tolerance 0.

- The scripted single-validator trajectory of seed 7 gives the JAX
  package's transition-digest stream on the port (device "cpu"), with
  the pipeline on (both packages' default) and off.
- The dual-PYTHONHASHSEED replay (two child processes of
  `python -m tendermint_tpu_torch.analysis.divergence --replay`) gives
  identical streams, equal to the in-process one.
- cross_check reports the same per-height mismatches as the JAX one.
- TM_CUDA_DIVERGENCE turns the executor's recorder on (TM_TPU_DIVERGENCE
  does not), and with the trace plane on the state machine stamps each
  height's digest on the causal timeline (`transition.digest`).
"""

import pytest

from tendermint_tpu.analysis import divergence as jdiv
from tendermint_tpu_torch import pipeline as tpipeline
from tendermint_tpu_torch.analysis import divergence as tdiv


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k in ("TM_TPU_DIVERGENCE", "TM_CUDA_DIVERGENCE", "TM_TPU_PIPELINE",
              "TM_CUDA_TRACE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(tpipeline, "_configured", "auto")


@pytest.mark.parametrize("mode", ["auto", "off"])
def test_replay_digests_seed7_equal_jax(monkeypatch, mode):
    monkeypatch.setenv("TM_TPU_PIPELINE", mode)
    monkeypatch.setattr(tpipeline, "_configured", mode)
    want = jdiv.replay_digests(seed=7)
    got = tdiv.replay_digests(seed=7, device="cpu")
    assert got == want
    assert len(got) == len(tdiv._SCRIPT) == 5
    assert [int(ln.split()[0]) for ln in got] == [1, 2, 3, 4, 5]


def test_dual_hash_seed_replay_identical_on_cpu():
    out = tdiv.run_dual_seed_replay(seed=7, device="cpu")
    assert out["identical"], out["streams"]
    assert out["heights"] == len(tdiv._SCRIPT)
    assert out["streams"][0].splitlines() == \
        tdiv.replay_digests(seed=7, device="cpu")


def _rec(mod, pairs):
    r = mod.DigestRecorder()
    with r._lock:
        for h, d in pairs:
            r._by_height[h] = d
    return r


def test_cross_check_reports_mismatches_as_jax():
    streams = {"a": [(1, "aa"), (2, "bb"), (3, "cc")],
               "b": [(1, "aa"), (2, "bX"), (3, "cc"), (4, "dd")],
               "c": [(2, "bb"), (3, "cY")]}
    got = tdiv.cross_check({k: _rec(tdiv, v) for k, v in streams.items()})
    want = jdiv.cross_check({k: _rec(jdiv, v) for k, v in streams.items()})
    assert got == want
    assert [m["height"] for m in got] == [2, 3]


def test_recorder_hatch_reads_only_the_ports_knob(monkeypatch):
    from tendermint_tpu_torch.models.verifier import BatchVerifier
    from tendermint_tpu_torch.state.execution import BlockExecutor
    v = BatchVerifier("python")
    monkeypatch.setenv("TM_TPU_DIVERGENCE", "on")
    assert not tdiv.enabled() and tdiv.maybe_recorder() is None
    assert BlockExecutor(None, None, verifier=v).divergence is None
    monkeypatch.setenv("TM_CUDA_DIVERGENCE", "on")
    rec = BlockExecutor(None, None, verifier=v).divergence
    assert isinstance(rec, tdiv.DigestRecorder) and rec.stream() == []


def test_transition_digest_points_on_the_causal_timeline(monkeypatch):
    from tendermint_tpu_torch.telemetry import causal
    causal.configure("on")
    causal.clear()
    try:
        stream = tdiv.replay_digests(seed=7, device="cpu")
        points = {ev["h"]: ev["a"]["digest"] for ev in
                  causal.dump()["spans"] if ev["n"] == "transition.digest"}
    finally:
        causal.configure("off")
        causal.clear()
    assert points == {int(ln.split()[0]): ln.split()[1][:16]
                      for ln in stream}
