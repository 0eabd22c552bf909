"""The light-client cell at a small size on the CPU: a sound run is
correct; the control and planted faults make it not correct (a client
that skips the trusted set's rule, a client that stops after its first
window, a client that takes every verdict as true from its third window
on); the generator and the reference are deterministic by seed. Each
run drives the rest of a run (harness.run_once), skipping the look for a
card, as test_portbench_controls.py does for the other cells."""

import json
import time

import pytest
import torch

from portbench import harness
from portbench.gen.lite import LiteChain, most_at_or_below
from portbench.reference import lite as ref_lite

BENCH = harness.load_benchmark(harness.ROOT.parent)
CELL = "lite100-sync"
SEED = 2 ** 31 + 23


def _small(ctx):
    ctx.config.update(validators=8, head=0, absent=[0, 1])
    # windows of 4: 2-5, 6-9, 10-13 and the short last one, 14; a forged
    # side chain of each kind in the first, in a middle one and in the last
    ctx.traffic.update(headers=14, sample_sigs=8, forge_at=[
        [kind, lo, hi] for lo, hi in ((2, 5), (6, 13), (14, 14))
        for kind in ("signature", "unknown_keys")])


def _run(control=""):
    code, lines, result = harness.run_once(
        harness.ROOT, BENCH, harness.cell_of(BENCH, CELL), SEED, 0.3,
        False, control, torch.device("cpu"), time.perf_counter(),
        ctx_hook=_small)
    assert code == 0, lines
    return json.loads(result)


@pytest.fixture(autouse=True)
def _small_windows(monkeypatch):
    # small calls go straight to the verifier's host route; windows of 4
    # headers, so that a sync takes several
    from tendermint_tpu_torch.lite import certifier
    monkeypatch.setenv("TM_CUDA_COALESCE", "off")
    monkeypatch.setattr(certifier, "default_window", lambda n: 4)


def test_a_sound_run_is_correct():
    out = _run()
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["metrics"]["blocks_per_s"]["value"] > 0


def test_the_control_is_not_correct():
    out = _run("accept_all")
    assert out["correct"] is False
    assert out["checks"]["forged_halts_off"]["value"] > 0


def test_a_client_that_skips_the_trusted_sets_rule_is_caught(monkeypatch):
    from tendermint_tpu_torch.types.validator_set import ValidatorSet
    inner = ValidatorSet.check_commit_any_results

    def new_set_only(self, new_set, ok, powers):
        # the trusted set's rule read as the new set's
        inner(new_set, new_set, ok, [(n, n) for _, n in powers])
    monkeypatch.setattr(ValidatorSet, "check_commit_any_results",
                        new_set_only)
    out = _run()
    assert out["correct"] is False
    assert out["checks"]["forged_halts_off"]["value"] > 0


def test_a_client_that_stops_after_its_first_window_is_caught(monkeypatch):
    from tendermint_tpu_torch.lite import InquiringCertifier
    inner = InquiringCertifier.certify_range

    def first_window(self, lo, hi):
        inner(self, lo, min(hi, lo + 3))
    monkeypatch.setattr(InquiringCertifier, "certify_range", first_window)
    out = _run()
    assert out["correct"] is False
    assert out["checks"]["syncs_off_reference"]["value"] > 0


class _AllTrue:
    """A window's pending verdicts, read as all true."""

    def __init__(self, fut):
        self.fut = fut

    def result(self):
        return [True] * len(self.fut.result())


def test_a_client_that_stops_verifying_after_two_windows_is_caught(
        monkeypatch):
    # from its third window on, the client takes every verdict as true:
    # only the forged signatures of the later windows can show it
    from tendermint_tpu_torch.lite import InquiringCertifier
    inner = InquiringCertifier._check
    seen = {}

    def trusting(self, h0, plans, fut):
        seen[id(self)] = n = seen.get(id(self), 0) + 1
        if n >= 3 and fut is not None:
            fut = _AllTrue(fut)
        inner(self, h0, plans, fut)
    monkeypatch.setattr(InquiringCertifier, "_check", trusting)
    out = _run()
    assert out["correct"] is False
    assert out["checks"]["forged_halts_off"]["value"] > 0
    assert out["checks"]["syncs_off_reference"]["value"] == 0


CFG = json.loads((harness.ROOT / "configs" / "lite100.json").read_text())
SMALL_CFG = dict(CFG, validators=8, head=0, absent=[0, 1])


def test_the_generator_is_deterministic_by_seed():
    a, b = (LiteChain(SMALL_CFG, SEED, 6) for _ in range(2))
    assert a.replies == b.replies
    assert LiteChain(SMALL_CFG, SEED + 1, 6).replies != a.replies
    # every height is a change of the set
    hashes = [json.loads(a.replies[h][0])["header"]["validators_hash"]
              for h in range(1, 7)]
    assert len(set(hashes)) == 6


def test_the_reference_is_deterministic_and_halts_at_the_forgeries():
    import random
    chain = LiteChain(SMALL_CFG, SEED, 10)
    clean = ref_lite.sync(chain.chain_id, chain.replies.get, 1, 2, 10)
    assert clean == ref_lite.sync(chain.chain_id, chain.replies.get, 1, 2,
                                  10)
    assert clean["error"] is None and clean["height"] == 10
    assert clean["transitions"] == clean["certified"] == 9
    replies, (h, j), _ = chain.forged_signature(5, random.Random(1))
    out = ref_lite.sync(chain.chain_id, replies.get, 1, 2, 10, {(h, j)})
    assert (out["at"], out["height"]) == (5, 4)
    assert out["error"] == ("CertificationError",
                            "cannot bridge trust from 4 to 5")
    replies, signing, total = chain.unknown_keys(7, random.Random(2))
    assert signing * 3 <= total * 2
    out = ref_lite.sync(chain.chain_id, replies.get, 1, 2, 10)
    assert (out["at"], out["height"]) == (7, 6)


@pytest.mark.parametrize("powers,limit", [([3, 5, 7, 11], 14),
                                          ([10, 10, 10], 20),
                                          ([4, 9], 3)])
def test_the_subset_with_the_most_power_at_or_below(powers, limit):
    best = max(sum(p for i, p in enumerate(powers) if m >> i & 1)
               for m in range(1 << len(powers))
               if sum(p for i, p in enumerate(powers) if m >> i & 1)
               <= limit)
    assert sum(powers[i] for i in most_at_or_below(powers, limit)) == best
