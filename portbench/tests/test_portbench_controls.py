"""The control and the faults of each cell make a run come out not
correct; a sound run comes out correct. Each drives the rest of a run
(harness.run_once) on the CPU at a small size, skipping the look for a
card, with the timed path broken underneath.

The control (`--control accept_all`) puts a verifier that accepts every
signature in the program's place. The faults, planted by wrapping the
program: an answer altered where it is produced, half of the batch left
out, and a step that returns its state unchanged; in the sync cell
also stores whose writes never reach the disk. The sync cell's
faults start after the set-up's warm-up sync (20 blocks applied), so
that they strike in the window."""

import json
import time

import numpy as np
import pytest
import torch

from portbench import harness

BENCH = harness.load_benchmark(harness.ROOT.parent)


def _run(cell, hook, control="", seconds=0.6, seed=2 ** 31 + 11):
    code, lines, result = harness.run_once(
        harness.ROOT, BENCH, harness.cell_of(BENCH, cell), seed, seconds,
        False, control, torch.device("cpu"), time.perf_counter(),
        ctx_hook=hook)
    assert code == 0, lines
    return json.loads(result)


def _small_batch(ctx):
    ctx.config.update(validators=16, heights=2)
    ctx.traffic.update(callers=1, forge_every=2, sample_lanes=8)


def _small_votes(ctx):
    ctx.config.update(validators=24, heights=2)
    ctx.traffic.update(msg_votes=8, sample_votes=6)


def _small_sync(ctx):
    ctx.config.update(validators=4, verify_window=6)
    ctx.traffic.update(blocks=14, txs=6, warm_blocks=14,
                       forge_at=[[2, 3], [5, 6]])


SMALL = {"valset10k-batch": _small_batch, "valset10k-votes": _small_votes,
         "fastsync64-5ktx": _small_sync}


@pytest.fixture(autouse=True)
def _direct_calls(monkeypatch):
    # small calls go straight to the verifier's host route, as every
    # call of the cells' own sizes goes straight to the kernels
    monkeypatch.setenv("TM_CUDA_COALESCE", "off")


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_sound_run_is_correct(cell):
    out = _run(cell, SMALL[cell])
    assert out["correct"] is True
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_control_is_not_correct(cell):
    assert _run(cell, SMALL[cell], control="accept_all")["correct"] is False


def _wrap_verifier(monkeypatch, change):
    """Plant `change(items, verdicts) -> verdicts` in every verifier the
    node builder returns."""
    from tendermint_tpu_torch import node
    build = node.build_verifier

    def planted(*a, **kw):
        v, owned = build(*a, **kw)
        inner = v.verify_async

        def verify_async(items):
            res = inner(items)
            return lambda: change(items, np.asarray(res()))
        v.verify_async = verify_async
        return v, owned

    monkeypatch.setattr(node, "build_verifier", planted)


def _flip_first(items, out):
    out = out.copy()
    if len(out):
        out[0] = not out[0]
    return out


def _half_left_out(items, out):
    out = out.copy()
    out[len(out) // 2:] = True
    return out


def _first_answer_kept():
    kept = {}

    def change(items, out):
        return kept.setdefault(len(items), out).copy()
    return change


@pytest.mark.parametrize("fault", ["altered", "half", "unchanged"])
def test_batch_faults_are_caught(monkeypatch, fault):
    change = {"altered": _flip_first, "half": _half_left_out,
              "unchanged": _first_answer_kept()}[fault]
    _wrap_verifier(monkeypatch, change)
    assert _run("valset10k-batch", _small_batch)["correct"] is False


def test_votes_answer_altered_is_caught(monkeypatch):
    from tendermint_tpu_torch.consensus.rstate import HeightVoteSet
    inner = HeightVoteSet.add_votes

    def add_votes(self, *a, **kw):
        results, errors = inner(self, *a, **kw)
        return [not results[0]] + list(results[1:]), errors
    monkeypatch.setattr(HeightVoteSet, "add_votes", add_votes)
    assert _run("valset10k-votes", _small_votes)["correct"] is False


def test_votes_state_unchanged_is_caught(monkeypatch):
    from tendermint_tpu_torch.consensus.rstate import HeightVoteSet
    monkeypatch.setattr(HeightVoteSet, "add_votes",
                        lambda self, r, t, votes, peer_id="":
                        ([False] * len(votes), []))
    assert _run("valset10k-votes", _small_votes)["correct"] is False


def test_votes_half_left_out_is_caught(monkeypatch):
    _wrap_verifier(monkeypatch, _half_left_out)
    assert _run("valset10k-votes", _small_votes)["correct"] is False


def test_sync_state_unchanged_is_caught(monkeypatch):
    from tendermint_tpu_torch.state.execution import BlockExecutor
    inner = BlockExecutor.apply_block
    calls = []

    def apply_block(self, state, *a, **kw):
        calls.append(1)
        out = inner(self, state, *a, **kw)
        return state if len(calls) > 20 and len(calls) % 7 == 0 else out
    monkeypatch.setattr(BlockExecutor, "apply_block", apply_block)
    assert _run("fastsync64-5ktx", _small_sync)["correct"] is False


def test_sync_answer_altered_is_caught(monkeypatch):
    from tendermint_tpu_torch.abci.apps import KVStoreApp
    inner = KVStoreApp.commit
    calls = []

    def commit(self):
        out = inner(self)
        calls.append(1)
        if len(calls) > 20 and len(calls) % 9 == 0:
            self.app_hash = bytes([out[0] ^ 1]) + out[1:]
            return self.app_hash
        return out
    monkeypatch.setattr(KVStoreApp, "commit", commit)
    assert _run("fastsync64-5ktx", _small_sync)["correct"] is False


def test_sync_half_left_out_is_caught(monkeypatch):
    _wrap_verifier(monkeypatch, _half_left_out)
    assert _run("fastsync64-5ktx", _small_sync)["correct"] is False


def test_sync_writes_kept_off_the_disk_are_caught(monkeypatch):
    # the nodes of the window write to stores that live in memory only:
    # every read through the node's own store would agree, and only the
    # stores opened again from its home show the loss
    from tendermint_tpu_torch import storage
    from tendermint_tpu_torch.state.execution import BlockExecutor
    inner_open, inner_apply = storage.open_db, BlockExecutor.apply_block
    calls = []

    def apply_block(self, *a, **kw):
        calls.append(1)
        return inner_apply(self, *a, **kw)

    def open_db(path):
        return storage.MemDB() if 20 <= len(calls) < 30 else inner_open(path)
    monkeypatch.setattr(BlockExecutor, "apply_block", apply_block)
    monkeypatch.setattr(storage, "open_db", open_db)
    assert _run("fastsync64-5ktx", _small_sync)["correct"] is False
