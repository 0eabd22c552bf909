"""divergence — per-height transition digests and the dual-hash-seed
replay: the port's copy of `tendermint_tpu/analysis/divergence.py`.

- `DigestRecorder` folds every applied height into one canonical
  *transition digest*: sha256 over (height, block bytes, canonical
  ABCI responses, validator updates, app_hash). Two honest nodes — or
  the same node replayed under a different PYTHONHASHSEED — MUST
  produce bit-identical digest streams; any divergence pinpoints the
  first height where replicated state forked.
- `BlockExecutor.apply_block` records into the recorder when the
  TM_CUDA_DIVERGENCE knob is on (`maybe_recorder()`), and the consensus
  state machine stamps each height's digest on the causal timeline
  (`transition.digest`); `cross_check` compares streams across nodes.
- `replay_digests()` + `run_dual_seed_replay()` are the differential
  harness: the same seeded single-validator trajectory (pinned
  protocol clock, scripted txs including a validator-power update) is
  run in two subprocesses under different hash seeds and the digest
  streams are compared bit-for-bit. Every signature check of the
  trajectory goes through a BatchVerifier on `device` (the verify
  kernel on a card; `device="cpu"` verifies on the host).

Run the harness directly:
  python -m tendermint_tpu_torch.analysis.divergence [--device cpu]
(`--replay --seed N` is the child mode; the parent spawns two children
with PYTHONHASHSEED=1 and =2 and diffs stdout.)
"""

from __future__ import annotations

import hashlib
import threading
from typing import Dict, List, Optional, Tuple

from tendermint_tpu_torch import telemetry
from tendermint_tpu_torch.utils import knobs

_m_heights = telemetry.counter(
    "divergence_heights_total",
    "Heights folded into the transition-digest stream")
_m_mismatch = telemetry.counter(
    "divergence_mismatch_total",
    "Cross-node transition-digest mismatches detected")


class DigestRecorder:
    """Per-node canonical transition-digest stream, one entry per
    applied height. Append is called from the consensus thread; reads
    (cross checks, tests) snapshot under the lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_height: Dict[int, str] = {}
        self.last_height = 0
        self.last_hex = ""

    def record(self, block, responses, new_state) -> str:
        """Fold one applied height; returns the hex digest."""
        from tendermint_tpu_torch.types import encoding
        h = hashlib.sha256()
        height = block.header.height
        h.update(height.to_bytes(8, "big"))
        h.update(hashlib.sha256(block.to_bytes()).digest())
        h.update(hashlib.sha256(
            encoding.cdumps(responses.to_obj())).digest())
        h.update(hashlib.sha256(encoding.cdumps(
            responses.end_block_obj.get("validator_updates", []))).digest())
        h.update(new_state.app_hash)
        hexd = h.hexdigest()
        with self._lock:
            self._by_height[height] = hexd
            self.last_height = height
            self.last_hex = hexd
        _m_heights.inc()
        return hexd

    def stream(self) -> List[Tuple[int, str]]:
        with self._lock:
            return sorted(self._by_height.items())

    def digest_at(self, height: int) -> Optional[str]:
        with self._lock:
            return self._by_height.get(height)


def enabled() -> bool:
    return knobs.knob_set("TM_CUDA_DIVERGENCE")


def maybe_recorder() -> Optional[DigestRecorder]:
    """A recorder when TM_CUDA_DIVERGENCE is on, else None — the
    BlockExecutor hook stays a single attribute test when off."""
    return DigestRecorder() if enabled() else None


def cross_check(streams: Dict[str, DigestRecorder]) -> List[dict]:
    """Compare digest streams across nodes; one mismatch dict per
    height where two nodes disagree (the cross-node `divergence`
    invariant)."""
    by_height: Dict[int, Dict[str, str]] = {}
    for name, rec in streams.items():
        for height, hexd in rec.stream():
            by_height.setdefault(height, {})[name] = hexd
    out = []
    for height in sorted(by_height):
        seen = by_height[height]
        if len(set(seen.values())) > 1:
            _m_mismatch.inc()
            out.append({"height": height, "digests": dict(sorted(
                seen.items()))})
    return out


# ------------------------------------------------- differential replay

#: scripted trajectory: dict-heavy kvstore writes plus one
#: validator-power update (exercises update_state + valset hashing);
#: {pk} is replaced with the validator's pubkey hex
_SCRIPT: Tuple[Tuple[bytes, ...], ...] = (
    (b"alpha=1", b"beta=2", b"gamma=3"),
    (b"delta=4", b"alpha=5"),
    (b"val:{pk}/15",),
    (b"epsilon=6", b"zeta=7", b"eta=8", b"theta=9"),
    (b"beta=10",),
)


def _verifier(device):
    """The trajectory's verifier: the batch path on the card ("cuda",
    every check a kernel launch), the host loop for device "cpu"."""
    from tendermint_tpu_torch.models.verifier import BatchVerifier
    from tendermint_tpu_torch.utils import device as _device
    dev = _device.resolve(device)
    if dev.type == "cpu":
        return BatchVerifier("python", coalesce="off")
    return BatchVerifier("cuda", device=dev, coalesce="off")


def replay_digests(seed: int, extra_heights: int = 0,
                   device=None) -> List[str]:
    """Run the scripted single-validator trajectory in-process and
    return the transition-digest stream as hex lines. Deterministic by
    construction: pinned protocol clock, seeded key, MockTicker — the
    only thing that can differ across two interpreters is hash-order
    leakage into the transition, which is the bug being hunted. Runs on
    the card unless `device="cpu"`."""
    from tendermint_tpu_torch.abci.apps import KVStoreApp
    from tendermint_tpu_torch.abci.proxy import AppConns, local_client_creator
    from tendermint_tpu_torch.abci.types import ValidatorUpdate
    from tendermint_tpu_torch.config import test_config as make_test_config
    from tendermint_tpu_torch.consensus import ConsensusState, MockTicker
    from tendermint_tpu_torch.state.execution import BlockExecutor
    from tendermint_tpu_torch.storage import BlockStore, MemDB, StateStore
    from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    from tendermint_tpu_torch.types.keys import PrivKey
    from tendermint_tpu_torch.types.priv_validator import (
        LocalSigner, PrivValidator)
    from tendermint_tpu_torch.utils import clock

    key = PrivKey.generate(seed.to_bytes(32, "big"))
    pk_hex = key.pubkey.ed25519.hex().encode()
    script = [[tx.replace(b"{pk}", pk_hex) for tx in height_txs]
              for height_txs in _SCRIPT]
    script += [[b"pad%d=%d" % (i, i)] for i in range(extra_heights)]

    gen = GenesisDoc(chain_id=f"divergence-{seed}", genesis_time_ns=1,
                     validators=[GenesisValidator(key.pubkey.ed25519, 10)])
    conns = AppConns(local_client_creator(KVStoreApp()))
    state_store = StateStore(MemDB())
    block_store = BlockStore(MemDB())
    state = state_store.load_or_genesis(gen)
    conns.consensus.init_chain(
        [ValidatorUpdate(v.pubkey, v.voting_power)
         for v in state.validators.validators], gen.chain_id)

    class _ListMempool:
        def __init__(self): self.txs = []
        def lock(self): pass
        def unlock(self): pass
        def size(self): return len(self.txs)
        def check_tx(self, tx): return None
        def reap(self, mx): return self.txs[:mx]

        def update(self, height, txs):
            self.txs = [t for t in self.txs if t not in txs]

        def flush(self): pass

    mempool = _ListMempool()
    recorder = DigestRecorder()
    exec_ = BlockExecutor(state_store, conns.consensus, mempool=mempool,
                          verifier=_verifier(device))
    exec_.divergence = recorder
    cs = ConsensusState(
        make_test_config().consensus, state, exec_, block_store,
        mempool=mempool,
        priv_validator=PrivValidator(LocalSigner(key)),
        ticker_factory=MockTicker)

    # pinned protocol clock: every timestamp (block time, votes) comes
    # from this counter, so both hash-seed runs see identical times
    tick = [seed * 1_000_000_000]

    def _clock() -> int:
        tick[0] += 1_000_000
        return tick[0]

    clock.set_source(_clock)
    try:
        cs.start()
        target = len(script)
        for _ in range(80 * target):
            height = cs.state.last_block_height
            if height >= target:
                break
            # stage the next height's txs the moment it opens
            if not mempool.txs and height < target:
                mempool.txs = list(script[height])
            cs.ticker.fire_next()
        if cs.state.last_block_height < target:
            raise RuntimeError(
                f"replay stalled at height {cs.state.last_block_height}"
                f"/{target}")
    finally:
        clock.set_source(None)

    return [f"{height} {hexd}" for height, hexd in recorder.stream()]


def run_dual_seed_replay(seed: int = 7, hash_seeds: Tuple[int, int] = (1, 2),
                         timeout_s: float = 300.0, device=None) -> dict:
    """Spawn the scripted replay in two subprocesses under different
    PYTHONHASHSEED values, side by side, and compare digest streams
    bit-for-bit. The children run on `device` (the card unless "cpu")."""
    import os
    import subprocess
    import sys

    procs = []
    try:
        for hs in hash_seeds:
            env = dict(os.environ)
            env["PYTHONHASHSEED"] = str(hs)
            env["TM_CUDA_DIVERGENCE"] = "on"
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "tendermint_tpu_torch.analysis.divergence",
                 "--replay", "--seed", str(seed)]
                + (["--device", str(device)] if device is not None else []),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env))
        streams = []
        for hs, proc in zip(hash_seeds, procs):
            out, err = proc.communicate(timeout=timeout_s)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"replay child (PYTHONHASHSEED={hs}) failed:\n"
                    f"{err.decode(errors='replace')[-2000:]}")
            streams.append(out.decode())
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {
        "seed": seed,
        "hash_seeds": list(hash_seeds),
        "heights": streams[0].count("\n"),
        "identical": streams[0] == streams[1],
        "streams": streams,
    }


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        description="dual-PYTHONHASHSEED transition-digest replay")
    parser.add_argument("--replay", action="store_true",
                        help="child mode: run the scripted trajectory "
                        "and print the digest stream")
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--extra-heights", type=int, default=0)
    parser.add_argument("--device", default=None,
                        help="cuda, cuda:N or cpu (default: the card)")
    args = parser.parse_args(argv)

    if args.replay:
        for line in replay_digests(args.seed, args.extra_heights,
                                   device=args.device):
            print(line)
        return 0

    result = run_dual_seed_replay(args.seed, device=args.device)
    status = "IDENTICAL" if result["identical"] else "DIVERGED"
    print(f"{status}: {result['heights']} heights under "
          f"PYTHONHASHSEED={result['hash_seeds']}")
    if not result["identical"]:
        for a, b in zip(result["streams"][0].splitlines(),
                        result["streams"][1].splitlines()):
            marker = " " if a == b else "!"
            print(f"{marker} {a}   |   {b}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
