"""StateStore: persistence of State and per-height historical data; the
port's copy of `tendermint_tpu/storage/state_store.py`.

Behavior parity with state/store.go:16-282: a single current-state row,
plus per-height validator-set, consensus-param and ABCI-response rows.
Validator/param rows use the reference's last-changed indirection: if the
value didn't change at height H, the row stores only a pointer to the last
height at which it did — historical lookups walk one indirection.
The recovery plane's rows are here too: `bootstrap` (a restored State
with full validator and param rows), the snapshot pins and `prune`
(windowed deletes that keep the last-changed indirection targets).
"""

from __future__ import annotations

from typing import Optional

from tendermint_tpu_torch.state.state import State
from tendermint_tpu_torch.storage.db import KVStore
from tendermint_tpu_torch.types import encoding
from tendermint_tpu_torch.types.params import ConsensusParams
from tendermint_tpu_torch.types.validator_set import ValidatorSet

_STATE_KEY = b"SS:state"
_SNAPSHOT_LATEST_KEY = b"SS:snapshot-latest"
_PRUNE_FLOOR_KEY = b"SS:prune-floor"


def _validators_key(h: int) -> bytes:
    return b"SS:validators:%020d" % h


def _params_key(h: int) -> bytes:
    return b"SS:consparams:%020d" % h


def _abci_responses_key(h: int) -> bytes:
    return b"SS:abciresp:%020d" % h


def _snapshot_key(h: int) -> bytes:
    return b"SS:snapshot:%020d" % h


class StateStore:
    def __init__(self, db: KVStore):
        self.db = db

    # -- current state (state/store.go:86) ----------------------------------

    def save(self, state: State) -> None:
        """Save state + the NEXT height's valset/params rows, as the
        reference does: state written at height H describes validators that
        will sign H+1. One atomic batch: a crash must not leave a
        valset/params row without its state row."""
        next_h = state.last_block_height + 1
        self.db.set_batch([
            self._validators_info_pair(
                next_h, state.last_height_validators_changed,
                state.validators),
            self._params_info_pair(
                next_h, state.last_height_consensus_params_changed,
                state.consensus_params),
            (_STATE_KEY, encoding.cdumps(state.to_obj())),
        ])

    def load(self) -> Optional[State]:
        raw = self.db.get(_STATE_KEY)
        return None if raw is None else State.from_obj(encoding.cloads(raw))

    def bootstrap(self, state: State) -> None:
        """State-sync bootstrap: install a restored State with FULL
        (non-indirected) validator/param rows at the snapshot height H
        and H+1. The last-changed indirection assumes history below H is
        on disk; after a restore it is not, so the rows a verification
        path can reach — the set that signed H (evidence, commit
        re-checks) and the set signing H+1 (fast-sync) — are
        materialized in place. One atomic batch; idempotent."""
        h = state.last_block_height
        pairs = [
            (_validators_key(h + 1), encoding.cdumps(
                {"last_changed": h + 1,
                 "valset": state.validators.to_obj()})),
            (_params_key(h + 1), encoding.cdumps(
                {"last_changed": h + 1,
                 "params": state.consensus_params.to_obj()})),
            (_STATE_KEY, encoding.cdumps(state.to_obj())),
        ]
        if state.last_validators is not None and \
                state.last_validators.validators:
            pairs.insert(0, (_validators_key(h), encoding.cdumps(
                {"last_changed": h,
                 "valset": state.last_validators.to_obj()})))
        self.db.set_batch(pairs)

    # -- snapshot pins --------------------------------------------------------

    def pin_snapshot(self, height: int, manifest_obj: dict) -> None:
        """Record a published snapshot's manifest (with its Merkle root)
        in the state store: a restore from local disk is then VERIFIED
        against this pin, not trusted to whatever the filesystem holds."""
        self.db.set_batch([
            (_snapshot_key(height), encoding.cdumps(manifest_obj)),
            (_SNAPSHOT_LATEST_KEY, b"%d" % height),
        ])

    def load_snapshot_pin(self, height: int) -> Optional[dict]:
        return self._load(_snapshot_key(height))

    def latest_snapshot_height(self) -> int:
        """Height of the most recent pinned snapshot, 0 when none."""
        raw = self.db.get(_SNAPSHOT_LATEST_KEY)
        return 0 if raw is None else int(raw)

    def unpin_snapshot(self, height: int) -> None:
        """Drop a deleted snapshot's pin (the latest pointer is only
        ever advanced, never rolled back)."""
        self.db.delete(_snapshot_key(height))

    # -- pruning --------------------------------------------------------------

    def prune(self, retain_height: int, window: int = 256) -> int:
        """Delete per-height rows (validators, params, ABCI responses)
        below `retain_height`, one delete_batch per `window` heights.
        The indirection targets retained rows still point at — the
        last valset/param change at or below the floor — survive the
        sweep, so every retained lookup keeps resolving. Returns the
        number of heights swept."""
        floor = retain_height
        if floor < 2:
            return 0
        # keep the floor row's indirection targets alive: last_changed
        # is monotone in height, so every retained row pointing below
        # the floor points at the SAME height the floor row does — one
        # surviving target row per family keeps all of them resolving
        keep: set[bytes] = set()
        v = self._load(_validators_key(floor))
        if v is not None and v["valset"] is None:
            keep.add(_validators_key(v["last_changed"]))
        p = self._load(_params_key(floor))
        if p is not None and p["params"] is None:
            keep.add(_params_key(p["last_changed"]))
        raw = self.db.get(_PRUNE_FLOOR_KEY)
        start = max(1, 0 if raw is None else int(raw))
        swept = 0
        for lo in range(start, floor, window):
            hi = min(lo + window, floor)
            keys = []
            for h in range(lo, hi):
                for key in (_validators_key(h), _params_key(h),
                            _abci_responses_key(h)):
                    if key not in keep:
                        keys.append(key)
            self.db.delete_batch(keys)
            # floor marker advances AFTER the window's deletes commit:
            # a crash mid-sweep only re-issues idempotent deletes
            self.db.set(_PRUNE_FLOOR_KEY, b"%d" % hi)
            swept += hi - lo
        return swept

    def prune_floor(self) -> int:
        """The first height whose per-height rows prune() kept (its
        floor marker), 1 on a store never pruned."""
        raw = self.db.get(_PRUNE_FLOOR_KEY)
        return 1 if raw is None else int(raw)

    def load_or_genesis(self, gen_doc) -> State:
        """state/store.go:48 — stored state if present, else from genesis."""
        from tendermint_tpu_torch.state.state import make_genesis_state
        s = self.load()
        if s is not None:
            if gen_doc is not None and s.chain_id != gen_doc.chain_id:
                raise ValueError(
                    f"stored chain_id {s.chain_id!r} != genesis "
                    f"{gen_doc.chain_id!r}")
            return s
        if gen_doc is None:
            raise ValueError("no stored state and no genesis doc provided")
        state = make_genesis_state(gen_doc)
        self.save(state)
        return state

    # -- historical validators (state/store.go:168-230) ----------------------

    def _validators_info_pair(self, height: int, last_changed: int,
                              valset: ValidatorSet) -> tuple[bytes, bytes]:
        if last_changed > height:
            raise ValueError("last_changed cannot exceed height")
        if last_changed == height:
            obj = {"last_changed": last_changed, "valset": valset.to_obj()}
        else:
            obj = {"last_changed": last_changed, "valset": None}
        return _validators_key(height), encoding.cdumps(obj)

    def load_validators(self, height: int) -> ValidatorSet:
        """Validator set that signs blocks at `height` (one indirection)."""
        o = self._load(_validators_key(height))
        if o is None:
            raise LookupError(f"no validators saved for height {height}")
        if o["valset"] is None:
            o2 = self._load(_validators_key(o["last_changed"]))
            if o2 is None or o2["valset"] is None:
                raise LookupError(
                    f"dangling validators pointer {height}->{o['last_changed']}")
            return ValidatorSet.from_obj(o2["valset"])
        return ValidatorSet.from_obj(o["valset"])

    # -- historical consensus params -----------------------------------------

    def _params_info_pair(self, height: int, last_changed: int,
                          params: ConsensusParams) -> tuple[bytes, bytes]:
        obj = {"last_changed": last_changed,
               "params": params.to_obj() if last_changed == height else None}
        return _params_key(height), encoding.cdumps(obj)

    def load_consensus_params(self, height: int) -> ConsensusParams:
        o = self._load(_params_key(height))
        if o is None:
            raise LookupError(f"no consensus params saved for height {height}")
        if o["params"] is None:
            o2 = self._load(_params_key(o["last_changed"]))
            if o2 is None or o2["params"] is None:
                raise LookupError("dangling params pointer")
            return ConsensusParams.from_obj(o2["params"])
        return ConsensusParams.from_obj(o["params"])

    # -- ABCI responses (state/store.go:127) ---------------------------------

    def save_abci_responses(self, height: int, responses_obj: dict) -> None:
        """Opaque per-height app responses; used for mock-app handshake
        replay (consensus/replay.go:308-318) and the tx indexer."""
        self.db.set(_abci_responses_key(height),
                    encoding.cdumps(responses_obj))

    def load_abci_responses(self, height: int) -> Optional[dict]:
        return self._load(_abci_responses_key(height))

    def _load(self, key: bytes):
        raw = self.db.get(key)
        return None if raw is None else encoding.cloads(raw)
