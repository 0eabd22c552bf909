"""StateStore: persistence of State and per-height historical data; the
port's copy of `tendermint_tpu/storage/state_store.py`.

Behavior parity with state/store.go:16-282: a single current-state row,
plus per-height validator-set, consensus-param and ABCI-response rows.
Validator/param rows use the reference's last-changed indirection: if the
value didn't change at height H, the row stores only a pointer to the last
height at which it did — historical lookups walk one indirection.
Snapshot pins, the state-sync bootstrap and pruning wait with state sync.
"""

from __future__ import annotations

from typing import Optional

from tendermint_tpu_torch.state.state import State
from tendermint_tpu_torch.storage.db import KVStore
from tendermint_tpu_torch.types import encoding
from tendermint_tpu_torch.types.params import ConsensusParams
from tendermint_tpu_torch.types.validator_set import ValidatorSet

_STATE_KEY = b"SS:state"


def _validators_key(h: int) -> bytes:
    return b"SS:validators:%020d" % h


def _params_key(h: int) -> bytes:
    return b"SS:consparams:%020d" % h


def _abci_responses_key(h: int) -> bytes:
    return b"SS:abciresp:%020d" % h


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
