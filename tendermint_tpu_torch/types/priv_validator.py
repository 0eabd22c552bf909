"""PrivValidator: a signer with persisted double-sign protection.

Counterpart of `tendermint_tpu/types/priv_validator.py`: the last
height/round/step is written to disk before a signature is released;
re-signing the identical message returns the stored signature, and so
does a message at the same height/round/step that differs only in its
timestamp (a vote made again after a crash must not double-sign);
anything else at the same height/round/step is refused.
`PrivValidatorFile` reads and writes the JAX package's file format.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass
from typing import Optional, Protocol

from tendermint_tpu_torch.types import encoding
from tendermint_tpu_torch.types.keys import PrivKey, PubKey
from tendermint_tpu_torch.types.vote import Vote, VoteType

_STEP_PROPOSE = 1
_STEP_PREVOTE = 2
_STEP_PRECOMMIT = 3


def vote_step(v: Vote) -> int:
    return _STEP_PREVOTE if v.type == VoteType.PREVOTE else _STEP_PRECOMMIT


class DoubleSignError(Exception):
    pass


class Signer(Protocol):
    """HSM hook point (types/priv_validator.go:74)."""
    def pubkey(self) -> PubKey: ...
    def sign(self, msg: bytes) -> bytes: ...


class LocalSigner:
    def __init__(self, privkey: PrivKey):
        self._priv = privkey

    def pubkey(self) -> PubKey:
        return self._priv.pubkey

    def sign(self, msg: bytes) -> bytes:
        return self._priv.sign(msg)


class PrivValidator:
    """In-memory double-sign-protected signer; PrivValidatorFile persists."""

    def __init__(self, signer: Signer):
        self.signer = signer
        self.pubkey = signer.pubkey()
        self.address = self.pubkey.address
        self.last_height = 0
        self.last_round = 0
        self.last_step = 0
        self.last_sign_bytes: Optional[bytes] = None
        self.last_signature: Optional[bytes] = None

    # -- persistence hook (overridden by PrivValidatorFile) -----------------

    def _persist(self) -> None:
        pass

    def _check_hrs(self, height: int, round_: int, step: int) -> bool:
        """types/priv_validator.go:219: returns True when exactly at the
        last (H,R,S) — a possible regeneration; raises when rolling back."""
        if self.last_height > height:
            raise DoubleSignError("height regression")
        if self.last_height == height:
            if self.last_round > round_:
                raise DoubleSignError("round regression")
            if self.last_round == round_:
                if self.last_step > step:
                    raise DoubleSignError("step regression")
                if self.last_step == step:
                    if self.last_sign_bytes is None:
                        raise DoubleSignError("no last signature to return")
                    return True
        return False

    def _sign_at(self, height: int, round_: int, step: int,
                 sign_bytes: bytes, same_hrs_ok_differs: str
                 ) -> tuple[bytes, Optional[int]]:
        """Returns (signature, stored_timestamp_ns). stored_timestamp_ns is
        set when the stored signature is re-used for a message that differs
        only in timestamp — the caller MUST write that timestamp back into
        the message so the signature verifies (types/priv_validator.go
        signVote re-uses both timestamp and signature together)."""
        same = self._check_hrs(height, round_, step)
        if same:
            if sign_bytes == self.last_sign_bytes:
                return self.last_signature, None
            if same_hrs_ok_differs == "timestamp" and \
                    _differs_only_in_timestamp(self.last_sign_bytes, sign_bytes):
                stored = json.loads(self.last_sign_bytes).get("timestamp_ns")
                return self.last_signature, stored
            raise DoubleSignError(
                f"conflicting {same_hrs_ok_differs or 'message'} at "
                f"{height}/{round_}/{step}")
        # Sign FIRST: a failed signer must not advance the last-sign state,
        # or a retry would pair the previous signature with the new message.
        sig = self.signer.sign(sign_bytes)
        self.last_height, self.last_round, self.last_step = height, round_, step
        self.last_sign_bytes = sign_bytes
        self.last_signature = sig
        self._persist()  # persist BEFORE the signature escapes
        return sig, None

    def sign_vote(self, chain_id: str, vote: Vote) -> None:
        sb = vote.sign_bytes(chain_id)
        vote.signature, stored_ts = self._sign_at(
            vote.height, vote.round, vote_step(vote), sb, "timestamp")
        if stored_ts is not None:
            vote.timestamp_ns = stored_ts

    def sign_proposal(self, chain_id: str, proposal) -> None:
        sb = proposal.sign_bytes(chain_id)
        proposal.signature, stored_ts = self._sign_at(
            proposal.height, proposal.round, _STEP_PROPOSE, sb, "timestamp")
        if stored_ts is not None:
            proposal.timestamp_ns = stored_ts

    def sign_heartbeat(self, chain_id: str, heartbeat) -> None:
        heartbeat.signature = self.signer.sign(heartbeat.sign_bytes(chain_id))


def _differs_only_in_timestamp(old: bytes, new: bytes) -> bool:
    """Votes regenerated after replay carry a new wall-clock time; the
    reference compares everything-but-timestamp (types/priv_validator.go:
    373-421). Canonical JSON makes this a field-level comparison."""
    try:
        o, n = json.loads(old), json.loads(new)
    except Exception:
        return False
    if not (isinstance(o, dict) and isinstance(n, dict)):
        return False
    o.pop("timestamp_ns", None)
    n.pop("timestamp_ns", None)
    return o == n


class PrivValidatorFile(PrivValidator):
    """File-backed: {key, last-sign-state} saved atomically
    (types/priv_validator.go:51,169-183)."""

    def __init__(self, path: str, privkey: PrivKey):
        self.path = path
        self._privkey = privkey
        super().__init__(LocalSigner(privkey))

    @classmethod
    def generate(cls, path: str, seed: bytes | None = None) -> "PrivValidatorFile":
        pv = cls(path, PrivKey.generate(seed))
        pv._persist()
        return pv

    @classmethod
    def load(cls, path: str) -> "PrivValidatorFile":
        with open(path) as f:
            o = json.load(f)
        pv = cls(path, PrivKey.from_obj(o["priv_key"]))
        pv.last_height = o["last_height"]
        pv.last_round = o["last_round"]
        pv.last_step = o["last_step"]
        pv.last_sign_bytes = encoding.hex_to_bytes(o.get("last_sign_bytes"))
        pv.last_signature = encoding.hex_to_bytes(o.get("last_signature"))
        return pv

    @classmethod
    def load_or_generate(cls, path: str) -> "PrivValidatorFile":
        return cls.load(path) if os.path.exists(path) else cls.generate(path)

    def _persist(self) -> None:
        o = {
            "address": self.address.hex(),
            "pub_key": self.pubkey.to_obj(),
            "priv_key": self._privkey.to_obj(),
            "last_height": self.last_height,
            "last_round": self.last_round,
            "last_step": self.last_step,
            "last_sign_bytes":
                self.last_sign_bytes.hex() if self.last_sign_bytes else None,
            "last_signature":
                self.last_signature.hex() if self.last_signature else None,
        }
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".privval")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(o, f, indent=1)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
