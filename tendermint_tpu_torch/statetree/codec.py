"""Wire codec of state proofs: the port's copy of
`tendermint_tpu/statetree/codec.py`.

Two forms, one source of truth:

- obj form: plain JSON-safe dict — what a response document embeds
  and what a JS/Go client would parse.
- bytes form: canonical JSON (types/encoding.cdumps — sorted keys, no
  whitespace) of the obj form — what `ResultQuery.proof` carries over
  ABCI, so the same proof travels both planes byte-identically.

Decoding VALIDATES: every field type, hash length, and step shape is
checked here so `proof.verify` only ever sees structurally sound
proofs and a malformed wire blob raises ProofError, never TypeError.
"""

from __future__ import annotations

import json

from tendermint_tpu_torch.statetree.proof import ProofError, StateProof
from tendermint_tpu_torch.statetree.store import _m_proof_bytes
from tendermint_tpu_torch.types.encoding import cdumps


def proof_to_obj(proof: StateProof) -> dict:
    obj = {
        "key_hash": proof.key_hash.hex(),
        "n_keys": int(proof.n_keys),
        "present": bool(proof.present),
        "steps": [[int(bit), sib.hex()] for bit, sib in proof.steps],
    }
    if not proof.present and proof.other_key_hash:
        obj["other_key_hash"] = proof.other_key_hash.hex()
        obj["other_value_hash"] = proof.other_value_hash.hex()
    return obj


def _hex32(obj: dict, field: str, optional: bool = False) -> bytes:
    raw = obj.get(field, "")
    if raw == "" and optional:
        return b""
    if not isinstance(raw, str):
        raise ProofError(f"{field}: expected hex string")
    try:
        out = bytes.fromhex(raw)
    except ValueError as e:
        raise ProofError(f"{field}: {e}") from e
    if len(out) != 32:
        raise ProofError(f"{field}: expected 32 bytes, got {len(out)}")
    return out


def proof_from_obj(obj) -> StateProof:
    if not isinstance(obj, dict):
        raise ProofError("proof must be an object")
    n_keys = obj.get("n_keys")
    if not isinstance(n_keys, int) or isinstance(n_keys, bool) or \
            n_keys < 0:
        raise ProofError("n_keys: expected a non-negative integer")
    raw_steps = obj.get("steps", [])
    if not isinstance(raw_steps, list) or len(raw_steps) > 256:
        raise ProofError("steps: expected a list of at most 256 steps")
    steps = []
    for entry in raw_steps:
        if not isinstance(entry, (list, tuple)) or len(entry) != 2:
            raise ProofError("step: expected [bit, sibling_hex]")
        bit, sib = entry
        if not isinstance(bit, int) or isinstance(bit, bool) or \
                not (0 <= bit <= 255):
            raise ProofError(f"step bit out of range: {bit!r}")
        if not isinstance(sib, str):
            raise ProofError("step sibling: expected hex string")
        try:
            sib_b = bytes.fromhex(sib)
        except ValueError as e:
            raise ProofError(f"step sibling: {e}") from e
        if len(sib_b) != 32:
            raise ProofError("step sibling must be 32 bytes")
        steps.append((bit, sib_b))
    return StateProof(
        key_hash=_hex32(obj, "key_hash"),
        n_keys=n_keys,
        steps=steps,
        present=bool(obj.get("present")),
        other_key_hash=_hex32(obj, "other_key_hash", optional=True),
        other_value_hash=_hex32(obj, "other_value_hash",
                                optional=True),
    )


def proof_to_bytes(proof: StateProof) -> bytes:
    out = cdumps(proof_to_obj(proof))
    _m_proof_bytes.observe(len(out))
    return out


def proof_from_bytes(raw: bytes) -> StateProof:
    try:
        obj = json.loads(bytes(raw).decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise ProofError(f"undecodable proof bytes: {e}") from e
    return proof_from_obj(obj)
