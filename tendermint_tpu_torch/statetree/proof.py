"""Per-key state proofs and the client-side verifier: the port's copy of
`tendermint_tpu/statetree/proof.py`.

A proof is the root-to-leaf navigation path for sha256(key): a list of
(bit, sibling_hash) steps plus the leaf at the end. The verifier needs
NO server-trusted direction flags — it derives each step's direction
from its OWN key hash, folds leaf-up recomputing every inner hash
(which binds the split bit), and compares the final size-bound hash
against the app_hash a lite-certified header carries.

Inclusion: the terminal leaf is the key's own (kh, sha256(value)).

Absence: the terminal leaf is the DIVERGENT leaf navigation lands on —
some other key's (kh', vh') with kh' != kh. Sound because the fold
recomputes the real tree's hashes: a verifying path IS the tree's
navigation path for kh (inner hashes pin bit indices, domain tags pin
node kinds, the final hash pins the key count), and in a critbit trie
navigation for a PRESENT key always terminates at that key's own leaf.
The empty tree proves absence with zero steps against the n=0 root.

Every malformed shape — wrong step order, short sibling, value on an
absence claim — raises ProofError rather than returning False, so a
caller can never conflate "proof invalid" with "key absent".
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Optional, Tuple

from tendermint_tpu_torch.statetree.store import (
    EMPTY_SUBROOT,
    final_hash,
    inner_hash,
    leaf_hash,
)


class ProofError(Exception):
    """A state proof failed verification or is malformed."""


@dataclass
class StateProof:
    key_hash: bytes
    n_keys: int
    steps: List[Tuple[int, bytes]]  # (bit, sibling hash), root -> leaf
    present: bool
    other_key_hash: bytes = b""    # absence: the divergent leaf
    other_value_hash: bytes = b""

    def depth(self) -> int:
        return len(self.steps)


def _nav_bit(kh: bytes, i: int) -> int:
    return (kh[i >> 3] >> (7 - (i & 7))) & 1


def verify(proof: StateProof, key: bytes, value: Optional[bytes],
           app_hash: bytes) -> None:
    """Check that `proof` binds (key, value) — value None/b'' meaning
    ABSENT — to `app_hash`. Raises ProofError on any failure."""
    key = bytes(key)
    kh = hashlib.sha256(key).digest()
    if proof.key_hash != kh:
        raise ProofError("proof is for a different key")
    if proof.n_keys < 0 or len(proof.steps) > 256:
        raise ProofError("malformed proof dimensions")
    if proof.present:
        if value is None:
            raise ProofError("inclusion proof carries no value")
        cur = leaf_hash(kh, hashlib.sha256(bytes(value)).digest())
    else:
        if value not in (None, b""):
            raise ProofError("absence proof cannot carry a value")
        if proof.n_keys == 0:
            if proof.steps or proof.other_key_hash:
                raise ProofError("empty-tree absence proof must be "
                                 "empty")
            if final_hash(0, EMPTY_SUBROOT) != app_hash:
                raise ProofError("empty-tree root mismatch")
            return
        if len(proof.other_key_hash) != 32 or \
                len(proof.other_value_hash) != 32:
            raise ProofError("absence proof needs the divergent leaf")
        if proof.other_key_hash == kh:
            raise ProofError("absence proof terminates at the key's "
                             "own leaf")
        cur = leaf_hash(proof.other_key_hash, proof.other_value_hash)
    prev = -1
    for bit, sibling in proof.steps:
        if not (0 <= int(bit) <= 255) or bit <= prev:
            raise ProofError(f"step bits must strictly increase "
                             f"root->leaf (got {bit} after {prev})")
        if len(sibling) != 32:
            raise ProofError("sibling hash must be 32 bytes")
        prev = int(bit)
    for bit, sibling in reversed(proof.steps):
        if _nav_bit(kh, bit):
            cur = inner_hash(bit, sibling, cur)
        else:
            cur = inner_hash(bit, cur, sibling)
    if final_hash(proof.n_keys, cur) != app_hash:
        raise ProofError("recomputed root does not match app_hash")
