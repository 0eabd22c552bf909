"""Certified cross-shard reads: the port's copy of
`tendermint_tpu/shard/reads.py`.

A client of shard A reading a key that lives on shard B must not have
to TRUST shard B's RPC: the response ships the value with the commit
proof a light client needs — the ``FullCommit`` chain (header, commit
and signing valset a height) from the caller's last certified height up
to the height the value was read at. The caller advances a
``ContinuousCertifier`` (lite/certifier.py) through every height:
unchanged valsets certify with one batch verify (a B1 launch on the
card), valset changes take the trusted-set endorsement rule, and NO
height is skipped. A forged proof — a tampered signature, a wrong
valset, a truncated chain, a mismatched frontier — raises
``ReadProofError``.

What the proof certifies: that shard B's validator set committed height
``h`` with the returned header (its app_hash included). When the chain
runs the authenticated state tree (TM_CUDA_STATE_TREE) the response
ALSO carries a per-key state proof at ``value_height = h-1`` — the
version whose root the certified header at ``h`` binds — and the client
verifies the whole chain of custody: value -> tree root -> app_hash ->
certified commit. Bucket-mode chains certify only the head; the value
itself rides untrusted.

The server side (``serve_read``) reads the value at a STABLE height: it
retries until the shard's frontier is the same before and after the app
query, so the proof height and the value snapshot agree; the proven read
is then served at the FIXED version h-1."""

from __future__ import annotations

from typing import Callable, Dict, Optional

from tendermint_tpu_torch.lite.certifier import ContinuousCertifier
from tendermint_tpu_torch.lite.types import (
    CertificationError,
    FullCommit,
    SignedHeader,
)


class ReadProofError(Exception):
    """A cross-shard read's commit proof failed certification."""


def full_commit_at(block_store, state_store, height: int) \
        -> Optional[FullCommit]:
    """The FullCommit for one height from a node's stores: header +
    the commit that sealed it (SeenCommit at the frontier, the block
    commit below it) + the valset that signed — exactly what an RPC
    provider serves a light client."""
    meta = block_store.load_block_meta(height)
    if meta is None:
        return None
    if height == block_store.height():
        commit = block_store.load_seen_commit(height)
    else:
        commit = block_store.load_block_commit(height)
    if commit is None:
        return None
    vals = state_store.load_validators(height)
    if vals is None:
        return None
    return FullCommit(SignedHeader(meta.header, commit, meta.block_id),
                      vals)


def serve_read(node, key: bytes, since_height: int = 0,
               max_attempts: int = 8) -> dict:
    """Server side of `shard_read`: the value at a stable frontier
    plus the FullCommit chain (since_height, h]. Raises RPCError-free
    ValueError on an impossible window (the router maps it)."""
    since_height = max(0, int(since_height))
    store = node.block_store
    value = b""
    h = store.height()
    for _ in range(max_attempts):
        h = store.height()
        res = node.app_conns.query.query("", bytes(key), height=0,
                                         prove=False)
        value = res.value or b""
        if store.height() == h:
            break   # frontier stable across the app read
    if since_height > h:
        raise ValueError(
            f"since_height {since_height} is ahead of the shard "
            f"frontier {h}")
    # authenticated value (tree backend): re-serve the value at the
    # FIXED version h-1 with its state proof — that version's root is
    # exactly the app_hash the certified header at h carries. h == 1
    # has no committed version below it (header 1 binds the genesis
    # app hash), so the first block falls back to the head-only read.
    value_height = None
    value_proof = None
    if h >= 2:
        res = node.app_conns.query.query("", bytes(key), height=h - 1,
                                         prove=True)
        if res.code == 0 and res.proof:
            import json
            value = res.value or b""
            value_height = h - 1
            value_proof = json.loads(bytes(res.proof).decode("utf-8"))
    from tendermint_tpu_torch.rpc.core import jsonify
    proof = []
    for hh in range(since_height + 1, h + 1):
        fc = full_commit_at(store, node.state_store, hh)
        if fc is None:
            raise ValueError(f"no commit material at height {hh} "
                             f"(pruned below the caller's trust?)")
        # jsonify NOW so the in-process and HTTP shapes are identical
        # (FullCommit.from_obj parses the hex form either way)
        proof.append(jsonify(fc.to_obj()))
    meta = store.load_block_meta(h)
    out = {
        "chain_id": node.gen_doc.chain_id,
        "key": bytes(key).hex(),
        "value": value.hex(),
        "height": h,
        "app_hash": (meta.header.app_hash.hex() if meta else ""),
        "proof_commits": proof,
    }
    if value_proof is not None:
        out["value_height"] = value_height
        out["value_proof"] = value_proof
    return out


class CertifiedReader:
    """Client-side certified cross-shard reads.

    One ContinuousCertifier per target chain, seeded from that chain's
    GENESIS valset and advanced height by height through the proof
    material each read ships — so a reader that keeps reading a shard
    only ever pays the delta since its last read. Transport is either
    a live ShardSet (in-process: shard A's node reading shard B) or a
    `call(method, **params)` callable (a JSONRPCClient against the
    front door)."""

    def __init__(self, shard_set=None, call: Optional[Callable] = None,
                 verifier=None):
        if (shard_set is None) == (call is None):
            raise ValueError(
                "CertifiedReader needs exactly one transport: "
                "shard_set= or call=")
        self.shard_set = shard_set
        self.call = call
        self.verifier = verifier
        self._certifiers: Dict[str, ContinuousCertifier] = {}
        self._map = None
        self.verified_reads = 0

    # ---------------------------------------------------- transport

    def _mapping(self):
        from tendermint_tpu_torch.shard.router import ShardMap
        if self._map is None:
            if self.shard_set is not None:
                self._map = self.shard_set.router_map()
            else:
                doc = self.call("shards")
                self._map = ShardMap(doc["chains"],
                                     version=doc["version"])
        return self._map

    def _genesis_validators(self, chain_id: str):
        if self.shard_set is not None:
            node = self.shard_set.node_for_chain(chain_id)
            return node.state_store.load_validators(1) or \
                _genesis_valset(node.gen_doc)
        doc = self.call("genesis", chain_id=chain_id)["genesis"]
        from tendermint_tpu_torch.types.genesis import GenesisDoc
        return _genesis_valset(GenesisDoc.from_obj(doc))

    def _shard_read(self, key: bytes, since_height: int) -> dict:
        if self.shard_set is not None:
            doc = self.shard_set.router.shard_read(
                key, since_height=since_height)
            # in-process serve returns raw bytes fields pre-jsonify
            return doc
        return self.call("shard_read", key=bytes(key).hex(),
                         since_height=since_height)

    # -------------------------------------------------------- reads

    def read(self, key: bytes) -> dict:
        """Read `key` from its owning shard and certify the shipped
        commit proof before returning. Returns {chain_id, height,
        value, certified_height, valset_updates}; raises
        ReadProofError when certification fails."""
        from tendermint_tpu_torch.shard.router import _m_cross_reads
        key = bytes(key)
        chain_id = self._mapping().chain_of(key)
        cert = self._certifiers.get(chain_id)
        if cert is None:
            cert = ContinuousCertifier(
                chain_id, self._genesis_validators(chain_id),
                verifier=self.verifier)
            self._certifiers[chain_id] = cert
        doc = self._shard_read(key, cert.certified_height)
        try:
            doc_key = doc.get("key", "")
            doc_key = bytes.fromhex(doc_key) \
                if isinstance(doc_key, str) else bytes(doc_key)
            if doc_key != key:
                raise ReadProofError(
                    f"response is for key {doc_key.hex()}, asked for "
                    f"{key.hex()}")
            self.verify(doc, cert)
        except ReadProofError:
            _m_cross_reads.labels("rejected").inc()
            raise
        _m_cross_reads.labels("verified").inc()
        self.verified_reads += 1
        return {
            "chain_id": doc["chain_id"],
            "key": key,
            "value": bytes.fromhex(doc["value"])
            if isinstance(doc["value"], str) else doc["value"],
            "height": doc["height"],
            "app_hash": doc.get("app_hash", ""),
            "certified_height": cert.certified_height,
            "valset_updates": cert.updates,
            "mapping_version": doc.get("mapping_version"),
            "value_height": doc.get("value_height"),
            "proven": doc.get("value_proof") is not None,
        }

    @staticmethod
    def verify(doc: dict, cert: ContinuousCertifier) -> None:
        """Advance `cert` through the proof chain and pin the frontier.
        Trust does not advance past a failed height — a later honest
        read recovers from exactly where certification stopped."""
        chain_id = doc.get("chain_id", "")
        if chain_id != cert.chain_id:
            raise ReadProofError(
                f"proof is for chain {chain_id!r}, certifier follows "
                f"{cert.chain_id!r}")
        for obj in doc.get("proof_commits", ()):
            try:
                fc = FullCommit.from_obj(obj)
            except (KeyError, ValueError, TypeError) as e:
                raise ReadProofError(
                    f"malformed proof commit: {e}") from e
            try:
                cert.advance(fc)
            except CertificationError as e:
                raise ReadProofError(
                    f"certification failed at height "
                    f"{fc.height}: {e}") from e
        if cert.certified_height < int(doc.get("height", 0)):
            raise ReadProofError(
                f"proof chain stops at {cert.certified_height}, "
                f"value was read at height {doc.get('height')}")
        if doc.get("value_proof") is None:
            return  # head-only certification (bucket-mode chain)
        # value -> root -> app_hash -> commit: the state proof must
        # verify against the CERTIFIED app hash of the header at
        # value_height + 1 (which binds the state after value_height),
        # never against anything server-claimed.
        from tendermint_tpu_torch import statetree
        try:
            value_height = int(doc.get("value_height", -1))
        except (TypeError, ValueError):
            raise ReadProofError("malformed value_height")
        anchor = cert.app_hashes.get(value_height + 1)
        if anchor is None:
            raise ReadProofError(
                f"no certified header at height {value_height + 1} "
                f"anchors the value proof (certified: "
                f"{sorted(cert.app_hashes)})")
        value = doc.get("value", b"")
        if isinstance(value, str):
            value = bytes.fromhex(value)
        key = doc.get("key", "")
        key = bytes.fromhex(key) if isinstance(key, str) else bytes(key)
        try:
            pf = statetree.proof_from_obj(doc["value_proof"])
            statetree.verify(
                pf, key, value if pf.present else (value or None),
                anchor)
        except statetree.ProofError as e:
            raise ReadProofError(f"value proof rejected: {e}") from e


def _genesis_valset(gen_doc):
    from tendermint_tpu_torch.types.validator_set import (
        Validator,
        ValidatorSet,
    )
    return ValidatorSet([Validator(v.pubkey, v.power)
                         for v in gen_doc.validators])
