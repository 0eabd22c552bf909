"""SecureClient, the proof-checking RPC proxy (lite/proxy/wrapper.go): the
port's copy of `tendermint_tpu/lite/proxy.py`.

It wraps an RPC client so that results are verified against certified
headers before they are returned: a block must hash to a certified
header, a commit and a validator set are certified, and a tx's Merkle
proof must reach the certified header's data_hash. Each certify runs the
certifier's verifier, on the card the verify kernels. `stats` counts the
certifications made and refused.
"""

from __future__ import annotations

import threading

from tendermint_tpu_torch.lite.certifier import InquiringCertifier
from tendermint_tpu_torch.lite.provider import HTTPProvider
from tendermint_tpu_torch.lite.types import CertificationError, FullCommit
from tendermint_tpu_torch.ops import merkle
from tendermint_tpu_torch.types.block import Block


class SecureClient:
    def __init__(self, rpc_client, certifier: InquiringCertifier):
        self.rpc = rpc_client
        self.certifier = certifier
        self.source = HTTPProvider(rpc_client)
        self._stats_lock = threading.Lock()
        #: certify calls that passed and that raised CertificationError
        self.stats = {"certified": 0, "refused": 0}

    def _count(self, key: str) -> None:
        with self._stats_lock:
            self.stats[key] += 1

    def _certified_commit(self, height: int) -> FullCommit:
        fc = self.source.get_by_height(height)
        if fc is None or fc.height != height:
            raise CertificationError(f"no commit for height {height}")
        try:
            self.certifier.certify(fc)
        except CertificationError:
            self._count("refused")
            raise
        self._count("certified")
        return fc

    def block(self, height: int) -> dict:
        """lite/proxy: the block, and proof that it matches the certified
        header."""
        res = self.rpc.call("block", height=height)
        block = Block.from_obj(res["block"])
        fc = self._certified_commit(height)
        if block.hash() != fc.signed_header.header.hash():
            raise CertificationError(
                f"block {height} does not match certified header")
        return res

    def commit(self, height: int) -> dict:
        fc = self._certified_commit(height)
        return {"header": fc.signed_header.header.to_obj(),
                "commit": fc.signed_header.commit.to_obj(),
                "certified": True}

    def status(self) -> dict:
        return self.rpc.call("status")

    def validators(self, height: int) -> dict:
        fc = self._certified_commit(height)
        return {"block_height": height,
                "validators": fc.validators.to_obj(),
                "certified": True}

    def tx(self, hash: bytes, prove: bool = True) -> dict:
        """The tx, its Merkle proof verified against the certified
        header's data_hash (lite/proxy/query.go semantics)."""
        res = self.rpc.call("tx", hash=hash, prove=True)
        height = res["height"]
        fc = self._certified_commit(height)
        proof = res.get("proof")
        if proof is None:
            raise CertificationError("node returned no tx proof")
        root = bytes.fromhex(proof["root_hash"])
        if root != fc.signed_header.header.data_hash:
            raise CertificationError("tx proof root != certified data_hash")
        ok = merkle.verify_proof_host(
            root, proof["total"], proof["index"],
            bytes.fromhex(res["tx"]),
            [bytes.fromhex(p) for p in proof["proof"]])
        if not ok:
            raise CertificationError("invalid tx merkle proof")
        return res
