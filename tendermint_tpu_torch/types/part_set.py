"""PartSet: a block's bytes split into Merkle-proven parts for gossip.

Counterpart of `tendermint_tpu/types/part_set.py`: the same split, root,
proofs and refusals. The skeleton (root and every proof) comes from one
host tree build (`merkle.tree_proofs_host`), the JAX package's route
when its native part-set builder is off; both give the same bytes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

from tendermint_tpu_torch.ops import merkle
from tendermint_tpu_torch.types.block import PartSetHeader


@dataclass
class Part:
    index: int
    payload: bytes
    proof: List[bytes]  # aunts, leaf-up

    def to_obj(self):
        return {"index": self.index, "payload": self.payload.hex(),
                "proof": [a.hex() for a in self.proof]}

    @classmethod
    def from_obj(cls, o):
        return cls(o["index"], bytes.fromhex(o["payload"]),
                   [bytes.fromhex(a) for a in o["proof"]])


def _build_skeleton(data: bytes, part_size: int):
    """(n_parts, root, proofs) of the split of `data` into part_size
    chunks (one empty part for empty data)."""
    chunks = [data[i:i + part_size]
              for i in range(0, len(data), part_size)] or [b""]
    root, proofs = merkle.tree_proofs_host(chunks)
    return len(chunks), root, proofs


class PartSet:
    def __init__(self, total: int, root: bytes):
        self.total = total
        self.root = root
        self.parts: List[Optional[Part]] = [None] * total
        self.count = 0
        self._size = 0

    @classmethod
    def from_data(cls, data: bytes, part_size: int) -> "PartSet":
        n, root, proofs = _build_skeleton(data, part_size)
        ps = cls(n, root)
        for i in range(n):
            ps.parts[i] = Part(i, data[i * part_size:(i + 1) * part_size],
                               proofs[i])
        ps.count = n
        ps._size = len(data)
        return ps

    @classmethod
    def from_data_streaming(cls, data: bytes, part_size: int
                            ) -> Tuple["PartSet", Iterator[Part]]:
        """(ps, parts): the header (total and root) is usable at once; the
        parts are made as the iterator is consumed, each added to `ps` as
        it is yielded. Consumed fully, `ps` equals from_data()'s."""
        n, root, proofs = _build_skeleton(data, part_size)
        ps = cls(n, root)

        def gen() -> Iterator[Part]:
            for i in range(n):
                part = Part(i, data[i * part_size:(i + 1) * part_size],
                            proofs[i])
                ps.parts[i] = part
                ps.count += 1
                ps._size += len(part.payload)
                yield part

        return ps, gen()

    @classmethod
    def from_header(cls, header: PartSetHeader) -> "PartSet":
        return cls(header.total, header.hash)

    def header(self) -> PartSetHeader:
        return PartSetHeader(self.total, self.root)

    def has_header(self, h: PartSetHeader) -> bool:
        return self.header() == h

    def add_part(self, part: Part) -> bool:
        """Add a part whose Merkle proof verifies against the root; raises
        on a bad index or proof, returns False for a duplicate."""
        if part.index >= self.total:
            raise ValueError("part index out of range")
        if self.parts[part.index] is not None:
            return False
        if not merkle.verify_proof_host(self.root, self.total, part.index,
                                        part.payload, part.proof):
            raise ValueError("invalid part proof")
        self.parts[part.index] = part
        self.count += 1
        self._size += len(part.payload)
        return True

    def get_part(self, index: int) -> Optional[Part]:
        return self.parts[index]

    def is_complete(self) -> bool:
        return self.count == self.total

    def get_data(self) -> bytes:
        assert self.is_complete()
        return b"".join(p.payload for p in self.parts)

    def bit_array(self) -> List[bool]:
        return [p is not None for p in self.parts]
