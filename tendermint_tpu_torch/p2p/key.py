"""Node identity — Ed25519 key whose address is the node ID: the port's
copy of `tendermint_tpu/p2p/key.py`.

p2p/key.go: `ID = hex(address(pubkey))` (:43-47), persisted as a JSON file
next to the validator key. The ID authenticates the peer during the
secret-connection handshake; dialing by `id@host:port` pins the expected
identity.
"""

from __future__ import annotations

import json
import os

from tendermint_tpu_torch.types.keys import PrivKey, address_of

ID_BYTE_LENGTH = 20  # address bytes (p2p/key.go:28)


def pubkey_to_id(pubkey: bytes) -> str:
    return address_of(pubkey).hex()


def validate_id(id_: str) -> None:
    if len(id_) != 2 * ID_BYTE_LENGTH:
        raise ValueError(f"invalid node ID length {len(id_)} (want "
                         f"{2 * ID_BYTE_LENGTH} hex chars): {id_!r}")
    bytes.fromhex(id_)  # raises on non-hex


class NodeKey:
    def __init__(self, priv_key: PrivKey):
        self.priv_key = priv_key

    @property
    def pubkey(self) -> bytes:
        return self.priv_key.pubkey.ed25519

    def id(self) -> str:
        return pubkey_to_id(self.pubkey)

    def sign(self, msg: bytes) -> bytes:
        return self.priv_key.sign(msg)

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"priv_key": self.priv_key.seed.hex()}, f)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "NodeKey":
        with open(path) as f:
            o = json.load(f)
        return cls(PrivKey.generate(bytes.fromhex(o["priv_key"])))

    @classmethod
    def load_or_generate(cls, path: str) -> "NodeKey":
        """p2p/key.go LoadOrGenNodeKey."""
        if os.path.exists(path):
            return cls.load(path)
        nk = cls(PrivKey.generate())
        nk.save(path)
        return nk
