"""ABCI result types: the port's copy of `tendermint_tpu/abci/types.py`.

Plain dataclasses with canonical-JSON object forms, field for field the
JAX package's. `UniformDeliverResults` is the lazy sequence the JAX
package's native kvstore returns; the port's kvstore returns a list, but
ABCIResponses.from_obj reads the compact form that sequence persists.
Request and Response are the socket transport's envelopes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional

CodeTypeOK = 0


@dataclass
class ValidatorUpdate:
    """EndBlock validator diff: power 0 removes (state/execution.go:246)."""
    pubkey: bytes
    power: int

    def to_obj(self):
        return {"pubkey": self.pubkey.hex(), "power": self.power}

    @classmethod
    def from_obj(cls, o):
        return cls(bytes.fromhex(o["pubkey"]), o["power"])


@dataclass
class ResultInfo:
    data: str = ""
    version: str = ""
    last_block_height: int = 0
    last_block_app_hash: bytes = b""

    def to_obj(self):
        return {"data": self.data, "version": self.version,
                "last_block_height": self.last_block_height,
                "last_block_app_hash": self.last_block_app_hash.hex()}

    @classmethod
    def from_obj(cls, o):
        return cls(o["data"], o["version"], o["last_block_height"],
                   bytes.fromhex(o["last_block_app_hash"]))


@dataclass
class ResultCheckTx:
    code: int = CodeTypeOK
    data: bytes = b""
    log: str = ""
    gas_wanted: int = 0

    @property
    def ok(self) -> bool:
        return self.code == CodeTypeOK

    def to_obj(self):
        return {"code": self.code, "data": self.data.hex(), "log": self.log,
                "gas_wanted": self.gas_wanted}

    @classmethod
    def from_obj(cls, o):
        return cls(o["code"], bytes.fromhex(o["data"]), o["log"],
                   o.get("gas_wanted", 0))


@dataclass
class ResultDeliverTx:
    code: int = CodeTypeOK
    data: bytes = b""
    log: str = ""
    tags: dict = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return self.code == CodeTypeOK

    def to_obj(self):
        return {"code": self.code, "data": self.data.hex(), "log": self.log,
                "tags": self.tags}

    @classmethod
    def from_obj(cls, o):
        return cls(o["code"], bytes.fromhex(o["data"]), o["log"],
                   o.get("tags", {}))


class UniformDeliverResults:
    """Lazy sequence of N DeliverTx results sharing one outcome
    (code, data, log) and differing only in a per-key tag — the shape a
    batched native app (kvstore deliver_batch) produces for a block of
    plain txs. Materializing 5,000 ResultDeliverTx objects + tag dicts
    costs ~10ms/block of pure interpreter time; consumers that only
    need the hashed fields (results_hash: code+data) or the count never
    pay it, and per-tx consumers (event firing, tx indexing) build each
    result on access.

    `uniform = True` is the protocol marker results_hash and
    ABCIResponses.to_obj key their fast paths on."""

    __slots__ = ("_keys", "code", "data", "log", "tag_key", "_packed",
                 "_n")
    uniform = True

    def __init__(self, keys, code: int = CodeTypeOK, data: bytes = b"",
                 log: str = "", tag_key: str = "app.key",
                 packed: bytes = None, n: int = None):
        # keys may be None when `packed` (the length-prefixed key blob
        # from the native core) and `n` are given: the per-key bytes
        # objects then only materialize if a per-tx consumer asks
        self._keys = keys
        self.code = code
        self.data = data
        self.log = log
        self.tag_key = tag_key
        self._packed = packed  # length-prefixed key blob, if prebuilt
        self._n = len(keys) if keys is not None else n

    @property
    def keys(self):
        if self._keys is None:
            blob, pos, keys = self._packed, 0, []
            for _ in range(self._n):
                ln = int.from_bytes(blob[pos:pos + 4], "little")
                keys.append(blob[pos + 4:pos + 4 + ln])
                pos += 4 + ln
            self._keys = keys
        return self._keys

    def __len__(self):
        return self._n

    def __iter__(self):
        for i in range(self._n):
            yield self[i]

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(self._n))]
        return ResultDeliverTx(
            self.code, self.data, self.log,
            {self.tag_key: self.keys[i].decode("utf-8", "replace")})

    def to_compact_obj(self) -> dict:
        # keys as ONE length-prefixed blob hexed once — per-key .hex()
        # over 5,000 keys costs more than the rest of the persist path
        packed = self._packed
        if packed is None:
            packed = b"".join(
                len(k).to_bytes(4, "little") + k for k in self.keys)
        return {"code": self.code, "data": self.data.hex(),
                "log": self.log, "tag_key": self.tag_key,
                "n": self._n, "keys_packed": packed.hex()}

    @classmethod
    def from_compact_obj(cls, o: dict) -> "UniformDeliverResults":
        if "keys_packed" in o:
            # stays lazy: keys unpack from the blob only if a per-tx
            # consumer asks (the keys property)
            return cls(None, o["code"], bytes.fromhex(o["data"]),
                       o["log"], o["tag_key"],
                       packed=bytes.fromhex(o["keys_packed"]), n=o["n"])
        keys = [bytes.fromhex(k) for k in o["keys"]]  # older form
        return cls(keys, o["code"], bytes.fromhex(o["data"]), o["log"],
                   o["tag_key"])


@dataclass
class ResultEndBlock:
    validator_updates: List[ValidatorUpdate] = field(default_factory=list)
    consensus_param_updates: Optional[dict] = None
    tags: dict = field(default_factory=dict)

    def to_obj(self):
        return {"validator_updates":
                    [v.to_obj() for v in self.validator_updates],
                "consensus_param_updates": self.consensus_param_updates,
                "tags": self.tags}

    @classmethod
    def from_obj(cls, o):
        return cls([ValidatorUpdate.from_obj(v)
                    for v in o["validator_updates"]],
                   o.get("consensus_param_updates"), o.get("tags", {}))


@dataclass
class ResultQuery:
    code: int = CodeTypeOK
    key: bytes = b""
    value: bytes = b""
    proof: bytes = b""
    height: int = 0
    log: str = ""

    def to_obj(self):
        return {"code": self.code, "key": self.key.hex(),
                "value": self.value.hex(), "proof": self.proof.hex(),
                "height": self.height, "log": self.log}

    @classmethod
    def from_obj(cls, o):
        return cls(o["code"], bytes.fromhex(o["key"]),
                   bytes.fromhex(o["value"]), bytes.fromhex(o["proof"]),
                   o["height"], o["log"])


# Generic request/response envelopes for the socket transport. `method` maps
# 1:1 onto Application methods; `payload` is method-specific plain obj.

@dataclass
class Request:
    method: str
    payload: Any = None

    def to_obj(self):
        return {"method": self.method, "payload": self.payload}

    @classmethod
    def from_obj(cls, o):
        return cls(o["method"], o.get("payload"))


@dataclass
class Response:
    method: str
    payload: Any = None
    error: Optional[str] = None

    def to_obj(self):
        return {"method": self.method, "payload": self.payload,
                "error": self.error}

    @classmethod
    def from_obj(cls, o):
        return cls(o["method"], o.get("payload"), o.get("error"))
