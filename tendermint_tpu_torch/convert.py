"""Carry the JAX package's device state and block-plane objects into the
port.

The JAX verifier's state is its constant tables and its predecompression
cache: the 16 affine multiples of B (X, Y, T*2d) as int32[16, 3, 20]
13-bit limbs (`ladder_pallas._s_table_np()`), the constants D, D2,
SQRT_M1, ONE as int32[4, 20] (`ladder_pallas._consts_np()`), and the
cached rows {pubkey: (xneg u8[32], y u8[32], ok)} (`ops/ed25519._predecomp`).

`state_from_jax` takes them as plain numpy arrays and dicts (this module
imports nothing of the JAX package) and installs them into the port's
tables and cache; the kernels then read them from `device`.

The block plane crosses as the canonical objects its types' `to_obj`
gives (a block, the votes and validator set a VoteSet takes, a genesis
doc): `block_from_jax`, `votes_from_jax`, `valset_from_jax` and
`genesis_from_jax` rebuild the port's types from them and refuse an
object whose canonical bytes do not survive the crossing.
"""

from __future__ import annotations

import numpy as np

from tendermint_tpu_torch.ops import ed25519, ladder
from tendermint_tpu_torch.types import encoding
from tendermint_tpu_torch.types.block import Block
from tendermint_tpu_torch.types.genesis import GenesisDoc
from tendermint_tpu_torch.types.validator_set import ValidatorSet
from tendermint_tpu_torch.types.vote import Vote
from tendermint_tpu_torch.utils import device as _device


def state_from_jax(s_table, consts, predecomp_rows=None, device=None) -> dict:
    """Install the s-table, the constants and, optionally, cache rows.
    Returns what was installed: {"s_table", "consts", "rows"}."""
    dev = _device.resolve(device)
    s_table = np.asarray(s_table)
    consts = np.asarray(consts)
    if s_table.dtype != np.int32 or consts.dtype != np.int32:
        raise ValueError(
            f"tables must be int32, got {s_table.dtype}, {consts.dtype}")
    rows = {}
    for pk, (xn, y, ok) in (predecomp_rows or {}).items():
        xn, y = np.asarray(xn), np.asarray(y)
        if len(pk) != 32 or xn.shape != (32,) or y.shape != (32,):
            raise ValueError("predecomp rows are {pubkey32: (u8[32], u8[32], "
                             "ok)}")
        rows[bytes(pk)] = (xn.astype(np.uint8), y.astype(np.uint8), bool(ok))
    ladder.install_tables(s_table, consts, device=dev)
    ed25519.install_predecomp_rows(rows)
    return {"s_table": s_table.shape, "consts": consts.shape,
            "rows": len(rows)}


def _carried(obj, out, what: str):
    """`out` if its canonical bytes equal those of the object it was
    built from, else ValueError."""
    if encoding.cdumps(out.to_obj()) != encoding.cdumps(obj):
        raise ValueError(f"{what} does not round-trip through to_obj")
    return out


def block_from_jax(obj) -> Block:
    """A Block from the JAX package's `Block.to_obj()`."""
    return _carried(obj, Block.from_obj(obj), "block")


def votes_from_jax(objs) -> list:
    """Votes from the JAX package's `Vote.to_obj()`s (None stays None)."""
    return [None if o is None else _carried(o, Vote.from_obj(o), "vote")
            for o in objs]


def valset_from_jax(obj) -> ValidatorSet:
    """A ValidatorSet, accums and proposer included, from the JAX
    package's `ValidatorSet.to_obj()`."""
    return _carried(obj, ValidatorSet.from_obj(obj), "validator set")


def genesis_from_jax(obj) -> GenesisDoc:
    """A GenesisDoc from the JAX package's `GenesisDoc.to_obj()`."""
    return _carried(obj, GenesisDoc.from_obj(obj), "genesis doc")
