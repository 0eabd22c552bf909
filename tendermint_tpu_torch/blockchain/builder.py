"""ChainBuilder: a valid chain of signed, applied blocks for a syncing
node; the counterpart of `bench_fastsync.ChainBuilder`.

For the same sizes it gives the same block bytes as the JAX package's
builder: validator i's seed is (i + 1) as 32 little-endian bytes, power
10; block h holds n_txs txs `k<h % key_space>.<i>=v<h>` at time h
seconds; every validator precommits it at time h seconds + 1 ns; and
each block is applied through the kvstore app, so its successor's header
carries the real app hash and results hash. Ed25519 signing is
deterministic, so the signatures are the same bytes too.

The 64 precommits of a block are signed in one `sign_batch_async` call
(the r*B kernel on the card). A block's commit hash enters its
successor's header, so blocks are signed one at a time; the signing is
dispatched before the block is applied and resolved after.
"""

from __future__ import annotations

import time

from tendermint_tpu_torch.abci.apps import KVStoreApp
from tendermint_tpu_torch.abci.proxy import AppConns, local_client_creator
from tendermint_tpu_torch.abci.types import ValidatorUpdate
from tendermint_tpu_torch.ops import ed25519
from tendermint_tpu_torch.state.execution import (exec_block_on_app,
                                                  update_state)
from tendermint_tpu_torch.storage import MemDB, StateStore
from tendermint_tpu_torch.types.block import BlockID, Commit
from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from tendermint_tpu_torch.types.keys import PrivKey
from tendermint_tpu_torch.types.vote import Vote, VoteType
from tendermint_tpu_torch.utils import device as _device

STAGES = ("make_block_ms", "part_set_ms", "sign_dispatch_ms", "apply_ms",
          "sign_resolve_ms", "votes_ms")


class ChainBuilder:
    def __init__(self, n_vals: int, n_txs: int, key_space: int = 512,
                 chain_id: str = "bench-sync", device=None):
        self.device = _device.resolve(device)
        seeds = [(i + 1).to_bytes(32, "little") for i in range(n_vals)]
        keys = [PrivKey.generate(s) for s in seeds]
        seed_of = {k.pubkey.address: s for k, s in zip(keys, seeds)}
        self.gen = GenesisDoc(
            chain_id=chain_id, genesis_time_ns=1,
            validators=[GenesisValidator(k.pubkey.ed25519, 10)
                        for k in keys])
        self.state = StateStore(MemDB()).load_or_genesis(self.gen)
        # seeds in the validator set's order (sorted by address)
        self.seeds = [seed_of[v.address]
                      for v in self.state.validators.validators]
        #: the kvstore app the blocks are applied to (at self.height)
        self.app = KVStoreApp()
        self.conns = AppConns(local_client_creator(self.app))
        self.conns.consensus.init_chain(
            [ValidatorUpdate(v.pubkey, v.voting_power)
             for v in self.state.validators.validators], self.gen.chain_id)
        self.n_txs = n_txs
        self.key_space = key_space
        self.part_size = \
            self.state.consensus_params.block_gossip.block_part_size_bytes
        self.height = 0
        self.last_commit = Commit()

    def build(self, n: int, times: dict | None = None) -> list:
        """The next n blocks. Each is applied through the app without
        block validation (the builder made it; the syncing node
        validates). `times`, when given, gains the ms of each stage
        (STAGES)."""
        st = dict.fromkeys(STAGES, 0.0)
        out = []
        chain_id = self.gen.chain_id
        for _ in range(n):
            h = self.height + 1
            t0 = time.perf_counter()
            txs = [b"k%d.%d=v%d" % (h % self.key_space, i, h)
                   for i in range(self.n_txs)]
            block = self.state.make_block(h, txs, self.last_commit,
                                          time_ns=h * 10 ** 9)
            t1 = time.perf_counter()
            parts = block.make_part_set(self.part_size)
            block_id = BlockID(block.hash(), parts.header())
            out.append(block)
            t1b = time.perf_counter()
            vals = self.state.validators.validators
            precommits = [Vote(validator_address=val.address,
                               validator_index=idx, height=h, round=0,
                               timestamp_ns=h * 10 ** 9 + 1,
                               type=VoteType.PRECOMMIT, block_id=block_id)
                          for idx, val in enumerate(vals)]
            # one timestamp and one block id: every validator signs the
            # same canonical bytes
            msg = precommits[0].sign_bytes(chain_id)
            t2 = time.perf_counter()
            resolve = ed25519.sign_batch_async(
                self.seeds, [msg] * len(vals), device=self.device)
            t3 = time.perf_counter()
            responses = exec_block_on_app(self.conns.consensus, block,
                                          self.state.validators)
            new_state = update_state(self.state.copy(), block_id, block,
                                     responses)
            new_state.app_hash = self.conns.consensus.commit()
            t4 = time.perf_counter()
            sigs = resolve()
            t5 = time.perf_counter()
            for v, sig in zip(precommits, sigs):
                v.signature = sig
            self.last_commit = Commit(block_id, precommits)
            self.state = new_state
            self.height = h
            t6 = time.perf_counter()
            st["votes_ms"] += (t2 - t1b) * 1e3
            for k, a, b in (("make_block_ms", t0, t1),
                            ("part_set_ms", t1, t1b),
                            ("sign_dispatch_ms", t2, t3),
                            ("apply_ms", t3, t4),
                            ("sign_resolve_ms", t4, t5),
                            ("votes_ms", t5, t6)):
                st[k] += (b - a) * 1e3
        if times is not None:
            for k, v in st.items():
                times[k] = times.get(k, 0.0) + v
        return out
