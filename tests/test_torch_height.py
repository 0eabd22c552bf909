"""One consensus height through the port alone, as chip_smoke.py's block
phase drives it at 10,000 validators on the card.

Propose (a block with txs, the previous height's commit and one
duplicate-vote evidence; its part set and block id), gossip (a receiver
adds every part through its proof, refuses a tampered one and rebuilds
the block), prevotes and precommits (signed with sign_batch, fed with a
flipped signature, a duplicate and a conflicting vote through one
add_votes_batch each), make_commit and verify_commit, the evidence check
on the batch path, and the device Merkle root and hash_fixed against
hashlib. On the CPU at 8 validators (the plain versions of the kernels);
the test marked `cuda` runs 64 validators on the card, where it needs no
jax: `python -m pytest --noconftest -m cuda tests/test_torch_height.py`.
"""

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from tendermint_tpu_torch.models import verifier as tverifier
from tendermint_tpu_torch.ops import ed25519 as ted
from tendermint_tpu_torch.ops import ladder, merkle, sha256
from tendermint_tpu_torch.types.block import (Block, BlockID, Commit, Data,
                                              EvidenceData, Header,
                                              PartSetHeader)
from tendermint_tpu_torch.types.evidence import DuplicateVoteEvidence
from tendermint_tpu_torch.types.keys import PrivKey
from tendermint_tpu_torch.types.part_set import PartSet
from tendermint_tpu_torch.types.validator_set import Validator, ValidatorSet
from tendermint_tpu_torch.types.vote import Vote, VoteType
from tendermint_tpu_torch.types.vote_set import ConflictingVoteError, VoteSet

torch.set_num_threads(1)

CHAIN = "height-chain"
H = 7


def _flip(b: bytes, i: int) -> bytes:
    return b[:i] + bytes([b[i] ^ 1]) + b[i + 1:]


def _signed(seeds, votes, device):
    """Sign every vote with its validator's seed in one sign_batch."""
    sigs = ted.sign_batch(seeds, [v.sign_bytes(CHAIN) for v in votes],
                          device=device)
    for v, s in zip(votes, sigs):
        v.signature = s
    return votes


def one_height(n_vals, n_txs, part_size, device, verifier):
    rng = np.random.RandomState(n_vals)
    seeds = [rng.bytes(32) for _ in range(n_vals)]
    privs = [PrivKey(s) for s in seeds]
    vs = ValidatorSet([Validator(p.pubkey.ed25519, 10 + i % 7)
                       for i, p in enumerate(privs)])
    seed_of = {p.pubkey.address: s for p, s in zip(privs, seeds)}
    vseeds = [seed_of[v.address] for v in vs.validators]

    # the previous height's commit and one equivocation in it
    last_bid = BlockID(b"\x5a" * 32, PartSetHeader(4, b"\xa5" * 32))
    last = _signed(vseeds, [Vote(v.address, i, H - 1, 0, 1000 + i,
                                 VoteType.PRECOMMIT, last_bid)
                            for i, v in enumerate(vs.validators)], device)
    fork = BlockID(b"\x66" * 32, last_bid.parts)
    dup = _signed(vseeds[:1], [Vote(vs.validators[0].address, 0, H - 1, 0,
                                    1000, VoteType.PRECOMMIT, fork)], device)
    evidence = DuplicateVoteEvidence(vs.validators[0].pubkey, last[0], dup[0])

    # 1. propose
    txs = [b"k%d.%d=v" % (H, i) for i in range(n_txs)]
    block = Block(Header(chain_id=CHAIN, height=H, time_ns=H, num_txs=n_txs,
                         total_txs=n_txs, last_block_id=last_bid,
                         validators_hash=vs.hash(), app_hash=b"\x01" * 32),
                  Data(txs), EvidenceData([evidence]),
                  Commit(last_bid, last))
    block.fill_header()
    block.validate_basic()
    ps = block.make_part_set(part_size)
    bid = block.block_id(part_size)
    assert ps.total > 1 and bid.parts == ps.header()

    # 2. gossip
    rx = PartSet.from_header(bid.parts)
    bad = ps.get_part(1)
    with pytest.raises(ValueError, match="invalid part proof"):
        rx.add_part(type(bad)(bad.index, _flip(bad.payload, 3), bad.proof))
    assert all(rx.add_part(ps.get_part(i)) for i in range(ps.total))
    got = Block.from_bytes(rx.get_data())
    assert got.hash() == block.hash() and got.block_id(part_size) == bid

    # 3, 4. prevotes and precommits, with three extras each
    other = BlockID(b"\x77" * 32, bid.parts)
    commit = None
    for type_ in (VoteType.PREVOTE, VoteType.PRECOMMIT):
        votes = [Vote(v.address, i, H, 0, 2000 + i, type_, bid)
                 for i, v in enumerate(vs.validators)]
        conflict = Vote(vs.validators[2].address, 2, H, 0, 3000, type_, other)
        _signed(vseeds + [vseeds[2]], votes + [conflict], device)
        flipped = dataclasses.replace(
            votes[1], signature=_flip(votes[1].signature, 40))
        vset = VoteSet(CHAIN, H, 0, type_, vs, verifier=verifier)
        sigs = verifier.stats["cuda_sigs"]
        results, errors = vset.add_votes_batch(
            votes + [flipped, votes[3], conflict])
        assert verifier.stats["cuda_sigs"] - sigs == n_vals + 3
        assert results == [True] * n_vals + [False] * 3
        assert [(p, type(e)) for p, e in errors] == [
            (n_vals, ValueError), (n_vals + 2, ConflictingVoteError)]
        assert str(errors[0][1]) == f"invalid signature on {flipped}"
        assert vset.two_thirds_majority() == bid
        if type_ == VoteType.PRECOMMIT:
            commit = vset.make_commit()
    vs.verify_commit(CHAIN, bid, H, commit, verifier=verifier)
    nxt = Block(Header(chain_id=CHAIN, height=H + 1, last_block_id=bid,
                       validators_hash=vs.hash()), last_commit=commit)
    nxt.fill_header()
    assert nxt.header.last_commit_hash == commit.hash()

    # 5. evidence on the batch path; a forged copy is refused
    evidence.verify(CHAIN, vs.validators[0].pubkey, verifier=verifier)
    forged = DuplicateVoteEvidence(evidence.pubkey, evidence.vote_a,
                                   dataclasses.replace(
                                       dup[0],
                                       signature=_flip(dup[0].signature, 5)))
    with pytest.raises(ValueError, match="^invalid signature in evidence$"):
        forged.verify(CHAIN, vs.validators[0].pubkey, verifier=verifier)

    # 6. the device Merkle plane
    assert merkle.root(txs, device=device) == block.data.hash()
    rows = np.random.RandomState(3).randint(0, 256, (64, 64)).astype(np.uint8)
    out = sha256.hash_fixed(torch.from_numpy(rows).to(device)).cpu().numpy()
    assert all(out[i].tobytes() == hashlib.sha256(rows[i].tobytes()).digest()
               for i in range(len(rows)))


def test_one_height_on_cpu():
    one_height(8, 40, 512, "cpu", tverifier.BatchVerifier("cuda",
                                                          device="cpu"))


@pytest.mark.cuda
def test_cuda_one_height_launches_the_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    before = dict(ladder.launches)
    one_height(64, 1000, 1024, "cuda", tverifier.BatchVerifier("cuda"))
    after = ladder.launches
    assert after["sign_rb"] > before["sign_rb"]
    assert after["verify"] + after["verify_pre"] > \
        before["verify"] + before["verify_pre"]
