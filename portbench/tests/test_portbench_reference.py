"""The plain references agree with the program at tiny sizes on the CPU."""

import random

from portbench.gen import keys as gkeys
from portbench.reference import ed25519 as ref
from portbench.reference.voteset import VoteSet as RefVoteSet


def _items(n, seed):
    r = random.Random(seed)
    seeds = [gkeys.seed_bytes(seed, "ref", i) for i in range(n)]
    msgs = [[r.randbytes(r.randrange(0, 200))] for _ in range(n)]
    pubs, sigs = gkeys.sign_matrix(seeds, msgs)
    items = [(p, m[0], s[0]) for p, m, s in zip(pubs, msgs, sigs)]
    out = []
    for i, (p, m, s) in enumerate(items):
        if i % 4 == 1:
            b = r.randrange(64)
            s = s[:b] + bytes([s[b] ^ (1 + r.randrange(255))]) + s[b + 1:]
        elif i % 4 == 2:
            m = m + b"."
        elif i % 8 == 3:
            s = s[:32] + (2 ** 253 + r.randrange(2 ** 200)).to_bytes(
                32, "little")
        elif i % 8 == 7:
            p = (2 ** 255 - 1).to_bytes(32, "little")   # y >= p
        out.append((p, m, s))
    return out


def test_reference_verify_equals_the_programs_batch_path_on_the_cpu():
    from tendermint_tpu_torch.models.verifier import BatchVerifier
    items = _items(24, 11)
    got = BatchVerifier("cuda", device="cpu", coalesce="off").verify(items)
    want = [ref.verify(*it) for it in items]
    assert list(map(bool, got)) == want
    assert any(want) and not all(want)


def test_reference_verify_equals_the_programs_host_path():
    from tendermint_tpu_torch.types import keys
    items = _items(40, 12)
    assert [bool(x) for x in keys.verify_many(items)] == \
        [ref.verify(*it) for it in items]


def test_reference_vote_set_equals_the_programs():
    from tendermint_tpu_torch.models.verifier import BatchVerifier
    from tendermint_tpu_torch.types.block import BlockID, PartSetHeader
    from tendermint_tpu_torch.types.validator_set import (Validator,
                                                          ValidatorSet)
    from tendermint_tpu_torch.types.vote import Vote
    from tendermint_tpu_torch.types.vote_set import VoteSet
    from portbench.frozen import tmhash
    r = random.Random(5)
    n = 10
    seeds = [gkeys.seed_bytes(5, "vs", i) for i in range(n)]
    pubs = [gkeys.pubkey(s) for s in seeds]
    order = sorted(range(n), key=lambda i: tmhash.address(pubs[i]))
    powers = [1 + r.randrange(9) for _ in range(n)]
    vs = ValidatorSet([Validator(pubs[i], powers[i]) for i in order])
    addrs = [tmhash.address(pubs[i]) for i in order]
    pw = [powers[i] for i in order]
    blocks = [(r.randbytes(32), 1, r.randbytes(32)) for _ in range(2)]
    # every validator votes A; validators 0-3 also vote B; one A vote
    # of validator 5 comes first with a changed signature
    plan = [(j, 0, True) for j in range(n)] + \
        [(j, 1, True) for j in range(4)] + [(5, 0, False)]
    r.shuffle(plan)
    plan.insert(0, (5, 0, False))
    msgs = [[(j, b, ok) for j, b, ok in plan[lo:lo + 4]]
            for lo in range(0, len(plan), 4)]
    signer = gkeys.Signer([seeds[i] for i in order])
    prog = VoteSet("c", 3, 0, 2, vs,
                   verifier=BatchVerifier("python", coalesce="off"))
    mine = RefVoteSet(3, 0, 2, pw, addrs)
    for msg in msgs:
        votes, plain = [], []
        for j, b, ok in msg:
            bid = blocks[b]
            sb = tmhash.vote_sign_bytes("c", bid, 3, 0, 100 + j, 2)
            sig = signer.sign(j, sb)
            if not ok:
                sig = bytes([sig[0] ^ 1]) + sig[1:]
            votes.append(Vote(addrs[j], j, 3, 0, 100 + j, 2,
                              BlockID(bid[0], PartSetHeader(1, bid[2])), sig))
            plain.append((j, addrs[j], 3, 0, 2,
                          f"{bid[0].hex()}/1/{bid[2].hex()}", ok))
        res, errs = prog.add_votes_batch(votes)
        got = (res, [(p, type(e).__name__, bool(getattr(e, "added", False)))
                     for p, e in errs])
        assert got == mine.add_message(plain)
    assert (prog.power, prog.maj23.key() if prog.maj23 else None,
            {k: v.power for k, v in prog.votes_by_block.items()}) \
        == mine.summary()
