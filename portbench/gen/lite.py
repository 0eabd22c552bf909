"""The lite100 chain: a light client's view of a chain whose validators'
powers change at every height, made from the run's seed, as a node's RPC
replies.

Validator i's key comes from the seed. The first `head` validators made
draw their powers from `head_power`, the rest from `tail_power` (so the
largest 10 of 100 hold about 40%). At every height after the first,
`changes` validators (a count drawn from its range) change power by a
percentage drawn from `change_pct`, up or down, by at least 1; and
`absent` validators (a count drawn from its range) are missing from the
height's commit. Membership never changes, so the set's order by address
is fixed.

Height h's header carries the hash of its own validator set and the block
id of h - 1; the fields a light client does not check (last commit hash,
app hash, consensus hash) are bytes from the seed, so that no header
depends on a signature and every message is known before signing. Every
present validator precommits the block at its own timestamp. The
signatures are OpenSSL's, made by `gen/keys.sign_matrix` in worker
processes: each key is handed to it once per chunk of heights, so that it
sees enough keys to use its pool.

`replies[h]` is the pair of JSON bytes a node's RPC returns for height h:
the `commit` reply (header and commit) and the `validators` reply. The
two forged side chains of the check are single replaced heights:
`forged_signature` changes one byte of one signature of a vote for the
block; `unknown_keys` replaces some validators of the set trusted below
by keys it does not know, so that the trusted validators who sign hold
exactly 2/3 of its power where the integers allow, else the most below,
while the new set's own rule holds.
"""

from __future__ import annotations

import random

from portbench.frozen import tmhash
from portbench.gen import keys as gkeys

PRECOMMIT = 2


def most_at_or_below(powers: list, limit: int) -> list:
    """Indices of a subset of `powers` whose sum is the largest at or
    below `limit` (subset sums by a bitset, one per prefix)."""
    masks = [1]
    for p in powers:
        masks.append(masks[-1] | (masks[-1] << p))
    full = masks[-1] & ((1 << (limit + 1)) - 1)
    s = full.bit_length() - 1
    picked = []
    for i in range(len(powers), 0, -1):
        if not (masks[i - 1] >> s) & 1:
            picked.append(i - 1)
            s -= powers[i - 1]
    return sorted(picked)


class LiteChain:
    """`replies[h]` (commit reply bytes, validators reply bytes) for
    h = 1 .. headers; `vals[h]` [(pubkey, power)] in address order;
    `votes[h]` [(timestamp, signature) or None] by commit index;
    `block_id[h]`; `seeds` the validators' private seeds in the order
    made and `order` their places by address; `chain_id`."""

    def __init__(self, cfg: dict, seed: int, headers: int):
        n = cfg["validators"]
        self.chain_id = cfg["chain_id"]
        self.headers = headers
        self.seed = seed
        self.seeds = [gkeys.seed_bytes(seed, cfg["name"], i)
                      for i in range(n)]
        pubs = [gkeys.pubkey(s) for s in self.seeds]
        self.order = sorted(range(n), key=lambda i: tmhash.address(pubs[i]))
        r = random.Random(repr((seed, "lite-chain")))
        power = [r.randint(*cfg["head_power"]) if i < cfg["head"]
                 else r.randint(*cfg["tail_power"]) for i in range(n)]
        self.vals, self.block_id, self.headers_obj = {}, {}, {}
        absent, stamps = {}, {}
        last_bid = tmhash.ZERO_BLOCK_ID
        for h in range(1, headers + 1):
            if h > 1:
                for i in r.sample(range(n), r.randint(*cfg["changes"])):
                    step = max(1, power[i] * r.randint(*cfg["change_pct"])
                               // 100)
                    power[i] += step if r.random() < 0.5 else -step
            vals = [(pubs[i], power[i]) for i in self.order]
            hobj = self._header(h, vals, last_bid, r)
            bid = (tmhash.header_hash(hobj), 1, r.randbytes(32))
            self.vals[h], self.headers_obj[h], self.block_id[h] = \
                vals, hobj, bid
            absent[h] = set(r.sample(range(n), r.randint(*cfg["absent"])))
            stamps[h] = [h * 10 ** 9 + 1 + r.randrange(10 ** 6)
                         for _ in range(n)]
            last_bid = bid
        sigs = self._sign(n, absent, stamps)
        self.votes = {h: [None if j in absent[h] else
                          (stamps[h][j], sigs[h][j]) for j in range(n)]
                      for h in range(1, headers + 1)}
        self.replies = {h: self._replies(h, r) for h in range(1, headers + 1)}

    def _header(self, h: int, vals: list, last_bid, r) -> dict:
        return tmhash.header_obj(
            self.chain_id, h, h * 10 ** 9, 0, 0, last_bid, r.randbytes(32),
            tmhash.merkle_root([]), tmhash.valset_hash(vals), r.randbytes(32),
            r.randbytes(32), b"", tmhash.merkle_root([]))

    def _msg(self, h: int, j: int, ts: int, bid=None) -> bytes:
        return tmhash.vote_sign_bytes(self.chain_id, bid or self.block_id[h],
                                      h, 0, ts, PRECOMMIT)

    def _sign(self, n: int, absent: dict, stamps: dict) -> dict:
        """{h: {commit index: signature}}: each key signs its heights'
        messages, a chunk of heights at a time across the pool."""
        chunks = max(3, gkeys.workers())
        step = -(-self.headers // chunks)
        seeds, msgs, where = [], [], []
        for lo in range(1, self.headers + 1, step):
            for j, i in enumerate(self.order):
                hs = [h for h in range(lo, min(lo + step, self.headers + 1))
                      if j not in absent[h]]
                seeds.append(self.seeds[i])
                msgs.append([self._msg(h, j, stamps[h][j]) for h in hs])
                where.append((j, hs))
        _, sigs = gkeys.sign_matrix(seeds, msgs)
        out = {h: {} for h in range(1, self.headers + 1)}
        for (j, hs), ss in zip(where, sigs):
            for h, s in zip(hs, ss):
                out[h][j] = s
        return out

    def _vote_obj(self, h: int, j: int, pk: bytes, ts: int, sig: bytes,
                  bid=None) -> dict:
        return tmhash.vote_obj(tmhash.address(pk), j, h, 0, ts, PRECOMMIT,
                               bid or self.block_id[h], sig)

    def _replies(self, h: int, r, hobj=None, bid=None, vals=None,
                 votes=None) -> tuple:
        hobj = hobj or self.headers_obj[h]
        bid = bid or self.block_id[h]
        vals = vals or self.vals[h]
        votes = votes or self.votes[h]
        precommits = [None if v is None else
                      self._vote_obj(h, j, vals[j][0], v[0], v[1], bid)
                      for j, v in enumerate(votes)]
        total = sum(p for _, p in vals)
        commit = {"header": hobj, "commit": tmhash.commit_obj(bid, precommits),
                  "canonical": True}
        validators = {"block_height": h, "validators": {
            "validators": [{"pubkey": pk.hex(), "voting_power": p,
                            "accum": r.randrange(-total, total)}
                           for pk, p in vals],
            "proposer": tmhash.address(r.choice(vals)[0]).hex()}}
        return tmhash.cdumps(commit), tmhash.cdumps(validators)

    def sign_bytes(self, h: int, j: int) -> bytes:
        return self._msg(h, j, self.votes[h][j][0])

    # -- the forged side chains of the check ------------------------------

    def forged_signature(self, at: int, r: random.Random) -> tuple:
        """(replies with height `at` replaced, the (height, index) of the
        changed signature, the changed signature): one byte of one
        present vote's signature changed."""
        j = r.choice([j for j, v in enumerate(self.votes[at]) if v])
        ts, sig = self.votes[at][j]
        b = r.randrange(64)
        bad = sig[:b] + bytes([sig[b] ^ (1 + r.randrange(255))]) + sig[b + 1:]
        votes = list(self.votes[at])
        votes[j] = (ts, bad)
        replies = dict(self.replies)
        replies[at] = self._replies(at, r, votes=votes)
        return replies, (at, j), bad

    def unknown_keys(self, at: int, r: random.Random) -> tuple:
        """(replies with height `at` replaced, the trusted validators'
        signing power, the trusted set's total): at `at` the validators of
        the set at at - 1 outside a subset are replaced by as many keys it
        does not know, each at the leaver's place in address order and
        with half its power. The subset holds the most power at or below
        2/3 of the total. The whole new set signs, every signature valid:
        the new set's rule holds (the staying validators keep their
        places, and hold 4/5 of the new power), so only the trusted set's
        refuses the header."""
        trusted = self.vals[at - 1]
        total = sum(p for _, p in trusted)
        stay = set(most_at_or_below([p for _, p in trusted], total * 2 // 3))
        addrs = [tmhash.address(pk) for pk, _ in trusted]
        seeds, powers = [], []
        tries = 0
        floor = b""
        for j, (pk, p) in enumerate(trusted):
            if j in stay:
                seeds.append(self.seeds[self.order[j]])
                powers.append(p)
                floor = addrs[j]
                continue
            ceil = addrs[j + 1] if j + 1 < len(addrs) else b"\xff" * 21
            while True:          # a key whose address falls in the place
                tries += 1
                if tries > 1 << 20:
                    raise RuntimeError("no unknown key found for a place")
                s = gkeys.seed_bytes(self.seed, "lite-unknown",
                                     at * 10 ** 9 + tries)
                a = tmhash.address(gkeys.pubkey(s))
                if floor < a < ceil:
                    break
            seeds.append(s)
            powers.append(max(1, p // 2))
            floor = a
        signer = gkeys.Signer(seeds)
        vals = list(zip(signer.pubkeys, powers))
        hobj = self._header(at, vals, self.block_id[at - 1], r)
        bid = (tmhash.header_hash(hobj), 1, r.randbytes(32))
        votes = []
        for j in range(len(vals)):
            ts = at * 10 ** 9 + 1 + r.randrange(10 ** 6)
            votes.append((ts, signer.sign(j, self._msg(at, j, ts, bid))))
        replies = dict(self.replies)
        replies[at] = self._replies(at, r, hobj=hobj, bid=bid, vals=vals,
                                    votes=votes)
        signing = sum(trusted[j][1] for j in stay)
        return replies, signing, total
