"""The valset10k inputs: a validator set and a pool of heights of signed
votes, made from the run's seed.

Validator i (in the order made) has power `power_base + i % power_mod`;
the set is ordered by address, as the program orders it, and a vote's
`index` is the validator's place in that order. Each height has one
block id and each validator its own timestamp. Every vote is signed by
OpenSSL. Plain records only: the traffic kinds turn them into the
program's objects.
"""

from __future__ import annotations

import hashlib
import random

from portbench.frozen import tmhash
from portbench.gen import keys as gkeys

PREVOTE, PRECOMMIT = 1, 2
TS_BASE = 1_700_000_000_000_000_000


def _h(seed: int, *parts) -> bytes:
    return hashlib.sha256(repr((seed,) + parts).encode()).digest()


class ValsetPool:
    """`vals`: [(pubkey, power, address)] in address order; `heights[k]` for k < n_heights:
    {"height", "block_id", "votes": {type: [(index, timestamp, sign
    bytes, signature)] in index order}, and with `extras` the odd votes
    under "extra": `flips` prevotes of distinct validators, each a copy of
    the validator's prevote with one signature byte changed, and one
    validly signed precommit for another block (an equivocation)}."""

    def __init__(self, cfg: dict, seed: int, n_heights: int, types: tuple,
                 extras: bool, flips: int = 1):
        n = cfg["validators"]
        self.chain_id = cfg["chain_id"]
        seeds = [gkeys.seed_bytes(seed, cfg["name"], i) for i in range(n)]
        power = [cfg["power_base"] + i % cfg["power_mod"] for i in range(n)]
        # block ids and timestamps first: the sign bytes need them
        heights = []
        for k in range(n_heights):
            h = cfg["first_height"] + k
            bid = (_h(seed, "block", h), 1, _h(seed, "parts", h))
            other = (_h(seed, "other", h), 1, _h(seed, "parts", h))
            heights.append({"height": h, "block_id": bid, "other": other})
        # pubkeys are needed for the order; they come with the first
        # signing pass, which signs by generation order
        msgs = [[] for _ in range(n)]
        stamp = {}
        for k, hh in enumerate(heights):
            for t in types:
                for i in range(n):
                    ts = TS_BASE + hh["height"] * 10 ** 9 + int.from_bytes(
                        _h(seed, "ts", hh["height"], t, i)[:4], "little") \
                        % 10 ** 6
                    stamp[(k, t, i)] = ts
                    msgs[i].append(tmhash.vote_sign_bytes(
                        self.chain_id, hh["block_id"], hh["height"], 0, ts,
                        t))
        rng = random.Random(int.from_bytes(_h(seed, "extras"), "little"))
        extra_jobs = []   # (k, kind, generation index, type, sign bytes, ts)
        if extras:
            for k, hh in enumerate(heights):
                i_eq = rng.randrange(n)
                ts = TS_BASE + hh["height"] * 10 ** 9 + 10 ** 6 + 1
                extra_jobs.append((k, "equivocate", i_eq, PRECOMMIT,
                                   tmhash.vote_sign_bytes(
                                       self.chain_id, hh["other"],
                                       hh["height"], 0, ts, PRECOMMIT), ts))
                for i in rng.sample(range(n), flips):
                    extra_jobs.append((k, "flip", i, PREVOTE, None, None))
        for k, kind, i, t, sb, ts in extra_jobs:
            if sb is not None:
                msgs[i].append(sb)
        pubs, sigs = gkeys.sign_matrix(seeds, msgs)
        order = sorted(range(n), key=lambda i: tmhash.address(pubs[i]))
        place = {i: j for j, i in enumerate(order)}
        self.vals = [(pubs[i], power[i], tmhash.address(pubs[i]))
                     for i in order]
        pos = [0] * n
        for k, hh in enumerate(heights):
            hh["votes"] = {}
            for t in types:
                rows = [None] * n
                for i in range(n):
                    m, s = msgs[i][pos[i]], sigs[i][pos[i]]
                    pos[i] += 1
                    rows[place[i]] = (place[i], stamp[(k, t, i)], m, s)
                hh["votes"][t] = rows
            hh["extra"] = []
        for k, kind, i, t, sb, ts in extra_jobs:
            hh = heights[k]
            if kind == "equivocate":
                m, s = msgs[i][pos[i]], sigs[i][pos[i]]
                pos[i] += 1
                hh["extra"].append({"kind": kind, "type": t, "block_id":
                                    hh["other"],
                                    "vote": (place[i], ts, m, s)})
            else:
                j = place[i]
                idx, ts0, m, s = hh["votes"][t][j]
                b = rng.randrange(64)
                bad = s[:b] + bytes([s[b] ^ (1 + rng.randrange(255))]) \
                    + s[b + 1:]
                hh["extra"].append({"kind": kind, "type": t, "block_id":
                                    hh["block_id"],
                                    "vote": (idx, ts0, m, bad)})
        self.heights = heights
