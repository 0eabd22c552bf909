"""Traffic kind `votes`: aggregated vote gossip through a node's
HeightVoteSet, one height after another.

Each height of the pool (`portbench/gen/valset.py`) brings every
validator's prevote, then every validator's precommit, for the height's
block, and odd votes: `flips_per_height` prevotes whose signatures have
one byte changed, each gossiped before the validator's own prevote, and
a validly signed precommit for another block (an equivocation). Each
type's votes, in an order drawn from the seed, are cut into messages of
`msg_votes` votes, as the vote_agg gossip path delivers them
(consensus/compact.py), and one caller (a node's consensus loop) feeds
them through `HeightVoteSet.add_votes(round, type, votes)` on a fresh
HeightVoteSet each height. The heights are cycled.

Set-up verifies the first height's prevotes three times on the verifier
(full -> fill -> hit: a running validator has its set's keys cached),
runs one message of each size the traffic has, and feeds a few messages
through a HeightVoteSet.

`sigs_per_s` counts the votes (one signature each) of the messages whose
add_votes call returned inside the window, over the window's seconds.
The check replays the same messages through the plain vote set of
`portbench/reference/voteset.py`, with each signature's validity as the
traffic made it (only the changed one is invalid) and a sample of
signatures, the changed ones among them, held against the plain
reference verify, and compares every message's results and errors and
every vote set's counted power, majority and power by block.
"""

from __future__ import annotations

import random
import time

from portbench.gen.valset import PRECOMMIT, PREVOTE, ValsetPool
from portbench.reference import ed25519 as ref
from portbench.reference.voteset import VoteSet as RefVoteSet
from portbench.traffic_kinds import common

SPANS = [("verifier", "verify_async", "dispatch", True),
         ("ops.ed25519", "prep_items", "prep", False),
         ("ops.ed25519", "_predecomp_rows", "rows", False),
         ("ops.ed25519", "_upload", "upload", False),
         ("consensus.rstate.HeightVoteSet", "add_votes", "add_votes",
          False)]




def _key(bid) -> str:
    return f"{bid[0].hex()}/{bid[1]}/{bid[2].hex()}"


def setup(ctx) -> None:
    from tendermint_tpu_torch.types.block import BlockID, PartSetHeader
    from tendermint_tpu_torch.types.validator_set import (Validator,
                                                          ValidatorSet)
    from tendermint_tpu_torch.types.vote import Vote
    cfg, t = ctx.config, ctx.traffic
    pool = ValsetPool(cfg, ctx.seed, cfg["heights"], (PREVOTE, PRECOMMIT),
                      True, t["flips_per_height"])
    vs = ValidatorSet([Validator(pk, p) for pk, p, _ in pool.vals])
    if [v.pubkey for v in vs.validators] != [pk for pk, _, _ in pool.vals]:
        raise RuntimeError("the validator set's order is not by address")
    addrs = [a for _, _, a in pool.vals]
    size = t["msg_votes"]
    heights = []
    for k, hh in enumerate(pool.heights):
        h = hh["height"]
        bids = {}

        def bid_of(b):
            if b not in bids:
                bids[b] = BlockID(b[0], PartSetHeader(b[1], b[2]))
            return bids[b]

        msgs = []
        for typ in (PREVOTE, PRECOMMIT):
            recs = [(i, ts, m, s, hh["block_id"], True)
                    for i, ts, m, s in hh["votes"][typ]]
            for e in hh["extra"]:
                if e["type"] == typ:
                    i, ts, m, s = e["vote"]
                    recs.append((i, ts, m, s, e["block_id"],
                                 e["kind"] != "flip"))
            random.Random(repr((ctx.seed, "gossip", h, typ))).shuffle(recs)
            # a changed signature reaches the node before the validator's
            # own vote, so that it is verified (after it, the vote set
            # skips it as a duplicate without a verdict)
            first = {}
            for pos, rec in enumerate(recs):
                first.setdefault(rec[0], pos)
            for pos, rec in enumerate(recs):
                if not rec[5] and first[rec[0]] < pos:
                    j = first[rec[0]]
                    recs[j], recs[pos] = recs[pos], recs[j]
            for lo in range(0, len(recs), size):
                part = recs[lo:lo + size]
                votes = [Vote(addrs[i], i, h, 0, ts, typ, bid_of(b), s)
                         for i, ts, _, s, b, _ in part]
                plain = [(i, addrs[i], h, 0, typ, _key(b), ok, m, s)
                         for i, ts, m, s, b, ok in part]
                msgs.append((typ, votes, plain))
        heights.append((h, msgs))
    ctx.state.update(pool=pool, valset=vs, addrs=addrs, heights=heights,
                     powers=[p for _, p, _ in pool.vals])
    ctx.mark("inputs")
    v = common.node_verifier(ctx)
    ctx.state["verifier"] = v
    ctx.mark("verifier")
    from tendermint_tpu_torch.consensus.rstate import HeightVoteSet
    items = [(pool.vals[i][0], m, s)
             for i, _, m, s in pool.heights[0]["votes"][PREVOTE]]
    for _ in range(3):
        v.verify_async(items)()
    for n in sorted({len(m[1]) for _, msgs in heights for m in msgs}):
        v.verify_async(items[:n])()
    h, msgs = heights[-1]
    warm = HeightVoteSet(pool.chain_id, h, vs, verifier=v)
    for typ, votes, _ in msgs[:2]:
        warm.add_votes(0, typ, votes)
    ctx.mark("warm-up")


def window(ctx, seconds: float) -> None:
    from tendermint_tpu_torch.consensus.rstate import HeightVoteSet
    st = ctx.state
    v, vs, chain_id = st["verifier"], st["valset"], st["pool"].chain_id
    log = []         # (height slot, message no., t0, t1, results, errors)
    sets = []        # (height slot, messages fed, {type: summary})
    before = common.counters()
    t0 = time.perf_counter()
    t_end = t0 + seconds
    failed = 0
    k = 0
    while time.perf_counter() < t_end:
        slot = k % len(st["heights"])
        h, msgs = st["heights"][slot]
        hvs = HeightVoteSet(chain_id, h, vs, verifier=v)
        fed = 0
        for j, (typ, votes, _) in enumerate(msgs):
            a = time.perf_counter()
            if a >= t_end:
                break
            try:
                results, errors = hvs.add_votes(0, typ, votes)
                errs = [(p, type(e).__name__, bool(getattr(e, "added",
                                                           False)))
                        for p, e in errors]
            except Exception as e:        # a message that raises fails
                results, errs = None, repr(e)
                failed += 1
            log.append((slot, j, a, time.perf_counter(), results, errs))
            fed += 1
        summ = {}
        for typ in (PREVOTE, PRECOMMIT):
            s = hvs.prevotes(0) if typ == PREVOTE else hvs.precommits(0)
            summ[typ] = (s.power, s.maj23.key() if s.maj23 else None,
                         {key: bv.power
                          for key, bv in s.votes_by_block.items()})
        sets.append((slot, fed, summ))
        k += 1
    after = common.counters()
    votes_in = sum(len(st["heights"][s][1][j][1]) for s, j, _, t1, r, _
                   in log if t1 <= t_end and r is not None)
    dispatched = sum(len(st["heights"][s][1][j][1]) for s, j, *_ in log)
    st.update(log=log, sets=sets, t_window=(t0, t_end))
    ctx.window_stats.update({
        "sigs_per_s": votes_in / seconds,
        "attempted": len(log), "failed": failed,
        "sigs_dispatched": dispatched, "new_keys": 0,
        "msg_latencies_s": [t1 - a for _, _, a, t1, _, _ in log],
        "add_votes_s": sum(t1 - a for _, _, a, t1, _, _ in log),
        **common.delta(before, after)})


def release(ctx) -> None:
    for key in ("verifier", "valset"):
        ctx.state.pop(key, None)


def check(ctx) -> list:
    st = ctx.state
    powers, addrs = st["powers"], st["addrs"]
    by_slot: dict = {}
    for entry in st["log"]:
        by_slot.setdefault(entry[0], []).append(entry)
    msgs_off = sets_off = 0
    # replay every fed height through the reference, message by message
    cursor = {}
    for slot, fed, summ in st["sets"]:
        h, msgs = st["heights"][slot]
        start = cursor.get(slot, 0)
        entries = by_slot.get(slot, [])[start:start + fed]
        cursor[slot] = start + fed
        ref_sets = {t: RefVoteSet(h, 0, t, powers, addrs)
                    for t in (PREVOTE, PRECOMMIT)}
        for (_, j, _, _, results, errs) in entries:
            typ, _, plain = msgs[j]
            want = ref_sets[typ].add_message(
                [(i, a, hh, r, t, key, ok)
                 for i, a, hh, r, t, key, ok, _, _ in plain])
            if results is None or (list(results), errs) != \
                    (want[0], want[1]):
                msgs_off += 1
        for typ in (PREVOTE, PRECOMMIT):
            if summ[typ] != ref_sets[typ].summary():
                sets_off += 1
    # the signatures' validity as made: every changed one and a sample
    r = random.Random(repr((ctx.seed, "sample")))
    fed_msgs = [(slot, j) for slot, j, *_ in st["log"]]
    picks = []
    for slot, j in fed_msgs:
        for rec in st["heights"][slot][1][j][2]:
            if not rec[6] and len(picks) < ctx.traffic["sample_votes"]:
                picks.append(rec)
    for _ in range(ctx.traffic["sample_votes"]):
        if not fed_msgs:
            break
        slot, j = r.choice(fed_msgs)
        picks.append(r.choice(st["heights"][slot][1][j][2]))
    pool = st["pool"]
    sample_off = sum(
        1 for i, _, _, _, _, _, ok, m, s in picks
        if ref.verify(pool.vals[i][0], m, s) != ok)
    st["sampled"] = len(picks)
    return [("messages_off_reference", msgs_off, 0),
            ("vote_sets_off_reference", sets_off, 0),
            ("sampled_signatures_off_reference", sample_off, 0)]


def report(ctx) -> list:
    st = ctx.state
    s = ctx.window_stats
    t0, t_end = st["t_window"]
    answered = [t1 for _, _, _, t1, r, _ in st["log"] if r is not None]
    return [f"votes: {s['attempted']} messages over {len(st['sets'])} "
            f"heights, {s['failed']} failed, {st.get('sampled', 0)} "
            f"signatures held against the plain reference",
            f"votes: messages answered a sixth of the window "
            f"{common.sixths(answered, t0, t_end)}"]
