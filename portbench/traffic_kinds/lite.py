"""Traffic kind `lite`: fresh light clients sync a chain's headers, one
after another, through the program's batched entry,
`InquiringCertifier.certify_range`.

Set-up makes the chain of `headers` heights from the seed (`portbench/gen/
lite.py`), each height's `commit` and `validators` replies as JSON bytes,
and warms up: one client syncs a full window of headers and then one of
the length of a sync's last window (`default_window` at the set's size),
so that the key cache holds every validator's key and the verifier has met
both window shapes.
In the window, a client is what `cli lite` builds: an
`InquiringCertifier` trusted at height 1 over a
`CacheProvider(MemProvider(), HTTPProvider(rpc))`, on the verifier a node
builds. `rpc` stands in for a node: it answers each `commit` and
`validators` call at once (message delay 0) with the height's reply
parsed from its JSON bytes. The client certifies heights 2 .. `headers`
in one `certify_range` call. At the top the next fresh client starts;
the key cache stays warm across them, as in a long-lived `cli lite`
proxy.

`blocks_per_s` counts the headers the clients certified inside the
window, over the window's seconds. The window holds whole syncs (as the
fastsync kind's does): no client starts after `seconds`, and the window
closes when the last one started has reached the top.

After the window, every sync's last trusted height, trusted set hash,
set changes crossed (`lite.certifier.sync_stats()`), headers certified
and stored commits are held against the plain reference
(`portbench/reference/lite.py`) on the same replies. Then, for each
entry (kind, lo, hi) of `forge_at`, a fresh client syncs a side chain
with one height of lo..hi (drawn from the seed) replaced. A `signature`
chain has one signature of a vote for the block changed in one byte. In
an `unknown_keys` chain, keys the trusted set does not know take the
power of some of its validators, so that the trusted validators who sign
hold exactly 2/3 of its power where the integers allow, else the most
below. The ranges cover a sync's first window, its middle windows and
its short last one, so that a client that stops verifying, reads stale
verdicts or misplaces its lanes after some window halts at none of the
later forgeries. Each client must stop at the forgery with trust at the
height below, and raise the reference's class and message; the
reference for a side chain starts from the clean chain's trust at the
height below the forgery (the replies below it are the clean chain's,
which the clean reference has certified). Last, `sample_sigs`
signatures, the changed ones among them, go through the plain verify
against the generator's record of which signatures it changed.
"""

from __future__ import annotations

import json
import random
import time

from portbench.gen.lite import LiteChain
from portbench.reference import ed25519 as ref_ed25519
from portbench.reference import lite as ref_lite
from portbench.traffic_kinds import common

SPANS = [("verifier", "verify_async", "dispatch", True),
         ("ops.ed25519", "prep_items", "prep", False),
         ("ops.ed25519", "_predecomp_rows", "rows", False),
         ("ops.ed25519", "_upload", "upload", False),
         ("lite.provider.HTTPProvider", "get_by_height", "fetch", False)]


class StandInRPC:
    """A node's RPC for a light client: each height's replies parsed from
    their JSON bytes, at once; a height it lacks raises, which the
    provider reads as no commit."""

    def __init__(self, replies: dict):
        self.replies = replies

    def call(self, method: str, height: int) -> dict:
        pair = self.replies[height]
        return json.loads(pair[0] if method == "commit" else pair[1])


def _sync(ctx, replies: dict, top: int) -> dict:
    """A fresh client certifies 2 .. top; what it leaves behind."""
    from tendermint_tpu_torch.lite import (CacheProvider, HTTPProvider,
                                           InquiringCertifier, MemProvider,
                                           sync_stats)
    chain = ctx.state["chain"]
    source = HTTPProvider(StandInRPC(replies))
    mem = MemProvider()
    ic = InquiringCertifier(chain.chain_id, source.get_by_height(1),
                            CacheProvider(mem, source),
                            verifier=ctx.state["verifier"])
    before = sync_stats()
    error = None
    try:
        ic.certify_range(2, top)
    except Exception as e:               # a sync that raises: the check
        error = (type(e).__name__, str(e))
    after = sync_stats()
    return {"height": ic.last_height, "valset_hash": ic.cert.validators.hash(),
            "transitions": after["transitions"] - before["transitions"],
            "certified": after["headers"] - before["headers"],
            "stored": sorted(mem._by_height), "error": error}


def setup(ctx) -> None:
    from tendermint_tpu_torch.lite import InquiringCertifier
    if not hasattr(InquiringCertifier, "certify_range"):
        raise RuntimeError("the program has no "
                           "InquiringCertifier.certify_range")
    from tendermint_tpu_torch.lite.certifier import default_window
    chain = ctx.state["chain"] = LiteChain(ctx.config, ctx.seed,
                                           ctx.traffic["headers"])
    ctx.mark("inputs")
    ctx.state["verifier"] = common.node_verifier(ctx)
    ctx.mark("verifier")
    # a full window, then one as long as a sync's last
    w = default_window(ctx.config["validators"])
    last = (chain.headers - 1) % w or w
    _sync(ctx, chain.replies, min(chain.headers, 1 + w + last))
    ctx.mark("warm-up")


def window(ctx, seconds: float) -> None:
    """Fresh clients sync the chain one after another; the window closes
    when the first sync to end at or after `seconds` has ended."""
    from tendermint_tpu_torch.lite import sync_stats
    chain = ctx.state["chain"]
    syncs = []
    before, stats0 = common.counters(), sync_stats()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        syncs.append(_sync(ctx, chain.replies, chain.headers))
        if syncs[-1]["error"] is not None:
            break                        # the check says why
    t_end = time.perf_counter()
    after, stats1 = common.counters(), sync_stats()
    certified = sum(s["certified"] for s in syncs)
    attempted = len(syncs) * (chain.headers - 1)
    ctx.state["syncs"] = syncs
    ctx.state["window_s"] = t_end - t0
    ctx.window_stats.update({
        "blocks_per_s": certified / (t_end - t0),
        "attempted": attempted, "failed": attempted - certified,
        "sigs_dispatched": stats1["sigs_dispatched"]
        - stats0["sigs_dispatched"],
        "sigs_sequential": stats1["sigs_sequential"]
        - stats0["sigs_sequential"],
        "windows": stats1["windows"] - stats0["windows"],
        "new_keys": 0, **common.delta(before, after)})


def release(ctx) -> None:
    ctx.state.pop("verifier", None)


def _off(got: dict, want: dict) -> int:
    """Fields of a sync off the reference's."""
    return sum(got[k] != want[k] for k in ("height", "valset_hash",
                                           "transitions", "certified",
                                           "stored", "error"))


def check(ctx) -> list:
    chain = ctx.state["chain"]
    cid, top = chain.chain_id, chain.headers
    r = random.Random(repr((ctx.seed, "check")))
    want = ref_lite.sync(cid, chain.replies.get, 1, 2, top)
    syncs_off = sum(_off(s, want) for s in ctx.state["syncs"])
    syncs_off += not ctx.state["syncs"]
    syncs_off += want["height"] != top or want["error"] is not None
    # forged side chains, each on a fresh client; the control's verifier
    # is installed again
    ctx.state["verifier"] = common.node_verifier(ctx)
    forged, changed, two_thirds = [], [], []
    halts_off = 0
    for kind, lo, hi in ctx.traffic["forge_at"]:
        at = r.randrange(lo, hi + 1)
        if kind == "signature":
            replies, (fh, fj), bad = chain.forged_signature(at, r)
            changed.append((fh, fj, bad))
            record = {(fh, fj)}
        else:
            replies, signing, total = chain.unknown_keys(at, r)
            two_thirds.append((signing, total))
            # the exact 2/3 where the integers allow it, else the most
            # below
            halts_off += not signing * 3 <= total * 2
            record = set()
        got = _sync(ctx, replies, top)
        exp = ref_lite.sync(cid, replies.get, at - 1, at, top, record)
        halts_off += (exp["at"] != at) + (exp["height"] != at - 1) \
            + sum(got[k] != exp[k] for k in ("height", "valset_hash",
                                             "error"))
        forged.append((kind, at, got["height"], got["error"]))
    # signatures against the plain verify: the changed ones, then a
    # seeded sample of the chain's
    picks = [(h, j, bad, False) for h, j, bad in changed]
    while len(picks) < ctx.traffic["sample_sigs"]:
        h = r.randrange(1, top + 1)
        j = r.choice([j for j, v in enumerate(chain.votes[h]) if v])
        picks.append((h, j, chain.votes[h][j][1], True))
    sample_off = sum(
        ref_ed25519.verify(chain.vals[h][j][0], chain.sign_bytes(h, j), sig)
        != valid for h, j, sig, valid in picks)
    ctx.state["forged"] = forged
    ctx.state["two_thirds"] = two_thirds
    return [("syncs_off_reference", syncs_off, 0),
            ("forged_halts_off", halts_off, 0),
            ("sampled_signatures_off_reference", sample_off, 0)]


def report(ctx) -> list:
    syncs = ctx.state["syncs"]
    s = ctx.window_stats
    return [f"lite: a window of {ctx.state['window_s']:.3f} s, "
            f"{len(syncs)} syncs, heights {[x['height'] for x in syncs]}, "
            f"{s['failed']} headers not certified; {s['windows']} "
            f"dispatches of {s['sigs_dispatched']} signatures (the "
            f"sequential route's {s['sigs_sequential']})",
            f"lite: forged side chains (kind, height, halted at, raised): "
            f"{ctx.state.get('forged')}; the trusted validators who sign "
            f"each unknown keys' header hold (of the total) "
            f"{ctx.state.get('two_thirds')}"]
