"""Traffic kind `batch`: whole commits' signatures handed to the
verifier's `verify_async`, the plugin boundary every node path and
light-client proxy calls.

Each request is one height's precommit items (pubkey, sign bytes,
signature) of the configuration's validator set, the heights taken in
order from a pool made at set-up. `callers` threads run a closed loop,
each keeping `in_flight` requests dispatched: it dispatches its next
request before it resolves the oldest. One request in `forge_every`
carries one signature with one byte changed, at a lane drawn from the
seed. Set-up verifies the first height three times, so that the key
cache goes full -> fill -> hit and every bucket the requests use is
built; in the window every request takes the cache's hit route.

`sigs_per_s` counts the signatures of the requests whose verdicts came
back inside the window, over the window's seconds. The check holds every
verdict of every request the window dispatched against what its items
are (true, but false at the changed lane), and a sample of lanes drawn
from the seed, every changed lane among them, against the plain
reference verify.
"""

from __future__ import annotations

import random
import threading
import time

import numpy as np

from portbench.gen.valset import PRECOMMIT, ValsetPool
from portbench.reference import ed25519 as ref
from portbench.traffic_kinds import common

SPANS = [("ops.ed25519", "prep_items", "prep", False),
         ("ops.ed25519", "_predecomp_rows", "rows", False),
         ("ops.ed25519", "_upload", "upload", False),
         ("verifier", "verify_async", "dispatch", True)]


def _rng(seed: int, *parts) -> random.Random:
    return random.Random(repr((seed,) + parts))


def _forge(ctx, k: int):
    """(lane, byte, xor) of request k's changed signature, or None."""
    t = ctx.traffic
    if (k + t["forge_offset"]) % t["forge_every"]:
        return None
    r = _rng(ctx.seed, "forge", k)
    return (r.randrange(ctx.config["validators"]), r.randrange(64),
            1 + r.randrange(255))


def request_items(ctx, k: int) -> list:
    st = ctx.state
    items = st["items"][k % len(st["items"])]
    f = _forge(ctx, k)
    if f is None:
        return items
    lane, b, x = f
    pk, msg, sig = items[lane]
    items = list(items)
    items[lane] = (pk, msg, sig[:b] + bytes([sig[b] ^ x]) + sig[b + 1:])
    return items


def setup(ctx) -> None:
    cfg = ctx.config
    pool = ValsetPool(cfg, ctx.seed, cfg["heights"], (PRECOMMIT,), False)
    ctx.state["items"] = [
        [(pool.vals[i][0], m, s) for i, _, m, s in h["votes"][PRECOMMIT]]
        for h in pool.heights]
    ctx.mark("inputs")
    v = common.node_verifier(ctx)
    ctx.state["verifier"] = v
    ctx.mark("verifier")
    for _ in range(3):
        v.verify_async(ctx.state["items"][0])()
    ctx.mark("warm-up")


def window(ctx, seconds: float) -> None:
    v = ctx.state["verifier"]
    t = ctx.traffic
    lock = threading.Lock()
    nxt = [0]
    done = []      # (k, t_dispatch, t_done, verdicts or None)
    t0 = time.perf_counter()
    t_end = t0 + seconds

    def caller():
        pending = []
        while True:
            now = time.perf_counter()
            if now < t_end:
                with lock:
                    k = nxt[0]
                    nxt[0] += 1
                items = request_items(ctx, k)
                t1 = time.perf_counter()
                try:
                    pending.append((k, t1, v.verify_async(items)))
                except Exception:               # a failed request counts
                    done.append((k, t1, time.perf_counter(), None))
                if len(pending) < t["in_flight"]:
                    continue
            elif not pending:
                return
            k, t1, res = pending.pop(0)
            try:
                out = res()
            except Exception:
                out = None
            done.append((k, t1, time.perf_counter(), out))

    before = common.counters()
    threads = [threading.Thread(target=caller, name=f"portbench-caller{i}")
               for i in range(t["callers"])]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    after = common.counters()
    n = ctx.config["validators"]
    in_window = [d for d in done if d[2] <= t_end and d[3] is not None]
    ctx.state["done"] = done
    ctx.state["t_window"] = (t0, t_end)
    ctx.window_stats.update({
        "sigs_per_s": len(in_window) * n / seconds,
        "attempted": len(done),
        "failed": sum(1 for d in done if d[3] is None),
        "sigs_dispatched": len(done) * n,
        "latencies_s": [d[2] - d[1] for d in done if d[3] is not None],
        "new_keys": 0,
        **common.delta(before, after)})


def release(ctx) -> None:
    ctx.state.pop("verifier", None)


def check(ctx) -> list:
    done = ctx.state["done"]
    n = ctx.config["validators"]
    mismatched = unanswered = 0
    for k, _, _, out in done:
        if out is None or len(out) != n:
            unanswered += 1
            continue
        want = np.ones(n, np.bool_)
        f = _forge(ctx, k)
        if f is not None:
            want[f[0]] = False
        mismatched += int(np.count_nonzero(np.asarray(out) != want))
    # the sample: every changed lane (up to half the sample), the rest
    # drawn from the seed over the answered requests
    answered = [d for d in done if d[3] is not None and len(d[3]) == n]
    r = _rng(ctx.seed, "sample")
    size = ctx.traffic["sample_lanes"]
    picks = [(k, _forge(ctx, k)[0]) for k, *_ in answered
             if _forge(ctx, k) is not None][:size // 2]
    while answered and len(picks) < size:
        picks.append((r.choice(answered)[0], r.randrange(n)))
    by_k = {d[0]: d[3] for d in answered}
    disagree = 0
    for k, lane in picks:
        pk, msg, sig = request_items(ctx, k)[lane]
        if ref.verify(pk, msg, sig) != bool(by_k[k][lane]):
            disagree += 1
    ctx.state["sampled"] = len(picks)
    return [("verdicts_mismatched", mismatched, 0),
            ("requests_unanswered", unanswered, 0),
            ("sampled_lanes_off_reference", disagree, 0)]


def report(ctx) -> list:
    s = ctx.window_stats
    t0, t_end = ctx.state["t_window"]
    answered = [d[2] for d in ctx.state["done"] if d[3] is not None]
    return [f"batch: {s['attempted']} requests of "
            f"{ctx.config['validators']} signatures, {s['failed']} failed, "
            f"{ctx.state.get('sampled', 0)} lanes held against the plain "
            f"reference",
            f"batch: requests answered a sixth of the window "
            f"{common.sixths(answered, t0, t_end)}"]
