"""The port's event bus (tendermint_tpu_torch.types.events) and
`fire_events` against the JAX package's, on the CPU: query parsing and
matching, refusals, bounded subscriptions that drop the oldest event,
subscription bookkeeping and the typed publish helpers' tags."""

import queue

import pytest

from tendermint_tpu.types import events as jev
from tendermint_tpu_torch.types import events as tev

QUERIES = [
    "tm.event = 'NewBlock'",
    "tm.event = 'Tx' AND tx.hash = 'ABCD'",
    "tm.event='Tx'   AND   account.number > 3",
    "account.number >= 3 AND account.number <= 7",
    "account.number < 2.5",
    "name CONTAINS 'ob'",
    "name != \"bob\"",
    "note = 'x AND y'",
    "tx.height = 5",
    "tags = 'b'",
]
TAGS = [
    {"tm.event": "NewBlock"},
    {"tm.event": "Tx", "tx.hash": "ABCD", "account.number": 4},
    {"tm.event": "Tx", "tx.hash": "ABCE", "account.number": "2"},
    {"account.number": "seven", "name": "bob"},
    {"account.number": 7, "name": "rob", "note": "x AND y"},
    {"tx.height": 5, "tags": ["a", "b"]},
    {},
]


def test_query_matching_matches_jax():
    for q in QUERIES:
        jq, tq = jev.Query(q), tev.Query(q)
        assert tq.conds == jq.conds and tq.source == jq.source
        for tags in TAGS:
            assert tq.matches(tags) == jq.matches(tags), (q, tags)


@pytest.mark.parametrize("bad", ["tm.event", "a = 'x' OR b = 'y'",
                                 "= 3", "a ~ 3"])
def test_bad_query_refused_like_jax(bad):
    msgs = []
    for E in (jev, tev):
        with pytest.raises(ValueError) as e:
            E.Query(bad)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _bus_run(E):
    bus = E.EventBus()
    small = bus.subscribe("c1", "tm.event = 'Tx'", capacity=3)
    votes = bus.subscribe("c1", "tm.event = 'Vote'")
    allb = bus.subscribe("c2", "tm.event = 'NewBlock'", capacity=2)
    with pytest.raises(ValueError) as dup:
        bus.subscribe("c1", "tm.event = 'Tx'")
    for i in range(5):
        bus.publish_tx(7, i, b"k%d=v" % i, {"code": 0},
                       extra_tags={"app.key": "k%d" % i})
    bus.publish_vote({"v": 1})
    bus.publish_new_block({"b": 1}, {"id": 1})
    bus.publish_new_block_header({"h": 1})
    got = []
    while not small.empty():
        it = small.get_nowait()
        got.append((it.query, it.tags, it.data))
    with pytest.raises(queue.Empty):
        small.get(timeout=0.01)
    vote = votes.get(timeout=1)
    out = [got, (vote.query, vote.tags, vote.data), small.dropped,
           bus.dropped_total, str(dup.value), bus.n_subscriptions(),
           allb.qsize()]
    bus.unsubscribe("c1", "tm.event='Tx'")
    out += [small.cancelled, bus.n_subscriptions()]
    bus.unsubscribe_all("c1")
    out += [votes.cancelled, bus.n_subscriptions(), allb.cancelled]
    return out


def test_event_bus_matches_jax():
    assert _bus_run(tev) == _bus_run(jev)


def test_event_type_and_tag_names_match_jax():
    names = [n for n in dir(jev) if n.startswith(("Event", "Tag"))
             and isinstance(getattr(jev, n), str)]
    assert names and all(getattr(tev, n) == getattr(jev, n) for n in names)
