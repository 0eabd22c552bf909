"""Compact consensus gossip — compact block relay + aggregated votes: the
port's copy of `tendermint_tpu/consensus/compact.py`.

Two settings of ConsensusConfig, both on by default as the JAX package's
`auto` resolves; `compact_on` / `voteagg_on` give TM_CUDA_COMPACT /
TM_CUDA_VOTE_AGG over the config field (the JAX package's TM_TPU_COMPACT
and TM_TPU_VOTE_AGG over `base.compact` / `vote_agg`):

- `compact`: the data gossip pass sends a compact proposal — header +
  ordered salted short tx ids — instead of streaming parts; receivers
  rebuild the block from their mempool by hash (Mempool.get_by_hash),
  fetch only the missing txs, and re-split it onto the canonical PartSet,
  so block_id, WAL shape and chain parity are untouched. Reconstruction
  failure or timeout falls back to full part gossip automatically.
- `vote_agg`: the vote gossip pass batches every vote a peer provably
  lacks for one (height, round, type) into a single `vote_agg` message,
  which the receiving state machine feeds through one batched verify.

Both off = the legacy wire bytes byte for byte: no capability strings in
the handshake, no new message types sent. Senders gate the new shapes on
the peer's advertised capability (NodeInfo.other), so a compact node
never sends a message a legacy peer would drop.

Misbehaving peers (a fetch that never returns, a compact body that does
not match the proposal's part-set header) earn strikes with exponential
backoff: while a peer is in backoff its compact offers are refused (nack
— the sender falls back to parts) and our own compact sends to it are
skipped.

`CompactStats` counts, per reactor, what the JAX package exports as metrics (offers,
reconstructions by outcome, fetches, aggregates), and feeds those families.
"""

from __future__ import annotations

import hashlib
import threading
from collections import Counter
from typing import Dict, List

from tendermint_tpu_torch import telemetry
from tendermint_tpu_torch.utils import knobs

#: capability strings advertised in NodeInfo.other — version-suffixed
#: so an incompatible future wire shape can bump without ambiguity
CAP_COMPACT = "compact/1"
CAP_VOTEAGG = "voteagg/1"

#: bytes per salted short tx id on the wire
SHORT_ID_LEN = 8

#: upper bound on txs requested in one tx_fetch (and served in one
#: reply) — beyond this the receiver nacks and takes the parts path
MAX_FETCH = 256

#: upper bound on votes in one vote_agg message
MAX_AGG_VOTES = 256

#: seconds a compact sender keeps an offer outstanding before writing
#: it off as unanswered, and a receiver waits for the matching proposal
#: before nacking. The sender never stalls parts behind an offer, so
#: this bounds bookkeeping, not latency.
COMPACT_DEADLINE_S = 0.35

#: deadline extension while a tx_fetch round trip is in flight (both
#: sides)
FETCH_DEADLINE_S = 0.75

#: nack reasons that are nobody's fault (round moved on, receiver
#: backing off, reconstruction already in flight) — the sender ships
#: parts but must NOT strike
BENIGN_NACKS = frozenset(("stale", "backoff", "busy"))

BACKOFF_BASE_S = 1.0
BACKOFF_CAP_S = 30.0

_m_compact_sent = telemetry.counter(
    "compact_blocks_sent_total",
    "Compact proposals sent to capable peers")
_m_compact_recv = telemetry.counter(
    "compact_blocks_received_total",
    "Compact proposals received, by what happened next",
    ("outcome",))  # accepted | stale | backoff | dup
_m_reconstruct = telemetry.counter(
    "compact_reconstruct_total",
    "Block reconstruction attempts by outcome", ("outcome",))
# outcome: hit (all txs from mempool) | fetched (completed after a
# tx_fetch round trip) | fallback (nacked/timed out -> part gossip)
_m_fetch_req = telemetry.counter(
    "compact_fetch_requests_total",
    "tx_fetch messages sent for missing txs")
_m_fetch_miss_txs = telemetry.histogram(
    "compact_fetch_missing_txs",
    "Missing txs per reconstruction that needed a fetch",
    buckets=telemetry.POW2_BUCKETS)
_m_fetch_served = telemetry.counter(
    "compact_fetch_txs_served_total",
    "Txs served to peers from tx_fetch requests")
_m_strikes = telemetry.counter(
    "compact_peer_strikes_total",
    "Strikes issued against peers on the compact plane", ("reason",))
_m_agg_sent = telemetry.counter(
    "voteagg_msgs_sent_total", "Aggregated vote messages sent")
_m_agg_votes_sent = telemetry.counter(
    "voteagg_votes_sent_total", "Votes carried inside aggregates")
_m_agg_batch = telemetry.histogram(
    "voteagg_batch_votes",
    "Votes per aggregate applied through the bulk VoteSet path",
    buckets=telemetry.POW2_BUCKETS)


def compact_on(config) -> bool:
    """env TM_CUDA_COMPACT > ConsensusConfig.compact > auto (= on)."""
    return knobs.knob_str("TM_CUDA_COMPACT",
                          config="on" if config.compact else "off",
                          default="auto") not in knobs.FALSY


def voteagg_on(config) -> bool:
    """env TM_CUDA_VOTE_AGG > ConsensusConfig.vote_agg > auto (= on)."""
    return knobs.knob_str("TM_CUDA_VOTE_AGG",
                          config="on" if config.vote_agg else "off",
                          default="auto") not in knobs.FALSY


def wire_capabilities(compact: bool = True,
                      vote_agg: bool = True) -> List[str]:
    """Capability strings for NodeInfo.other. Empty with both off — the
    handshake bytes stay exactly the legacy shape."""
    caps = []
    if compact:
        caps.append(CAP_COMPACT)
    if vote_agg:
        caps.append(CAP_VOTEAGG)
    return caps


def peer_capabilities(peer) -> tuple:
    """(supports_compact, supports_voteagg) from a peer's handshaken
    NodeInfo.other; tolerant of test doubles without node_info."""
    other = getattr(getattr(peer, "node_info", None), "other", None) or ()
    return (CAP_COMPACT in other, CAP_VOTEAGG in other)


# ------------------------------------------------------------- short ids

def proposal_salt(signature: bytes) -> bytes:
    """Per-proposal short-id salt, derived from the proposal signature
    (unpredictable before the proposer signs, identical for every
    receiver of the same proposal)."""
    return hashlib.sha256(b"tm/compact/1" + signature).digest()[:8]


def short_id(salt: bytes, tx_hash: bytes) -> bytes:
    """Salted short id of a tx, computed from its FULL sha256 hash — the
    mempool index stores full hashes, so receivers never rehash tx
    bodies to match."""
    return hashlib.sha256(salt + tx_hash).digest()[:SHORT_ID_LEN]


def short_ids_for(salt: bytes, txs: List[bytes]) -> List[bytes]:
    sha = hashlib.sha256
    return [sha(salt + sha(tx).digest()).digest()[:SHORT_ID_LEN]
            for tx in txs]


# ------------------------------------------------------- strike ledger

class StrikeLedger:
    """Per-peer strike counter with exponential backoff. While a peer is
    in backoff we neither send it compact proposals nor accept compact
    proposals from it; parts flow as before. `reasons` counts strikes by
    reason."""

    def __init__(self, base_s: float = BACKOFF_BASE_S,
                 cap_s: float = BACKOFF_CAP_S):
        self.base_s = base_s
        self.cap_s = cap_s
        self._lock = threading.Lock()
        self._strikes: Dict[str, int] = {}
        self._until: Dict[str, float] = {}
        self.reasons: Counter = Counter()

    def strike(self, peer_id: str, now: float, reason: str) -> None:
        with self._lock:
            n = self._strikes.get(peer_id, 0) + 1
            self._strikes[peer_id] = n
            self._until[peer_id] = now + min(
                self.cap_s, self.base_s * (2 ** (n - 1)))
            self.reasons[reason] += 1
        if telemetry.enabled():
            _m_strikes.labels(reason).inc()

    def in_backoff(self, peer_id: str, now: float) -> bool:
        with self._lock:
            return now < self._until.get(peer_id, 0.0)

    def forget(self, peer_id: str) -> None:
        with self._lock:
            self._strikes.pop(peer_id, None)
            self._until.pop(peer_id, None)


# ----------------------------------------------------------------- stats

class CompactStats:
    """Counts of one reactor's compact plane: `sent` offers; `received`
    offers by outcome (accepted, stale, backoff, dup); `reconstruct` by
    outcome (hit: every tx from the mempool, fetched: after a tx_fetch,
    fallback: nacked or timed out to part gossip); `fetch_requests`,
    `fetch_missing_txs`, `fetch_served`; `agg_sent` vote_agg messages
    carrying `agg_votes_sent` votes."""

    def __init__(self):
        self._lock = threading.Lock()
        self.sent = 0
        self.received: Counter = Counter()
        self.reconstruct: Counter = Counter()
        self.fetch_requests = 0
        self.fetch_missing_txs = 0
        self.fetch_served = 0
        self.agg_sent = 0
        self.agg_votes_sent = 0

    def compact_sent(self) -> None:
        if telemetry.enabled():
            _m_compact_sent.inc()
        with self._lock:
            self.sent += 1

    def compact_received(self, outcome: str) -> None:
        if telemetry.enabled():
            _m_compact_recv.labels(outcome).inc()
        with self._lock:
            self.received[outcome] += 1

    def reconstructed(self, outcome: str) -> None:
        if telemetry.enabled():
            _m_reconstruct.labels(outcome).inc()
        with self._lock:
            self.reconstruct[outcome] += 1

    def fetch_request(self, missing: int) -> None:
        if telemetry.enabled():
            _m_fetch_req.inc()
            _m_fetch_miss_txs.observe(missing)
        with self._lock:
            self.fetch_requests += 1
            self.fetch_missing_txs += missing

    def fetch_served_txs(self, n: int) -> None:
        if telemetry.enabled() and n:
            _m_fetch_served.inc(n)
        with self._lock:
            self.fetch_served += n

    def agg(self, n_votes: int) -> None:
        if telemetry.enabled():
            _m_agg_sent.inc()
            _m_agg_votes_sent.inc(n_votes)
        with self._lock:
            self.agg_sent += 1
            self.agg_votes_sent += n_votes

    def snapshot(self) -> dict:
        with self._lock:
            return {"sent": self.sent, "received": dict(self.received),
                    "reconstruct": dict(self.reconstruct),
                    "fetch_requests": self.fetch_requests,
                    "fetch_missing_txs": self.fetch_missing_txs,
                    "fetch_served": self.fetch_served,
                    "agg_sent": self.agg_sent,
                    "agg_votes_sent": self.agg_votes_sent}


def note_agg_applied(n_votes: int) -> None:
    if telemetry.enabled():
        _m_agg_batch.observe(n_votes)
