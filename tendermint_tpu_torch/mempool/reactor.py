"""MempoolReactor — tx gossip on channel 0x30: the port's copy of
`tendermint_tpu/mempool/reactor.py` (mempool/reactor.go).

One broadcast routine per peer walks the mempool CList at its own pace,
parking on next_wait when it reaches the tip (:104-157); received txs
funnel into Mempool.check_tx (:82-87). Peers lagging more than one height
behind a tx's admission height are skipped until they catch up. On the
thread plane the routine is a thread; on a ReactorLoop it is a task whose
`_broadcast_pass` makes the same walk and returns its next delay instead
of blocking in the clist's waits. With the causal plane on, a gossip
message carries the trace stamp of its batch head's admission height,
and `receive` takes it off before validation."""

from __future__ import annotations

import threading
import time
from typing import Dict

from tendermint_tpu_torch.mempool.mempool import (Mempool, MempoolFull,
                                                  TxAlreadyInCache)
from tendermint_tpu_torch.p2p.base_reactor import Reactor
from tendermint_tpu_torch.p2p.conn import ChannelDescriptor
from tendermint_tpu_torch.telemetry import causal
from tendermint_tpu_torch.types import encoding

MEMPOOL_CHANNEL = 0x30
PEER_CATCHUP_SLEEP_S = 0.1  # peerCatchupSleepIntervalMS (reactor.go:24)


class MempoolReactor(Reactor):
    _GOSSIP_BATCH = 64   # txs a batched "txs" gossip message at most

    def __init__(self, mempool: Mempool, broadcast: bool = True):
        super().__init__("mempool")
        self.mempool = mempool
        self.broadcast = broadcast
        self._stopped = False
        self._peer_threads: Dict[str, threading.Thread] = {}

    def get_channels(self):
        return [ChannelDescriptor(MEMPOOL_CHANNEL, priority=5,
                                  send_queue_capacity=1000)]

    def stop(self) -> None:
        self._stopped = True

    def add_peer(self, peer) -> None:
        if not self.broadcast:
            return
        loop = getattr(self.switch, "loop", None) \
            if self.switch is not None else None
        if loop is not None:
            st = {"el": None, "sent": set()}
            self._peer_threads[peer.id] = loop.spawn(
                lambda: self._broadcast_pass(peer, st),
                owner="mempool", name=f"mempool-bcast-{peer.id[:8]}")
            return
        t = threading.Thread(target=self._broadcast_tx_routine,
                             args=(peer,), daemon=True,
                             name=f"mempool-bcast-{peer.id[:8]}")
        t.start()
        self._peer_threads[peer.id] = t

    def remove_peer(self, peer, reason) -> None:
        # a broadcast thread exits on its own (peer.running is False); a
        # loop task is stopped, as nothing wakes a removed peer's
        entry = self._peer_threads.pop(peer.id, None)
        if entry is not None and not isinstance(entry, threading.Thread):
            entry.stop()

    def receive(self, ch_id: int, peer, msg_bytes: bytes) -> None:
        msg = encoding.cloads(msg_bytes)
        t = msg.get("type")
        causal.take(msg, t or "")  # trace stamp off before validation
        if t == "tx":
            txs = [msg["tx"]]
        elif t == "txs":
            # batched gossip (see _broadcast_tx_routine): a list of
            # hex txs in one message
            txs = msg.get("txs")
            if not isinstance(txs, list):
                if self.switch is not None:
                    self.switch.stop_peer_for_error(
                        peer, ValueError("bad mempool txs batch"))
                return
        else:
            if self.switch is not None:
                self.switch.stop_peer_for_error(
                    peer, ValueError("bad mempool message"))
            return
        raw = [bytes.fromhex(tx_hex) for tx_hex in txs]
        if len(raw) > 1 and hasattr(self.mempool, "check_tx_batch"):
            # one lock + one WAL append for the whole gossip batch;
            # dups/overflow come back as result codes (normal noise)
            self.mempool.check_tx_batch(raw)
            return
        for tx in raw:
            try:
                self.mempool.check_tx(tx)
            except (TxAlreadyInCache, MempoolFull):
                pass  # dup/overflow: normal gossip noise

    def _peer_height(self, peer) -> int:
        """Consensus PeerState height when available (reactor.go:120)."""
        ps = peer.get("consensus_peer_state")
        if ps is None:
            return -1
        return ps.height

    def _broadcast_tx_routine(self, peer) -> None:
        """mempool/reactor.go:104 broadcastTxRoutine: walk the clist,
        sending each tx to this peer at most once. The tip element is
        parked on (next_wait), NOT re-sent on timeout; after the list
        drains we restart from the front, with `sent` suppressing
        re-sends of still-pending txs.

        Consecutive ready txs coalesce into ONE batched "txs" message
        (up to _GOSSIP_BATCH): the reference sends one TxMessage per tx,
        which at 1,000-tx blocks made tx gossip the testnet's dominant
        system cost (per-message encode + frame + AEAD + decode on
        every hop)."""
        el = None
        sent: set = set()   # tx counters already sent to this peer
        _COALESCE_S = 0.02  # let a burst of insertions accumulate so
        #                     one message carries many txs; block
        #                     cadence is 100x this, so the added gossip
        #                     latency is invisible while the per-tx
        #                     message cost (frame+AEAD+decode per hop)
        #                     drops by the batch factor
        while not self._stopped and peer.running:
            if el is None:
                el = self.mempool.txs.front_wait(timeout=0.5)
                if el is None:
                    sent.clear()  # mempool drained: forget history
                    continue
                time.sleep(_COALESCE_S)
            batch, batch_counters, last, catchup = self._collect(
                peer, el, sent)
            if catchup and not batch:
                time.sleep(PEER_CATCHUP_SLEEP_S)
                continue
            if batch:
                msg = ({"type": "tx", "tx": batch[0]} if len(batch) == 1
                       else {"type": "txs", "txs": batch})
                # trace context: the admission height of the batch head
                # places tx gossip on the cluster timeline (and its
                # send/recv pair is one more clock-alignment sample)
                causal.stamp(msg, el.value.height)
                if not peer.send(MEMPOOL_CHANNEL, encoding.cdumps(msg)):
                    time.sleep(PEER_CATCHUP_SLEEP_S)
                    continue
                sent.update(batch_counters)
                if len(sent) > 200_000:
                    sent.clear()
            el = last
            nxt = el.next_wait(timeout=0.5)
            if nxt is not None:
                el = nxt
                if len(batch) < self._GOSSIP_BATCH:
                    # trickle: let the burst behind it accumulate.
                    # A FULL batch means a backlog is draining — no
                    # sleep, or the ceiling becomes BATCH/COALESCE
                    time.sleep(_COALESCE_S)
            elif el.removed:
                el = None  # tip removed: restart from the live front

    def _collect(self, peer, el, sent: set) -> tuple:
        """A run of ready txs from `el`, at most _GOSSIP_BATCH, none in
        `sent`: (hex txs, their counters, the last element walked, whether
        the walk stopped at a tx the peer is too far behind for). The
        peer's height is read once a batch (it moves a block, not a tx)."""
        batch: list = []
        counters: list = []
        last = cur = el
        peer_h = self._peer_height(peer)
        while cur is not None and len(batch) < self._GOSSIP_BATCH:
            mtx = cur.value
            if mtx.counter not in sent and not cur.removed:
                if peer_h >= 0 and peer_h < mtx.height - 1:
                    return batch, counters, last, True
                batch.append(mtx.tx.hex())
                counters.append(mtx.counter)
            last = cur
            cur = cur.next()
        return batch, counters, last, False

    def _broadcast_pass(self, peer, st: dict) -> object:
        """One cooperative pass of the broadcast walk (loop plane): the
        batch collection of _broadcast_tx_routine, returning the next
        delay instead of blocking in the clist's waits. `st` carries the
        cursor (`el`) and the counters already sent."""
        if self._stopped or not peer.running:
            return "stop"
        el = st["el"]
        sent = st["sent"]
        if el is None or el.removed:
            el = self.mempool.txs.front()
            if el is None:
                sent.clear()   # mempool drained: forget history
                st["el"] = None
                return 0.1
            st["el"] = el
        batch, batch_counters, last, catchup = self._collect(peer, el, sent)
        if catchup and not batch:
            return PEER_CATCHUP_SLEEP_S
        if batch:
            msg = ({"type": "tx", "tx": batch[0]} if len(batch) == 1
                   else {"type": "txs", "txs": batch})
            causal.stamp(msg, el.value.height)
            if not peer.send(MEMPOOL_CHANNEL, encoding.cdumps(msg)):
                # channel queue full (backpressure) or conn stopping:
                # retry after the catchup interval
                return PEER_CATCHUP_SLEEP_S
            sent.update(batch_counters)
            if len(sent) > 200_000:
                sent.clear()
        st["el"] = last
        nxt = last.next()
        if nxt is not None:
            st["el"] = nxt
            # trickle pacing as in the thread routine: a full batch
            # means a backlog is draining, so no pause
            return 0.0 if len(batch) >= self._GOSSIP_BATCH else 0.02
        if last.removed:
            st["el"] = None
        return 0.05   # parked at the tip: poll for the next insertion
