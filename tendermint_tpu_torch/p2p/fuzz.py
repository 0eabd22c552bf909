"""FuzzedLink — the chaos wrapper for connection links: the port's copy
of `tendermint_tpu/p2p/fuzz.py` (p2p/fuzz.go).

Wraps any link (write/read/close) and randomly drops writes, delays
reads/writes, or kills the connection — the reference's FuzzedConnection
with mode=drop (p=0.2 default) / mode=delay (:10-47). Used by tests to
assert reactors survive a lossy transport.

Two extensions over the reference, as in the JAX package:

- Vectored passthrough: burst-mode links (SecretConnection /
  PlainFramedConn `write_many` / `read_burst`) are fuzzed PER FRAME, so
  a connection on the burst frame plane cannot bypass fault injection.
  When the inner link lacks the vectored API the wrapper degrades to
  per-frame calls, so FuzzedLink always presents the full link surface
  (the event loop's `seal_frames` / `feed_wire` codec included).

- Deterministic decider: a `decider(op)` callable replaces the
  probability draws with externally scheduled decisions — the chaos
  plane drives drop/delay from one seed. Return None/"pass" to deliver,
  "drop" to drop, ("delay", s) to sleep s seconds first. `on_fault(kind)`
  observes every injected fault (the counting lives in
  tendermint_tpu_torch.chaos, not here).
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass


@dataclass
class FuzzConfig:
    """p2p/fuzz.go FuzzConnConfig defaults (:39-47)."""
    mode: str = "drop"              # "drop" | "delay"
    max_delay_s: float = 0.3
    prob_drop_rw: float = 0.2
    prob_drop_conn: float = 0.0
    prob_sleep: float = 0.0
    seed: int | None = None


class FuzzedLink:
    def __init__(self, link, config: FuzzConfig | None = None,
                 decider=None, on_fault=None):
        self.link = link
        self.config = config or FuzzConfig()
        self.decider = decider
        self.on_fault = on_fault
        self._rng = random.Random(self.config.seed)
        self._lock = threading.Lock()
        self._dead = False

    def _note(self, kind: str) -> None:
        if self.on_fault is not None:
            self.on_fault(kind)

    def _fuzz(self, op: str = "rw") -> bool:
        """True = drop this operation (fuzz.go:132)."""
        if self.decider is not None:
            with self._lock:
                if self._dead:
                    raise ConnectionError("fuzzed connection killed")
                action = self.decider(op)
            if action in (None, "pass"):
                return False
            if action == "drop":
                self._note("drop")
                return True
            if isinstance(action, tuple) and action[0] == "delay":
                self._note("delay")
                time.sleep(action[1])
                return False
            raise ValueError(f"unknown fuzz action {action!r}")
        cfg = self.config
        with self._lock:
            if self._dead:
                raise ConnectionError("fuzzed connection killed")
            if cfg.mode == "drop":
                if cfg.prob_drop_conn > 0 and \
                        self._rng.random() < cfg.prob_drop_conn:
                    self._dead = True
                    self._note("kill")
                    raise ConnectionError("fuzzed connection killed")
                if self._rng.random() < cfg.prob_drop_rw:
                    self._note("drop")
                    return True
            elif cfg.mode == "delay":
                if cfg.prob_sleep > 0 and self._rng.random() < cfg.prob_sleep:
                    self._note("delay")
                    time.sleep(self._rng.random() * cfg.max_delay_s)
        return False

    def write(self, data: bytes) -> int:
        if self._fuzz("write"):
            return len(data)  # silently dropped
        return self.link.write(data)

    def write_many(self, chunks) -> int:
        """Per-frame fuzz over a burst: survivors still go out as ONE
        vectored write when the inner link supports it (the wire stays
        burst-framed); callers observe full acceptance, dropped frames
        never reach the wire — the same contract as write()."""
        chunks = list(chunks)
        kept = [c for c in chunks if not self._fuzz("write")]
        if kept:
            inner = getattr(self.link, "write_many", None)
            if inner is not None:
                inner(kept)
            else:
                for c in kept:
                    self.link.write(c)
        return sum(len(c) for c in chunks)

    def read(self) -> bytes:
        while True:
            frame = self.link.read()
            if frame == b"":
                return b""
            if self._fuzz("read"):
                continue  # drop received frame
            return frame

    def read_burst(self):
        """Per-frame fuzz over a received burst; loops until at least
        one frame survives ([] only on clean EOF, the burst link
        contract)."""
        inner = getattr(self.link, "read_burst", None)
        while True:
            if inner is not None:
                frames = inner()
            else:
                f = self.link.read()
                frames = [f] if f != b"" else []
            if not frames:
                return []
            kept = [f for f in frames if not self._fuzz("read")]
            if kept:
                return kept

    def seal_frames(self, chunks) -> bytes:
        """Event-loop codec surface: per-frame fuzz applied BEFORE the
        inner seal, so a loop connection cannot bypass fault injection;
        survivors seal in one inner burst. Dropped frames never reach
        the wire."""
        kept = [c for c in chunks if not self._fuzz("write")]
        if not kept:
            return b""
        return self.link.seal_frames(kept)

    def feed_wire(self, data: bytes):
        """Event-loop codec surface: inner decode, then per-frame read
        fuzz over the decoded burst. [] only means nothing survived this
        readiness event (the loop never reads [] as EOF)."""
        frames = self.link.feed_wire(data)
        return [f for f in frames if not self._fuzz("read")]

    def close(self) -> None:
        self.link.close()
