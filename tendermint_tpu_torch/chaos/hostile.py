"""Hostile-peer simulator — scripted adversaries for the socket plane:
the port's copy of `tendermint_tpu/chaos/hostile.py`.

Each script drives a REAL TCP connection against a node's p2p listener
the way an attacker would: complete (or deliberately stall) the secret
handshake, then misbehave. The defenses under test live in
p2p/switch.py: the total handshake deadline, invalid-frame trust
scoring, score-threshold ban enforcement with decaying unban, and
fd-headroom admission shedding.

Scripts (run_hostile(script, ...)):

  handshake_stall   connect, send a few bytes of the ephemeral-key
                    prelude, then nothing — a half-open slow loris.
                    Expects the victim to close within its handshake
                    deadline (reports time-to-close).
  slow_handshake    the prelude trickled one byte per interval, always
                    below any per-read timeout — only a TOTAL deadline
                    kills it.
  garbage_after_auth  full authenticated handshake (valid node key +
                    NodeInfo), then raw garbage on the socket. The
                    victim's codec raises on the first frame, the
                    switch scores it, and repeats from the same key
                    must eventually be BANNED (handshake completes,
                    then the conn is dropped before NodeInfo). The
                    script keeps reconnecting and reports the
                    admit/reject sequence — including re-admission
                    after the ban decays.
  oversize_frame    authenticated handshake, then a frame header
                    claiming a 16MB frame — the oversized-frame guard
                    must kill the conn, not allocate.
  flood             raw connection flood, no handshake: counts how many
                    conns the victim sheds immediately (admission
                    control) vs leaves hanging.

Every script returns a report dict; none of them raises on the
expected defensive disconnects (a hostile peer observing its own
failure is the success path)."""

from __future__ import annotations

import socket
import struct
import time
from typing import List, Optional

from tendermint_tpu_torch.p2p.key import NodeKey
from tendermint_tpu_torch.p2p.node_info import NodeInfo
from tendermint_tpu_torch.p2p.peer import (read_handshake_msg,
                                           write_handshake_msg)
from tendermint_tpu_torch.types import encoding
from tendermint_tpu_torch.types.keys import PrivKey

SCRIPTS = ("handshake_stall", "slow_handshake", "garbage_after_auth",
           "oversize_frame", "flood")


def _auth_handshake(host: str, port: int, network: str,
                    node_key: NodeKey, channels: List[int],
                    timeout_s: float = 8.0):
    """Complete the full peer handshake as a well-formed client:
    secret conn + NodeInfo exchange. Returns (sock, link, their_info);
    raises on rejection (the caller decides whether that was the
    defense working)."""
    from tendermint_tpu_torch.p2p.conn import SecretConnection
    sock = socket.create_connection((host, port), timeout=timeout_s)
    try:
        link = SecretConnection.make(sock, node_key)
        info = NodeInfo(pubkey=node_key.pubkey, moniker="hostile",
                        network=network, channels=list(channels))
        write_handshake_msg(link, encoding.cdumps(info.to_obj()))
        their_info = NodeInfo.from_obj(
            encoding.cloads(read_handshake_msg(link)))
        return sock, link, their_info
    except BaseException:
        try:
            sock.close()
        except OSError:
            pass
        raise


def _wait_closed(sock: socket.socket, budget_s: float) -> Optional[float]:
    """Seconds until the peer closes the conn, None if it never does
    within the budget."""
    t0 = time.monotonic()
    sock.settimeout(0.25)
    while time.monotonic() - t0 < budget_s:
        try:
            if sock.recv(4096) == b"":
                return time.monotonic() - t0
        except socket.timeout:
            continue
        except OSError:
            return time.monotonic() - t0
    return None


def hostile_handshake_stall(host: str, port: int,
                            budget_s: float = 15.0) -> dict:
    sock = socket.create_connection((host, port), timeout=5.0)
    try:
        sock.sendall(b"\x41" * 8)  # partial prelude, then silence
        closed_after = _wait_closed(sock, budget_s)
    finally:
        try:
            sock.close()
        except OSError:
            pass
    return {"script": "handshake_stall",
            "closed_by_victim_s": closed_after,
            "defense_fired": closed_after is not None}


def hostile_slow_handshake(host: str, port: int, byte_interval_s: float,
                           budget_s: float = 15.0) -> dict:
    """Trickle the 32-byte prelude one byte at a time: each read
    arrives well inside any per-read timeout, so only a TOTAL
    handshake deadline disconnects us."""
    sock = socket.create_connection((host, port), timeout=5.0)
    t0 = time.monotonic()
    sent = 0
    closed_after = None
    try:
        sock.settimeout(byte_interval_s)
        while time.monotonic() - t0 < budget_s:
            try:
                sock.sendall(b"\x42")
                sent += 1
            except OSError:
                closed_after = time.monotonic() - t0
                break
            try:
                if sock.recv(4096) == b"":
                    closed_after = time.monotonic() - t0
                    break
            except socket.timeout:
                continue
            except OSError:
                closed_after = time.monotonic() - t0
                break
    finally:
        try:
            sock.close()
        except OSError:
            pass
    return {"script": "slow_handshake", "bytes_sent": sent,
            "closed_by_victim_s": closed_after,
            "defense_fired": closed_after is not None}


def hostile_garbage_after_auth(host: str, port: int, network: str,
                               channels: List[int],
                               node_key: Optional[NodeKey] = None,
                               rounds: int = 6,
                               retry_gap_s: float = 0.4,
                               budget_s: float = 40.0) -> dict:
    """Reconnect from ONE identity, each time completing the full
    authenticated handshake and then writing raw garbage. Reports the
    per-round outcome: 'authed' (handshake completed — garbage then
    killed us), 'rejected' (the victim dropped us during the
    handshake: the ban is enforced). The ban lifecycle shows up as
    authed... -> rejected... -> authed (re-admitted after decay) when
    the caller's budget spans the ban window."""
    nk = node_key or NodeKey(PrivKey.generate())
    outcomes = []
    t0 = time.monotonic()
    for _ in range(rounds):
        if time.monotonic() - t0 > budget_s:
            break
        try:
            sock, link, _ = _auth_handshake(host, port, network, nk,
                                            channels)
        except Exception as e:
            outcomes.append({"outcome": "rejected", "err": repr(e),
                             "t": round(time.monotonic() - t0, 3)})
            time.sleep(retry_gap_s)
            continue
        try:
            # raw bytes that are NOT a sealed frame: the victim's
            # feed_wire sees an impossible frame and must disconnect
            sock.sendall(struct.pack(">I", 0x00FFFFFF) + b"\xff" * 512)
            closed = _wait_closed(sock, 5.0)
        finally:
            try:
                sock.close()
            except OSError:
                pass
        outcomes.append({"outcome": "authed",
                         "killed_s": closed,
                         "t": round(time.monotonic() - t0, 3)})
        time.sleep(retry_gap_s)
    kinds = [o["outcome"] for o in outcomes]
    return {"script": "garbage_after_auth", "peer_id": nk.id(),
            "rounds": outcomes,
            "saw_ban": "rejected" in kinds,
            "readmitted_after_ban":
                "rejected" in kinds and
                kinds.index("rejected") < len(kinds) - 1 and
                "authed" in kinds[kinds.index("rejected"):]}


def hostile_oversize_frame(host: str, port: int, network: str,
                           channels: List[int],
                           node_key: Optional[NodeKey] = None) -> dict:
    nk = node_key or NodeKey(PrivKey.generate())
    try:
        sock, link, _ = _auth_handshake(host, port, network, nk,
                                        channels)
    except Exception as e:
        return {"script": "oversize_frame", "outcome": "rejected",
                "err": repr(e)}
    try:
        sock.sendall(struct.pack(">I", 16 << 20))
        closed = _wait_closed(sock, 5.0)
    finally:
        try:
            sock.close()
        except OSError:
            pass
    return {"script": "oversize_frame", "outcome": "authed",
            "killed_s": closed, "defense_fired": closed is not None}


def hostile_flood(host: str, port: int, count: int = 64,
                  hold_s: float = 1.0) -> dict:
    """Open `count` raw conns as fast as the OS allows and hold them.
    Counts conns the victim closed within hold_s (shed by admission
    control / handshake deadline) vs still-hanging."""
    socks = []
    refused = 0
    for _ in range(count):
        try:
            socks.append(socket.create_connection((host, port),
                                                  timeout=2.0))
        except OSError:
            refused += 1
    time.sleep(hold_s)
    shed = 0
    for s in socks:
        s.setblocking(False)
        try:
            if s.recv(1) == b"":
                shed += 1
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            shed += 1
        try:
            s.close()
        except OSError:
            pass
    return {"script": "flood", "attempted": count, "refused": refused,
            "shed_within_hold": shed,
            "held_open": count - refused - shed}


def run_hostile(script: str, host: str, port: int, network: str = "",
                channels: Optional[List[int]] = None, **kw) -> dict:
    """Dispatch one hostile script by name (see SCRIPTS)."""
    channels = channels if channels is not None else [0x20]
    if script == "handshake_stall":
        return hostile_handshake_stall(host, port, **kw)
    if script == "slow_handshake":
        return hostile_slow_handshake(
            host, port, kw.pop("byte_interval_s", 0.5), **kw)
    if script == "garbage_after_auth":
        return hostile_garbage_after_auth(host, port, network, channels,
                                          **kw)
    if script == "oversize_frame":
        return hostile_oversize_frame(host, port, network, channels,
                                      **kw)
    if script == "flood":
        return hostile_flood(host, port, **kw)
    raise ValueError(f"unknown hostile script {script!r} "
                     f"(known: {SCRIPTS})")
