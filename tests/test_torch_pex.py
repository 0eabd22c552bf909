"""The port's peer exchange (p2p/pex: AddrBook, KnownAddress, PEXReactor)
against the JAX package's, on the CPU, tolerance 0.

- AddrBook: the same seeded adds from several sources, attempts, good
  marks (promotions to old buckets), bad marks and removals, with `random` seeded and the wall clock pinned
  before each package runs, leave byte-equal book files; each package
  loads the other's file to the same picks and selections; strict books
  refuse the same non-routable addresses.
- PEXReactor messages: a request answered from the same book, a
  response taken into the book, and the refusals (an unsolicited
  response, a request flood, an unknown type) are the JAX package's
  bytes and outcomes.
- A JAX and a port PEX reactor on encrypted switches exchange addresses
  both ways: the dialer solicits its outbound peer, which answers from
  its book.
"""

import json
import random
import time
from types import SimpleNamespace

import pytest

from tendermint_tpu.p2p import netaddress as jnet
from tendermint_tpu.p2p.pex import addrbook as jbook
from tendermint_tpu.p2p.pex import pex_reactor as jpex
from tendermint_tpu.p2p.test_util import make_switch as jmake_switch
from tendermint_tpu.types import encoding as jenc
from tendermint_tpu_torch.p2p import netaddress as tnet
from tendermint_tpu_torch.p2p.key import pubkey_to_id
from tendermint_tpu_torch.p2p.pex import addrbook as tbook
from tendermint_tpu_torch.p2p.pex import pex_reactor as tpex
from tendermint_tpu_torch.p2p.test_util import make_switch
from tendermint_tpu_torch.types import encoding as tenc

PKGS = {"port": SimpleNamespace(book=tbook, pex=tpex, net=tnet, enc=tenc),
        "jax": SimpleNamespace(book=jbook, pex=jpex, net=jnet, enc=jenc)}
KEY = bytes(range(24))


@pytest.fixture
def pinned_time(monkeypatch):
    """time.time() of both modules on one counter, reset per package."""
    t = [1_700_000_000.0]

    def now():
        t[0] += 0.25
        return t[0]

    def reset():
        t[0] = 1_700_000_000.0
    monkeypatch.setattr(time, "time", now)
    return reset


def _addr(P, rng, routable=True):
    ip = (f"{rng.randrange(1, 223)}.{rng.randrange(256)}."
          f"{rng.randrange(256)}.{rng.randrange(1, 255)}" if routable
          else f"10.0.0.{rng.randrange(1, 255)}")
    nid = pubkey_to_id(bytes(rng.randrange(256) for _ in range(32)))
    return P.net.NetAddress(ip, rng.randrange(1024, 65535), nid)


def _drive_book(P, path, seed):
    """Seeded adds, attempts, good and bad marks on a fresh book."""
    random.seed(seed)
    rng = random.Random(seed)
    book = P.book.AddrBook(path=path, strict=True, key=KEY)
    srcs = [_addr(P, rng) for _ in range(5)]
    addrs = [_addr(P, rng) for _ in range(400)]
    refused = [book.add_address(_addr(P, rng, routable=False), srcs[0])
               for _ in range(5)]
    added = [book.add_address(a, rng.choice(srcs)) for a in addrs]
    again = [book.add_address(a, rng.choice(srcs)) for a in addrs[:50]]
    for a in addrs[::3]:
        book.mark_attempt(a)
    for a in addrs[::5]:
        book.mark_good(a)
    for a in addrs[1::11]:
        book.mark_bad(a)
    book.add_our_address(addrs[2])
    picks = [str(book.pick_address(b)) for b in (0, 30, 100) * 5]
    sel = sorted(str(a) for a in book.get_selection())
    book.save()
    return {"refused": refused, "added": added, "again": again,
            "picks": picks, "selection": sel, "size": book.size(),
            "ours": book.add_address(addrs[2], srcs[0])}


def test_addr_book_files_and_picks_match_jax(tmp_path, pinned_time):
    out = {}
    for name, P in PKGS.items():
        pinned_time()
        out[name] = _drive_book(P, str(tmp_path / f"{name}.json"), seed=3)
    assert out["port"] == out["jax"]
    assert not any(out["port"]["refused"])
    assert out["port"]["size"] > 300
    tbytes = (tmp_path / "port.json").read_bytes()
    assert tbytes == (tmp_path / "jax.json").read_bytes()
    # each loads the other's file to the same state
    loaded = {}
    for name, other in (("port", "jax"), ("jax", "port")):
        random.seed(9)
        b = PKGS[name].book.AddrBook(path=str(tmp_path / f"{other}.json"))
        loaded[name] = (b.size(), [str(b.pick_address(50)) for _ in
                                   range(10)],
                        sorted(str(a) for a in b.get_selection()))
    assert loaded["port"] == loaded["jax"]
    obj = json.loads(tbytes)
    assert {ka["bucket_type"] for ka in obj["addrs"]} == {"new", "old"}


class _Peer:
    def __init__(self, P, pid, outbound, dial_addr=None, listen_addr=""):
        self.id = pid
        self.outbound = outbound
        self.dial_addr = dial_addr
        self.node_info = SimpleNamespace(id=pid, listen_addr=listen_addr)
        self.enc = P.enc
        self.sent = []

    def try_send_obj(self, ch_id, obj):
        self.sent.append((ch_id, self.enc.cdumps(obj)))
        return True


class _Switch:
    def __init__(self):
        self.events = []

    def stop_peer_for_error(self, peer, err):
        self.events.append(("error", peer.id, type(err).__name__, str(err)))

    def stop_peer_gracefully(self, peer):
        self.events.append(("graceful", peer.id))


def _pex_run(P, seed):
    random.seed(seed)
    rng = random.Random(seed)
    book = P.book.AddrBook(strict=False, key=KEY)
    for _ in range(40):
        book.add_address(_addr(P, rng), _addr(P, rng))
    r = P.pex.PEXReactor(book, seed_mode=True)
    sw = _Switch()
    r.switch = sw
    dial = _addr(P, rng)
    out_peer = _Peer(P, dial.id, True, dial_addr=dial)
    in_peer = _Peer(P, pubkey_to_id(b"\x09" * 32), False,
                    listen_addr="8.8.4.4:26656")
    r.add_peer(out_peer)          # solicits the outbound peer
    r.add_peer(in_peer)           # records the inbound listen addr
    req = P.enc.cdumps({"type": "pex_request"})
    r.receive(P.pex.PEX_CHANNEL, in_peer, req)     # answered, seed hangs up
    r.receive(P.pex.PEX_CHANNEL, in_peer, req)     # flood
    resp = P.enc.cdumps({"type": "pex_addrs", "addrs": [
        _addr(P, rng).to_obj() for _ in range(12)]})
    r.receive(P.pex.PEX_CHANNEL, out_peer, resp)   # solicited: taken
    r.receive(P.pex.PEX_CHANNEL, out_peer, resp)   # now unsolicited
    r.receive(P.pex.PEX_CHANNEL, out_peer, P.enc.cdumps({"type": "x"}))
    r.remove_peer(in_peer, None)
    return {"out": out_peer.sent, "in": in_peer.sent, "events": sw.events,
            "size": book.size(), "picks": [str(book.pick_address(40))
                                           for _ in range(5)]}


def test_pex_messages_and_refusals_match_jax(pinned_time):
    runs = {}
    for name, P in PKGS.items():
        pinned_time()
        runs[name] = _pex_run(P, seed=17)
    assert runs["port"] == runs["jax"]
    assert runs["port"]["out"] and runs["port"]["in"]
    kinds = [e[0] for e in runs["port"]["events"]]
    assert kinds == ["graceful", "error", "error", "error"]


def _wait(cond, timeout=20.0):
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            return False
        time.sleep(0.02)
    return True


@pytest.mark.parametrize("dialer", ["port", "jax"])
def test_jax_and_port_pex_reactors_exchange_addresses(dialer):
    rng = random.Random(5)
    books = {name: PKGS[name].book.AddrBook(strict=False, key=KEY)
             for name in PKGS}
    listener = "jax" if dialer == "port" else "port"
    seeded = [_addr(PKGS[listener], rng) for _ in range(30)]
    for a in seeded:
        books[listener].add_address(a, a)
    sws = {"port": make_switch(network="pex", seed=b"\x01" * 32,
                               encrypt=True),
           "jax": jmake_switch(network="pex", seed=b"\x02" * 32,
                               encrypt=True)}
    for name, sw in sws.items():
        sw.add_reactor("pex", PKGS[name].pex.PEXReactor(books[name]))
        sw.start()
    try:
        addr = sws[listener].listen("127.0.0.1", 0)
        sws[dialer].dial_peer(PKGS[dialer].net.NetAddress.from_string(
            str(addr)))
        # the dialer records and promotes its outbound peer, asks it for
        # addresses and takes its answer (~23% of its book, at least 1)
        assert _wait(lambda: books[dialer].size() > 1), books[dialer].size()
        got = {str(a) for a in (ka.addr for ka in
                                books[dialer]._addrs.values())}
        assert str(addr) in got
        assert got - {str(addr)} <= {str(a) for a in seeded}
        assert books[dialer]._addrs[addr.id].is_old()
    finally:
        for sw in sws.values():
            sw.stop()
