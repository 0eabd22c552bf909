"""The port's wire-level chaos (tendermint_tpu_torch/chaos/wire.py) and
hostile peers (chaos/hostile.py) against the JAX package's, on the CPU.

- WireSchedule: for the same (spec, seed) the plan, its digest, the
  episodes, the resets, the blocked windows and every per-connection
  decision stream equal the JAX ones (bench.py's WIRECHAOS_SPEC and a
  spec with every key, at several seeds); invalid specs raise the same
  errors.
- SocketInvariantMonitor: canned chains give the JAX monitor's checks,
  violations and recovery report.
- The proxy in front of two port switches (short deadlines): a planned
  reset disconnects the link and the persistent dialer redials through
  the proxy; corruption makes the victim disconnect without a crash.
- Each hostile script against a port switch's listener: the handshake
  stall and the slow handshake are closed by the total deadline, the
  garbage peer is banned and readmitted after the ban decays, the
  oversize frame is killed, the flood is answered.
- The switch's seam: with TM_CUDA_CHAOS on, both peers' links are
  FuzzedLinks and still deliver; off, the peer gets the handshake's
  link object itself.
"""

import copy
import threading
import time

import pytest

from tendermint_tpu.chaos import wire as jwire
from tendermint_tpu_torch.chaos import hostile
from tendermint_tpu_torch.chaos import wire as twire
from tendermint_tpu_torch.config import P2PConfig
from tendermint_tpu_torch.p2p import NetAddress
from tendermint_tpu_torch.p2p.test_util import make_switch
from tendermint_tpu_torch.p2p.trust import TrustMetricStore
from tendermint_tpu_torch.storage import MemDB

import chip_smoke


def wait_for(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


FULL_SPEC = {
    "drop": 0.01, "delay": 0.2, "delay_steps": [1, 4],
    "corrupt": 0.005,
    "partitions": [{"start": 10, "stop": 30, "groups": [[0], [1, 2, 3]]}],
    "stalls": [{"start": 40, "stop": 50, "links": [[0, 1]]},
               {"start": 55, "stop": 58}],
    "resets": [{"at": 60, "links": [[1, 2]]}],
    "reset_every_steps": 100,
    "geo": {"profile": "wan2"},
    "step_ms": 20,
    "horizon_steps": 700,
}


def _schedule_view(mod, spec, seed):
    s = mod.WireSchedule(copy.deepcopy(spec), seed=seed, n_nodes=4)
    streams = {}
    for i in range(4):
        for j in range(4):
            if i != j:
                for conn in (0, 1):
                    st = s.link_stream(i, j, conn)
                    streams[(i, j, conn)] = (
                        [st.decide() for _ in range(60)], st.digest(200))
    blocked = [s.blocked(step + 0.5, a, b) for step in range(0, 700, 3)
               for a in range(4) for b in range(4) if a != b]
    return (s.plan, s.plan_digest(), s.episodes(), s.resets(), blocked,
            streams, s.applied_counts(), s.applied_log[:200],
            (s.step_ms, s.horizon_steps, s.buffer_cap, s.rates, s.geo))


@pytest.mark.parametrize("spec", ["wirechaos", "full"])
@pytest.mark.parametrize("seed", [1, 42, 7777])
def test_wire_schedule_matches_jax(spec, seed):
    spec = chip_smoke.WIRECHAOS_SPEC if spec == "wirechaos" else FULL_SPEC
    assert _schedule_view(twire, spec, seed) == \
        _schedule_view(jwire, spec, seed)


@pytest.mark.parametrize("spec", [{"dorp": 0.1},
                                  {"geo": {"profile": "wan9"}},
                                  {"geo": {"latency_steps": [[0]],
                                           "loss": [[0.0, 1.0]]}}])
def test_wire_spec_errors_match_jax(spec):
    errs = []
    for mod in (twire, jwire):
        with pytest.raises(ValueError) as e:
            mod.WireSchedule(spec)
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    assert twire.FAULT_KINDS == jwire.FAULT_KINDS


# ---------------------------------------------------------------- monitor

class _FakeClient:
    """Scripted RPC client: status and blockchain from canned chains."""

    def __init__(self, chain):
        self.chain = chain     # height -> (block hash hex, app hash hex)

    def call(self, method, **kw):
        if method == "status":
            return {"latest_block_height": max(self.chain, default=0)}
        if method == "blockchain":
            lo, hi = kw["min_height"], kw["max_height"]
            return {"block_metas": [
                {"header": {"height": h, "app_hash": self.chain[h][1]},
                 "block_id": {"hash": self.chain[h][0]}}
                for h in range(hi, lo - 1, -1) if h in self.chain]}
        raise AssertionError(method)


def _monitor(mod, chains):
    mon = mod.SocketInvariantMonitor([])
    mon.clients = [_FakeClient(dict(c)) for c in chains]
    return mon


def _monitor_run(mod):
    good = {h: ("h%d" % h, "a%d" % h) for h in range(1, 45)}
    forked = {**good, 7: ("xx", "a7"), 9: ("h9", "yy")}
    mon = _monitor(mod, [good, forked, good])
    for i, c in enumerate(mon.clients):
        mon._poll_node(i, c)
    mon.clients[2].chain = {3: ("h3", "a3")}
    mon._audited[2] = 44
    mon._poll_node(2, mon.clients[2])      # height regression
    t = 1000.0
    mon.progress = [(t + 1.0, 5), (t + 8.0, 6)]
    report = mon.finalize([("partition", t), ("reset", t + 5.0),
                           ("stall", t + 100.0)], liveness_bound_s=4.0)
    return report, mon.per_height, mon.heights


def test_socket_monitor_verdicts_match_jax():
    got, want = _monitor_run(twire), _monitor_run(jwire)
    assert got == want
    kinds = {v["invariant"] for v in got[0]["violations"]}
    assert kinds == {"agreement", "apphash", "liveness", "validity"}


# -------------------------------------------------------------- the proxy

def _proxied_switch_pair(spec, seed=1):
    """Two encrypted port switches connected THROUGH a WireProxy (node 0
    dials node 1), persistent so the redial path is live; no ban plane
    (no trust store). Keepalive pings every 0.5 s put frames on the
    link without a reactor."""
    sw0, sw1 = (make_switch(network="wire-net", seed=bytes([b]) * 32,
                            encrypt=True,
                            config=P2PConfig(ping_interval_s=0.5))
                for b in (0x21, 0x22))
    a1 = sw1.listen("127.0.0.1", 0)
    sched = twire.WireSchedule(spec, seed=seed, n_nodes=2)
    proxy = twire.WireProxy(sched, {(0, 1): ("127.0.0.1", a1.port)})
    ports = proxy.listen()
    proxy.start()
    sw0.start()
    sw1.start()
    sw0.dial_peer(NetAddress("127.0.0.1", ports[(0, 1)], sw1.node_info.id),
                  persistent=True)
    return sw0, sw1, proxy, sched


def test_proxy_reset_disconnects_and_the_persistent_peer_redials():
    spec = {"resets": [{"at": 0, "links": [[0, 1]]}], "step_ms": 20}
    sw0, sw1, proxy, sched = _proxied_switch_pair(spec)
    try:
        assert wait_for(lambda: sw0.peers.size() == 1 and
                        sw1.peers.size() == 1)
        first = sw0.peers.list()[0]
        proxy.arm()
        assert wait_for(lambda: sw0.peers.get(first.id) is not first or
                        not first.running, timeout=15.0)
        # the victim can see the RST before the proxy books it
        assert wait_for(lambda: sched.applied_counts().get("reset", 0) >= 1)
        assert wait_for(lambda: sw0.peers.size() == 1 and
                        sw0.peers.list()[0].running and
                        sw0.peers.list()[0] is not first, timeout=20.0)
    finally:
        sw0.stop()
        sw1.stop()
        proxy.stop()


def test_proxy_corruption_causes_disconnect_not_crash():
    spec = {"corrupt": 1.0, "step_ms": 20}
    sw0, sw1, proxy, sched = _proxied_switch_pair(spec)
    try:
        assert wait_for(lambda: sw0.peers.size() == 1 and
                        sw1.peers.size() == 1)
        peer0 = sw0.peers.list()[0]
        proxy.arm()
        peer0.try_send(0x01, b"\x01")
        assert wait_for(lambda: sched.applied_counts().get("corrupt", 0)
                        >= 1, timeout=15.0)
        assert wait_for(lambda: sw0.peers.size() == 0 or
                        sw1.peers.size() == 0, timeout=15.0)
        assert sw1.listen_address is not None
    finally:
        sw0.stop()
        sw1.stop()
        proxy.stop()


# ---------------------------------------------------------- hostile peers

def _victim(ban_base_s=1.0, handshake_timeout_s=1.5):
    sw = make_switch(network="hostile-net", seed=b"\x31" * 32, encrypt=True)
    sw.trust_store = TrustMetricStore(MemDB())
    sw._ban_base_s = ban_base_s
    sw.config.handshake_timeout_s = handshake_timeout_s
    return sw


def test_handshake_stall_and_slow_handshake_hit_the_total_deadline():
    sw = _victim(handshake_timeout_s=1.2)
    addr = sw.listen("127.0.0.1", 0)
    out = {}
    try:
        threads = [threading.Thread(target=lambda s=s, kw=kw: out.setdefault(
            s, hostile.run_hostile(s, "127.0.0.1", addr.port, **kw)))
            for s, kw in (("handshake_stall", {"budget_s": 6.0}),
                          ("slow_handshake", {"byte_interval_s": 0.3,
                                              "budget_s": 8.0}))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(15)
        stall, slow = out["handshake_stall"], out["slow_handshake"]
        assert stall["defense_fired"] and stall["closed_by_victim_s"] < 4.0
        assert slow["defense_fired"], slow
        assert 2 <= slow["bytes_sent"] < 32   # progressing, yet killed
    finally:
        sw.stop()


def test_garbage_peer_banned_then_readmitted_after_decay():
    sw = _victim(ban_base_s=1.0)
    addr = sw.listen("127.0.0.1", 0)
    try:
        r = hostile.run_hostile(
            "garbage_after_auth", "127.0.0.1", addr.port,
            network="hostile-net", channels=[], rounds=9,
            retry_gap_s=0.25, budget_s=20.0)
        kinds = [o["outcome"] for o in r["rounds"]]
        assert r["saw_ban"] and r["readmitted_after_ban"], kinds
        assert sw.trust_store.get_metric(r["peer_id"]).trust_score() < 30
        with sw._lock:
            assert r["peer_id"] in sw.banned
    finally:
        sw.stop()


def test_oversize_frame_killed_and_flood_answered():
    sw = _victim()
    addr = sw.listen("127.0.0.1", 0)
    try:
        r = hostile.run_hostile("oversize_frame", "127.0.0.1", addr.port,
                                network="hostile-net", channels=[])
        assert r["outcome"] == "authed" and r["defense_fired"], r
        f = hostile.run_hostile("flood", "127.0.0.1", addr.port, count=16,
                                hold_s=0.3)
        assert f["attempted"] == 16
        assert f["refused"] + f["shed_within_hold"] + f["held_open"] == 16
        with pytest.raises(ValueError, match="unknown hostile script"):
            hostile.run_hostile("nope", "127.0.0.1", addr.port)
        assert hostile.SCRIPTS == ("handshake_stall", "slow_handshake",
                                   "garbage_after_auth", "oversize_frame",
                                   "flood")
    finally:
        sw.stop()


# ------------------------------------------------------- the switch seam

@pytest.mark.parametrize("mode", ["off", "delay=0.3,delay_ms=5,seed=1"])
def test_switch_links_wrapped_only_with_chaos_on_and_still_deliver(
        monkeypatch, mode):
    """With TM_CUDA_CHAOS on both peers' links are FuzzedLinks and
    traffic still flows through a delay-only spec; off, the switch hands
    the handshake's link itself to the peer."""
    from test_torch_p2p import EchoReactor
    from tendermint_tpu_torch import chaos as tchaos
    from tendermint_tpu_torch.p2p import switch as tswitch
    from tendermint_tpu_torch.p2p.conn import SecretConnection
    from tendermint_tpu_torch.p2p.fuzz import FuzzedLink
    from tendermint_tpu_torch.p2p.test_util import connect_switches

    monkeypatch.delenv("TM_TPU_CHAOS", raising=False)
    monkeypatch.setenv("TM_CUDA_CHAOS", mode)
    seam = []

    def spy(link, peer_id=""):
        out = tchaos.maybe_wrap_link(link, peer_id)
        seam.append((link, out))
        return out
    monkeypatch.setattr(tswitch, "maybe_wrap_link", spy)
    r1, r2 = EchoReactor(0x10), EchoReactor(0x10)
    sw1 = make_switch(seed=b"\x01" * 32, encrypt=True)
    sw2 = make_switch(seed=b"\x02" * 32, encrypt=True)
    sw1.add_reactor("echo", r1)
    sw2.add_reactor("echo", r2)
    sw1.start()
    sw2.start()
    try:
        p1, p2 = connect_switches(sw1, sw2)
        assert len(seam) == 2
        for p in (p1, p2):
            link = p.mconn.link
            if mode == "off":
                assert type(link) is SecretConnection
                assert any(out is link and inner is link
                           for inner, out in seam)
            else:
                assert isinstance(link, FuzzedLink)
                assert type(link.link) is SecretConnection
        assert p1.send(0x10, b"through-chaos")
        assert wait_for(lambda: r2.received, timeout=5.0)
        assert r2.received[0][1] == b"through-chaos"
    finally:
        sw1.stop()
        sw2.stop()
