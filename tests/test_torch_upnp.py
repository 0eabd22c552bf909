"""The port's UPnP client (p2p/upnp.py) against the JAX package's, on the
CPU, tolerance 0, over the loopback fake IGD of tests/test_upnp.py (an
SSDP responder on a loopback UDP port and an HTTP server answering the
device description and the SOAP control requests; nothing leaves the
host).

- discover, external_ip, add_port_mapping and delete_port_mapping send
  the same HTTP requests (URL, SOAP body, headers) and parse the same
  replies in both packages; probe reports the same capabilities.
- The failures raise the same UPnPError messages: no IGD answering, a
  SOAP action the gateway refuses, a description without a WAN service.
- `probe_upnp` prints the JAX CLI's JSON and exit codes (probe stubbed,
  as the real one searches the network).
- The switch asks UPnP for its external address only for a wildcard
  bind with `skip_upnp` false, and advertises what it answers.
"""

import contextlib
import io
import socket

import pytest

from tendermint_tpu import cli as jcli
from tendermint_tpu.p2p import upnp as jupnp
from tendermint_tpu_torch import cli as tcli
from tendermint_tpu_torch.config import P2PConfig
from tendermint_tpu_torch.p2p import upnp as tupnp
from tendermint_tpu_torch.p2p.test_util import make_switch
from test_upnp import FakeIGD

PKGS = {"port": tupnp, "jax": jupnp}


def _recording(monkeypatch, mod) -> list:
    """Every urlopen of `mod`: (url, body, headers) in order."""
    seen = []
    real = mod.urlopen

    def urlopen(req, timeout=None):
        if isinstance(req, str):
            seen.append((req, None, ()))
        else:
            seen.append((req.full_url, req.data,
                         tuple(sorted(req.header_items()))))
        return real(req, timeout=timeout)
    monkeypatch.setattr(mod, "urlopen", urlopen)
    return seen


def _session(mod, monkeypatch):
    seen = _recording(monkeypatch, mod)
    igd_srv = FakeIGD()
    try:
        igd = mod.discover(timeout=2.0, ssdp_addr=igd_srv.ssdp_addr,
                           local_ip="127.0.0.1")
        out = [igd.control_url.replace(str(igd_srv.http_port), "P"),
               igd.service_type, igd.local_ip, igd.external_ip()]
        igd.add_port_mapping(46656, 46657, lease_s=60)
        out.append(dict(igd_srv.mappings))
        igd.delete_port_mapping(46656)
        out.append(dict(igd_srv.mappings))
        report = mod.probe(timeout=2.0, ssdp_addr=igd_srv.ssdp_addr)
        report["control_url"] = report["control_url"].replace(
            str(igd_srv.http_port), "P")
        out.append(report)
        with pytest.raises(mod.UPnPError) as e:
            igd._soap("NoSuchAction", {"X": 1}, timeout=2.0)
        out.append(str(e.value).replace(str(igd_srv.http_port), "P"))
        reqs = [(u.replace(str(igd_srv.http_port), "P"), b, h)
                for u, b, h in seen]
        return out, reqs
    finally:
        igd_srv.close()


def test_requests_and_replies_match_jax(monkeypatch):
    port = _session(tupnp, monkeypatch)
    jax = _session(jupnp, monkeypatch)
    assert port == jax
    out, reqs = port
    assert out[3] == "203.0.113.7" and out[4] == {"46656": "127.0.0.1"}
    assert out[5] == {} and out[6]["port_mapping"] is True
    assert out[7].startswith("SOAP NoSuchAction failed")
    assert any(b and b"<NewExternalPort>46656</NewExternalPort>" in b
               for _, b, _ in reqs)


def test_no_igd_raises_the_jax_error():
    msgs = []
    for mod in PKGS.values():
        silent = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        silent.bind(("127.0.0.1", 0))
        try:
            with pytest.raises(mod.UPnPError) as e:
                mod.discover(timeout=0.3, ssdp_addr=silent.getsockname())
            msgs.append(str(e.value))
        finally:
            silent.close()
    assert msgs[0] == msgs[1] == "no IGD responded to SSDP search"


def test_description_without_a_wan_service_raises_the_jax_error(
        monkeypatch):
    import test_upnp
    monkeypatch.setattr(test_upnp, "DESC_XML", test_upnp.DESC_XML.replace(
        "WANIPConnection", "SomethingElse"))
    msgs = []
    for mod in PKGS.values():
        igd_srv = FakeIGD()
        try:
            with pytest.raises(mod.UPnPError) as e:
                mod.discover(timeout=1.0, ssdp_addr=igd_srv.ssdp_addr,
                             local_ip="127.0.0.1")
            msgs.append(str(e.value))
        finally:
            igd_srv.close()
    assert msgs[0] == msgs[1] == \
        "no usable IGD found: device has no WANIPConnection service"


@pytest.mark.parametrize("outcome", ["report", "error"])
def test_probe_upnp_prints_the_jax_json(monkeypatch, outcome):
    def probe(mod):
        def run(timeout=3.0, **kw):
            if outcome == "error":
                raise mod.UPnPError("no IGD responded to SSDP search")
            return {"control_url": "http://gw/ctl", "service_type": "s",
                    "local_ip": "10.0.0.2", "external_ip": "203.0.113.7",
                    "port_mapping": True, "timeout": timeout}
        return run
    out = {}
    for name, cli, mod in (("port", tcli, tupnp), ("jax", jcli, jupnp)):
        monkeypatch.setattr(mod, "probe", probe(mod))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["probe_upnp", "--timeout", "1.5"])
        out[name] = (rc, buf.getvalue())
    assert out["port"] == out["jax"]
    assert out["port"][0] == (1 if outcome == "error" else 0)


@pytest.mark.parametrize("skip", [True, False])
def test_wildcard_listener_advertises_the_upnp_address(monkeypatch, skip):
    calls = []
    monkeypatch.setattr(tupnp, "external_address",
                        lambda timeout=1.5: calls.append(1) or "203.0.113.7")
    sw = make_switch(config=P2PConfig(skip_upnp=skip), seed=b"\x07" * 32)
    try:
        addr = sw.listen("0.0.0.0", 0)
        if skip:
            assert calls == [] and addr.ip != "203.0.113.7"
        else:
            assert calls == [1] and addr.ip == "203.0.113.7"
        # a bound (non-wildcard) host never asks
        sw2 = make_switch(config=P2PConfig(skip_upnp=skip),
                          seed=b"\x08" * 32)
        try:
            assert sw2.listen("127.0.0.1", 0).ip == "127.0.0.1"
        finally:
            sw2.stop()
        assert len(calls) == (0 if skip else 1)
    finally:
        sw.stop()

