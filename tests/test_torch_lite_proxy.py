"""The port's light-client proxy (lite/provider.py FileProvider and
HTTPProvider, lite/proxy.py SecureClient, `cli lite`) against the JAX
package's (tests/test_lite.py), on the CPU, tolerance 0.

- FileProvider: a directory written by one package is read by the other,
  file for file byte-equal, latest and by-height lookups alike.
- HTTPProvider against a device="cpu" port node's RPC gives the JAX
  HTTPProvider's FullCommits on the same RPC; an RPC that fails reads as
  no commit in both.
- SecureClient against the live node (the counterpart of
  test_secure_proxy_against_live_node): block, commit, validators and a
  tx with its Merkle proof, certified, equal to the JAX SecureClient's.
- Refusals: over a stub RPC client that serves one header with a flipped
  byte, a commit whose signature is forged, or a block whose header was
  changed, both packages raise CertificationError with the same message.
- `cli lite` in process with --max-seconds and --device cpu, read over
  its RPC: certified commits and validator sets, its `lite kernels` line,
  and the unverifiable routes proxied as the JAX CLI proxies them; the
  test ends the CLI's window once its checks are done.
"""

import contextlib
import copy
import hashlib
import io
import json
import os
import socket
import threading
import time

import pytest

from tendermint_tpu import lite as jlite
from tendermint_tpu.models.verifier import BatchVerifier as JVerifier
from tendermint_tpu_torch import cli as tcli
from tendermint_tpu_torch import lite as tlite
from tendermint_tpu_torch.config import test_config as make_test_config
from tendermint_tpu_torch.models.verifier import BatchVerifier as TVerifier
from tendermint_tpu_torch.node import Node
from tendermint_tpu_torch.rpc import JSONRPCClient
from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from tendermint_tpu_torch.types.keys import PrivKey
from tendermint_tpu_torch.types.priv_validator import (LocalSigner,
                                                       PrivValidator)

CHAIN = "lite-live"
TX = b"lite=proof"


@pytest.fixture(scope="module")
def live():
    """A single-validator port node on the CPU serving JSON-RPC, with a
    committed tx and at least 4 heights; its RPC client."""
    key = PrivKey.generate(b"\x0c" * 32)
    gen = GenesisDoc(chain_id=CHAIN, genesis_time_ns=1,
                     validators=[GenesisValidator(key.pubkey.ed25519, 10)])
    cfg = make_test_config("")
    cfg.base.verifier_backend = "python"
    cfg.rpc.laddr = "tcp://127.0.0.1:0"
    cfg.tx_index.index_all_tags = True
    node = Node(cfg, gen, priv_validator=PrivValidator(LocalSigner(key)),
                in_memory=True, with_rpc=True, device="cpu")
    node.start()
    try:
        host, port = node.rpc_address
        rpc = JSONRPCClient(f"http://{host}:{port}")
        rpc.call("broadcast_tx_commit", tx=TX)
        deadline = time.monotonic() + 30
        while node.height < 4 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert node.height >= 4
        yield node, rpc
    finally:
        node.stop()


def _tverifier():
    return TVerifier("python")


def _jverifier():
    return JVerifier("auto", mesh="off", coalesce="off")


# ------------------------------------------------------------ providers --

def test_file_provider_directories_cross(live, tmp_path):
    _, rpc = live
    jfcs = [jlite.HTTPProvider(rpc).get_by_height(h) for h in (1, 2, 3)]
    tfcs = [tlite.HTTPProvider(rpc).get_by_height(h) for h in (1, 2, 3)]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jp, tp = jlite.FileProvider(jdir), tlite.FileProvider(tdir)
    for jfc, tfc in zip(jfcs, tfcs):
        jp.store_commit(jfc)
        tp.store_commit(tfc)
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir)) == [
        "%012d.fc.json" % h for h in (1, 2, 3)]
    for name in names:
        with open(os.path.join(jdir, name), "rb") as f, \
                open(os.path.join(tdir, name), "rb") as g:
            assert f.read() == g.read()
    # each package reads the other's directory
    for reader, written in ((tlite.FileProvider(jdir), jfcs),
                            (jlite.FileProvider(tdir), tfcs)):
        assert reader.latest_commit().to_obj() == written[2].to_obj()
        assert reader.get_by_height(2).to_obj() == written[1].to_obj()
        assert reader.get_by_height(99).height == 3
        assert reader.get_by_height(0) is None
    # a certifier of the port trusts what the JAX package stored
    fc = tlite.FileProvider(jdir).get_by_height(3)
    tlite.StaticCertifier(CHAIN, fc.validators,
                          verifier=_tverifier()).certify(fc)


class _DeadRPC:
    def call(self, method, **params):
        raise ConnectionError("node down")


def test_http_provider_matches_jax(live):
    node, rpc = live
    for h in (1, 2, node.height):
        t = tlite.HTTPProvider(rpc).get_by_height(h)
        j = jlite.HTTPProvider(rpc).get_by_height(h)
        assert t.height == j.height == h
        assert t.to_obj() == j.to_obj()
        assert t.signed_header.header.hash() == \
            j.signed_header.header.hash()
    # the chain goes on: the latest of each at its own moment
    t = tlite.HTTPProvider(rpc).latest_commit()
    j = jlite.HTTPProvider(rpc).latest_commit()
    assert 4 <= t.height <= j.height
    assert t.to_obj() == \
        jlite.HTTPProvider(rpc).get_by_height(t.height).to_obj()
    for mod in (tlite, jlite):
        dead = mod.HTTPProvider(_DeadRPC())
        assert dead.get_by_height(1) is None
        assert dead.latest_commit() is None
        dead.store_commit(t)   # a read-only source: a no-op


# ----------------------------------------------------------- SecureClient

def _clients(rpc, trust=1):
    out = []
    for mod, v in ((jlite, _jverifier()), (tlite, _tverifier())):
        trusted = mod.HTTPProvider(rpc).get_by_height(trust)
        cert = mod.InquiringCertifier(CHAIN, trusted, mod.MemProvider(),
                                      verifier=v)
        out.append(mod.SecureClient(rpc, cert))
    return out


def _certified_tx(sc):
    deadline = time.monotonic() + 10
    while True:
        try:
            return sc.tx(hashlib.sha256(TX).digest())
        except Exception:  # the indexer may lag the commit
            if time.monotonic() > deadline:
                raise
            time.sleep(0.1)


def test_secure_proxy_against_live_node(live):
    """SecureClient certifies blocks, commits, validators and txs read
    from a real RPC node, as the JAX SecureClient does."""
    _, rpc = live
    jsc, tsc = _clients(rpc)
    for h in (2, 3):
        blk = tsc.block(h)
        assert blk["block"]["header"]["height"] == h
        assert blk == jsc.block(h)
        cm = tsc.commit(h)
        assert cm["certified"] and cm == jsc.commit(h)
        vals = tsc.validators(h)
        assert vals["certified"] and vals == jsc.validators(h)
    res = _certified_tx(tsc)
    assert bytes.fromhex(res["tx"]) == TX
    assert res == _certified_tx(jsc)
    assert tsc.status()["latest_block_height"] >= 4
    assert tsc.stats == {"certified": 7, "refused": 0}
    assert jsc.certifier.last_height == tsc.certifier.last_height


class _StubRPC:
    """Serves a live node's responses with one of them forged."""

    def __init__(self, rpc, forge):
        self.rpc, self.forge = rpc, forge

    def call(self, method, **params):
        res = copy.deepcopy(self.rpc.call(method, **params))
        return self.forge(method, params, res)


def _flip_hex(s: str, i: int = 0) -> str:
    raw = bytearray(bytes.fromhex(s))
    raw[i] ^= 1
    return raw.hex()


def _flip_header(method, params, res):
    if method == "commit" and params.get("height") == 3:
        res["header"]["app_hash"] = _flip_hex(res["header"]["app_hash"])
    return res


def _forge_signature(method, params, res):
    if method == "commit" and params.get("height") == 3:
        pc = res["commit"]["precommits"][0]
        pc["signature"] = _flip_hex(pc["signature"], 5)
    return res


def _forge_block_header(method, params, res):
    if method == "block" and params.get("height") == 2:
        hdr = res["block"]["header"]
        hdr["app_hash"] = _flip_hex(hdr["app_hash"])
    return res


@pytest.mark.parametrize("forge,call", [
    (_flip_header, lambda sc: sc.commit(3)),
    (_forge_signature, lambda sc: sc.validators(3)),
    (_forge_block_header, lambda sc: sc.block(2)),
], ids=["flipped_header_byte", "forged_signature", "forged_block"])
def test_forgeries_are_refused(live, forge, call):
    _, rpc = live
    got = []
    for sc in _clients(_StubRPC(rpc, forge)):
        with pytest.raises(Exception) as e:
            call(sc)
        got.append((type(e.value).__name__, str(e.value)))
    assert got[0] == got[1]
    assert got[1][0] == "CertificationError"


# --------------------------------------------------------------- cli lite

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _StoppableClock:
    """The `time` module as `cli` sees it, with a clock the test can move
    past the CLI's --max-seconds deadline once its checks are done."""

    def __init__(self):
        self.skip = 0.0
        self.sleep = time.sleep

    def time(self) -> float:
        return time.time() + self.skip


def test_cli_lite_serves_certified_reads(live, tmp_path, monkeypatch):
    """The CLI serves until its --max-seconds window ends. The window is
    a backstop only: each certified read runs the plain verify on the
    CPU (~1.2 s alone, ~7 s beside eight busy torch processes), and a
    fixed 12 s window from the proxy's start once closed under load
    between the reads. The test ends the window itself, by moving the
    CLI's clock past the deadline, once its checks are done."""
    node, rpc = live
    port = _free_port()
    home = str(tmp_path / "lite")
    out = io.StringIO()
    codes = []
    clock = _StoppableClock()
    monkeypatch.setattr(tcli, "time", clock)

    def run():
        with contextlib.redirect_stdout(out):
            codes.append(tcli.main([
                "--home", home, "lite", "--node-addr", rpc.address,
                "--laddr", f"tcp://127.0.0.1:{port}", "--trust-height", "1",
                "--max-seconds", "600", "--device", "cpu"]))

    th = threading.Thread(target=run, daemon=True)
    th.start()
    proxy = JSONRPCClient(f"http://127.0.0.1:{port}", timeout=60)
    deadline = time.monotonic() + 30
    while True:
        try:
            proxy.call("status")
            break
        except Exception:  # not serving yet
            assert time.monotonic() < deadline and th.is_alive()
            time.sleep(0.1)
    try:
        cm = proxy.call("commit", height=2)
        assert cm["certified"] and \
            cm == jlite.SecureClient(rpc, jlite.InquiringCertifier(
                CHAIN, jlite.HTTPProvider(rpc).get_by_height(1),
                jlite.MemProvider(), verifier=_jverifier())).commit(2)
        vals = proxy.call("validators", height=2)
        assert vals["certified"] and vals["block_height"] == 2
        # the JAX CLI's proxied routes refuse their own **kw parameter
        # (RPCFunc does not pass keyword catch-alls): the same refusal
        with pytest.raises(Exception, match="missing param 'kw'"):
            proxy.call("genesis")
    finally:
        clock.skip = 600.0
        th.join(30)
    assert not th.is_alive() and codes == [0]
    lines = [ln for ln in out.getvalue().splitlines()
             if ln.startswith("lite kernels ")]
    assert len(lines) == 1
    got = json.loads(lines[0][len("lite kernels "):])
    assert got["certify"] == {"certified": 2, "refused": 0}
    assert got["device"] == "cpu" and got["trusted_height"] == 1
    assert got["verifier"]["calls"] >= 2 and got["verifier"]["sigs"] >= 2
    # the certified commits landed in the proxy's file store
    assert "%012d.fc.json" % 2 in os.listdir(os.path.join(home, "lite"))
    assert "lite proxy serving on 127.0.0.1:%d" % port in out.getvalue()
