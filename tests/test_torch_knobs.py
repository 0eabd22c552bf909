"""The port's knob catalog (tendermint_tpu_torch/utils/knobs.py) against
the JAX package's (tendermint_tpu/utils/knobs.py), on the CPU.

- The readers give env > config > default in both packages, with the
  same values for the same inputs (the port's TM_CUDA_* name, the JAX
  package's TM_TPU_* one), for every reader and kind.
- A TM_TPU_* variable changes nothing in the port: each plane the port
  gates on a knob reads only its TM_CUDA_* name, and that name wins over
  the plane's config. The front door's pair and the shard count resolve
  as the JAX package's do (an explicit argument, then env, then default).
- Every JAX catalog name has a TM_CUDA_* counterpart of the same kind,
  default and config field, but three: TM_TPU_NO_PALLAS (the CUDA kernel
  is the only device route), TM_TPU_FETCH_WORKERS (no fetch pool) and
  TM_TPU_MESH_FORCE_HOST_DEVICES (its counterpart is
  TM_CUDA_MESH_FORCE_DEVICES); TM_CUDA_NODE_PROFILE's counterpart is the
  JAX CLI's TM_NODE_PROFILE, which the JAX catalog does not list. Every
  TM_CUDA_* name in the port's sources is in the catalog, and reading an
  unknown one raises.
- The operator's env surface (the verifier, the host oracle, the native
  plane, p2p, the commit path, recovery): each knob at its resolver,
  env > config > default, equals the JAX resolver at its call site on
  the same values; the host oracle's two import-time knobs in a fresh
  interpreter.
"""

import re
from pathlib import Path

import pytest

from tendermint_tpu.utils import knobs as jknobs
from tendermint_tpu_torch.utils import knobs as tknobs

PORT = Path(__file__).resolve().parent.parent / "tendermint_tpu_torch"

#: JAX knobs with no TM_CUDA_* counterpart
NO_COUNTERPART = ("TM_TPU_NO_PALLAS", "TM_TPU_FETCH_WORKERS",
                  "TM_TPU_MESH_FORCE_HOST_DEVICES")
#: port knobs whose counterpart is not the same name under TM_TPU_
PORT_ONLY = ("TM_CUDA_NODE_PROFILE", "TM_CUDA_MESH_FORCE_DEVICES")
#: knobs the port resolves in another module than the JAX package (the
#: JAX `where` -> the port's); every other knob's `where` is the JAX one
MOVED = {
    # native.py is the counterpart of native/__init__.py
    "TM_CUDA_NO_NATIVE": ("native/__init__.py", "native.py"),
    # resolve_reactor is the port's config helper, not the loop module's
    "TM_CUDA_REACTOR": ("p2p/conn/loop.py", "config.py"),
    # the port's Node resolves the recovery settings it hands the planes
    "TM_CUDA_SNAPSHOT_INTERVAL": ("storage/snapshot.py", "node.py"),
    "TM_CUDA_SNAPSHOT_KEEP": ("storage/snapshot.py", "node.py"),
    "TM_CUDA_SNAPSHOT_CHUNK_KB": ("storage/snapshot.py", "node.py"),
    "TM_CUDA_RETAIN_HEIGHTS": ("storage/snapshot.py", "node.py"),
    "TM_CUDA_STATE_SYNC": ("statesync/reactor.py", "node.py"),
}


def _jax_name(name: str) -> str:
    # the forced device count's counterpart fakes host (CPU) devices
    if name == "TM_CUDA_MESH_FORCE_DEVICES":
        return "TM_TPU_MESH_FORCE_HOST_DEVICES"
    return name.replace("TM_CUDA_", "TM_TPU_")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in tknobs.NAMES:
        monkeypatch.delenv(k, raising=False)
        monkeypatch.delenv(_jax_name(k), raising=False)


def test_catalog_holds_the_slice_knobs_with_jax_counterparts():
    want = set(PORT_ONLY)
    for j in jknobs.CATALOG:
        if j.name in NO_COUNTERPART:
            continue
        name = j.name.replace("TM_TPU_", "TM_CUDA_")
        want.add(name)
        k = tknobs.get(name)
        assert (k.kind, k.default, k.config) == \
            (j.kind, j.default, j.config), name
        assert (j.where, k.where) == MOVED.get(name, (j.where, j.where)), \
            name
    assert want == tknobs.NAMES
    assert all(k.name.startswith("TM_CUDA_") for k in tknobs.CATALOG)
    md = tknobs.knobs_md()
    assert "TM_CUDA_TELEMETRY" in md
    # the three without a counterpart are named, each with its reason
    for name in NO_COUNTERPART:
        assert name in md, name


def test_every_port_source_knob_is_cataloged():
    seen = set()
    for p in PORT.rglob("*.py"):
        if "_build" in p.parts:
            continue
        seen |= set(re.findall(r"TM_CUDA_[A-Z0-9_]+", p.read_text()))
    assert seen, "no knob read anywhere"
    assert seen <= tknobs.NAMES, seen - tknobs.NAMES
    with pytest.raises(KeyError):
        tknobs.knob_raw("TM_CUDA_NOT_A_KNOB")
    with pytest.raises(KeyError):
        tknobs.knob_raw("TM_TPU_TRACE")


# (reader, knob, env value or None, config, default)
_CASES = [
    ("knob_str", "TM_CUDA_TRACE", None, None, "off"),
    ("knob_str", "TM_CUDA_TRACE", None, " ON ", "off"),
    ("knob_str", "TM_CUDA_TRACE", "On", "off", "off"),
    ("knob_str", "TM_CUDA_TRACE", "   ", "on", "off"),
    ("knob_spec", "TM_CUDA_QUEUE_WATCH", None, None, "on"),
    ("knob_spec", "TM_CUDA_QUEUE_WATCH", None, "0.5", "on"),
    ("knob_spec", "TM_CUDA_QUEUE_WATCH", "Off", "0.5", "on"),
    ("knob_bool", "TM_CUDA_DIVERGENCE", None, None, False),
    ("knob_bool", "TM_CUDA_DIVERGENCE", None, True, False),
    ("knob_bool", "TM_CUDA_DIVERGENCE", "disabled", True, True),
    ("knob_bool", "TM_CUDA_DIVERGENCE", "yes", False, False),
    ("knob_int", "TM_CUDA_TRACE_CAP", None, None, 65536),
    ("knob_int", "TM_CUDA_TRACE_CAP", None, 10, 65536),
    ("knob_int", "TM_CUDA_TRACE_CAP", "7", 10, 65536),
    ("knob_float", "TM_CUDA_PROF_HZ", None, None, 13.0),
    ("knob_float", "TM_CUDA_PROF_HZ", None, 29.0, 13.0),
    ("knob_float", "TM_CUDA_PROF_HZ", "3.5", 29.0, 13.0),
    ("knob_float", "TM_CUDA_SLO_SAMPLE", "0.25", None, 1.0),
    ("knob_int", "TM_CUDA_SHARDS", None, None, 0),
    ("knob_int", "TM_CUDA_SHARDS", None, 8, 0),
    ("knob_int", "TM_CUDA_SHARDS", "32", 8, 0),
    ("knob_int", "TM_CUDA_EDGE_MAX_LAG", None, None, 50),
    ("knob_int", "TM_CUDA_EDGE_MAX_LAG", None, 5, 50),
    ("knob_int", "TM_CUDA_EDGE_MAX_LAG", "2", 5, 50),
    ("knob_int", "TM_CUDA_RPC_MAX_CONNS", "20", None, 0),
    ("knob_float", "TM_CUDA_RPC_RATE", "40", None, 0.0),
    ("knob_str", "TM_CUDA_MESH", None, None, "auto"),
    ("knob_str", "TM_CUDA_MESH", None, "4", "auto"),
    ("knob_str", "TM_CUDA_MESH", "Off", "4", "auto"),
    ("knob_int", "TM_CUDA_MESH_FORCE_DEVICES", None, None, 0),
    ("knob_int", "TM_CUDA_MESH_FORCE_DEVICES", "8", None, 0),
]


@pytest.mark.parametrize("reader,name,env,config,default", _CASES)
def test_precedence_env_config_default_as_jax(monkeypatch, reader, name,
                                              env, config, default):
    if env is not None:
        monkeypatch.setenv(name, env)
        monkeypatch.setenv(_jax_name(name), env)
    got = getattr(tknobs, reader)(name, config=config, default=default)
    want = getattr(jknobs, reader)(_jax_name(name), config=config,
                                   default=default)
    assert got == want
    assert type(got) is type(want)


@pytest.mark.parametrize("value", [None, "off", "0", "no", "on", "1",
                                   "anything"])
def test_flag3_and_set_as_jax(monkeypatch, value):
    if value is not None:
        monkeypatch.setenv("TM_CUDA_TELEMETRY", value)
        monkeypatch.setenv("TM_TPU_TELEMETRY", value)
        monkeypatch.setenv("TM_CUDA_DIVERGENCE", value)
        monkeypatch.setenv("TM_TPU_DIVERGENCE", value)
    assert tknobs.knob_flag3("TM_CUDA_TELEMETRY") == \
        jknobs.knob_flag3("TM_TPU_TELEMETRY")
    assert tknobs.knob_set("TM_CUDA_DIVERGENCE") == \
        jknobs.knob_set("TM_TPU_DIVERGENCE")
    for s in ("", "off", "FALSE", "on", "x"):
        assert tknobs.parse_bool(s) == jknobs.parse_bool(s)


def _planes():
    """(knob, reader of the port plane's effective value, config setter,
    value with the knob set to `on_value`) for each gated plane."""
    from tendermint_tpu_torch.analysis import divergence
    from tendermint_tpu_torch.serving.edge import CertifierFollower
    from tendermint_tpu_torch.shard import resolve_shards
    from tendermint_tpu_torch.telemetry import causal, profile, queues, slo

    def slo_read():
        slo.reset()
        return slo.enabled()

    def slo_rate():
        slo.reset()
        return slo.sample_rate()

    def cap_read():
        causal.set_capacity(None)
        return causal._capacity()

    return [
        ("TM_CUDA_TRACE", "on", causal.enabled,
         lambda: causal.configure("off"), False, True),
        ("TM_CUDA_TRACE_CAP", "7", cap_read, lambda: None,
         causal.DEFAULT_CAPACITY, 7),
        ("TM_CUDA_PROF", "on", profile.enabled,
         lambda: profile.configure("off"), False, True),
        ("TM_CUDA_PROF_HZ", "5", profile.default_hz,
         lambda: profile.configure("off", 0.0), profile.DEFAULT_HZ, 5.0),
        ("TM_CUDA_QUEUE_WATCH", "off", lambda: queues.resolve()[0],
         lambda: queues.configure("on"), True, False),
        ("TM_CUDA_SLO", "on", slo_read, lambda: slo.configure("off"),
         False, True),
        ("TM_CUDA_SLO_SAMPLE", "0.5", slo_rate,
         lambda: slo.configure("on", None), 1.0, 0.5),
        ("TM_CUDA_DIVERGENCE", "on", divergence.enabled, lambda: None,
         False, True),
        ("TM_CUDA_SHARDS", "8", lambda: resolve_shards(config=2),
         lambda: None, 2, 8),
        ("TM_CUDA_EDGE_MAX_LAG", "3",
         lambda: CertifierFollower(None).max_lag, lambda: None, 50, 3),
        ("TM_CUDA_RPC_MAX_CONNS", "20", lambda: _server_field("max_conns"),
         lambda: None, 4096, 20),
        ("TM_CUDA_RPC_RATE", "40", lambda: _server_field("rate_per_ip"),
         lambda: None, 0.0, 40.0),
    ]


def _server_field(name: str):
    """A field of a fresh async front door (no loop, no thread started)."""
    from tendermint_tpu_torch.rpc.aserver import AsyncRPCServer
    srv = AsyncRPCServer(None)
    try:
        return getattr(srv, name)
    finally:
        srv._pool.shutdown()


@pytest.fixture
def planes_restored():
    from tendermint_tpu_torch.telemetry import causal, profile, queues, slo
    yield
    causal.configure("off")
    causal.set_capacity(None)
    profile.configure("off", 0.0)
    queues.configure("on")
    slo.configure("off")
    slo.reset()


@pytest.mark.parametrize("i", range(12))
def test_tm_tpu_names_change_nothing_in_the_port(monkeypatch, i,
                                                 planes_restored):
    name, on_value, read, set_config, base, forced = _planes()[i]
    set_config()
    assert read() == base
    monkeypatch.setenv(_jax_name(name), on_value)
    assert read() == base, f"{_jax_name(name)} reached the port"
    monkeypatch.setenv(name, on_value)
    assert read() == forced


def test_telemetry_env_pin_wins_over_config(monkeypatch):
    """TM_CUDA_TELEMETRY=off silences the port's registry whatever the
    config says; TM_TPU_TELEMETRY does not reach it."""
    from tendermint_tpu_torch.telemetry import registry
    monkeypatch.setenv("TM_TPU_TELEMETRY", "off")
    st = registry._TelemetryState()
    assert st.enabled and not st.env_forced
    monkeypatch.setenv("TM_CUDA_TELEMETRY", "off")
    st = registry._TelemetryState()
    assert not st.enabled and st.env_forced
    saved = registry._state
    registry._state = st
    try:
        registry.configure(enabled=True, namespace="tm")
        assert not registry.enabled()
        assert registry.namespace() == "tm"
    finally:
        registry._state = saved
    assert registry._TelemetryState().namespace == "tmcuda"


@pytest.mark.parametrize("env,arg", [(None, 0), ("20", 0), ("20", 7),
                                     (None, 7)])
def test_rpc_admission_pair_resolves_as_jax(monkeypatch, env, arg):
    """An explicit constructor argument wins, else the knob, else the
    default: the port's front door resolves its pair as the JAX one."""
    from tendermint_tpu.rpc.aserver import AsyncRPCServer as JServer
    from tendermint_tpu_torch.rpc.aserver import AsyncRPCServer as TServer
    if env is not None:
        monkeypatch.setenv("TM_CUDA_RPC_MAX_CONNS", env)
        monkeypatch.setenv("TM_TPU_RPC_MAX_CONNS", env)
        monkeypatch.setenv("TM_CUDA_RPC_RATE", env)
        monkeypatch.setenv("TM_TPU_RPC_RATE", env)
    got = []
    for cls in (TServer, JServer):
        srv = cls(None, max_conns=arg, rate_per_ip=float(arg))
        got.append((srv.max_conns, srv.rate_per_ip))
        srv._pool.shutdown()
    assert got[0] == got[1]


@pytest.mark.parametrize("env,config", [(None, 0), (None, 4), ("16", 4),
                                        ("0", 4)])
def test_resolve_shards_as_jax(monkeypatch, env, config):
    from tendermint_tpu.shard import resolve_shards as jresolve
    from tendermint_tpu_torch.shard import resolve_shards as tresolve
    if env is not None:
        monkeypatch.setenv("TM_CUDA_SHARDS", env)
        monkeypatch.setenv("TM_TPU_SHARDS", env)
    assert tresolve(config) == jresolve(config)


@pytest.mark.parametrize("flag,env,config,want", [
    (3, "8", 4, 3), (0, "8", 4, 8), (0, None, 4, 4), (0, None, 0, 2),
    (0, "0", 0, 2)])
def test_shardset_count_reads_the_knob_and_the_home_config(
        monkeypatch, tmp_path, flag, env, config, want):
    """`cli shardset`'s chain count: --shards > TM_CUDA_SHARDS >
    base.shards of the home's config.json > 2."""
    import json

    from tendermint_tpu_torch.serving.deploy import shard_count
    monkeypatch.delenv("TM_CUDA_SHARDS", raising=False)
    if env is not None:
        monkeypatch.setenv("TM_CUDA_SHARDS", env)
    (tmp_path / "config").mkdir()
    (tmp_path / "config" / "config.json").write_text(
        json.dumps({"base": {"shards": config}}))
    assert shard_count(flag, str(tmp_path)) == want


def test_mesh_knobs_are_the_ports_own(monkeypatch):
    """TM_TPU_MESH and TM_TPU_MESH_FORCE_HOST_DEVICES change nothing in
    the port; TM_CUDA_MESH wins over base.verifier_mesh, which wins over
    the default, in the node's verifier; the forced count lays logical
    devices over the CPU."""
    import torch
    from tendermint_tpu_torch.config import BaseConfig
    from tendermint_tpu_torch.node import build_verifier
    from tendermint_tpu_torch.ops import merkle
    from tendermint_tpu_torch.parallel import mesh as pmesh
    monkeypatch.setattr(merkle, "_mesh_state", None)
    monkeypatch.setattr(merkle, "_mesh_config", "auto")
    monkeypatch.setenv("TM_TPU_MESH", "8")
    monkeypatch.setenv("TM_TPU_MESH_FORCE_HOST_DEVICES", "8")
    assert pmesh.logical_devices("cpu") == (torch.device("cpu"),)
    assert merkle._mesh_root_kernel() == (None, 1)
    assert merkle._mesh_state == (None, 1)
    vs = []
    for env, cfg, want in ((None, "auto", "auto"), (None, "4", 4),
                           ("2", "4", 2), ("off", "4", "off")):
        if env is None:
            monkeypatch.delenv("TM_CUDA_MESH", raising=False)
        else:
            monkeypatch.setenv("TM_CUDA_MESH", env)
        v, owned = build_verifier(BaseConfig(verifier_mesh=cfg),
                                  device="cpu")
        vs.append(v)
        assert owned and v.mesh == want, (env, cfg)
    monkeypatch.setenv("TM_CUDA_MESH_FORCE_DEVICES", "4")
    assert pmesh.logical_devices("cpu") == (torch.device("cpu"),) * 4
    for v in vs:
        v.close()


# ------------------------------------------------- the operator's env surface

def _verifier_field(pkg, field, **kw):
    """A field of a fresh BatchVerifier ("python": no device, no thread)."""
    if pkg == "port":
        from tendermint_tpu_torch.models.verifier import BatchVerifier
    else:
        from tendermint_tpu.models.verifier import BatchVerifier
    v = BatchVerifier("python", **kw)
    try:
        return getattr(v, field)
    finally:
        v.close()


def _default_backend(pkg, monkeypatch):
    """The backend the process-default verifier takes (port: through
    node.build_verifier of a default BaseConfig on the CPU; JAX: its
    default_verifier, "jax" reading as the port's "cuda")."""
    if pkg == "port":
        from tendermint_tpu_torch.config import BaseConfig
        from tendermint_tpu_torch.node import build_verifier
        v, _ = build_verifier(BaseConfig(), device="cpu")
        v.close()
        return v.backend
    from tendermint_tpu.models import verifier as jverifier
    monkeypatch.setattr(jverifier, "_default", None)
    v = jverifier.default_verifier()
    v.close()
    return {"jax": "cuda"}.get(v.backend, v.backend)


def _burst(pkg, mode, monkeypatch):
    if pkg == "port":
        from tendermint_tpu_torch.config import P2PConfig, _mode_on
        from tendermint_tpu_torch.p2p.conn.burst import Burst
        m = str(mode)
        cfg = P2PConfig(burst=_mode_on(m),
                        burst_max=int(m) if m.isdigit() else 0)
        return Burst.from_config(cfg).resolve()
    from tendermint_tpu.p2p.conn import burst as jburst
    monkeypatch.setattr(jburst, "_cfg_mode", jburst._cfg_mode)
    monkeypatch.setattr(jburst, "_cfg_max", jburst._cfg_max)
    m = str(mode)
    jburst.configure(m, int(m) if m.isdigit() else 0)
    return jburst.resolve()


def _linger(pkg):
    import socket
    if pkg == "port":
        from tendermint_tpu_torch.p2p.conn import loop, mconn
    else:
        from tendermint_tpu.p2p.conn import loop, mconn
    a, b = socket.socketpair()
    try:
        c = loop.LoopMConnection(None, mconn.PlainFramedConn(a),
                                 [mconn.ChannelDescriptor(0x20)],
                                 on_receive=lambda ch, msg: None)
        return c._flush_linger_s
    finally:
        a.close()
        b.close()


def _switch_field(pkg, field, **cfg):
    from tendermint_tpu_torch.types.keys import PrivKey
    pub = PrivKey.generate(b"\x01" * 32).pubkey.ed25519
    if pkg == "port":
        from tendermint_tpu_torch import p2p
        from tendermint_tpu_torch.config import P2PConfig
        from tendermint_tpu_torch.p2p.switch import Switch
        sw = Switch(P2PConfig(**cfg), p2p.NodeKey(PrivKey.generate(
            b"\x01" * 32)), p2p.NodeInfo(pubkey=pub))
    else:
        from tendermint_tpu import p2p
        from tendermint_tpu.config import P2PConfig
        from tendermint_tpu.p2p.switch import Switch
        from tendermint_tpu.types.keys import PrivKey as JPrivKey
        c = P2PConfig()
        for k, v in cfg.items():
            setattr(c, k, v)
        sw = Switch(c, p2p.NodeKey(JPrivKey.generate(b"\x01" * 32)),
                    p2p.NodeInfo(pubkey=pub))
    return getattr(sw, field)


def _reactor(pkg, mode, monkeypatch):
    if pkg == "port":
        from tendermint_tpu_torch.config import resolve_reactor
        return resolve_reactor(mode)
    from tendermint_tpu.p2p.conn import loop as jloop
    monkeypatch.setattr(jloop, "_cfg_mode", jloop._cfg_mode)
    jloop.configure(mode)
    return jloop.resolve()


def _pipeline(pkg, mode, monkeypatch):
    if pkg == "port":
        from tendermint_tpu_torch import pipeline
    else:
        from tendermint_tpu import pipeline
    monkeypatch.setattr(pipeline, "_configured", pipeline._configured)
    pipeline.configure(mode)
    return pipeline.resolve()


def _compact(pkg, field, mode, monkeypatch):
    if pkg == "port":
        from tendermint_tpu_torch.config import ConsensusConfig, _mode_on
        from tendermint_tpu_torch.consensus import compact
        cc = ConsensusConfig(**{field: _mode_on(mode)})
        return (compact.compact_on if field == "compact"
                else compact.voteagg_on)(cc)
    from tendermint_tpu.consensus import compact as jcompact
    monkeypatch.setattr(jcompact, "_configured_compact",
                        jcompact._configured_compact)
    monkeypatch.setattr(jcompact, "_configured_voteagg",
                        jcompact._configured_voteagg)
    if field == "compact":
        jcompact.configure(compact_mode=mode)
        return jcompact.compact_on()
    jcompact.configure(voteagg_mode=mode)
    return jcompact.voteagg_on()


_RECOVERY_ATTRS = {"snapshot_interval": "_snap_interval",
                   "snapshot_keep": "_snap_keep",
                   "snapshot_chunk_kb": "_snap_chunk_kb",
                   "retain_heights": "_retain_heights",
                   "state_sync": "_state_sync"}


def _node_field(pkg, field, value, tmp_path):
    """A recovery setting of a fresh (unstarted) node on disk with
    base.<field> = value (None: the config's default)."""
    import os

    from tests.test_torch_snapshot import JAX, PORT, _gen
    P = PORT if pkg == "port" else JAX
    home = str(tmp_path / pkg)
    os.makedirs(home, exist_ok=True)
    gen, key = _gen(P, "knobs")
    pv = P.pv.PrivValidatorFile(os.path.join(home, "priv_validator.json"),
                                key)
    cfg = P.config.test_config(home)
    if P is PORT:
        cfg.base.verifier_backend = "python"
    if value is not None:
        setattr(cfg.base, field, value)
    node = P.node.Node(cfg, gen, priv_validator=pv, app=P.app())
    try:
        return getattr(node, _RECOVERY_ATTRS[field])
    finally:
        node.stop()


def _fresh(tmp_path):
    """A new directory under tmp_path for each call."""
    n = len(list(tmp_path.iterdir()))
    d = tmp_path / f"h{n}"
    d.mkdir()
    return d


def _native_off(pkg, mp):
    """The knob as a process started now reads it (the port reads it once
    a process, at its first `disabled()`)."""
    if pkg == "port":
        from tendermint_tpu_torch import native
        mp.setattr(native, "_no_native", None)
        return native.disabled()
    return jknobs.knob_set("TM_TPU_NO_NATIVE")


#: knob -> reader(pkg, config, monkeypatch, tmp_path) of its resolved
#: value at the plane's resolver, and its (env, config) cases
_SURFACE = {
    "TM_CUDA_VERIFIER": (
        lambda pkg, c, mp, tp: c if c not in (None, "auto")
        else _default_backend(pkg, mp),
        [(None, None), (None, "python"), ("python", None)]),
    "TM_CUDA_AUTO_THRESHOLD": (
        lambda pkg, c, mp, tp: _verifier_field(pkg, "auto_threshold",
                                               auto_threshold=c),
        [(None, None), ("64", None), ("64", 32)]),
    "TM_CUDA_COALESCE": (
        lambda pkg, c, mp, tp: _verifier_field(pkg, "coalesce", coalesce=c),
        [(None, None), (None, "off"), ("off", "on"), ("on", "off")]),
    "TM_CUDA_COALESCE_WAIT_MS": (
        lambda pkg, c, mp, tp: _verifier_field(pkg, "_coalesce_wait_s",
                                               coalesce_wait_ms=c),
        [(None, None), ("5", None), ("5", 1.0)]),
    "TM_CUDA_COALESCE_MAX_BATCH": (
        lambda pkg, c, mp, tp: _verifier_field(pkg, "_coalesce_max_batch",
                                               coalesce_max_batch=c),
        [(None, None), ("32", None), ("32", 16)]),
    "TM_CUDA_NO_NATIVE": (
        lambda pkg, c, mp, tp: _native_off(pkg, mp),
        [(None, None), ("1", None), ("0", None)]),
    "TM_CUDA_P2P_BURST": (
        lambda pkg, c, mp, tp: _burst(pkg, c or "auto", mp),
        [(None, None), (None, "off"), (None, "16"), ("off", "on"),
         ("8", "on"), ("on", "off")]),
    "TM_CUDA_P2P_FLUSH_LINGER_MS": (
        lambda pkg, c, mp, tp: _linger(pkg),
        [(None, None), ("0", None), ("10", None)]),
    "TM_CUDA_P2P_BAN_SCORE": (
        lambda pkg, c, mp, tp: _switch_field(
            pkg, "_ban_score", **({} if c is None else {"ban_score": c})),
        [(None, None), (None, 10), ("50", 10)]),
    "TM_CUDA_P2P_BAN_BASE_S": (
        lambda pkg, c, mp, tp: _switch_field(
            pkg, "_ban_base_s", **({} if c is None else {"ban_base_s": c})),
        [(None, None), (None, 5.0), ("7", 5.0)]),
    "TM_CUDA_P2P_FD_HEADROOM": (
        lambda pkg, c, mp, tp: _switch_field(
            pkg, "_fd_headroom",
            **({} if c is None else {"fd_headroom": c})),
        [(None, None), (None, 8), ("16", 8)]),
    "TM_CUDA_REACTOR": (
        lambda pkg, c, mp, tp: _reactor(pkg, c or "auto", mp),
        [(None, None), (None, "threads"), ("threads", "loop"),
         ("loop", "threads")]),
    "TM_CUDA_PIPELINE": (
        lambda pkg, c, mp, tp: _pipeline(pkg, c or "auto", mp),
        [(None, None), (None, "off"), ("off", "on"), ("on", "off")]),
    "TM_CUDA_COMPACT": (
        lambda pkg, c, mp, tp: _compact(pkg, "compact", c or "auto", mp),
        [(None, None), (None, "off"), ("off", "on"), ("on", "off")]),
    "TM_CUDA_VOTE_AGG": (
        lambda pkg, c, mp, tp: _compact(pkg, "vote_agg", c or "auto", mp),
        [(None, None), (None, "off"), ("off", "on"), ("on", "off")]),
}
for _field, _cases in (
        ("snapshot_interval", [(None, None), (None, 5), ("7", 5)]),
        ("snapshot_keep", [(None, None), (None, 3), ("4", 3)]),
        ("snapshot_chunk_kb", [(None, None), (None, 64), ("32", 64)]),
        ("retain_heights", [(None, None), (None, 10), ("20", 10)]),
        ("state_sync", [(None, None), (None, True), ("off", True)])):
    _SURFACE["TM_CUDA_" + _field.upper()] = (
        lambda pkg, c, mp, tp, f=_field: _node_field(pkg, f, c,
                                                      _fresh(tp)),
        _cases)

_SURFACE_CASES = [(k, env, cfg) for k, (_, cases) in _SURFACE.items()
                  for env, cfg in cases]


def test_the_surface_covers_every_knob_of_the_slice():
    import_time = {"TM_CUDA_HOST_TABLE_MIN", "TM_CUDA_HOST_TABLE_CACHE"}
    assert len(_SURFACE) + len(import_time) == 22
    assert set(_SURFACE) | import_time <= tknobs.NAMES


@pytest.mark.parametrize("name,env,config", _SURFACE_CASES)
def test_surface_knob_resolves_as_jax(monkeypatch, tmp_path, name, env,
                                      config):
    """env > config > default at the knob's resolver, equal to the JAX
    resolver at its call site on the same values."""
    read = _SURFACE[name][0]
    if env is not None:
        monkeypatch.setenv(name, env)
        monkeypatch.setenv(_jax_name(name), env)
    assert read("port", config, monkeypatch, tmp_path) == \
        read("jax", config, monkeypatch, tmp_path)


@pytest.mark.parametrize("name", sorted(_SURFACE))
def test_surface_tm_tpu_names_change_nothing_in_the_port(
        monkeypatch, tmp_path, name):
    read, cases = _SURFACE[name]
    env, config = next((e, c) for e, c in cases if e is not None)
    base = read("port", config, monkeypatch, tmp_path)
    monkeypatch.setenv(_jax_name(name), env)
    assert read("port", config, monkeypatch, tmp_path) == base, \
        f"{_jax_name(name)} reached the port"
    want = read("jax", config, monkeypatch, tmp_path)
    monkeypatch.setenv(name, env)
    assert read("port", config, monkeypatch, tmp_path) == want != base


_IMPORT_PROBE = """
import json
from tendermint_tpu.types import keys as jkeys
from tendermint_tpu.utils import ed25519_fast as jfast
from tendermint_tpu_torch.types import keys as tkeys
from tendermint_tpu_torch.utils import ed25519_fast as tfast
print(json.dumps([tkeys._HOST_TABLE_MIN, jkeys._HOST_TABLE_MIN,
                  tfast._TABLE_MAX, jfast._TABLE_MAX]))
"""


@pytest.mark.parametrize("env", [{}, {"TM_CUDA_HOST_TABLE_MIN": "9",
                                      "TM_TPU_HOST_TABLE_MIN": "9",
                                      "TM_CUDA_HOST_TABLE_CACHE": "17",
                                      "TM_TPU_HOST_TABLE_CACHE": "17"},
                                 {"TM_TPU_HOST_TABLE_MIN": "9",
                                  "TM_TPU_HOST_TABLE_CACHE": "17"}])
def test_host_table_knobs_read_at_import_as_jax(env):
    """The host oracle's gate and cache, read once at import in a fresh
    interpreter: the port's TM_CUDA_* names as the JAX package's TM_TPU_*
    ones, and a TM_TPU_* name alone leaves the port at its default."""
    import json
    import os
    import subprocess
    import sys
    full = {k: v for k, v in os.environ.items()
            if not k.startswith(("TM_CUDA_HOST_TABLE", "TM_TPU_HOST_TABLE"))}
    full.update(env, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _IMPORT_PROBE],
                         cwd=str(PORT.parent), env=full, check=True,
                         capture_output=True, text=True, timeout=120)
    tmin, jmin, tcache, jcache = json.loads(out.stdout.splitlines()[-1])
    assert (jmin, jcache) == (int(env.get("TM_TPU_HOST_TABLE_MIN", 4)),
                              int(env.get("TM_TPU_HOST_TABLE_CACHE", 256)))
    assert (tmin, tcache) == (int(env.get("TM_CUDA_HOST_TABLE_MIN", 4)),
                              int(env.get("TM_CUDA_HOST_TABLE_CACHE", 256)))
