"""The port's knob catalog (tendermint_tpu_torch/utils/knobs.py) against
the JAX package's (tendermint_tpu/utils/knobs.py), on the CPU.

- The readers give env > config > default in both packages, with the
  same values for the same inputs (the port's TM_CUDA_* name, the JAX
  package's TM_TPU_* one), for every reader and kind.
- A TM_TPU_* variable changes nothing in the port: each plane the port
  gates on a knob (telemetry, trace, trace cap, profiler and its rate,
  queue observatory, SLO and its rate, divergence, the shard count, the
  edge replicas' lag threshold, the front door's connection cap and
  rate, the device mesh and its forced device count) reads only its
  TM_CUDA_* name, and that name wins over the plane's config. The front door's pair and the shard count resolve as
  the JAX package's do (an explicit argument, then env, then default).
- The catalog holds every knob the port reads, each a TM_CUDA_* name
  with a JAX counterpart of the same kind, default and config field
  (TM_CUDA_NODE_PROFILE's counterpart is the JAX CLI's TM_NODE_PROFILE,
  which the JAX catalog does not list, and TM_CUDA_MESH_FORCE_DEVICES's
  is TM_TPU_MESH_FORCE_HOST_DEVICES); every TM_CUDA_* name in the
  port's sources is in the catalog, and reading an unknown one raises.
"""

import re
from pathlib import Path

import pytest

from tendermint_tpu.utils import knobs as jknobs
from tendermint_tpu_torch.utils import knobs as tknobs

PORT = Path(__file__).resolve().parent.parent / "tendermint_tpu_torch"

SLICE_KNOBS = ("TM_CUDA_MESH", "TM_CUDA_MESH_FORCE_DEVICES",
               "TM_CUDA_TELEMETRY", "TM_CUDA_TRACE", "TM_CUDA_TRACE_CAP",
               "TM_CUDA_TRACE_STALL_S", "TM_CUDA_PROF", "TM_CUDA_PROF_HZ",
               "TM_CUDA_QUEUE_WATCH", "TM_CUDA_SLO", "TM_CUDA_SLO_SAMPLE",
               "TM_CUDA_DIVERGENCE", "TM_CUDA_NODE_PROFILE",
               "TM_CUDA_STATE_TREE", "TM_CUDA_CHAOS", "TM_CUDA_LOCKCHECK",
               "TM_CUDA_SHARDS", "TM_CUDA_EDGE_MAX_LAG",
               "TM_CUDA_RPC_MAX_CONNS", "TM_CUDA_RPC_RATE")


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
    assert set(SLICE_KNOBS) == tknobs.NAMES
    for k in tknobs.CATALOG:
        assert k.name.startswith("TM_CUDA_")
        if k.name == "TM_CUDA_NODE_PROFILE":
            continue
        j = jknobs.get(_jax_name(k.name))
        assert (k.kind, k.config) == (j.kind, j.config), k.name
        if k.name in SLICE_KNOBS[-4:]:
            assert (k.default, k.where) == (j.default, j.where), k.name
    assert "TM_CUDA_TELEMETRY" in tknobs.knobs_md()


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
