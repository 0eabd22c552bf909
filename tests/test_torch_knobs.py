"""The port's knob catalog (tendermint_tpu_torch/utils/knobs.py) against
the JAX package's (tendermint_tpu/utils/knobs.py), on the CPU.

- The readers give env > config > default in both packages, with the
  same values for the same inputs (the port's TM_CUDA_* name, the JAX
  package's TM_TPU_* one), for every reader and kind.
- A TM_TPU_* variable changes nothing in the port: each plane the port
  gates on a knob (telemetry, trace, trace cap, profiler and its rate,
  queue observatory, SLO and its rate, divergence) reads only its
  TM_CUDA_* name, and that name wins over the plane's config.
- The catalog holds every knob the port reads, each a TM_CUDA_* name
  with a JAX counterpart of the same kind, default and config field
  (TM_CUDA_NODE_PROFILE's counterpart is the JAX CLI's TM_NODE_PROFILE,
  which the JAX catalog does not list); every TM_CUDA_* name in the
  port's sources is in the catalog, and reading an unknown one raises.
"""

import re
from pathlib import Path

import pytest

from tendermint_tpu.utils import knobs as jknobs
from tendermint_tpu_torch.utils import knobs as tknobs

PORT = Path(__file__).resolve().parent.parent / "tendermint_tpu_torch"

SLICE_KNOBS = ("TM_CUDA_TELEMETRY", "TM_CUDA_TRACE", "TM_CUDA_TRACE_CAP",
               "TM_CUDA_TRACE_STALL_S", "TM_CUDA_PROF", "TM_CUDA_PROF_HZ",
               "TM_CUDA_QUEUE_WATCH", "TM_CUDA_SLO", "TM_CUDA_SLO_SAMPLE",
               "TM_CUDA_DIVERGENCE", "TM_CUDA_NODE_PROFILE",
               "TM_CUDA_STATE_TREE", "TM_CUDA_CHAOS", "TM_CUDA_LOCKCHECK")


def _jax_name(name: str) -> str:
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
    ]


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


@pytest.mark.parametrize("i", range(8))
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
