"""The port's sampling profiler and queue observatory
(telemetry/profile.py, telemetry/queues.py) against the JAX package's,
on the CPU, tolerance 0.

- Classification: a frame's subsystem is the package subdirectory (or
  top-level module) of the first in-package frame from the leaf up; the
  port's classifier names the same subsystem for a port file as the JAX
  classifier for the same JAX file, and a JAX package file is `other` to
  the port (tendermint_tpu_torch/ begins with tendermint_tpu: the prefix
  carries the separator).
- Synthetic frame stacks (busy, lock-wait, the event loop's `_invoke`
  owner tag, a loop-only stack, foreign-only stacks, the stack cap)
  recorded by both profilers give equal collapsed stacks, subsystem
  counts, shares, lock-wait counts and drop counts.
- Thread-name normalization equal. No test reads a wall-clock share.
- The queue observatory on the same fake queues: equal tables (depth,
  capacity, saturation, high water, instances, episodes), the fullest
  instance wins, the watchdog fires once an episode, and off registers
  nothing.
"""

import os
from types import SimpleNamespace

import pytest

import tendermint_tpu
import tendermint_tpu_torch
from tendermint_tpu.telemetry import profile as jprof
from tendermint_tpu.telemetry import queues as jq
from tendermint_tpu_torch.telemetry import profile as tprof
from tendermint_tpu_torch.telemetry import queues as tq

JDIR = os.path.dirname(os.path.abspath(tendermint_tpu.__file__))
TDIR = os.path.dirname(os.path.abspath(tendermint_tpu_torch.__file__))
THREADING = os.path.join(os.path.dirname(os.__file__), "threading.py")
SITE = os.path.join(os.sep, "site-packages", "numpy", "core", "numeric.py")

RELS = ("consensus/state.py", "models/verifier.py", "p2p/conn/mconn.py",
        "node.py", "cli.py", "rpc/core.py", "telemetry/profile.py",
        "ops/ed25519.py", "state/execution.py")


def test_profiler_dir_is_the_ports_with_the_separator():
    assert tprof._PKG_DIR == TDIR + os.sep
    assert jprof._PKG_DIR == JDIR + os.sep
    assert tprof._PKG_DIR.startswith(JDIR)   # the prefix hazard


@pytest.mark.parametrize("rel", RELS)
def test_classification_as_jax_and_jax_frames_are_other(rel):
    tpath = os.path.join(TDIR, *rel.split("/"))
    jpath = os.path.join(JDIR, *rel.split("/"))
    assert tprof._subsystem_of(tpath) == jprof._subsystem_of(jpath)
    assert tprof._subsystem_of(tpath) is not None
    assert tprof._subsystem_of(jpath) is None
    assert jprof._subsystem_of(tpath) is None
    assert tprof._subsystem_of(SITE) is None


def _frames(base, chain, owner=None):
    """A synthetic frame stack, root first: (relative path, function)
    pairs; an absolute path stays as given. The `_invoke` frame of the
    loop carries `owner` in its locals."""
    frame = None
    for path, fn in chain:
        full = path if os.path.isabs(path) else os.path.join(
            base, *path.split("/"))
        local = {"__owner__": owner} if fn == "_invoke" else {}
        frame = SimpleNamespace(
            f_code=SimpleNamespace(co_filename=full, co_name=fn),
            f_back=frame, f_locals=local)
    return frame


STACKS = [
    ("tm-consensus-1", [("node.py", "start"),
                        ("consensus/state.py", "_enter_commit"),
                        ("models/verifier.py", "resolve")], None),
    ("tm-consensus-1", [("node.py", "start"),
                        ("consensus/state.py", "_enter_commit"),
                        ("models/verifier.py", "resolve"),
                        (THREADING, "wait")], None),
    ("tm-reactor-loop-12", [("p2p/conn/loop.py", "_run"),
                            ("p2p/conn/loop.py", "_invoke"),
                            ("consensus/reactor.py", "_gossip_pass")],
     "consensus"),
    ("tm-reactor-loop-12", [("p2p/conn/loop.py", "_run"),
                            ("p2p/conn/loop.py", "_invoke"),
                            ("p2p/conn/loop.py", "_on_readable")], "rpc"),
    ("tm-reactor-loop-12", [("p2p/conn/loop.py", "_run"),
                            ("rpc/aserver.py", "_on_accept")], None),
    ("Thread-3 (worker)", [(SITE, "dot"), (SITE, "inner")], None),
    ("MainThread", [(THREADING, "join"), (THREADING, "wait")], None),
    ("tm-verify-coalesce", [("models/coalescer.py", "_run"),
                            ("models/verifier.py", "_verify_async"),
                            ("ops/ed25519.py", "verify_prepared_async")],
     None),
]


def _record_all(mod, base, max_stacks=8192, reps=3):
    p = mod.SamplingProfiler(hz=50, max_stacks=max_stacks)
    for r in range(reps):
        for thread, chain, owner in STACKS[:len(STACKS) - r]:
            p._record(_frames(base, chain, owner),
                      mod._normalize_thread(thread))
    snap = p.snapshot()
    for k in ("wall_ns", "started_ns"):
        snap.pop(k)
    return snap


@pytest.mark.parametrize("max_stacks", [8192, 4])
def test_synthetic_stacks_record_as_jax(max_stacks):
    got = _record_all(tprof, TDIR, max_stacks)
    want = _record_all(jprof, JDIR, max_stacks)
    assert got == want
    if max_stacks == 4:
        assert got["stacks_dropped"] > 0
        assert "(truncated)" in got["collapsed"]
    else:
        assert got["subsystems"]["consensus"] == 3
        assert got["subsystems"]["rpc"] == 3
        assert got["subsystems"]["loop"] == 3
        assert got["lock_wait"] == {"models": 3, "other": 2}
        assert "[lock_wait]" in got["collapsed"]


def test_port_profiler_charges_jax_frames_to_other():
    p = tprof.SamplingProfiler(hz=50)
    for thread, chain, owner in STACKS:
        p._record(_frames(JDIR, chain, owner), thread)
    subs = set(p.snapshot()["subsystems"]) | \
        set(p.snapshot()["lock_wait"])
    # loop frames of the JAX package are not the port's loop files
    # either: everything lands in `other`
    assert subs == {"other"}


@pytest.mark.parametrize("name", ["Thread-12 (worker)", "tm-verify-fetch-3",
                                  "mconn-send", "rpc-http", "tm-rpc-worker_0",
                                  "tm-reactor-loop-4242", "MainThread", "7"])
def test_thread_name_normalization_as_jax(name):
    assert tprof._normalize_thread(name) == jprof._normalize_thread(name)


# ---------------------------------------------------- queue observatory

class _Q:
    def __init__(self):
        self.items = []


@pytest.fixture
def observatories(monkeypatch):
    for k in ("TM_TPU_QUEUE_WATCH", "TM_CUDA_QUEUE_WATCH"):
        monkeypatch.delenv(k, raising=False)
    for m in (jq, tq):
        m.configure("on")
        m.clear_callbacks()
    yield
    for m in (jq, tq):
        m.configure("on")
        m.clear_callbacks()


def _table(mod, prefix):
    return {k: {f: v for f, v in row.items()
                if f not in ("wait_s", "saturated_s")}
            for k, row in mod.table().items() if k.startswith(prefix)}


def _queue_script(mod, tag):
    prefix = f"test.{tag}."
    a, b, c = _Q(), _Q(), _Q()
    probes = [mod.register(prefix + "multi", a,
                           depth=lambda o: len(o.items), capacity=10),
              mod.register(prefix + "multi", b,
                           depth=lambda o: len(o.items), capacity=10),
              mod.register(prefix + "sat", c,
                           depth=lambda o: len(o.items),
                           capacity=lambda o: 10)]
    fired = []
    mod.on_saturation(lambda k, s, d: fired.append((k, d)) if
                      k.startswith(prefix) else None)
    out = []
    for items_a, items_b, items_c in ((1, 5, 9), (2, 0, 10), (0, 0, 1),
                                      (3, 3, 10), (0, 0, 0)):
        a.items, b.items, c.items = [0] * items_a, [0] * items_b, \
            [0] * items_c
        mod.poll()
        out.append((_table(mod, prefix),
                    [k for k in mod.saturated() if k.startswith(prefix)]))
    probes[1].close()
    mod.poll()
    out.append(_table(mod, prefix))
    for p in probes:
        p.close()
    return [str(x).replace(prefix, "") for x in out], \
        [(k.replace(prefix, ""), d) for k, d in fired]


def test_queue_observatory_as_jax(observatories):
    got, got_fired = _queue_script(tq, "port")
    want, want_fired = _queue_script(jq, "jax")
    assert got == want
    assert got_fired == want_fired == [("sat", 9), ("sat", 10)]


def test_observatory_off_registers_nothing(observatories, monkeypatch):
    monkeypatch.setenv("TM_CUDA_QUEUE_WATCH", "off")
    q = _Q()
    probe = tq.register("test.off", q, depth=lambda o: 0, capacity=1)
    assert isinstance(probe, tq._NoopProbe)
    tq.poll()
    assert "test.off" not in tq.table()
