"""The verifier's families and the causal `verify.dispatch` span around a
B1 launch on the card (tests marked `cuda`; they skip without one).

A verify of 4 signatures on BatchVerifier("cuda") pads to 8 lanes and
launches B1 (csrc/ladder.cu ladder_kernel<true>) once. The families
move by exactly that call: verifier_calls_total{backend="cuda"} by 1,
verifier_sigs_total{backend="cuda"} by 4, verifier_batch_size and
verifier_dispatch_seconds{backend="cuda"} by one observation, and the
chunk occupancy by one chunk of 4/8. The dispatch seconds and the span
run from the dispatch to the verdicts on the host, so each covers the
device time of the same batch's upload and launch (CUDA events around
it on the stream) and lies within the call's wall time. It needs no
jax: `python -m pytest
--noconftest -m cuda tests/test_torch_telemetry_card.py`.
"""

import hashlib
import time

import pytest
import torch

from tendermint_tpu_torch import telemetry
from tendermint_tpu_torch.models.verifier import BatchVerifier
from tendermint_tpu_torch.ops import ed25519, ladder
from tendermint_tpu_torch.telemetry import causal
from tendermint_tpu_torch.types.keys import PrivKey


def _items(n, bad=()):
    out = []
    for i in range(n):
        k = PrivKey.generate(hashlib.sha256(b"card/%d" % i).digest())
        msg = b"precommit %d" % i
        sig = k.sign(msg)
        if i in bad:
            sig = sig[:-1] + bytes([sig[-1] ^ 1])
        out.append((k.pubkey.ed25519, msg, sig))
    return out


def _v(name, labels=None, field=None):
    x = telemetry.value(name, labels)
    if field is not None:
        return 0 if x is None else x[field]
    return x or 0


@pytest.mark.cuda
def test_verifier_families_and_dispatch_span_around_b1():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    telemetry.set_enabled(True)
    causal.configure("on")
    causal.clear()
    try:
        v = BatchVerifier("cuda", coalesce="off")
        v.warmup(4)
        items = _items(4, bad=(2,))
        cuda = {"backend": "cuda"}
        before = (_v("verifier_calls_total", cuda),
                  _v("verifier_sigs_total", cuda),
                  _v("verifier_dispatch_seconds", cuda, "count"),
                  _v("verifier_dispatch_seconds", cuda, "sum"),
                  _v("verifier_batch_size", None, "count"),
                  _v("verifier_chunk_occupancy", None, "sum"),
                  dict(ladder.launches))
        causal.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = v.verify(items)
        wall = time.perf_counter() - t0
        assert ok.tolist() == [True, True, False, True]
        assert _v("verifier_calls_total", cuda) - before[0] == 1
        assert _v("verifier_sigs_total", cuda) - before[1] == 4
        assert _v("verifier_dispatch_seconds", cuda, "count") \
            - before[2] == 1
        dispatch_s = _v("verifier_dispatch_seconds", cuda, "sum") \
            - before[3]
        assert _v("verifier_batch_size", None, "count") - before[4] == 1
        assert _v("verifier_chunk_occupancy", None, "sum") \
            - before[5] == pytest.approx(0.5)
        assert ladder.launches["verify"] - before[6]["verify"] == 1
        assert ladder.launches["verify_pre"] == before[6]["verify_pre"]
        spans = [ev for ev in causal.dump()["spans"]
                 if ev["n"] == "verify.dispatch"]
        assert len(spans) == 1
        span_s = spans[0]["d"] / 1e9
        assert spans[0]["a"] == {"n": 4, "backend": "cuda"}
        # the same batch's upload and B1 launch alone, timed by CUDA
        # events on the stream: the dispatch time and the span close on
        # the verdicts, so each covers it
        pk, rb, sb, hb, _ = ed25519.prep_items(items)
        s = torch.cuda.current_stream(v.device)
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record(s)
        ed25519.verify_prepared_async(pk, rb, sb, hb, device=v.device)
        b.record(s)
        b.synchronize()
        kernel_s = a.elapsed_time(b) / 1e3
        assert kernel_s * 0.9 <= dispatch_s <= wall
        assert kernel_s * 0.9 <= span_s <= wall
    finally:
        causal.configure("off")
        causal.clear()
