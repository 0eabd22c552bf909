"""Batched Ed25519 verification and signing: host prep, the
predecompression cache, the routing of padded chunks to the verify
kernels, and batched RFC 8032 signing around the r*B kernel.

Counterpart of `tendermint_tpu/ops/ed25519.py`. Verify:

  host    SHA-512 of (R || A || M), h mod L, the s < L malleability
          check: in C++ (`tendermint_tpu_torch.native`: prep_items for the
          verifier's items, tm_ed25519_prepare here), in hashlib for
          batches of malformed lengths (`prepare_batch_bytes_plain`)
  device  the double-scalar ladder of `ops/ladder.py`, on the CUDA kernel
          when the tensors are on the card, on its plain version on the CPU

Every padded chunk goes to a kernel: a batch of mostly unseen keys to the
fused kernel ("full"), a batch of seen keys to the predecompressed one
after decompressing them once ("fill") or from cached rows ("hit"). The
CUDA kernel has no tile constraint, but `_bucket` padding is kept so that
the cache sees the same batches, and counts the same outcomes, as the JAX
package.

Sign: the nonces r = SHA-512(prefix || M) mod L and the finish
s = (r + SHA-512(R || A || M) * a) mod L run on the host in C++ (the
native sign phases; `sign_phase1_plain`/`sign_phase2_plain` are the
hashlib versions); R = r*B runs on the sign kernel of `ops/ladder.py`.
There is no scalar fallback: on the card the kernel launches or the call
raises.

`prep_stats()` counts the items each route prepared.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict

import numpy as np
import torch

from tendermint_tpu_torch import native
from tendermint_tpu_torch.ops import curve
from tendermint_tpu_torch.ops import field as fe
from tendermint_tpu_torch.ops import ladder
from tendermint_tpu_torch.utils import device as _device
from tendermint_tpu_torch.utils import ed25519_fast

L_ORDER = (1 << 252) + 27742317777372353535851937790883648493


# ---------------------------------------------------------------------------
# Host preparation
# ---------------------------------------------------------------------------

# items prepared per route: verify prep in C++ ("native") or hashlib
# ("plain"), signing phases in C++ ("sign_native") or hashlib
# ("sign_plain", under TM_CUDA_NO_NATIVE)
_prep_stats = {"native": 0, "plain": 0, "sign_native": 0, "sign_plain": 0}
_prep_stats_lock = threading.Lock()


def _count_prep(route: str, n: int) -> None:
    with _prep_stats_lock:
        _prep_stats[route] += n


def prep_stats() -> dict:
    """Snapshot of the items prepared by each route."""
    with _prep_stats_lock:
        return dict(_prep_stats)


def prep_items(items):
    """The verifier's one-call prep (`native.prep_items`): (pk, R, s, h
    u8[N,32], precheck bool[N]), or None when the batch needs the
    general path (a secp256k1 key, a member that is not `bytes`, an item
    that is not a triple, or TM_CUDA_NO_NATIVE)."""
    if native.disabled():
        return None
    out = native.prep_items(items)
    if out is not None:
        _count_prep("native", len(items))
    return out


def prepare_batch_bytes(pubkeys, msgs, sigs):
    """(pubkeys u8[N,32], R u8[N,32], s u8[N,32], h u8[N,32], precheck
    bool[N]). precheck is False for malformed inputs (bad lengths,
    s >= L); their rows stay zero so the batch shape is unchanged.

    When every pubkey is 32 bytes and every signature 64, the whole
    batch is prepared in one C call (`native.ed25519_prepare`); the
    hashlib loop is the malformed-length path, and every batch's under
    TM_CUDA_NO_NATIVE."""
    n = len(pubkeys)
    pk_list = [bytes(p) for p in pubkeys]
    sg_list = [bytes(s) for s in sigs]
    if n > 0 and not native.disabled() and \
            all(len(p) == 32 for p in pk_list) and \
            all(len(s) == 64 for s in sg_list):
        pk_cat = b"".join(pk_list)
        sg_cat = b"".join(sg_list)
        h_bytes, pre = native.ed25519_prepare(pk_cat, sg_cat,
                                              [bytes(m) for m in msgs])
        sg = np.frombuffer(sg_cat, np.uint8).reshape(n, 64)
        pk = np.frombuffer(pk_cat, np.uint8).reshape(n, 32).copy()
        rb = sg[:, :32].copy()
        s_bytes = np.where(pre[:, None], sg[:, 32:], 0).astype(np.uint8)
        pk[~pre] = 0
        rb[~pre] = 0
        _count_prep("native", n)
        return pk, rb, s_bytes, h_bytes, pre
    _count_prep("plain", n)
    return prepare_batch_bytes_plain(pubkeys, msgs, sigs)


def prepare_batch_bytes_plain(pubkeys, msgs, sigs):
    """prepare_batch_bytes item by item in hashlib and Python ints."""
    n = len(pubkeys)
    pk = np.zeros((n, 32), np.uint8)
    rb = np.zeros((n, 32), np.uint8)
    s_bytes = np.zeros((n, 32), np.uint8)
    h_bytes = np.zeros((n, 32), np.uint8)
    pre = np.zeros(n, np.bool_)
    for i in range(n):
        p, m, sg = bytes(pubkeys[i]), bytes(msgs[i]), bytes(sigs[i])
        if len(p) != 32 or len(sg) != 64:
            continue
        s = int.from_bytes(sg[32:], "little")
        if s >= L_ORDER:
            continue
        h = int.from_bytes(
            hashlib.sha512(sg[:32] + p + m).digest(), "little") % L_ORDER
        pk[i] = np.frombuffer(p, np.uint8)
        rb[i] = np.frombuffer(sg[:32], np.uint8)
        s_bytes[i] = np.frombuffer(sg[32:], np.uint8)
        h_bytes[i] = np.frombuffer(h.to_bytes(32, "little"), np.uint8)
        pre[i] = True
    return pk, rb, s_bytes, h_bytes, pre


def bits_from_bytes_dev(b_u8):
    """uint8[..., 32] -> int32[..., 256] little-endian bits, on b's device."""
    b = b_u8.to(torch.int32)
    bits = (b.unsqueeze(-1) >> torch.arange(8, dtype=torch.int32,
                                            device=b.device)) & 1
    return bits.reshape(b.shape[:-1] + (256,))


def _pad_to(x: np.ndarray, n: int) -> np.ndarray:
    if x.shape[0] == n:
        return x
    pad = np.zeros((n - x.shape[0],) + x.shape[1:], x.dtype)
    return np.concatenate([x, pad], axis=0)


def _bucket(n: int, min_size: int = 8) -> int:
    """Round a batch size up to a power of two (at least min_size)."""
    b = min_size
    while b < n:
        b *= 2
    return b


def _upload(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


# ---------------------------------------------------------------------------
# Predecompressed-pubkey cache (stable validator sets)
# ---------------------------------------------------------------------------
# Decompressing A is a field square root, about 8% of a verify; consensus
# verifies the same validator keys commit after commit. Rows are keyed
# per 32-byte pubkey: the canonical bytes of (-A).x and A.y and the
# validity flag, host-resident, re-assembled and uploaded per batch.

_PREDECOMP_MAX_KEYS = 16384  # rows; covers a 10k-validator set
# padded batches below this skip the cache
_PREDECOMP_MIN_BATCH = 64
# pubkey -> (xneg_bytes u8[32], y_bytes u8[32], ok bool)
_predecomp: "OrderedDict[bytes, tuple]" = OrderedDict()
# pubkeys sighted once: a first sighting stays on the fused kernel
_predecomp_seen: "OrderedDict[bytes, bool]" = OrderedDict()
# hit   = batch fully served from cached rows (pre kernel, no sqrt)
# fill  = repeat-traffic batch decompressed once + rows stored
# full  = mostly-unseen batch routed to the fused kernel
# evict = per-pubkey rows dropped by the LRU
_predecomp_stats = {"hit": 0, "fill": 0, "full": 0, "evict": 0}
# one lock guards both cache dicts and the counters: batches dispatch
# from several threads, and OrderedDict mutation is not thread-safe
_predecomp_lock = threading.Lock()


def _predecomp_note(outcome: str, n: int = 1) -> None:
    """Count a cache outcome in the plain counters and mirror it into
    the verifier_predecomp_* families (registered by models/verifier;
    lazy import, models.verifier is loaded in any process that
    dispatches batches here). Called under _predecomp_lock."""
    _predecomp_stats[outcome] += n
    from tendermint_tpu_torch.models import verifier
    if outcome == "evict":
        verifier._m_predecomp_evictions.inc(n)
    else:
        verifier._m_predecomp.labels(outcome).inc(n)
    verifier._m_predecomp_keys.set(len(_predecomp))


def predecomp_stats() -> dict:
    """Snapshot of the cache counters: hit/fill/full batch outcomes, row
    evictions, resident keys, and the batch hit rate."""
    with _predecomp_lock:
        s = dict(_predecomp_stats)
        s["keys"] = len(_predecomp)
    routed = s["hit"] + s["fill"] + s["full"]
    s["hit_rate"] = round(s["hit"] / routed, 4) if routed else 0.0
    return s


def install_predecomp_rows(rows: dict) -> None:
    """Store cached rows {pubkey: (xneg u8[32], y u8[32], ok)} (the
    state `convert.state_from_jax` carries across)."""
    with _predecomp_lock:
        for k, (xn, y, ok) in rows.items():
            _predecomp[bytes(k)] = (np.asarray(xn, np.uint8).copy(),
                                    np.asarray(y, np.uint8).copy(), bool(ok))
        while len(_predecomp) > _PREDECOMP_MAX_KEYS:
            _predecomp.popitem(last=False)
            _predecomp_note("evict")


def _decompress_to_bytes(pk_u8):
    """(-A).x and A.y as canonical field bytes, with the validity mask
    (the inputs of the predecompressed kernel). Plain PyTorch."""
    (x, y, _one, _t), ok = curve.decompress(pk_u8)
    return fe.to_bytes(fe.neg(x)), fe.to_bytes(y), ok


def _predecomp_rows(pk_np, device):
    """The predecompressed kernel's key rows for a batch, (-A).x u8[n,32],
    A.y u8[n,32], ok bool[n] on the host: stacked from cached rows (hit),
    or decompressed once on `device` and stored (fill). None when the
    batch holds unseen keys (full): it then takes the fused kernel while
    its keys are marked seen, and the next batch over them fills rows."""
    n = pk_np.shape[0]
    raw = pk_np.tobytes()
    keys = [raw[i * 32:(i + 1) * 32] for i in range(n)]
    with _predecomp_lock:
        rows = [_predecomp.get(k) for k in keys]
        miss = {k for k, r in zip(keys, rows) if r is None}
        if not miss:
            for k in keys:
                _predecomp.move_to_end(k)
            _predecomp_note("hit")
        else:
            fresh = miss - _predecomp_seen.keys()
            for k in fresh:
                _predecomp_seen[k] = True
            while len(_predecomp_seen) > 4 * _PREDECOMP_MAX_KEYS:
                _predecomp_seen.popitem(last=False)
            if fresh:
                _predecomp_note("full")
                return None
            _predecomp_note("fill")
    if not miss:
        return (np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows]),
                np.array([r[2] for r in rows], np.bool_))
    # decompress the whole batch once, outside the lock; a concurrent
    # duplicate fill is harmless (same key, same bytes)
    xnb_d, yb_d, ok_d = _decompress_to_bytes(_upload(pk_np, device))
    xnb_h, yb_h = xnb_d.cpu().numpy(), yb_d.cpu().numpy()
    ok_h = ok_d.cpu().numpy()
    with _predecomp_lock:
        for i, k in enumerate(keys):
            if k not in _predecomp:
                _predecomp[k] = (xnb_h[i].copy(), yb_h[i].copy(),
                                 bool(ok_h[i]))
        while len(_predecomp) > _PREDECOMP_MAX_KEYS:
            _predecomp.popitem(last=False)
            _predecomp_note("evict")
    return xnb_h, yb_h, ok_h


def _verify_cached_predecomp(pk_np, rb, s_bytes, h_bytes, device):
    """Verdicts through the predecompressed kernel, or None when the
    batch holds unseen keys (see _predecomp_rows)."""
    rows = _predecomp_rows(pk_np, device)
    if rows is None:
        return None
    return ladder.verify_pre(*(_upload(x, device) for x in
                               (*rows, rb, s_bytes, h_bytes)))


# ---------------------------------------------------------------------------
# End-to-end batch verify (host prep + kernel)
# ---------------------------------------------------------------------------

def verify_prepared_async(pk, rb, s_bytes, h_bytes, device=None):
    """Dispatch prepared arrays (prepare_batch_bytes minus the precheck):
    pad to the bucket, route through the predecompression cache, launch.
    Returns bool[m] verdicts on `device` (m the padded size), enqueued on
    the current stream; the caller masks with its precheck."""
    device = _device.resolve(device)
    m = _bucket(pk.shape[0])
    pk_p = _pad_to(pk, m)
    rb_p, sb_p, hb_p = (_pad_to(rb, m), _pad_to(s_bytes, m),
                        _pad_to(h_bytes, m))
    if m >= _PREDECOMP_MIN_BATCH:
        res = _verify_cached_predecomp(pk_p, rb_p, sb_p, hb_p, device)
        if res is not None:
            return res
    return ladder.verify(_upload(pk_p, device), _upload(rb_p, device),
                         _upload(sb_p, device), _upload(hb_p, device))


def verify_batch_async(pubkeys, msgs, sigs, device=None):
    """Prepare and dispatch one padded batch without waiting:
    (device verdicts bool[m], precheck bool[N])."""
    pk, rb, s_bytes, h_bytes, pre = prepare_batch_bytes(pubkeys, msgs, sigs)
    res = verify_prepared_async(pk, rb, s_bytes, h_bytes, device=device)
    return res, pre


def verify_batch(pubkeys, msgs, sigs, device=None) -> np.ndarray:
    """Verify N (pubkey, msg, sig) triples; returns bool[N]."""
    device = _device.resolve(device)
    n = len(pubkeys)
    if n == 0:
        return np.zeros(0, np.bool_)
    res, pre = verify_batch_async(pubkeys, msgs, sigs, device=device)
    return res.cpu().numpy()[:n] & pre


# ---------------------------------------------------------------------------
# Batched signing (host nonce and finish + the r*B kernel)
# ---------------------------------------------------------------------------

# signatures per r*B launch: signing is bulk work (chain builders, load
# generators), so it takes larger chunks than the verifier's 8192
SIGN_CHUNK = 16384
_SIGN_PARAMS_MAX = 4096

_sign_params_cache: dict = {}
_sign_params_lock = threading.Lock()


def signing_params(seed: bytes):
    """(a32 clamped, prefix32, pk32) for an RFC 8032 seed, cached per
    seed (the cache is cleared when it passes 4096 seeds)."""
    with _sign_params_lock:
        ent = _sign_params_cache.get(seed)
    if ent is None:
        h = hashlib.sha512(seed).digest()
        a = bytearray(h[:32])
        a[0] &= 248
        a[31] &= 127
        a[31] |= 64
        ent = (bytes(a), h[32:], ed25519_fast.public_key(seed))
        with _sign_params_lock:
            if len(_sign_params_cache) > _SIGN_PARAMS_MAX:
                _sign_params_cache.clear()
            _sign_params_cache[seed] = ent
    return ent


def _check_msgs(msgs) -> None:
    for m in msgs:
        if not isinstance(m, bytes):
            raise TypeError("msgs must be bytes")


def sign_phase1(prefixes: bytes, msgs) -> bytes:
    """The nonces r (32 bytes each) of signing, in C++
    (`native.sign_phase1`); sign_phase1_plain under TM_CUDA_NO_NATIVE."""
    if native.disabled():
        return sign_phase1_plain(prefixes, msgs)
    return native.sign_phase1(prefixes, msgs)


def sign_phase2(renc: bytes, pks: bytes, msgs, rs: bytes,
                as_: bytes) -> bytes:
    """The signatures from enc(r*B), in C++ (`native.sign_phase2`);
    sign_phase2_plain under TM_CUDA_NO_NATIVE."""
    if native.disabled():
        return sign_phase2_plain(renc, pks, msgs, rs, as_)
    return native.sign_phase2(renc, pks, msgs, rs, as_)


def sign_phase1_plain(prefixes: bytes, msgs) -> bytes:
    """sign_phase1 in hashlib and Python ints, with the same refusals."""
    n = len(msgs)
    if len(prefixes) != 32 * n:
        raise ValueError("prefixes must be n*32 bytes")
    _check_msgs(msgs)
    return b"".join(
        (int.from_bytes(hashlib.sha512(prefixes[32 * i:32 * i + 32]
                                       + msgs[i]).digest(), "little")
         % L_ORDER).to_bytes(32, "little")
        for i in range(n))


def sign_phase2_plain(renc: bytes, pks: bytes, msgs, rs: bytes,
                      as_: bytes) -> bytes:
    """sign_phase2 in hashlib and Python ints, with the same refusals."""
    n = len(msgs)
    if not len(renc) == len(pks) == len(rs) == len(as_) == 32 * n:
        raise ValueError("scalar blobs must be n*32")
    _check_msgs(msgs)
    out = []
    for i in range(n):
        lo, hi = 32 * i, 32 * i + 32
        r_enc = renc[lo:hi]
        k = int.from_bytes(hashlib.sha512(r_enc + pks[lo:hi]
                                          + msgs[i]).digest(), "little")
        s = (int.from_bytes(rs[lo:hi], "little") + k % L_ORDER
             * int.from_bytes(as_[lo:hi], "little")) % L_ORDER
        out.append(r_enc + s.to_bytes(32, "little"))
    return b"".join(out)


def sign_batch_async(seeds, msgs, device=None):
    """Sign msgs[i] with seeds[i] without waiting for the card: the
    nonces are computed now and R = r*B is enqueued on the current
    stream in SIGN_CHUNK launches. Returns a zero-arg resolver that
    waits on one CUDA event, copies the encodings to the host and
    finishes the 64-byte signatures."""
    device = _device.resolve(device)
    n = len(msgs)
    if n == 0:
        return lambda: []
    params = [signing_params(seed) for seed in seeds]
    a_cat = b"".join(p[0] for p in params)
    pk_cat = b"".join(p[2] for p in params)
    r_cat = sign_phase1(b"".join(p[1] for p in params), msgs)
    _count_prep("sign_plain" if native.disabled() else "sign_native", n)
    r_dev = _upload(np.frombuffer(r_cat, np.uint8).reshape(n, 32).copy(),
                    device)
    host = torch.empty((n, 32), dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    # the device buffers stay referenced until the resolver has waited
    keep = [r_dev]
    for lo in range(0, n, SIGN_CHUNK):
        hi = min(lo + SIGN_CHUNK, n)
        keep.append(ladder.sign_rb(r_dev[lo:hi]))
        host[lo:hi].copy_(keep[-1], non_blocking=True)
    done = None
    if device.type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))

    def resolve() -> list:
        if done is not None:
            done.synchronize()
        keep.clear()
        sig_cat = sign_phase2(host.numpy().tobytes(), pk_cat, msgs, r_cat,
                              a_cat)
        return [sig_cat[64 * i:64 * (i + 1)] for i in range(n)]

    return resolve


def sign_batch(seeds, msgs, device=None) -> list:
    """Batched Ed25519 signing: seeds[i] signs msgs[i]. Returns 64-byte
    signatures, byte-equal to RFC 8032 (and so to OpenSSL)."""
    return sign_batch_async(seeds, msgs, device=device)()
