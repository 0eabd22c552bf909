"""The CUDA kernel's own arithmetic (csrc/fe25519.cuh) on the CPU, and the
kernel itself on the card.

There is no card and no nvcc here, so the header is built with g++ into
a small C shim (csrc/cpu_shim.cpp, loaded with ctypes): the same field,
point and ladder functions the kernels run, one signature after another.
Its verify runs the 4-lane schedule of the verify kernel with the group
emulated on one thread, its r*B the sign kernel's fixed-base comb. Its
field mul/invert/encode are held against the plain PyTorch field ops,
each 4-lane point operation against the one-thread one (and the oracle),
its verify against the plain versions (n_windows=8) and the oracle (64
windows; the small-order probe lanes against both), its r*B against the plain version, which keeps the TPU
kernel's windowed schedule, and the oracle at 1, 2, 8, 63 and 64
windows. Bytes and verdicts are integers: tolerance 0.

The tests marked `cuda` launch the kernels themselves and skip without a card;
on the H100 run them with `python -m pytest --noconftest -m cuda
tests/test_torch_kernel.py` (tests/conftest.py imports jax).
"""

import ctypes

import numpy as np
import pytest
import torch

from tendermint_tpu_torch.ops import _build, ladder
from tendermint_tpu_torch.ops import ed25519 as ted
from tendermint_tpu_torch.ops import field as tfe
from tendermint_tpu_torch.utils import ed25519_ref as ref
from tendermint_tpu_torch.utils import vectors

# small tensors: one intra-op thread is faster here and leaves the
# cores to the other test workers
torch.set_num_threads(1)

_rng = np.random.RandomState(5)


@pytest.fixture(scope="module")
def shim():
    return _build.cpu_shim_lib()


def _ptr(a: np.ndarray):
    return ctypes.c_void_p(a.ctypes.data)


def _field_inputs(n=24):
    raw = np.frombuffer(_rng.bytes(32 * n), np.uint8).reshape(n, 32).copy()
    specials = [0, 1, tfe.P - 1, tfe.P, tfe.P + 1, (1 << 255) - 1,
                (1 << 255) - 20, 19]
    for i, v in enumerate(specials):
        raw[i] = np.frombuffer(v.to_bytes(32, "little"), np.uint8)
    raw[len(specials), 31] |= 0x80          # bit 255 is dropped
    return raw


def _plain_bytes(limbs):
    return tfe.to_bytes(limbs).numpy()


@pytest.mark.parametrize("op", ["mul", "invert", "canon"])
def test_shim_field_op_matches_plain(shim, op):
    a = _field_inputs()
    b = np.roll(a, 5, axis=0).copy()
    out = np.zeros_like(a)
    ta, _ = tfe.from_bytes(torch.from_numpy(a))
    tb, _ = tfe.from_bytes(torch.from_numpy(b))
    if op == "mul":
        shim.tm_cpu_fe_mul(_ptr(a), _ptr(b), _ptr(out), len(a))
        want = _plain_bytes(tfe.mul(ta, tb))
    elif op == "invert":
        shim.tm_cpu_fe_invert(_ptr(a), _ptr(out), len(a))
        want = _plain_bytes(ladder._inv(ta))
    else:
        shim.tm_cpu_fe_canon(_ptr(a), _ptr(out), len(a))
        want = _plain_bytes(ta)
    np.testing.assert_array_equal(out, want)


def _fe_bytes(v: int) -> np.ndarray:
    return np.frombuffer((v % ref.P).to_bytes(32, "little"), np.uint8)


def _random_points(n, seed):
    """n extended points k*B (the identity first) with a random Z, as
    uint8[n, 4, 32] (X, Y, Z, T), and the affine points."""
    rng = np.random.RandomState(seed)
    rows, affine = [], []
    for i in range(n):
        k = 0 if i == 0 else int.from_bytes(rng.bytes(32), "little") % ref.L
        X, Y, Z, T = ref.point_mul(k, ref.BASE)
        zi = pow(Z, ref.P - 2, ref.P)
        x, y = X * zi % ref.P, Y * zi % ref.P
        z = int.from_bytes(rng.bytes(32), "little") % (ref.P - 1) + 1
        rows.append(np.stack([_fe_bytes(c * z) for c in (x, y, 1, x * y)]))
        affine.append((x, y))
    return np.stack(rows), affine


def _shim_point_op(shim, op, lanes4, p, q):
    out = np.zeros_like(p)
    shim.tm_cpu_point_op(op, lanes4, _ptr(p), _ptr(q), _ptr(out), len(p))
    return out


def _affine(row):
    X, Y, Z = (int.from_bytes(row[c].tobytes(), "little") for c in range(3))
    zi = pow(Z, ref.P - 2, ref.P)
    return X * zi % ref.P, Y * zi % ref.P


@pytest.mark.parametrize("op", [0, 1, 2],
                         ids=["double", "affine_add", "projective_add"])
def test_shim_4lane_point_op_matches_one_thread(shim, op):
    p, p_aff = _random_points(12, seed=31 + op)
    q, q_aff = _random_points(12, seed=41 + op)
    q[:, 3] = np.stack([_fe_bytes(int.from_bytes(t.tobytes(), "little") *
                                  ref.D * 2) for t in q[:, 3]])
    if op == 1:
        q = np.ascontiguousarray(np.stack([
            np.stack([_fe_bytes(x), _fe_bytes(y), _fe_bytes(1),
                      _fe_bytes(x * y * ref.D * 2)]) for x, y in q_aff]))
    got = _shim_point_op(shim, op, 1, p, q)
    want = _shim_point_op(shim, op, 0, p, q)
    np.testing.assert_array_equal(got, want)
    for i in range(len(p)):
        a = (*p_aff[i], 1, p_aff[i][0] * p_aff[i][1] % ref.P)
        b = (*q_aff[i], 1, q_aff[i][0] * q_aff[i][1] % ref.P)
        r = ref.point_add(a, a if op == 0 else b)
        rz = pow(r[2], ref.P - 2, ref.P)
        assert _affine(got[i]) == (r[0] * rz % ref.P, r[1] * rz % ref.P)
        X, Y, Z, T = (int.from_bytes(got[i, c].tobytes(), "little")
                      for c in range(4))
        assert X * Y % ref.P == Z * T % ref.P       # T is X Y / Z


def _kernel_consts():
    return np.ascontiguousarray(
        ladder._kernel_consts(torch.device("cpu")).numpy())


def _shim_verify(shim, batch, n_windows, pre):
    n = len(batch["pk"])
    out = np.zeros(n, np.int32)
    consts = _kernel_consts()
    rest = [batch["rb"], batch["s"], batch["h"]]
    if pre:
        xnb, yb, ok = ted._decompress_to_bytes(torch.from_numpy(batch["pk"]))
        okb = ok.numpy().astype(np.uint8)
        shim.tm_cpu_verify_pre(_ptr(xnb.numpy()), _ptr(yb.numpy()), _ptr(okb),
                               *map(_ptr, rest), _ptr(consts), _ptr(out), n,
                               n_windows)
    else:
        shim.tm_cpu_verify(_ptr(batch["pk"]), *map(_ptr, rest), _ptr(consts),
                           _ptr(out), n, n_windows)
    return out != 0


@pytest.mark.parametrize("pre", [False, True], ids=["full", "pre"])
def test_shim_verify_matches_plain_at_8_windows(shim, pre):
    batch = vectors.small_scalar_batch(8, seed=21, n_windows=8)
    edge = vectors.edge_batch(8, seed=22)     # every edge lane kind once
    for key in ("pk", "rb", "s", "h"):
        batch[key] = np.concatenate([batch[key], edge[key]])
    got = _shim_verify(shim, batch, 8, pre)
    t = {k: torch.from_numpy(batch[k]) for k in ("pk", "rb", "s", "h")}
    if pre:
        want = ladder.verify_pre(*ted._decompress_to_bytes(t["pk"]), t["rb"],
                                 t["s"], t["h"], n_windows=8)
    else:
        want = ladder.verify(t["pk"], t["rb"], t["s"], t["h"], n_windows=8)
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(got[:8], batch["expect"])


@pytest.mark.parametrize("pre", [False, True], ids=["full", "pre"])
def test_shim_verify_matches_oracle_at_64_windows(shim, pre):
    batch = vectors.edge_batch(64, seed=23)
    np.testing.assert_array_equal(_shim_verify(shim, batch, 64, pre),
                                  batch["expect"])


def _plain_verify(batch, pre, device="cpu"):
    t = {k: torch.from_numpy(batch[k]).to(device)
         for k in ("pk", "rb", "s", "h")}
    digs = [ladder.digits_from_bytes(t[k]) for k in ("s", "h")]
    if pre:
        return ladder.verify_pre_plain(*ted._decompress_to_bytes(t["pk"]),
                                       t["rb"], *digs)
    return ladder.verify_plain(t["pk"], t["rb"], *digs)


@pytest.mark.parametrize("pre", [False, True], ids=["full", "pre"])
def test_shim_verify_matches_plain_and_oracle_on_probe_lanes(shim, pre):
    """Small-order and non-canonical lanes (vectors.probe_batch) at 64
    windows: the 4-lane schedule, the plain version and the oracle."""
    batch = vectors.probe_batch(40, seed=29)
    got = _shim_verify(shim, batch, 64, pre)
    np.testing.assert_array_equal(got, batch["expect"])
    np.testing.assert_array_equal(got, _plain_verify(batch, pre).numpy())


def _shim_sign_rb(shim, r, n_windows):
    out = np.zeros_like(r)
    comb = np.ascontiguousarray(ladder._comb(torch.device("cpu")).numpy())
    shim.tm_cpu_sign_rb(_ptr(r), _ptr(comb), _ptr(out), len(r), n_windows)
    return out


def _oracle_rb(r, n_windows=64):
    """enc((r mod 16^n_windows) * B) by the reference's double-and-add."""
    return np.stack([np.frombuffer(ref.point_compress(ref.point_mul(
        int.from_bytes(row.tobytes(), "little") % (1 << 4 * n_windows),
        ref.BASE)), np.uint8) for row in r])


def _r_rows(rs):
    return np.stack([np.frombuffer(r.to_bytes(32, "little"), np.uint8)
                     for r in rs])


def _scalars(n, seed, bits):
    rng = np.random.RandomState(seed)
    rs = [0, 1, 2, (1 << bits) - 1] + [
        int.from_bytes(rng.bytes(32), "little") % (1 << bits)
        for _ in range(n - 4)]
    if bits == 256:
        rs[3] = ref.L - 1
    return _r_rows(rs)


# scalars whose signed recoding carries: every nibble 8 (each window
# becomes -8 and carries), all ones, a lone top bit; at 64 windows a top
# nibble >= 8 carries into 2^256 * B (comb row 64)
CARRY_EDGES = {
    8: [0x88888888, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0x08080808],
    64: [(1 << 256) - 1, 1 << 255, ref.L, ref.L + 1, int("88" * 32, 16),
         (1 << 252) - 1],
}


def _with_edges(r, edges):
    """r with rows 4.. replaced by the scalars `edges`."""
    r[4:4 + len(edges)] = _r_rows(edges)
    return r


@pytest.mark.parametrize("n_windows", [1, 2, 8, 63, 64])
def test_shim_sign_rb_matches_plain_and_oracle(shim, n_windows):
    """The sign kernel's comb (through the shim) against the plain
    version's windowed schedule and the oracle, on (r mod 16^n) * B:
    random scalars of all 256 bits, so the windows above n are ignored and
    the recoding's carry lands in comb row n."""
    r = _with_edges(_scalars(12, 25 + n_windows, 256),
                    CARRY_EDGES.get(n_windows, CARRY_EDGES[64]))
    want = ladder.sign_rb_plain(ladder.digits_from_bytes(torch.from_numpy(r)),
                                n_windows=n_windows).numpy()
    np.testing.assert_array_equal(_shim_sign_rb(shim, r, n_windows), want)
    np.testing.assert_array_equal(want, _oracle_rb(r, n_windows))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    return torch.device("cuda")


def _cuda_matches_plain(device, batch, pre):
    t = {k: torch.from_numpy(batch[k]).to(device)
         for k in ("pk", "rb", "s", "h")}
    if pre:
        got = ladder.verify_pre(*ted._decompress_to_bytes(t["pk"]), t["rb"],
                                t["s"], t["h"])
    else:
        got = ladder.verify(t["pk"], t["rb"], t["s"], t["h"])
    want = _plain_verify(batch, pre, device)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.cpu().numpy(), batch["expect"])


@pytest.mark.cuda
@pytest.mark.parametrize("pre", [False, True], ids=["full", "pre"])
def test_cuda_kernel_matches_plain(cuda_device, pre):
    _cuda_matches_plain(cuda_device, vectors.edge_batch(256, seed=24), pre)


@pytest.mark.cuda
@pytest.mark.parametrize("pre", [False, True], ids=["full", "pre"])
def test_cuda_kernel_matches_plain_on_probe_lanes(cuda_device, pre):
    _cuda_matches_plain(cuda_device, vectors.probe_batch(256, seed=30), pre)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 5, 33, 2048])
@pytest.mark.parametrize("pre", [False, True], ids=["full", "pre"])
def test_cuda_kernel_partial_groups(cuda_device, pre, n):
    """n signatures take 4n threads: a block, a warp or a group left
    partly empty must still give every verdict."""
    batch = vectors.edge_batch(min(n, 64), seed=28)
    reps = -(-n // len(batch["expect"]))
    rows = {k: np.ascontiguousarray(np.tile(batch[k], (reps, 1))[:n])
            for k in ("pk", "rb", "s", "h")}
    expect = np.tile(batch["expect"], reps)[:n]
    t = {k: torch.from_numpy(v).to(cuda_device) for k, v in rows.items()}
    if pre:
        got = ladder.verify_pre(*ted._decompress_to_bytes(t["pk"]), t["rb"],
                                t["s"], t["h"])
    else:
        got = ladder.verify(t["pk"], t["rb"], t["s"], t["h"])
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), expect)


@pytest.mark.cuda
def test_cuda_sign_rb_matches_plain(cuda_device):
    r_np = _with_edges(_scalars(256, 27, 256),
                       CARRY_EDGES[64] + CARRY_EDGES[8])
    r = torch.from_numpy(r_np).to(cuda_device)
    for n_windows in (1, 8, 64):
        got = ladder.sign_rb(r, n_windows=n_windows)
        want = ladder.sign_rb_plain(ladder.digits_from_bytes(r), n_windows)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        np.testing.assert_array_equal(got.cpu().numpy()[:24],
                                      _oracle_rb(r_np[:24], n_windows))
