"""Batched signing of the port (ops/ed25519 signing half, ops/ladder.sign_rb)
on the CPU, against the JAX package and RFC 8032:

- sign_rb_plain at 64 windows on edge scalars against the oracle;
- sign_rb_plain at 8 windows against the JAX package's own sign kernel
  body, `ladder_pallas.sign_pallas_rB` run in interpret mode on crafted
  32-bit scalars (the construction of tests/test_pallas_kernel.py);
- the host phases against the JAX package's native sign phases;
- sign_batch(device="cpu") against the JAX package's sign_batch and the
  oracle's scalar signer;
- the tables the JAX package installs drive sign_rb too, and give the
  sign kernel the same comb as the port's own tables; the comb's entries
  are j * 16^w * B;
- the sign kernel's field products, the count of its bound.

Every output is bytes: tolerance 0.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendermint_tpu import native
from tendermint_tpu.ops import ed25519 as jed
from tendermint_tpu.ops import ladder_pallas
from tendermint_tpu_torch import convert
from tendermint_tpu_torch.ops import ed25519 as ted
from tendermint_tpu_torch.ops import ladder
from tendermint_tpu_torch.utils import ed25519_ref as ref

# small tensors: one intra-op thread is faster here and leaves the
# cores to the other test workers
torch.set_num_threads(1)

_rng = np.random.RandomState(41)
EDGE_R = [0, 1, 2, ref.L - 1, 1 << 252, (1 << 252) - 1] + [
    int.from_bytes(_rng.bytes(32), "little") % ref.L for _ in range(6)]


def _r_bytes(rs):
    return np.stack([np.frombuffer(r.to_bytes(32, "little"), np.uint8)
                     for r in rs])


def _oracle(rs):
    return [ref.point_compress(ref.point_mul(r, ref.BASE)) for r in rs]


def _rows(t):
    return [bytes(row) for row in t.numpy()]


def test_sign_rb_plain_matches_oracle_on_edge_scalars():
    r = torch.from_numpy(_r_bytes(EDGE_R))
    got = ladder.sign_rb_plain(ladder.digits_from_bytes(r))
    assert got.dtype == torch.uint8 and got.shape == (len(EDGE_R), 32)
    assert _rows(got) == _oracle(EDGE_R)
    # the wrapper takes the plain version for a CPU tensor, launching
    # nothing
    before = dict(ladder.launches)
    assert torch.equal(ladder.sign_rb(r), got)
    assert ladder.launches == before


def test_sign_rb_plain_matches_interpreted_pallas_at_8_windows():
    rng = np.random.RandomState(5)
    rs = [int.from_bytes(rng.bytes(4), "little") for _ in range(7)] + \
        [(1 << 32) - 1]
    r_np = _r_bytes(rs)
    sign_fn = jax.jit(functools.partial(
        ladder_pallas.sign_pallas_rB, tile=8, interpret=True, n_windows=8))
    want = np.asarray(sign_fn(jnp.asarray(r_np)))
    got = ladder.sign_rb(torch.from_numpy(r_np), n_windows=8)
    np.testing.assert_array_equal(got.numpy(), want)
    assert _rows(got) == _oracle(rs)


def _sign_inputs(n, seed):
    rng = np.random.RandomState(seed)
    seeds = [rng.bytes(32) for _ in range(3)]
    msgs = [b"", b"x", rng.bytes(300), bytes(range(256)) * 5]
    return ([seeds[i % 3] for i in range(n)],
            [msgs[i % 4] + bytes([i]) * (i % 2) for i in range(n)])


def test_sign_phases_match_native():
    mod = native._prep()
    assert mod is not None and hasattr(mod, "sign_phase1")
    seeds, msgs = _sign_inputs(10, 42)
    params = [ted.signing_params(s) for s in seeds]
    assert params == [jed.signing_params(s) for s in seeds]
    a_cat = b"".join(p[0] for p in params)
    pre_cat = b"".join(p[1] for p in params)
    pk_cat = b"".join(p[2] for p in params)
    r_cat = ted.sign_phase1(pre_cat, msgs)
    assert r_cat == mod.sign_phase1(pre_cat, msgs)
    renc = b"".join(_oracle([int.from_bytes(r_cat[32 * i:32 * i + 32],
                                            "little")
                             for i in range(len(msgs))]))
    sigs = ted.sign_phase2(renc, pk_cat, msgs, r_cat, a_cat)
    assert sigs == mod.sign_phase2(renc, pk_cat, msgs, r_cat, a_cat)
    assert [sigs[64 * i:64 * i + 64] for i in range(len(msgs))] == \
        [ref.sign(s, m) for s, m in zip(seeds, msgs)]
    # the same refusals as the native phases
    for fn, args in ((ted.sign_phase1, (pre_cat, msgs[:-1] + ["str"])),
                     (mod.sign_phase1, (pre_cat, msgs[:-1] + ["str"]))):
        with pytest.raises(TypeError, match="msgs must be bytes"):
            fn(*args)
    with pytest.raises(ValueError, match="prefixes must be n\\*32 bytes"):
        ted.sign_phase1(pre_cat[:-1], msgs)


@pytest.mark.parametrize("n", [0, 1, 12])
def test_sign_batch_cpu_matches_jax_and_rfc8032(n):
    seeds, msgs = _sign_inputs(n, 43 + n)
    got = ted.sign_batch(seeds, msgs, device="cpu")
    assert got == jed.sign_batch(seeds, msgs)
    assert got == [ref.sign(s, m) for s, m in zip(seeds, msgs)]
    assert all(ref.verify(ted.signing_params(s)[2], m, sg)
               for s, m, sg in zip(seeds, msgs, got))


def test_installed_jax_tables_drive_sign_rb():
    own = ladder.tables()
    try:
        convert.state_from_jax(ladder_pallas._s_table_np(),
                               ladder_pallas._consts_np(), device="cpu")
        got = ladder.sign_rb(torch.from_numpy(_r_bytes(EDGE_R[:6])))
        assert _rows(got) == _oracle(EDGE_R[:6])
    finally:
        ladder.install_tables(*own)


def test_comb_from_installed_jax_tables_equals_own():
    own_tables = ladder.tables()
    own = ladder._comb(torch.device("cpu"))
    try:
        convert.state_from_jax(ladder_pallas._s_table_np(),
                               ladder_pallas._consts_np(), device="cpu")
        got = ladder._comb(torch.device("cpu"))
        assert got is not own            # rebuilt from the installed table
        assert torch.equal(got, own)
    finally:
        ladder.install_tables(*own_tables)


def _limbs25_int(limbs) -> int:
    """10 limbs of radix 2^25.5 (limb i at bit ceil(25.5 i)) -> int."""
    return sum(int(v) << (26 * ((i + 1) // 2) + 25 * (i // 2))
               for i, v in enumerate(limbs))


def test_comb_entries_are_multiples_of_b():
    comb = ladder._comb_np(*ladder.tables())
    assert comb.shape == (65, 8, 3, 10) and comb.dtype == np.int32
    base = ref.BASE
    for w in range(65):
        pt = ref.IDENT
        for j in range(8):
            pt = ref.point_add(pt, base)                 # (j + 1) 16^w B
            X, Y, Z, _ = pt
            zi = pow(Z, ref.P - 2, ref.P)
            x, y = X * zi % ref.P, Y * zi % ref.P
            assert [_limbs25_int(comb[w, j, c]) for c in range(3)] == [
                (y - x) % ref.P, (y + x) % ref.P, 2 * ref.D * x * y % ref.P]
        base = ref.point_mul(16, base)


def test_sign_field_mul_count():
    # a scalar on the sign kernel's comb: 64 windows x 7 (a mixed add with
    # T) + 6 (the carry's add, no T) + 259 + 5 + 1 (the inverse) + 2 (x
    # and y); on the plain version's windowed schedule: 64 windows x (3 x 7
    # + 8 doublings + 6, the add without T) + 265 + 2
    assert ladder.field_muls("sign_rb") == 64 * 7 + 6 + 259 + 5 + 1 + 2 \
        == 721
    assert ladder.field_muls("sign_rb", n_windows=8) == 8 * 7 + 273
    assert ladder.field_muls("sign_rb", n_windows=1) == 280
    assert ladder.field_muls("sign_rb_plain") == 64 * 35 + 267 == 2507
    with pytest.raises(ValueError):
        ladder.field_muls("sign")


def test_bound_field_muls():
    # the sign kernel's bound is the least work of the batch: per scalar
    # the comb's adds (64 x 7 + 6), x and y (2) and Montgomery's trick (3);
    # one inverse (265) for the batch, less the 3 the first scalar saves
    per_scalar = 64 * 7 + 6 + 2 + 3
    assert ladder.bound_field_muls("sign_rb", 16384) \
        == 16384 * per_scalar + 265 - 3 == 7_520_518
    assert ladder.bound_field_muls("sign_rb", 1) == ladder.field_muls(
        "sign_rb")
    assert ladder.bound_field_muls("sign_rb", 4, n_windows=1) \
        == 4 * (7 + 6 + 2 + 3) + 262
    # the verify kernels' is their schedule's count
    assert ladder.bound_field_muls("verify", 8192) == 8192 * 3414
    assert ladder.bound_field_muls("verify_pre", 2048) == 2048 * 3140
