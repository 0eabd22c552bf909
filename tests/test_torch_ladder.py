"""The plain versions of the verify kernels (tendermint_tpu_torch.ops.ladder)
on the CPU:

- both at n_windows=8 on crafted 32-bit scalars against the oracle (the
  construction of tests/test_pallas_kernel.py::make_small_scalar_batch);
- the tables and digits against the JAX package's, exactly;
- the wrappers take the plain version for CPU tensors only.
At 64 windows, verify_plain / verify_pre_plain are held against the JAX
package's jnp kernels in tests/test_torch_verifier.py, whose process has
those kernels compiled at the same shape already (each costs ~20 s of
XLA compile here). Tolerance 0: verdicts, bytes and limbs are integers.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tendermint_tpu.ops import ed25519 as jed
from tendermint_tpu.ops import ladder_pallas
from tendermint_tpu_torch.ops import ed25519 as ted
from tendermint_tpu_torch.ops import ladder
from tendermint_tpu_torch.utils import vectors

# small tensors: one intra-op thread is faster here and leaves the
# cores to the other test workers
torch.set_num_threads(1)

EDGE = vectors.edge_batch(16, seed=11)
SMALL = vectors.small_scalar_batch(12, seed=12, n_windows=8)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _digits(batch, key):
    return ladder.digits_from_bytes(_t(batch[key]))


def test_tables_match_jax():
    np.testing.assert_array_equal(ladder._s_table_np(),
                                  ladder_pallas._s_table_np())
    np.testing.assert_array_equal(ladder._consts_np(),
                                  ladder_pallas._consts_np())


def test_digits_match_jax():
    bits = jed.bits_from_bytes_dev(jnp.asarray(EDGE["s"]))
    want = np.asarray(ladder_pallas._digits4_t(bits)).T
    np.testing.assert_array_equal(_digits(EDGE, "s").numpy(), want)
    tbits = ted.bits_from_bytes_dev(_t(EDGE["s"]))
    np.testing.assert_array_equal(tbits.numpy(), np.asarray(bits))
    np.testing.assert_array_equal(ladder._digits4(tbits).numpy(), want)


@pytest.mark.parametrize("variant", ["full", "pre"])
def test_small_windows_match_oracle(variant):
    args = [_t(SMALL["rb"]), _digits(SMALL, "s"), _digits(SMALL, "h")]
    if variant == "full":
        got = ladder.verify_plain(_t(SMALL["pk"]), *args, n_windows=8)
    else:
        xnb, yb, ok = ted._decompress_to_bytes(_t(SMALL["pk"]))
        got = ladder.verify_pre_plain(xnb, yb, ok, *args, n_windows=8)
    np.testing.assert_array_equal(got.numpy(), SMALL["expect"])


def test_wrappers_take_plain_version_on_cpu_only():
    rows = [_t(EDGE[k]) for k in ("pk", "rb", "s", "h")]
    before = dict(ladder.launches)
    assert ladder.verify(*rows).tolist() == EDGE["expect"].tolist()
    assert ladder.launches == before     # the plain version launches nothing
    meta = [r.to("meta") for r in rows]
    with pytest.raises(ValueError):
        ladder.verify(*meta)


def test_field_mul_count():
    # the per-verify count the roofline bound in PERF.md is taken from
    assert ladder.field_muls("verify") == 3414
    assert ladder.field_muls("verify_pre") == 3140
