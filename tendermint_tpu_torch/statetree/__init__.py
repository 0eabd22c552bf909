"""The authenticated state tree: the port's copy of
`tendermint_tpu/statetree/`, the kvstore's proof-carrying commit backend
behind TM_CUDA_STATE_TREE.

A persistent critbit Merkle trie over sha256(key) bits: a per-key update
is an O(log n) copy-on-write path, a commit rehashes only the dirty
subtree in waves through `ops/merkle.sha256_many_host` on the tree's
device, app_hash is the tree root, and every key gets a compact inclusion
or absence proof that a client verifies against the app_hash of a
lite-certified header. Roots, proofs and proof bytes equal the JAX
package's.
"""

from tendermint_tpu_torch.statetree.codec import (  # noqa: F401
    proof_from_bytes,
    proof_from_obj,
    proof_to_bytes,
    proof_to_obj,
)
from tendermint_tpu_torch.statetree.proof import (  # noqa: F401
    ProofError,
    StateProof,
    verify,
)
from tendermint_tpu_torch.statetree.store import NodeStore  # noqa: F401
from tendermint_tpu_torch.statetree.tree import StateTree  # noqa: F401
