"""Multi-device parallelism: device meshes and the sharded verify and
Merkle roots over them (parallel/mesh.py)."""

from tendermint_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh, sharded_merkle_root, sharded_verify_kernel, verify_step,
)
