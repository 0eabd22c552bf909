"""The device plane: field and curve arithmetic, the verify and sign
ladders and their CUDA kernels, batched Ed25519 verification and signing,
and host Merkle hashing.

  field.py    GF(2^255-19) on int32 limb tensors (plain PyTorch)
  curve.py    edwards25519 point ops (plain PyTorch)
  ladder.py   plain versions of the verify and r*B kernels + launchers
  _build.py   builds csrc/ with nvcc (or g++ for the CPU shim)
  ed25519.py  host prep, predecompression cache, kernel routing, and
              batched signing
  merkle.py   host half of the SHA-256 Merkle spec
"""
