"""Analysis planes of the port: `divergence` (per-height transition
digests and the dual-hash-seed replay)."""
