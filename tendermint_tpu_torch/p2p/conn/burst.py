"""Frame bursts of the p2p link: the port's form of
`tendermint_tpu/p2p/conn/burst.py`: a setting of the P2PConfig, under
the knob TM_CUDA_P2P_BURST (the JAX package's `TM_TPU_P2P_BURST`).

With bursts on, SecretConnection seals every frame of a write, and opens
every frame already buffered on receive, in one native AEAD call
(`native.aead_*_burst`), and MConnection coalesces up to `max_packets`
packets into one link write. Off, each frame seals and opens alone
through the per-frame AEAD (`cryptography`, else `purecrypto`), and
MConnection writes one packet at a time.

Bursts never change the wire format: a burst is exactly the concatenation
of the frames the per-frame path produces, so nodes with bursts on and
off interoperate frame for frame.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from tendermint_tpu_torch.utils import knobs

DEFAULT_MAX_PACKETS = 64  # ~64KB ceiling per sendall at 1KB frames


@dataclass(frozen=True)
class Burst:
    on: bool = True
    max_packets: int = DEFAULT_MAX_PACKETS

    @classmethod
    def from_config(cls, p2p_config) -> "Burst":
        """From a P2PConfig's `burst` and `burst_max` (0: the default)."""
        return cls(bool(p2p_config.burst),
                   int(p2p_config.burst_max) or DEFAULT_MAX_PACKETS)

    def resolve(self) -> Tuple[bool, int]:
        """-> (bursts on, packets a send burst at most): TM_CUDA_P2P_BURST
        (off|on|auto|<max packets>) over this config; read on every call,
        which connection setup makes once a connection."""
        on, max_packets = self.on, self.max_packets
        env = knobs.knob_str("TM_CUDA_P2P_BURST")
        if env:
            if env.isdigit():
                on, max_packets = True, max(1, int(env))
            else:
                on = env not in knobs.FALSY
        if not on:
            return False, 1
        return True, max(1, max_packets)
