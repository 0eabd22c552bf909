"""Peer exchange: the port's copy of `tendermint_tpu/p2p/pex/`."""

from tendermint_tpu_torch.p2p.pex.addrbook import AddrBook, KnownAddress
from tendermint_tpu_torch.p2p.pex.pex_reactor import PEXReactor, PEX_CHANNEL

__all__ = ["AddrBook", "KnownAddress", "PEXReactor", "PEX_CHANNEL"]
