"""The light client: certifiers, providers and their types.

Counterpart of `tendermint_tpu/lite/`. `certify_chain` sends the
signatures of a run of headers through the batch verifier, a window at a
time, and so through the verify kernels on the card.
"""

from tendermint_tpu_torch.lite.certifier import (
    ContinuousCertifier,
    DynamicCertifier,
    InquiringCertifier,
    StaticCertifier,
    certify_chain,
    default_window,
)
from tendermint_tpu_torch.lite.provider import CacheProvider, MemProvider
from tendermint_tpu_torch.lite.types import (
    CertificationError,
    FullCommit,
    SignedHeader,
    ValidatorsChangedError,
)

__all__ = ["CacheProvider", "CertificationError", "ContinuousCertifier",
           "DynamicCertifier", "FullCommit", "InquiringCertifier",
           "MemProvider", "SignedHeader", "StaticCertifier",
           "ValidatorsChangedError", "certify_chain", "default_window"]
