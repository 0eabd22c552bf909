"""The light client: certifiers, providers and their types.

Counterpart of `tendermint_tpu/lite/`. `certify_chain` sends the
signatures of a run of headers through the batch verifier, a window at a
time, and so through the verify kernels on the card;
`InquiringCertifier.certify_range` does the same for a run of its
provider's heights across set changes. `SecureClient` certifies what a
node's RPC returns; `cli lite` serves it.
"""

from tendermint_tpu_torch.lite.certifier import (
    ContinuousCertifier,
    DynamicCertifier,
    InquiringCertifier,
    StaticCertifier,
    certify_chain,
    default_window,
    sync_stats,
)
from tendermint_tpu_torch.lite.provider import (
    CacheProvider,
    FileProvider,
    HTTPProvider,
    MemProvider,
)
from tendermint_tpu_torch.lite.proxy import SecureClient
from tendermint_tpu_torch.lite.types import (
    CertificationError,
    FullCommit,
    SignedHeader,
    ValidatorsChangedError,
)

__all__ = ["CacheProvider", "CertificationError", "ContinuousCertifier",
           "DynamicCertifier", "FileProvider", "FullCommit", "HTTPProvider",
           "InquiringCertifier", "MemProvider", "SecureClient",
           "SignedHeader", "StaticCertifier", "ValidatorsChangedError",
           "certify_chain", "default_window", "sync_stats"]
