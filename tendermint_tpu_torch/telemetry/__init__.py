"""Telemetry — metrics registry + tracing (dependency-free).

Public surface:

    from tendermint_tpu_torch import telemetry

    _hits = telemetry.counter("mysubsys_hits_total", "...")
    _hits.inc()

    _size = telemetry.histogram("verifier_batch_size", "...",
                                buckets=telemetry.POW2_BUCKETS)
    _size.observe(n)

    with telemetry.span("verify", batch=n): ...
    text = telemetry.expose()          # Prometheus text format 0.0.4

Conventions (the family catalog test holds the port to the JAX names):
  - names are `<subsystem>_<what>[_<unit>]`, un-namespaced; exposition
    prefixes the configured namespace (default `tmcuda`, so
    `verifier_batch_size` serves as `tmcuda_verifier_batch_size`)
  - counters end in `_total`; durations are `_seconds`
  - metric families are created at module import (cheap, stdlib-only);
    values are only recorded while `enabled()`

Disable globally with TM_CUDA_TELEMETRY=off (wins over config) or
config `base.telemetry = false` — every instrument call then reduces to
one flag check.
"""

from tendermint_tpu_torch.telemetry.registry import (  # noqa: F401
    DEFAULT_BUCKETS,
    DEFAULT_QUANTILES,
    POW2_BUCKETS,
    RATIO_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    QuantileSketch,
    REGISTRY,
    Registry,
    Summary,
    configure,
    enabled,
    namespace,
    set_enabled,
)
from tendermint_tpu_torch.telemetry.trace import (  # noqa: F401
    TRACER,
    Tracer,
    dump_trace,
    instant,
    span,
)


def counter(name, help="", labelnames=()):
    return REGISTRY.counter(name, help, labelnames)


def gauge(name, help="", labelnames=()):
    return REGISTRY.gauge(name, help, labelnames)


def histogram(name, help="", labelnames=(), buckets=DEFAULT_BUCKETS):
    return REGISTRY.histogram(name, help, labelnames, buckets=buckets)


def summary(name, help="", labelnames=(), quantiles=DEFAULT_QUANTILES,
            cap=512):
    return REGISTRY.summary(name, help, labelnames,
                            quantiles=quantiles, cap=cap)


def expose(namespace=None) -> str:
    return REGISTRY.expose(namespace=namespace)


def value(name, labels=None):
    return REGISTRY.value(name, labels)
