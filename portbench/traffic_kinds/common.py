"""What the traffic kinds share: the program's verifier as a node builds
it, the kernel launch and key-cache counters read around a window, and
the span targets of a traced run."""

from __future__ import annotations

from portbench import controls


def node_verifier(ctx):
    """node.build_verifier(BaseConfig()): the process's default verifier
    on the card; on the CPU (tests) a verifier of its own there."""
    from tendermint_tpu_torch import node
    from tendermint_tpu_torch.config import BaseConfig
    dev = None if ctx.device.type == "cuda" else ctx.device
    v, _ = node.build_verifier(BaseConfig(), device=dev)
    controls.install(ctx, v)
    return v


def counters() -> dict:
    """Kernel launches (every kernel) and key-cache routes so far."""
    from tendermint_tpu_torch.ops import ed25519, ladder
    out = {"launches": sum(ladder.launches.values())}
    out.update({k: v for k, v in ed25519.predecomp_stats().items()
                if k in ("hit", "fill", "full")})
    return out


def delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in before}


def span_target(ctx, path: str):
    """A traced run's wrap target by name: an object the kind keeps under
    ctx.state, a module of the program (`ops.ed25519`), or a class of one
    (`storage.BlockStore`)."""
    if path in ctx.state:
        return ctx.state[path]
    import importlib
    mod, _, attr = path.rpartition(".")
    if attr[:1].isupper():
        return getattr(importlib.import_module("tendermint_tpu_torch." + mod),
                       attr)
    return importlib.import_module("tendermint_tpu_torch." + path)


def sixths(times: list, t0: float, t_end: float) -> list:
    """How many of `times` (answers on the perf_counter clock) fall in
    each sixth of the window [t0, t_end], in order: whether a run's rate
    drifts inside it or holds."""
    out = [0] * 6
    span = (t_end - t0) / 6
    for t in times:
        if t0 <= t <= t_end:
            out[min(5, int((t - t0) / span))] += 1
    return out
