"""Host microseconds inside `ops.ed25519.prep_items` (the native
SHA-512 and scalar prep of the verifier's items) per signature
dispatched in the window: a span around the module function."""


def install(ctx):
    from tendermint_tpu_torch.ops import ed25519
    ctx.probe.wrap(ed25519, "prep_items", "prep")


def read(ctx):
    sigs = ctx.window_stats.get("sigs_dispatched")
    if not sigs or not ctx.probe.count("prep"):
        return None
    return 1e6 * ctx.probe.total_s("prep") / sigs
