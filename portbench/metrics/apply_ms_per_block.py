"""Host milliseconds per applied block inside BlockExecutor.apply_block
(validate, deliver to the kvstore app, results, app commit, state save)
and BlockStore.save_block, wrapped on the classes of the harness's
nodes (the only ones in the process)."""


def install(ctx):
    from tendermint_tpu_torch.state.execution import BlockExecutor
    from tendermint_tpu_torch.storage import BlockStore
    ctx.probe.wrap(BlockExecutor, "apply_block", "apply")
    ctx.probe.wrap(BlockStore, "save_block", "save")


def read(ctx):
    n = ctx.probe.count("apply")
    if not n:
        return None
    return 1e3 * (ctx.probe.total_s("apply") + ctx.probe.total_s("save")) / n
