"""Percent of the add_votes calls' time spent inside the verifier
instance's verify_async and its resolver (spans around the instance's
public method and the resolver it returns)."""


def install(ctx):
    ctx.probe.wrap(ctx.state["verifier"], "verify_async", "dispatch",
                   resolver=True)


def read(ctx):
    total = ctx.window_stats.get("add_votes_s")
    if not total:
        return None
    inside = ctx.probe.total_s("dispatch") + ctx.probe.total_s(
        "dispatch.resolve")
    return 100.0 * inside / total
