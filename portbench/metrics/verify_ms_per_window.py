"""Host milliseconds per verify window inside the node's verifier
instance's verify_async and its resolver (the resolver runs on the
reactor's resolver thread and mostly waits for the card)."""


def install(ctx):
    ctx.probe.wrap(ctx.state["verifier"], "verify_async", "dispatch",
                   resolver=True)


def read(ctx):
    n = ctx.probe.count("dispatch")
    if not n:
        return None
    return 1e3 * (ctx.probe.total_s("dispatch")
                  + ctx.probe.total_s("dispatch.resolve")) / n
