"""Upload: ms a round in ``ClientRuntime.collect_messengers`` (the
messengers and their dense32 encoding) and ``ServerBus.deliver`` without
the ``fire`` it makes (the repository merge), host clock with the card
synchronized around each call."""
SPANS = ("clients.collect_messengers", "bus.deliver", "bus.fire")


def read(ctx):
    collect, deliver, fire = (ctx.spans.get(p) for p in SPANS)
    if not collect or not deliver or not ctx.span_rounds:
        return None
    return 1e3 * (sum(collect) + sum(deliver) - sum(fire or [])) \
        / ctx.span_rounds
