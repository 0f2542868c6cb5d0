"""Server round: ms a round in ``ServerBus.fire`` (``policy_round``:
Eq. 1 grades, the pool, the Eq. 2 divergence, the neighbours, the Eq. 5
targets; then the dense32 downlink), host clock with the card
synchronized around the call."""
SPANS = ("bus.fire",)


def read(ctx):
    calls = ctx.spans.get(SPANS[0])
    if not calls or not ctx.span_rounds:
        return None
    return 1e3 * sum(calls) / ctx.span_rounds
