"""Client step: ms a round in ``ClientRuntime.local_round`` (every
cohort's gated SGD step, ``core/client.py`` ``sharded_cohort_step``),
host clock with the card synchronized around the call."""
SPANS = ("clients.local_round",)


def read(ctx):
    calls = ctx.spans.get(SPANS[0])
    if not calls or not ctx.span_rounds:
        return None
    return 1e3 * sum(calls) / ctx.span_rounds
