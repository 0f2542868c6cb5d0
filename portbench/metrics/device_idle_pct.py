"""Device: the share of the profiled rounds' wall time in which no
operation ran on the card (torch.profiler's device events, merged)."""


def read(ctx):
    p = ctx.profile
    if not p or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
