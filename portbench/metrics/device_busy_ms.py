"""Device: ms a round in which some operation ran on the card, from the
profiler's device events merged over the profiled rounds. It leaves the
host's gaps out, so it reads the kernels' work steadier than
``round_ms`` does."""


def read(ctx):
    p = ctx.profile
    if not p or not p["rounds"] or p["busy_s"] <= 0:
        return None
    return 1e3 * p["busy_s"] / p["rounds"]
