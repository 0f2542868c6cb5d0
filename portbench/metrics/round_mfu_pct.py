"""Whole round: the model FLOPs a round needs over the window's time at
the TF32 peak (the card's top dense rate for fp32 operands).

Counted from the configuration's shapes: each awake client's forward and
backward (``portbench/reference/<kind>.py``'s counts) on its batch and,
from the second round on, on the reference set; each awake client's
upload forward on the reference set; Eq. 2's 2 N N R C and Eq. 5's
2 N K R C each time the server fires. Work the port does beyond that
(rows stepped under a mask, three products for one) is not counted.
The awake share is that of the window's rounds."""
from portbench import spec


def eq2_operations(n: int, r: int, c: int) -> int:
    """Eq. 2's N x N divergence: one product over R C per pair."""
    return 2 * n * n * r * c


def client_flops(config: dict, in_dim: int, n_classes: int, length: int,
                 ref_size: int) -> float:
    """Model FLOPs of every client's step and upload in a round past the
    first, all awake."""
    n, b = config["n_clients"], config["batch_size"]
    fams = config["families"]
    steps = config["local_steps"]
    total = 0.0
    for i, fam in enumerate(fams):
        mod = spec.reference_kind(fam["kind"])
        n_f = len(range(i, n, len(fams)))
        fwd = mod.forward_flops(fam, in_dim, n_classes, length)
        bwd = mod.backward_flops(fam, in_dim, n_classes, length)
        total += n_f * ((fwd + bwd) * (b + ref_size) * steps
                        + fwd * ref_size)
    return total


def server_flops(config: dict, ref_size: int, n_classes: int) -> float:
    n, k = config["n_clients"], config["protocol"]["k"]
    return (eq2_operations(n, ref_size, n_classes)
            + 2 * n * k * ref_size * n_classes) / config["protocol"][
                "interval"]


def round_flops(config: dict, in_dim: int, n_classes: int, length: int,
                ref_size: int, awake: float) -> float:
    return (awake * client_flops(config, in_dim, n_classes, length,
                                 ref_size)
            + server_flops(config, ref_size, n_classes))


def read(ctx):
    w = ctx.window
    if not w or not ctx.peaks or w["seconds"] <= 0:
        return None
    flops = round_flops(ctx.config, ctx.length, ctx.n_classes, ctx.length,
                        ctx.ref_size, ctx.awake_share)
    return 100.0 * flops * w["rounds"] / (w["seconds"]
                                          * ctx.peaks["tf32_flops"])
