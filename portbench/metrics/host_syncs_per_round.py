"""Dispatch: the host's blocking waits on the card a round, the
program's ``host_syncs`` counter summed over its sites (pageable copies
to the card, ``.cpu()``, ``bool()`` of a device tensor,
``torch.nonzero``)."""
from portbench import program_trace

PROGRAM = True


def read(ctx):
    return program_trace.syncs_per_round(ctx)
