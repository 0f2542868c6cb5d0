"""Dispatch: host ms a round inside the program's ``sync`` spans, the
time the host is held at its blocking waits on the card."""
from portbench import program_trace

PROGRAM = True


def read(ctx):
    return program_trace.sync_wait_ms(ctx)
