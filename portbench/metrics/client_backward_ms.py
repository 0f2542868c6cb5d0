"""Client step: host ms a round in ``client.backward``
(``torch.autograd.grad`` in ``cohort_step``), self time summed over the
cohorts, from the program's own spans (``repro_torch.trace``): host
time with no synchronize."""
from portbench import program_trace

PROGRAM = True


def read(ctx):
    return program_trace.self_ms(ctx, "client.backward")
