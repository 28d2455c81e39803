"""host_reads: the program's reads from the device to the host per op, from its ``host_read.<site>`` counters
(simplex_gp_torch.trace): the CG's stop flag each iteration and its state at the end, K3'a's n_lattice, the NLML's
mean residual."""

from gpbench.program_spans import counter_total


def read(ctx):
    reads = counter_total(ctx, "host_read.")
    return None if reads is None else reads / ctx["ops"]
