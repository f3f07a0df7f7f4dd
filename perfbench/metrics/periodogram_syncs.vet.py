"""periodogram_syncs.vet: the program's ``host_sync`` counts (the host
waiting on the device to read a value) inside its ``periodogram.bls``
spans of the traced window, per span."""
from perfbench.program_spans import counts_under


def read(run):
    return counts_under(run, "periodogram.bls", "host_sync")
