"""flatten_syncs.sweep: the program's ``host_sync`` counts (the host
waiting on the device to read a value) inside its ``flatten`` spans of
the traced window, per ``flatten`` span."""
from perfbench.program_spans import counts_under


def read(run):
    return counts_under(run, "flatten", "host_sync")
