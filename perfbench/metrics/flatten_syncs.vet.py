"""flatten_syncs.vet: flatten_syncs.sweep's reading (``host_sync`` inside
the program's ``flatten`` spans, per span) in the vet cell, where it
moves vet_evals_per_s."""
from perfbench import harness


def read(run):
    return harness.reader(run.cell.root, "flatten_syncs.sweep")(run)
