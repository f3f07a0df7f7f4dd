"""flatten_ms.vet: flatten_ms.sweep's reading (mean ms of the kind's
``flatten`` span, host clock) in the vet cell, where it moves
vet_evals_per_s."""
from perfbench import harness


def read(run):
    return harness.reader(run.cell.root, "flatten_ms.sweep")(run)
