"""flatten_idle_ms.vet: flatten_idle_ms.sweep's reading (device-idle ms
inside the program's ``flatten`` spans, per span) in the vet cell, where
it moves vet_evals_per_s."""
from perfbench import harness


def read(run):
    return harness.reader(run.cell.root, "flatten_idle_ms.sweep")(run)
