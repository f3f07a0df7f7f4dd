"""device_idle_frac.vet: device_idle_frac.sweep's reading (the traced
window's share with no device activity) in the vet cell, where it moves
vet_evals_per_s."""
from perfbench import harness


def read(run):
    return harness.reader(run.cell.root, "device_idle_frac.sweep")(run)
