"""vet_evals_per_s: the vet cell's curves x trial periods searched over the
window, read as search_evals_per_s reads them: its own metric, so that it
has a bound of its own (the vet's rate follows the host's speed)."""
from perfbench import harness


def read(run):
    return harness.reader(run.cell.root, "search_evals_per_s")(run)
