"""step_mfu.vet: step_mfu.sweep's reading (the window's counted
operations over its whole time at the card's float32 peak, in percent: the
whole vet's share of the chip's peak) in the vet cell, where it moves
vet_evals_per_s."""
from perfbench import harness


def read(run):
    return harness.reader(run.cell.root, "step_mfu.sweep")(run)
