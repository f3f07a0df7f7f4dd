"""step_mfu.sweep: the operations the window's searches need (the
benchmark's own count) over the window's whole time, flatten and search
both, at the card's float32 peak, in percent: the whole step's share of
the chip's peak."""
from perfbench.roofline import PEAKS


def read(run):
    if not run.searches or run.window_s <= 0:
        return None
    ops = sum(o for _, o in run.searches)
    return 100.0 * ops / (run.window_s * PEAKS["f32"])
