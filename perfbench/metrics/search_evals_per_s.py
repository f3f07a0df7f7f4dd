"""search_evals_per_s: curves x trial periods searched over the window,
all steps' work over the window's whole time."""


def read(run):
    work = run.counters.get("curve_periods")
    return None if not work or run.window_s <= 0 else work / run.window_s
