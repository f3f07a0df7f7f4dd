"""flatten_ms.sweep: mean milliseconds of a step's flatten (the body of
``LightCurveStack.flatten``: ``ops.detrend.flatten_batch`` and the
division), host clock around the call ended by a device synchronize."""
import numpy as np


def read(run):
    d = run.spans.durations("flatten")
    return float(np.mean(d)) * 1e3 if d else None
