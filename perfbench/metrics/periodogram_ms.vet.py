"""periodogram_ms.vet: mean milliseconds of a vet's
``to_periodogram("bls")`` and the read of its winner, host clock."""
import numpy as np


def read(run):
    d = run.spans.durations("periodogram")
    return float(np.mean(d)) * 1e3 if d else None
