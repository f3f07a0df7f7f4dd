"""The traced window's share with no device activity (the union of every
kernel, copy and set on the device, from torch.profiler)."""


def read(run):
    return None if run.trace is None else run.trace.idle_fraction()
