"""setup_s: seconds from the run's start to the end of its warm-up
(loading, data on the device, kernel builds, one warm-up of every shape)."""


def read(run):
    return run.setup_s
