"""sweep_idle_ms.sweep: device-idle ms of the traced window inside the
program's ``sweep`` spans (``parallel.checkpoint.SweepRunner.run``), per
``sweep`` span."""
from perfbench.program_spans import per_span_idle_ms


def read(run):
    return per_span_idle_ms(run, "sweep")
