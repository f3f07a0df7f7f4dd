"""flatten_idle_ms.sweep: device-idle ms of the traced window inside the
program's ``flatten`` spans (``ops.detrend.flatten_batch``) and its
top-level ``flatten.design`` spans (``ops.savgol.savgol_design_matrix``
called before it), per ``flatten`` span."""
from perfbench.program_spans import per_span_idle_ms


def read(run):
    return per_span_idle_ms(run, "flatten", also=("flatten.design",))
