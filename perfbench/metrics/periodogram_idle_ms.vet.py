"""periodogram_idle_ms.vet: device-idle ms of the traced window inside the
program's ``periodogram.bls`` spans
(``BoxLeastSquaresPeriodogram.from_lightcurve``), per span."""
from perfbench.program_spans import per_span_idle_ms


def read(run):
    return per_span_idle_ms(run, "periodogram.bls")
