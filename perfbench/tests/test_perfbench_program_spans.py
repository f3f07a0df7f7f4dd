"""The readers of the program's own spans and counters on a tiny traced CPU
run of each cell of kind ``sweep``: sound values, and nothing read where
there is no trace or where the program records no spans (a checkout from
before it had them)."""
import pytest

from perfbench import harness
from perfbench.tests.tiny import cells_of_kind, tiny_root

READERS = ("flatten_idle_ms.sweep", "sweep_idle_ms.sweep",
           "flatten_syncs.sweep")


@pytest.mark.parametrize("cell", cells_of_kind("sweep"))
def test_the_program_span_readers_read_a_traced_run(tmp_path, cell,
                                                    monkeypatch):
    from lightkurve_tpu_torch import diagnostics
    root = tiny_root(str(tmp_path))
    c = harness.load_cell(cell, root)
    run, *_ = harness.run_cell(c, 2 ** 31 + 11, 0.2, True, device="cpu")
    got = {m: harness.reader(root, m)(run) for m in READERS}
    assert got["flatten_syncs.sweep"] == 6.0           # 3 clip iterations
    flat_ms = 1e3 * run.spans.total("flatten") / len(
        run.spans.durations("flatten"))
    # no device activity in a CPU trace: all of a span is idle, and the
    # program's flatten lies inside the benchmark's
    assert 0 < got["flatten_idle_ms.sweep"] <= flat_ms
    sweep_ms = 1e3 * run.spans.total("sweep") / len(
        run.spans.durations("sweep"))
    assert 0 < got["sweep_idle_ms.sweep"] <= sweep_ms
    assert {m["name"] for m in c.per_layer} >= set(READERS)

    run.trace, trace = None, run.trace
    assert all(harness.reader(root, m)(run) is None for m in READERS)
    run.trace = trace
    monkeypatch.delattr(diagnostics, "spans")
    assert all(harness.reader(root, m)(run) is None for m in READERS)
