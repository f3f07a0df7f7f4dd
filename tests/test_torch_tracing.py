"""The program's spans and counters (lightkurve_tpu_torch.diagnostics) on the
CPU: the tree a tiny flatten and a tiny shared sweep record, nothing at all
while recording is off, the spans against their ``lk:`` ranges in a CPU
profiler's trace, ``idle_by_span`` on hand-made intervals, the
``host_sync`` counts, the timers and annotations as spans, the cap."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lightkurve_tpu_torch import config
from lightkurve_tpu_torch import diagnostics as diag
from lightkurve_tpu_torch.batch import LightCurveStack
from lightkurve_tpu_torch.ops.detrend import flatten_batch
from lightkurve_tpu_torch.ops.savgol import savgol_design_matrix
from lightkurve_tpu_torch.parallel.checkpoint import SweepRunner

ITER_CHILDREN = ["flatten.compact", "flatten.gaps", "flatten.savgol",
                 "flatten.median", "flatten.clip"]


@pytest.fixture(autouse=True)
def clean_registry(monkeypatch):
    monkeypatch.setattr(config, "default_device", "cpu")
    diag.disable()
    diag.reset()
    yield
    diag.disable()
    diag.reset()


def curves(B=4, n=600, gap_at=300):
    """B curves on one grid with a 1-d gap and three masked cadences."""
    rng = np.random.default_rng(0)
    t = np.arange(n) * 0.02
    t[gap_at:] += 1.0
    time = torch.tensor(np.broadcast_to(t, (B, n)).copy(),
                        dtype=torch.float32)
    flux = torch.tensor(1 + 1e-3 * rng.standard_normal((B, n)),
                        dtype=torch.float32)
    mask = torch.ones((B, n), dtype=torch.bool)
    mask[:, 50:53] = False
    return time, flux, mask


def flatten_and_sweep(tmp_path):
    """One flatten of :func:`curves` and one shared sweep of 100 periods
    in chunks of 32 over the flattened stack, checkpointed in
    ``tmp_path``."""
    time, flux, mask = curves()
    H = savgol_design_matrix(51, 2)
    trend, _ = flatten_batch(time, flux, mask, H, 5.0, 3.0, niters=3)
    stack = LightCurveStack(time=time, flux=flux / trend,
                            flux_err=torch.full(flux.shape, 1e-3),
                            mask=mask)
    runner = SweepRunner(stack, np.linspace(0.5, 2.0, 100),
                         np.array([0.05, 0.1]), str(tmp_path / "s.npz"),
                         chunk_periods=32, method="shared", async_save=True)
    return runner.run()


def children(spans, parent):
    return [s for s in spans if s.parent == parent.index]


def test_spans_nest_with_parents_and_attributes(tmp_path):
    diag.enable()
    flatten_and_sweep(tmp_path)
    spans = diag.spans()
    assert [s.index for s in spans] == list(range(len(spans)))
    top = [s for s in spans if s.parent == -1]
    assert [s.name for s in top] == ["flatten.design", "flatten", "sweep"]
    design, flat, sweep = top
    assert design.attrs == {"window_length": 51, "polyorder": 2}
    assert flat.attrs == {"curves": 4, "cadences": 600, "niters": 3}
    iters = children(spans, flat)
    assert [s.name for s in iters] == ["flatten.design"] + [
        "flatten.iter"] * 3
    for i, it in enumerate(iters[1:]):
        assert it.attrs == {"index": i}
        assert [s.name for s in children(spans, it)] == ITER_CHILDREN
    for s in spans:
        assert s.start_ns <= s.end_ns
        assert s.thread == spans[0].thread
        if s.parent != -1:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns

    assert sweep.attrs == {"chunks": 4, "curves": 4}
    kids = children(spans, sweep)
    names = [s.name for s in kids]
    assert names == ["sweep.prepare"] + ["sweep.chunk"] * 4 + [
        "sweep.wait", "sweep.merge", "sweep.flush"]
    chunks = kids[1:5]
    assert [c.attrs for c in chunks] == [
        {"index": i, "lo": 32 * i, "hi": min(32 * i + 32, 100)}
        for i in range(4)]
    for i, c in enumerate(chunks):
        want = ["sweep.dispatch"] + (["sweep.wait", "sweep.merge"] if i
                                     else [])
        assert [s.name for s in children(spans, c)] == want
        dispatch = children(spans, c)[0]
        prep, search = children(spans, dispatch)
        assert (prep.name, search.name) == ("bls.prepare", "bls.search")
        assert search.attrs["route"] == "fused"
        assert search.attrs["slices"] == 0
        assert search.attrs["curves"] == 4 and search.attrs["periods"] == 32
        assert search.attrs["rows"] > 0
        if i:
            merge = children(spans, c)[2]
            assert [s.name for s in children(spans, merge)] == [
                "sweep.save"]
    assert diag.dropped() == 0


def test_the_staged_route_records_its_slices(tmp_path):
    from lightkurve_tpu_torch.ops.bls import bls_power_shared_batch
    time, flux, _ = curves()
    diag.enable()
    bls_power_shared_batch(time[0], flux, None, np.linspace(0.5, 2.0, 20),
                           np.array([0.05, 0.1]), chunk=8,
                           fold_impl="staged")
    search, = [s for s in diag.spans() if s.name == "bls.search"]
    assert search.attrs["route"] == "staged"
    assert search.attrs["slices"] == 3                 # 20 periods by 8
    assert search.attrs["periods"] == 20


def test_nothing_is_recorded_or_opened_while_off(tmp_path, monkeypatch):
    opened = []

    class Range:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(diag, "_FastRange", Range)
    assert not diag.recording()
    assert diag.span("x") is diag.span("y", a=1)       # one shared no-op
    want = flatten_and_sweep(tmp_path)
    assert diag.spans() == [] and diag.counters() == {}
    assert opened == []
    diag.enable()
    (tmp_path / "on").mkdir()
    got = flatten_and_sweep(tmp_path / "on")
    assert opened and all(n.startswith("lk:") for n in opened)
    assert len(opened) == len(diag.spans())
    for f in want:                      # recording changes no output
        np.testing.assert_array_equal(got[f], want[f])


def test_spans_match_their_ranges_in_a_cpu_profile(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert diag.recording()
        flatten_and_sweep(tmp_path)
    assert not diag.recording()
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("lk:"):
            # a function-scope range: not mirrored on a device's timeline
            assert not e.is_user_annotation()
            ranges.setdefault(e.name()[3:], []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    spans = diag.spans()
    assert spans
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    assert sorted(by_name) == sorted(ranges)
    for name, recs in by_name.items():
        got = sorted(ranges[name])
        assert len(got) == len(recs), name
        for s, (a, b) in zip(recs, got):
            assert abs(s.start_ns - a) < 1_000_000, name
            assert abs(s.end_ns - b) < 1_000_000, name


def test_host_sync_counts_two_per_clip_iteration(tmp_path):
    diag.enable()
    time, flux, mask = curves()
    H = savgol_design_matrix(51, 2)
    flatten_batch(time, flux, mask, H, 5.0, 3.0, niters=3)
    spans = diag.spans()
    savgol = [s for s in spans if s.name == "flatten.savgol"]
    assert [s.counts for s in savgol] == [{"host_sync": 2}] * 3
    assert diag.counters() == {"host_sync": 6}
    # segments shorter than the window: no end window, one read
    diag.reset()
    flatten_batch(time, flux, mask, savgol_design_matrix(401, 2), 5.0,
                  3.0, niters=2)
    assert diag.counters() == {"host_sync": 2}


def test_the_sweep_counts_its_set_up_reads(tmp_path):
    diag.enable()
    time, flux, mask = curves()
    stack = LightCurveStack(time=time, flux=flux,
                            flux_err=torch.full(flux.shape, 1e-3),
                            mask=torch.ones_like(mask))
    SweepRunner(stack, np.linspace(0.5, 2.0, 40), np.array([0.05]),
                str(tmp_path / "s.npz"), chunk_periods=32,
                method="shared").run()
    prep, = [s for s in diag.spans() if s.name == "sweep.prepare"]
    # every cadence valid: the mask, flux_err and time row tests
    assert prep.counts == {"host_sync": 3}


def span(name, start, end, parent=-1, thread=1, index=0):
    s = diag.Span(name, {}, parent, thread, index)
    s.start_ns, s.end_ns = start, end
    return s


def test_idle_by_span_on_hand_made_intervals():
    spans = [span("step", 10, 90, index=0),
             span("inner", 20, 40, parent=0, index=1),
             span("deep", 25, 30, parent=1, index=2),
             span("other", 50, 60, parent=0, index=3),
             span("thread2", 12, 100, thread=2, index=4),
             span("later", 95, None, index=5)]       # still open
    busy = [(22, 27), (26, 28), (45, 55), (200, 300)]
    got = diag.idle_by_span(busy, (0, 100), spans)
    # idle: [0, 22) [28, 45) [55, 100)
    assert got == {"outside": 10 + 5, "step": 10 + 5 + 30,
                   "inner": 2 + 10, "deep": 2, "other": 5, "later": 5}
    assert sum(got.values()) == 100 - 6 - 10
    # another thread's spans count where its span is the earliest
    spans[4].start_ns = 5
    assert diag.idle_by_span(busy, (0, 100), spans) == {
        "outside": 5, "thread2": 79}
    assert diag.idle_by_span([], (0, 10), []) == {"outside": 10}


def test_busy_intervals_leave_out_annotations():
    from torch.autograd import DeviceType

    def ev(name, start, end, device, user=False):
        return SimpleNamespace(
            name=lambda: name, start_ns=lambda: start,
            duration_ns=lambda: end - start,
            device_type=lambda: DeviceType.CUDA if device
            else DeviceType.CPU, is_user_annotation=lambda: user)

    events = [ev("kernel", 5, 20, True), ev("pb:sweep", 0, 50, True, True),
              ev("aten::add", 0, 3, False), ev("copy", 30, 40, True)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    assert diag.busy_intervals(prof) == [(5, 20), (30, 40)]


def test_timers_and_annotations_are_spans_while_recording():
    with diag.KernelTimer("off"):
        pass
    assert diag.spans() == [] and diag.report()["off"]["calls"] == 1
    diag.enable()
    with diag.KernelTimer("timer"):
        with diag.annotate("note"):
            diag.count("things", 3)
    timer, note = diag.spans()
    assert (timer.name, note.name, note.parent) == ("timer", "note", 0)
    assert note.counts == {"things": 3}
    assert diag.report()["timer"]["calls"] == 1
    diag.reset()
    assert diag.report() == {} and diag.spans() == []


def test_past_the_cap_spans_are_dropped_and_counted(monkeypatch):
    monkeypatch.setattr(diag, "MAX_SPANS", 3)
    diag.enable()
    with diag.span("a"):
        for _ in range(4):
            with diag.span("b") as rec:
                diag.set_attrs(k=1)
    assert [s.name for s in diag.spans()] == ["a", "b", "b"]
    assert rec is None and diag.dropped() == 2
    assert [s.attrs for s in diag.spans()] == [{}, {"k": 1}, {"k": 1}]
    with diag.span("c"):
        pass
    assert diag.dropped() == 3


def vet_curve(n=1500):
    """A TESS-like curve of float64 BTJD times: a gap, NaN cadences, a
    transit every 1.3 d."""
    from lightkurve_tpu_torch import LightCurve
    from lightkurve_tpu_torch.time import Time
    rng = np.random.default_rng(1)
    t = 1325.2931 + np.arange(n) * (2.0 / 1440)
    t[n // 2:] += 1.0
    flux = 1.0 + 2e-4 * rng.standard_normal(n)
    flux[np.abs(np.mod(t - 1325.5 + 0.65, 1.3) - 0.65) < 0.04] -= 2e-3
    flux[rng.random(n) < 0.03] = np.nan
    return LightCurve(time=Time(t, format="btjd"), flux=flux,
                      flux_err=np.full(n, 2e-4))


@pytest.mark.parametrize("method,route", [("fast", "binned"),
                                          ("exact", "exact")])
def test_the_vet_path_spans_nest_with_attributes(monkeypatch, method,
                                                 route):
    """``LightCurve.flatten`` then ``to_periodogram("bls")``: their spans,
    the per-curve BLS's chunks (7 periods a chunk here) and one
    ``host_sync`` for each device read on the path."""
    from lightkurve_tpu_torch.ops import bls
    from lightkurve_tpu_torch.periodogram import BoxLeastSquaresPeriodogram
    from perfbench.program_spans import counts_under
    monkeypatch.setattr(bls, "_periods_per_step", lambda B, work: 7)
    lc = vet_curve()
    diag.enable()
    pg = BoxLeastSquaresPeriodogram.from_lightcurve(
        lc.flatten(window_length=101), minimum_period=1.0,
        maximum_period=1.6, method=method)
    spans = diag.spans()
    P = len(pg.period)
    top = [s for s in spans if s.parent == -1]
    assert [s.name for s in top] == ["lc.flatten", "periodogram.bls"]
    flat, per = top
    assert flat.attrs == {"cadences": 1500}
    assert [s.name for s in children(spans, flat)] == [
        "lc.flatten.host", "flatten", "lc.flatten.out"]
    host, inner, out = children(spans, flat)
    assert [s.name for s in children(spans, host)] == ["flatten.design"]
    assert inner.attrs["curves"] == 1 and inner.attrs["cadences"] == 1500
    assert out.counts == {"host_sync": 1}
    assert per.attrs == {"cadences": int(np.isfinite(lc.flux.value).sum()),
                         "periods": P, "durations": 6, "method": method}
    assert [s.name for s in children(spans, per)] == [
        "periodogram.grid", "bls.curve", "periodogram.result"]
    grid, curve, result = children(spans, per)
    chunks = -(-P // 7)
    assert curve.attrs == {"route": route, "periods": P, "chunks": chunks}
    kids = children(spans, curve)
    assert [s.name for s in kids] == ["bls.curve.chunk"] * chunks
    assert [s.attrs for s in kids] == [
        {"index": i, "periods": min(7, P - 7 * i)} for i in range(chunks)]
    assert result.counts == {"host_sync": 8}
    for s in spans:
        if s.parent != -1:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    counts = diag.counters()
    assert counts["bls.curve.chunks"] == chunks
    # the flatten's own reads: two a clip iteration (ops/savgol.py)
    assert counts["host_sync"] == 1 + 6 + 8
    # what periodogram_syncs.vet reads from a traced window
    run = SimpleNamespace(trace=SimpleNamespace(window_ns=(
        spans[0].start_ns, max(s.end_ns for s in spans) + 1)))
    assert counts_under(run, "periodogram.bls", "host_sync") == 8
