"""lightkurve_tpu_torch.diagnostics against lightkurve_tpu.diagnostics on the
CPU: the timers' registry and report after the same calls, reset, the
memory counters on the CPU, and a torch.profiler trace written into a
directory with an annotated region in it."""
import json
import os

import pytest
import torch

from lightkurve_tpu import diagnostics as jdiag
from lightkurve_tpu_torch import config
from lightkurve_tpu_torch import diagnostics as tdiag


@pytest.fixture(autouse=True)
def clean_registries(monkeypatch):
    monkeypatch.setattr(config, "default_device", "cpu")
    jdiag.reset()
    tdiag.reset()
    yield
    jdiag.reset()
    tdiag.reset()


def drive(diag):
    """The same calls through either package's timers."""
    @diag.timed()
    def add(a, b):
        return a + b

    @diag.timed("named")
    def mul(a, b):
        return a * b

    for i in range(3):
        add(i, 1)
    mul(2, 3)
    for _ in range(2):
        with diag.KernelTimer("block"):
            sum(range(100))
    return add(1, 2), mul(2, 2)


def test_timers_and_report_match_the_reference():
    assert drive(tdiag) == drive(jdiag) == (3, 4)
    got, want = tdiag.report(), jdiag.report()
    assert sorted(got) == sorted(want)
    for name, entry in want.items():
        assert sorted(got[name]) == sorted(entry) == ["calls", "max_s",
                                                      "total_s"]
        assert got[name]["calls"] == entry["calls"]
        assert 0 <= got[name]["max_s"] <= got[name]["total_s"]
    assert got["named"]["calls"] == got["block"]["calls"] == 2
    assert tdiag.report(sort_by="calls") == got


def test_reset_empties_the_registry():
    drive(tdiag)
    assert tdiag.report()
    tdiag.reset()
    assert tdiag.report() == {}


def test_timer_device_resolution(monkeypatch):
    """The timers take the configured device and refuse the card where
    there is none, as the entry points do."""
    assert tdiag.KernelTimer("x").device.type == "cpu"
    monkeypatch.setattr(config, "default_device", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdiag.KernelTimer("x")
    assert tdiag.KernelTimer("x", device="cpu").device.type == "cpu"


def test_hbm_stats_on_the_cpu_is_empty(monkeypatch):
    assert tdiag.hbm_stats(device="cpu") == {}
    assert tdiag.hbm_stats(torch.device("cpu")) == {}
    monkeypatch.setattr(config, "default_device", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tdiag.hbm_stats() == {}


def test_trace_writes_a_trace_with_the_annotation(tmp_path):
    logdir = tmp_path / "trace"
    with tdiag.trace(str(logdir), device="cpu") as prof:
        with tdiag.annotate("prf_region"):
            torch.ones(64).cumsum(0)
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(logdir / files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name") == "prf_region" for e in events)
    assert any(e.key == "prf_region" for e in prof.key_averages())
