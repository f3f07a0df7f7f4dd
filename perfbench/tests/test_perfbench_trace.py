"""The reading of a profiler trace: busy union, idle share, busy time
inside a span, idle gaps named by span, annotations kept off the device."""
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from perfbench import trace


class _Event:
    def __init__(self, name, start, end, device):
        self._v = (name, start, end - start,
                   DeviceType.CUDA if device else DeviceType.CPU)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]


def _prof(events):
    ev = [_Event(*e) for e in events]
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: ev)))


def test_summary_of_a_hand_made_trace():
    prof = _prof([
        ("pb:window", 0, 100, False), ("pb:window", 0, 100, True),
        ("pb:sweep", 10, 60, False), ("pb:sweep", 10, 60, True),
        ("pb:load_wait", 60, 100, False),
        ("kernel_a", 5, 20, True), ("kernel_a", 15, 30, True),
        ("kernel_b", 40, 55, True), ("copy", 90, 120, True),
        ("aten::add", 0, 1, False)])
    s = trace.summarize(prof)
    assert s.window_s == pytest.approx(100e-9)
    # [5, 30] + [40, 55] + [90, 100] (clipped to the window)
    assert s.busy_s == pytest.approx(50e-9)
    assert s.idle_fraction() == pytest.approx(0.5)
    assert s.busy_in("sweep") == pytest.approx(35e-9)       # 10-30, 40-55
    assert dict(s.device_ops()) == pytest.approx(
        {"kernel_a": 30e-9, "kernel_b": 15e-9, "copy": 30e-9})
    gaps = s.idle_gaps()
    assert gaps[0] == ["load_wait", pytest.approx(35e-9)]   # 55-90
    assert [g[0] for g in gaps[1:]] == ["sweep", "outside spans"]


def test_a_trace_without_a_window_is_refused():
    with pytest.raises(RuntimeError):
        trace.summarize(_prof([("kernel", 0, 1, True)]))
