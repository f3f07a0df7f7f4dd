"""The check fails what it must: a run with the timed path broken
underneath (the faults a cell can have), and the control -- the plain
reference in TF32 put in the program's place -- on the CPU at a tiny
size.  (One chip, so no exchange between chips can be left out.)"""
import numpy as np
import pytest
import torch

from perfbench import harness, limits
from perfbench.tests.tiny import cells_of_kind, set_traffic, tiny_root

SEARCHING = cells_of_kind("sweep")


def _correct(root, cell, seed=2 ** 31 + 17):
    run, checks, *_ = harness.run_cell(harness.load_cell(cell, root), seed,
                                       0.0, False, device="cpu")
    return all(v <= lim for _, v, lim in checks), checks


@pytest.fixture
def root(tmp_path):
    r = tiny_root(str(tmp_path))
    for cell in SEARCHING:
        set_traffic(r, cell, check_curves_per_stack=8)   # every curve
    return r


@pytest.mark.parametrize("cell", SEARCHING)
def test_sound_runs_are_correct(root, cell):
    ok, checks = _correct(root, cell)
    assert ok, checks


@pytest.mark.parametrize("cell", SEARCHING)
def test_a_search_that_returns_its_state_unchanged(root, cell, monkeypatch):
    from lightkurve_tpu_torch.parallel.checkpoint import SweepRunner
    monkeypatch.setattr(SweepRunner, "run", lambda self, max_chunks=None:
                        dict(self.state))
    assert not _correct(root, cell)[0]


@pytest.mark.parametrize("cell", SEARCHING)
def test_half_of_the_batch_left_out(root, cell, monkeypatch):
    """The search runs on the first half of the curves; the rest keep the
    runner's starting state."""
    from lightkurve_tpu_torch.parallel import checkpoint
    real = checkpoint._reduce_winner

    def half(out, n_valid):
        w = real(out, n_valid)
        B = w.shape[1]
        w[:, B // 2:] = float("nan")
        return w

    monkeypatch.setattr(checkpoint, "_reduce_winner", half)
    assert not _correct(root, cell)[0]


@pytest.mark.parametrize("cell", SEARCHING)
@pytest.mark.parametrize("field,scale", [("power", 3.0), ("depth", 3.0),
                                         ("period", 1.001)])
def test_an_answer_altered_where_it_is_produced(root, cell, monkeypatch,
                                                field, scale):
    from lightkurve_tpu_torch.parallel import checkpoint
    real = checkpoint._reduce_winner
    i = checkpoint._FIELDS.index(field)

    def altered(out, n_valid):
        w = real(out, n_valid)
        w[i] = w[i] * scale
        return w

    monkeypatch.setattr(checkpoint, "_reduce_winner", altered)
    assert not _correct(root, cell)[0]


def _patch_flatten(monkeypatch, change):
    """Let ``change(trend)`` alter the trend ``flatten_batch`` returns."""
    from lightkurve_tpu_torch.ops import detrend
    real = detrend.flatten_batch

    def altered(*a, **k):
        trend, valid = real(*a, **k)
        return change(trend.clone()), valid

    monkeypatch.setattr(detrend, "flatten_batch", altered)


@pytest.mark.parametrize("cell", SEARCHING)
def test_a_flatten_that_returns_its_input(root, cell, monkeypatch):
    _patch_flatten(monkeypatch, lambda trend: torch.ones_like(trend))
    assert not _correct(root, cell)[0]


@pytest.mark.parametrize("cell", SEARCHING)
def test_one_segment_of_one_curve_mis_flattened(root, cell, monkeypatch):
    """The last 2.5% of one curve's cadences flattened 2e-4 off: under 1%
    of the checked cadences pooled, so only a per-curve percentile sees
    it."""
    def change(trend):
        n = trend.shape[1]
        trend[0, n - n // 40:] *= 1.0 + 2e-4
        return trend

    _patch_flatten(monkeypatch, change)
    ok, checks = _correct(root, cell)
    assert not ok
    assert "flat_err_curve_p99" in {n for n, v, lim in checks if v > lim}


@pytest.mark.parametrize("cell", SEARCHING)
def test_the_control_is_not_correct(root, cell):
    checks = limits.control_checks(harness.load_cell(cell, root), 23,
                                   device="cpu")
    values = {n: v for n, v, _ in checks}
    assert not all(v <= lim for _, v, lim in checks), values
    assert np.isfinite(values["flat_err_curve_p99"])
