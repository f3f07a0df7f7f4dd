"""Traffic kind ``vet`` on the CPU at a tiny size: the cell
``tess_sector.vet`` keeps the contract and reports its metrics; a sound
run is correct, and the check fails the faults the public single-curve path can have -- times rounded
to float32 before the flatten, segment medians capped at 16, a flatten
that returns its input, a winner one period step off -- and the control,
the plain reference in TF32 put in the program's place."""
import json
import os

import numpy as np
import pytest
import torch

from perfbench import harness, limits
from perfbench.drivers import load_kind
from perfbench.tests.test_perfbench_harness import (check_contract,
                                                    runs_and_reports)
from perfbench.tests.tiny import tiny_root

CELL = "tess_sector.vet"
CADENCE = 2.0 / 1440


def _config(root, cell, **change):
    """Change the tiny copy of ``cell``'s configuration file."""
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    entry = next(w for w in bench["workloads"] if w["name"] == cell)
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    path = os.path.join(root, conf["file"])
    with open(path) as f:
        cfg = json.load(f)
    for key, value in change.items():
        block, _, name = key.partition(".")
        if name:
            cfg[block][name] = value
        else:
            cfg[block] = value
    with open(path, "w") as f:
        json.dump(cfg, f)


def _correct(root, cell=CELL, seed=2 ** 31 + 29):
    run, checks, *_ = harness.run_cell(harness.load_cell(cell, root), seed,
                                       0.5, False, device="cpu")
    return all(v <= lim for _, v, lim in checks), checks


@pytest.fixture
def root(tmp_path):
    return tiny_root(str(tmp_path))


@pytest.fixture
def runs_root(root):
    """Masked cadences at 40%: every curve has about 18 runs of exactly 4
    masked cadences, which float32 BTJD times all split and lightkurve's
    float64 ones split only where rounding puts the 5-cadence step above 5
    median steps, so every vet shows the fault."""
    _config(root, CELL, **{"assumed.masked_share": 0.4})
    return root


@pytest.fixture
def segments_root(root):
    """24 segments of 80 cadences, 8 cadences apart: each shorter than the
    window, so each takes its own median."""
    _config(root, CELL, **{"time.segments": [
        [i * 88 * CADENCE, 80] for i in range(24)]})
    return root


def test_the_cell_is_added_by_its_entries_alone(root):
    """The cell's entries in BENCHMARK.json keep the contract, and a traced
    run reports every per-layer metric that lists the cell, but for the
    roofline share (no device on the CPU), the periodogram's host reads
    at 8 a vet (one a result field)."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    check_contract(bench, root)
    listed = {m["name"] for m in bench["per_layer"]
              if CELL in m["workloads"] and "_roofline" not in m["name"]}
    assert {"periodogram_ms.vet", "flatten_ms.sweep"} <= listed
    run, traced = runs_and_reports(root, CELL)
    assert listed <= set(traced["metrics"])
    assert traced["metrics"]["periodogram_syncs.vet"]["value"] == 8


def test_hard_gaps_finds_the_cuts_rounding_decides():
    """A run of 4 masked cadences on a TESS grid is a step of 5 cadences,
    at the break tolerance of 5 median steps: hard.  A run of 3 is not,
    nor is any curve with no break tolerance; 17 segments are hard."""
    hard_gaps = load_kind(harness.ROOT, "vet").hard_gaps
    t = 1325.2931 + CADENCE * np.arange(2000)
    valid = np.ones(t.size, bool)
    assert not hard_gaps(t, valid, 5)
    run4, run3 = valid.copy(), valid.copy()
    run4[500:504] = False
    run3[500:503] = False
    assert hard_gaps(t, run4, 5)
    assert not hard_gaps(t, run3, 5)
    assert not hard_gaps(t, run4, None)
    cut = valid.copy()
    for i in range(16):
        cut[100 * i + 50:100 * i + 60] = False
    assert hard_gaps(t, cut, 5)
    assert not hard_gaps(t, cut, 5, max_segments=17)


@pytest.mark.parametrize("tree", ["root", "runs_root", "segments_root"])
def test_sound_runs_are_correct(request, tree):
    ok, checks = _correct(request.getfixturevalue(tree))
    assert ok, checks


def test_times_rounded_to_float32_before_the_flatten(runs_root, monkeypatch):
    from lightkurve_tpu_torch import lightcurve
    real = lightcurve._tensor

    def rounded(x, dtype=None):
        return real(x, torch.float32 if dtype == torch.float64 else dtype)

    monkeypatch.setattr(lightcurve, "_tensor", rounded)
    ok, checks = _correct(runs_root)
    assert not ok, checks
    assert "flat_err_curve_p99" in {n for n, v, lim in checks if v > lim}


def test_segment_medians_capped_at_16(segments_root, monkeypatch):
    from lightkurve_tpu_torch.ops import detrend
    real = detrend.flatten_batch

    def capped(time, flux, valid, H, bt, sigma, niters=3, max_segments=16):
        return real(time, flux, valid, H, bt, sigma, niters, 16)

    monkeypatch.setattr(detrend, "flatten_batch", capped)
    ok, checks = _correct(segments_root)
    assert not ok
    assert "flat_err_curve_p99" in {n for n, v, lim in checks if v > lim}


def test_a_flatten_that_returns_its_input(root, monkeypatch):
    from lightkurve_tpu_torch.ops import detrend
    real = detrend.flatten_batch

    def ones(*a, **k):
        trend, valid = real(*a, **k)
        return torch.ones_like(trend), valid

    monkeypatch.setattr(detrend, "flatten_batch", ones)
    assert not _correct(root)[0]


def test_a_winner_one_period_step_off(root, monkeypatch):
    from lightkurve_tpu_torch.periodogram import Periodogram

    def off(self):
        i = int(np.nanargmax(self.power.value))
        return self.period[i + 1 if i + 1 < len(self.period) else i - 1]

    monkeypatch.setattr(Periodogram, "period_at_max_power", property(off))
    ok, checks = _correct(root)
    assert not ok
    assert {n for n, v, lim in checks if v > lim} & {"winner_gap",
                                                    "winner_err"}


def test_the_control_is_not_correct(root):
    checks = limits.control_checks(harness.load_cell(CELL, root), 23,
                                   device="cpu")
    values = {n: v for n, v, _ in checks}
    assert not all(v <= lim for _, v, lim in checks), values
    assert np.isfinite(values["flat_err_curve_p99"])
