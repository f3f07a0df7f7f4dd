"""Traffic kind ``vet`` on the CPU at a tiny size: the cell
``tess_sector.vet`` keeps the contract and reports its metrics; a run keeps
at most two reservoirs of ``check_vets`` vets whole and counts every search
as keeping them all would; a sound run is correct, and the check fails the faults the
public single-curve path can have -- times rounded to float32 before the
flatten, segment medians capped at 16, a flatten that returns its input,
a winner one period step off -- and the control, the plain reference in
TF32 put in the program's place."""
import json
import os
import weakref

import numpy as np
import pytest
import torch

from perfbench import data, drivers, harness, limits
from perfbench.drivers import load_kind
from perfbench.roofline import search_counts
from perfbench.tests.test_perfbench_harness import (check_contract,
                                                    runs_and_reports)
from perfbench.tests.tiny import tiny_root

CELL = "tess_sector.vet"
CADENCE = 2.0 / 1440
#: seconds of a tiny run's window: the check needs ``check_vets`` vets
WINDOW = 2.0


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
                                       WINDOW, False, device="cpu")
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
    assert {"periodogram_ms.vet", "flatten_ms.vet"} <= listed
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
    assert not hard_gaps(t, valid[None], 5)[0]
    run4, run3 = valid.copy(), valid.copy()
    run4[500:504] = False
    run3[500:503] = False
    assert hard_gaps(t, run4[None], 5)[0]
    assert not hard_gaps(t, run3[None], 5)[0]
    assert not hard_gaps(t, run4[None], None)[0]
    cut = valid.copy()
    for i in range(16):
        cut[100 * i + 50:100 * i + 60] = False
    assert hard_gaps(t, cut[None], 5)[0]
    assert not hard_gaps(t, cut[None], 5, max_segments=17)[0]


def _plain_hard_gaps(t, valid, break_tolerance, max_segments=16, rtol=1e-6):
    """The gap test of one curve in numpy, as the kind first had it."""
    dt = np.diff(np.asarray(t, np.float64)[np.asarray(valid, bool)])
    if dt.size == 0 or break_tolerance is None:
        return False
    limit = float(break_tolerance) * np.median(dt)
    close = np.abs(dt - limit) <= rtol * limit
    return bool(close.any() or (dt > limit).sum() + 1 > max_segments)


@pytest.mark.parametrize("cadences", [1999, 2000])
def test_hard_gaps_of_a_pool_reads_each_curve_as_numpy(cadences):
    """The pool's test, in two blocks of rows, gives each curve the answer
    of the one-curve numpy test, at an odd and an even count of steps."""
    hard_gaps = load_kind(harness.ROOT, "vet").hard_gaps
    t = 1325.2931 + CADENCE * np.arange(cadences)
    t[cadences // 2:] += 1.0
    g = torch.Generator().manual_seed(3)
    order = torch.argsort(torch.rand((300, cadences), generator=g), dim=1)
    valid = torch.ones((300, cadences), dtype=torch.bool)
    valid.scatter_(1, order[:, :200], False)
    got = hard_gaps(t, valid, 5)
    want = np.array([_plain_hard_gaps(t, v, 5) for v in valid.numpy()])
    assert 0 < want.sum() < want.size
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(hard_gaps(t, valid, 5, max_segments=2),
                                  [_plain_hard_gaps(t, v, 5, 2)
                                   for v in valid.numpy()])
    assert not hard_gaps(t, valid, None).any()


def _driver(root, seed):
    cell = harness.load_cell(CELL, root)
    drv = drivers.make(cell, seed, "cpu", harness.Run(cell=cell), None)
    drv.setup()
    return drv


def test_a_run_keeps_at_most_two_reservoirs_whole(root):
    """However long the window, at most ``check_vets`` hard and
    ``check_vets`` other vets' outputs are alive, drawn from the whole
    window, the rest freed; every vet leaves its curve and its number of
    periods.  The sample takes the kept hard ones first."""
    drv = _driver(root, 2 ** 31 + 41)
    k = drv.traffic["check_vets"]
    made = []

    def vet(c):
        flat = np.full(drv.t.size, float(len(made)))
        made.append(weakref.ref(flat))
        return flat, {}, np.ones(7)

    drv.vet = vet
    steps = 3 * len(drv.order)
    for _ in range(steps):
        drv.step()
    alive = sum(r() is not None for r in made)
    easy, hard = drv.kept
    assert len(easy) == k and len(hard) == min(k, drv.seen[1]) > 0
    assert alive == len(easy) + len(hard) <= 2 * k <= 64
    at = [int(f[0]) for _, f, _ in easy + hard]
    assert max(at) >= 2 * steps // 3 and min(at) < steps // 3
    assert all(drv.hard[i % (len(drv.order) - 1)] for i in
               (int(f[0]) for _, f, _ in hard))
    assert len(drv.searched) == steps
    assert all(s == (int(drv.order[i % (len(drv.order) - 1)]), 7)
               for i, s in enumerate(drv.searched))
    drv.draw_sample()
    got = [f[0] for _, f, _ in drv.sample]
    assert len(got) == k and got[:len(hard)] == [f[0] for _, f, _ in hard]
    drv.restore_config()


def test_the_counted_searches_are_those_of_every_vet_kept(root):
    """``curve_periods`` and the searches' counts equal those of keeping
    every vet's valid cadences and periods, the program's own, as the kind
    first did; a count for a grid the program did not search raises."""
    drv = _driver(root, 2 ** 31 + 43)
    vet, old = drv.vet, []

    def vet_and_keep(c):
        flat, win, periods = vet(c)
        old.append((int(drv.valid[c].sum()), periods))
        return flat, win, periods

    drv.vet = vet_and_keep
    for _ in range(24):
        drv.step()
    drv.release()
    want = [search_counts(n, 1, n, periods, drv.search["durations"],
                          drv.search["oversample"], weighted=True)
            for n, periods in old]
    assert drv.run.searches == want
    assert drv.run.counters["curve_periods"] == sum(p.size for _, p in old)
    assert len(drv.sample) == drv.traffic["check_vets"]
    drv = _driver(root, 2 ** 31 + 43)
    drv.searched = [(int(drv.order[0]), 5)]
    with pytest.raises(RuntimeError, match="searched 5 periods"):
        drv.record_searches()
    drv.restore_config()


def test_a_window_too_short_for_the_check_raises(root):
    with pytest.raises(RuntimeError, match="the check needs 16"):
        harness.run_cell(harness.load_cell(CELL, root), 2 ** 31 + 47, 0.0,
                         False, device="cpu")


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
