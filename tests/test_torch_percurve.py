"""lightkurve_tpu_torch per-curve BLS, mixed time grids and the sweep
methods against lightkurve_tpu, float64 on the CPU.

The same numpy inputs go through both packages.  Bar: identical
finite/-inf patterns and rtol 1e-9 on every field, with exact objective
ties allowed to rank either way (``assert_same``).  Times that the exact
method reads are jittered: on a commensurate regular grid a sample can sit
exactly on a window edge t0 ± d/2, and the reference's compiler contracts
``t0 * d_phase ± d/2`` into one fused multiply-add where torch rounds the
product first, so such a sample may fall on either side (ROADMAP C).
"""
import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightkurve_tpu.batch import LightCurveStack as JStack
from lightkurve_tpu.ops import bls as jbls
from lightkurve_tpu.parallel import checkpoint as jckpt
from lightkurve_tpu_torch import config
from lightkurve_tpu_torch.batch import LightCurveStack as TStack
from lightkurve_tpu_torch.io.pipeline import StreamingStackLoader
from lightkurve_tpu_torch.ops import bls as tbls
from lightkurve_tpu_torch.parallel import checkpoint as tckpt

FIELDS = ("power", "depth", "depth_err", "depth_snr", "log_likelihood",
          "duration", "transit_time", "period")
PERIODS = np.linspace(1.5, 3.5, 48)
DURATIONS = np.array([0.1, 0.2])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same(a, b, tag="", fields=FIELDS):
    """Identical finite patterns and rtol 1e-9; where the winning
    (duration, transit_time) differs, power must still agree to 1e-9 (an
    exact tie summed in another order) and such cells must stay rare."""
    get = {k: (_np(a[k]), _np(b[k])) for k in fields}
    for k, (aa, bb) in get.items():
        assert aa.shape == bb.shape, (tag, k, aa.shape, bb.shape)
        np.testing.assert_array_equal(np.isfinite(aa), np.isfinite(bb),
                                      err_msg=f"{tag} {k}")
    (ta, tb), (da, db) = get["transit_time"], get["duration"]
    same = np.isclose(ta, tb, rtol=1e-9, atol=1e-12) & np.isclose(
        da, db, rtol=1e-9)
    assert (~same).mean() < 0.01, f"{tag}: {(~same).sum()} winner flips"
    for k, (aa, bb) in get.items():
        m = np.isfinite(aa) & (same | (k == "power"))
        np.testing.assert_allclose(bb[m], aa[m], rtol=1e-9, atol=1e-12,
                                   err_msg=f"{tag} {k}")


def curve(rng, n=300, period=2.6, t0=1.0, regular=False):
    t = (np.arange(n) * 0.02 + 0.0011 if regular
         else np.sort(rng.uniform(0, 15, n)))
    y = 1 + 5e-4 * rng.normal(size=n)
    ph = np.mod(t - t0 + period / 2, period) - period / 2
    y[np.abs(ph) < 0.08] -= 4e-3
    dy = rng.uniform(4e-4, 6e-4, n)
    dy[rng.random(n) < 0.05] = np.inf
    return t, y, dy


@pytest.mark.parametrize("objective", ["likelihood", "snr"])
def test_bls_power_matches_jax(rng, objective):
    """Exact per-curve BLS on one curve: sorted phases, prefix sums,
    searchsorted range queries."""
    t, y, dy = curve(rng)
    periods = np.linspace(1.2, 3.5, 37)
    a = jbls.bls_power(t, y, dy, periods, DURATIONS, objective=objective)
    b = tbls.bls_power(torch.from_numpy(t), torch.from_numpy(y),
                       torch.from_numpy(dy), periods, DURATIONS,
                       objective=objective, chunk=5)
    assert b["power"].shape == (37,)
    assert_same(a, b, objective)
    assert tbls.bls_power_direct is tbls.bls_power


@pytest.mark.parametrize("edge_mode", ["wrap", "astropy"])
@pytest.mark.parametrize("objective", ["likelihood", "snr"])
@pytest.mark.parametrize("regular", [False, True])
def test_bls_power_binned_matches_jax(rng, edge_mode, objective, regular):
    """Binned per-curve BLS, on random and on regular (bin-edge) times."""
    t, y, dy = curve(rng, regular=regular)
    periods = np.linspace(0.05, 3.5, 41)     # 0.05 d: no valid window
    kw = dict(objective=objective, edge_mode=edge_mode)
    a = jbls.bls_power_binned(t, y, dy, periods, DURATIONS, **kw)
    b = tbls.bls_power_binned(torch.from_numpy(t), torch.from_numpy(y),
                              torch.from_numpy(dy), periods, DURATIONS,
                              chunk=7, **kw)
    assert_same(a, b, f"{edge_mode}/{objective}")
    assert np.isneginf(b["power"].numpy()[0])


@pytest.mark.parametrize("method", ["exact", "binned"])
def test_per_curve_batch_equals_one_curve_calls(rng, method):
    """The batch dimension is the reference's vmap: a (B, n) call equals B
    one-curve calls, each curve on its own times."""
    fn = tbls.bls_power if method == "exact" else tbls.bls_power_binned
    curves = [curve(rng) for _ in range(3)]
    t, y, dy = (torch.from_numpy(np.stack(c)) for c in zip(*curves))
    periods = np.linspace(1.2, 3.5, 19)
    batch = fn(t, y, dy, periods, DURATIONS)
    for i in range(3):
        one = fn(t[i], y[i], dy[i], periods, DURATIONS)
        for k in FIELDS:
            torch.testing.assert_close(batch[k][i], one[k], rtol=0, atol=0)


def make_arrays(layout, B=6, n=400, seed=3):
    """Host arrays (time, flux, flux_err, mask) with one injected transit
    per curve.  'shared': one regular grid; 'mixed': two grids of three
    rows; 'percurve': each row its own jittered grid.  Per-cadence errors
    and ~3% masked cadences."""
    rng = np.random.default_rng(seed)
    base = np.arange(n) * 0.02 + 0.0011
    if layout == "shared":
        t = np.tile(base, (B, 1))
    elif layout == "mixed":
        t = np.stack([base + (10.0 if i % 2 else 0.0) for i in range(B)])
    else:
        t = base + rng.uniform(-0.004, 0.004, (B, n))
    p_inj = rng.uniform(1.8, 3.2, B)
    flux = 1.0 + 5e-4 * rng.standard_normal((B, n))
    for i in range(B):
        ph = np.mod(t[i] - 0.4 + p_inj[i] / 2, p_inj[i]) - p_inj[i] / 2
        flux[i, np.abs(ph) < 0.06] -= 6e-3
    fe = rng.uniform(4e-4, 6e-4, (B, n))
    mask = rng.random((B, n)) >= 0.03
    flux[~mask] = 0.0
    return (t, flux, fe, mask), p_inj


def stacks(layout, **kw):
    arrays, p_inj = make_arrays(layout, **kw)
    return (JStack(*(jnp.asarray(a) for a in arrays)),
            TStack.from_numpy(*arrays, dtype=torch.float64, device="cpu"),
            p_inj)


def test_grid_groups_matches_jax():
    for layout in ("shared", "mixed", "percurve"):
        js, ts, _ = stacks(layout)
        ga, ta = js._grid_groups()
        gb, tb = ts._grid_groups()
        np.testing.assert_array_equal(ga, gb)
        assert (ta is None) == (tb is None) == (layout == "shared")
        if ta is not None:
            np.testing.assert_array_equal(ta, tb)
    _, ts, _ = stacks("mixed")
    gid, _ = ts._grid_groups()
    np.testing.assert_array_equal(gid, [0, 1, 0, 1, 0, 1])


@pytest.mark.parametrize("branch", ["shared", "mixed", "exact",
                                    "percurve"])
def test_bls_search_branches_match_jax(branch):
    """Every branch of bls_search: one shared grid, mixed grids (one
    shared-grid search per group), method='exact', and an explicit
    shared_time=False (per-curve exact search)."""
    layout = {"shared": "shared", "mixed": "mixed"}.get(branch, "percurve")
    js, ts, _ = stacks(layout)
    kw = {"exact": dict(method="exact"),
          "percurve": dict(shared_time=False)}.get(branch, {})
    a = js.bls_search(PERIODS[::3], DURATIONS, **kw)
    b = ts.bls_search(PERIODS[::3], DURATIONS, **kw)
    for k in FIELDS:
        assert isinstance(b[k], torch.Tensor) and b[k].shape == (6, 16), k
    assert_same(a, b, branch)


def test_bls_search_rejects_unknown_method():
    _, ts, _ = stacks("shared")
    with pytest.raises(ValueError):
        ts.bls_search(PERIODS, DURATIONS, method="slow")


def assert_npz_layout(pa, pb):
    a, b = np.load(pa), np.load(pb)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k


@pytest.mark.parametrize("method, layout", [("fast", "percurve"),
                                            ("fast", "shared"),
                                            ("fast", "mixed"),
                                            ("exact", "percurve"),
                                            ("shared", "mixed")])
def test_sweep_method_matches_jax(tmp_path, method, layout):
    """SweepRunner's per-curve steps and its bucketed shared step equal the
    JAX runner's, field for field and in the npz they write.  On the
    regular grids the fast step's bins follow the reference's compiled
    step (the product with 1/d_phase), where samples sit on bin edges."""
    js, ts, p_inj = stacks(layout)
    kw = dict(chunk_periods=16, method=method)
    ja = jckpt.SweepRunner(js, PERIODS, DURATIONS, str(tmp_path / "j.npz"),
                           **kw).run()
    runner = tckpt.SweepRunner(ts, PERIODS, DURATIONS,
                               str(tmp_path / "t.npz"), **kw)
    tb = runner.run()
    assert runner.done
    assert_same(ja, tb, f"{method}/{layout}")
    assert np.all(np.abs(tb["period"] - p_inj) / p_inj < 0.02)
    assert_npz_layout(tmp_path / "j.npz", tmp_path / "t.npz")


@pytest.mark.parametrize("regime", ["uniform", "weighted"])
def test_bucketed_step_equals_per_grid_runs(tmp_path, regime):
    """The bucketed step's winners, put back in row order, equal one
    shared-grid sweep per grid on the same rows, in both weight regimes."""
    arrays, _ = make_arrays("mixed")
    t, flux, fe, mask = arrays
    if regime == "uniform":
        fe = np.tile(fe[:, :1], (1, fe.shape[1]))
        mask = np.ones_like(mask)
    ts = TStack.from_numpy(t, flux, fe, mask, dtype=torch.float64,
                           device="cpu")
    kw = dict(chunk_periods=16, method="shared")
    full = tckpt.SweepRunner(ts, PERIODS, DURATIONS,
                             str(tmp_path / "all.npz"), **kw).run()
    for g in (0, 1):
        rows = np.arange(g, 6, 2)
        sub = TStack.from_numpy(t[rows], flux[rows], fe[rows], mask[rows],
                                dtype=torch.float64, device="cpu")
        one = tckpt.SweepRunner(sub, PERIODS, DURATIONS,
                                str(tmp_path / f"g{g}.npz"), **kw).run()
        for f in FIELDS:
            np.testing.assert_array_equal(full[f][rows], one[f], err_msg=f)


@pytest.mark.parametrize("method, layout", [("fast", "percurve"),
                                            ("exact", "percurve"),
                                            ("shared", "mixed")])
def test_port_resumes_jax_checkpoint_per_method(tmp_path, method, layout):
    """A checkpoint the JAX runner wrote after 1 of 3 chunks is finished
    by the port; the result equals an uninterrupted JAX run."""
    js, ts, _ = stacks(layout)
    kw = dict(chunk_periods=16, method=method)
    full = jckpt.SweepRunner(js, PERIODS, DURATIONS,
                             str(tmp_path / "full.npz"), **kw).run()
    ck = str(tmp_path / "handoff.npz")
    jckpt.SweepRunner(js, PERIODS, DURATIONS, ck, **kw).run(max_chunks=1)
    t2 = tckpt.SweepRunner(ts, PERIODS, DURATIONS, ck, **kw)
    assert t2.next_chunk == 1
    assert_same(full, t2.run(), f"resume {method}")


@pytest.mark.parametrize("method, layout", [("fast", "percurve"),
                                            ("exact", "percurve"),
                                            ("shared", "mixed")])
def test_kill_resume_bit_equal_per_method(tmp_path, method, layout):
    """A killed port sweep resumed by a fresh runner ends bit-equal to an
    uninterrupted one, for every method and the bucketed step."""
    _, ts, _ = stacks(layout)
    kw = dict(chunk_periods=16, method=method, async_save=True)
    full = tckpt.SweepRunner(ts, PERIODS, DURATIONS,
                             str(tmp_path / "full.npz"), **kw).run()
    ck = str(tmp_path / "kill.npz")
    r1 = tckpt.SweepRunner(ts, PERIODS, DURATIONS, ck, **kw)
    r1.run(max_chunks=2)
    assert not r1.done
    r2 = tckpt.SweepRunner(ts, PERIODS, DURATIONS, ck, **kw)
    assert r2.next_chunk == 2
    out = r2.run()
    for f in FIELDS:
        np.testing.assert_array_equal(full[f], out[f], err_msg=f)


def test_default_method_is_fast_and_unknown_raises(tmp_path):
    _, ts, _ = stacks("percurve")
    assert tckpt.SweepRunner(ts, PERIODS, DURATIONS,
                             str(tmp_path / "a.npz")).method == "fast"
    with pytest.raises(ValueError):
        tckpt.SweepRunner(ts, PERIODS, DURATIONS, str(tmp_path / "b.npz"),
                          method="slow")


def test_many_buckets_warn(tmp_path, caplog):
    """Past 32 distinct grids the bucketed step says the per-curve methods
    may be faster."""
    arrays, _ = make_arrays("percurve", B=33, n=120)
    ts = TStack.from_numpy(*arrays, dtype=torch.float64, device="cpu")
    runner = tckpt.SweepRunner(ts, PERIODS[:4], DURATIONS,
                               str(tmp_path / "w.npz"), chunk_periods=4,
                               method="shared")
    with caplog.at_level(logging.WARNING):
        runner.run()
    assert any("33 distinct time grids" in r.getMessage()
               for r in caplog.records)


def test_shared_sweep_geometries_match_jax():
    periods = np.linspace(0.5, 9.0, 5000)
    durs = np.array([0.05, 0.1, 0.33])
    for cp in (512, 1024, 4096):
        a = jckpt.shared_sweep_geometries(periods, durs, cp)
        b = tckpt.shared_sweep_geometries(periods, durs, cp)
        assert len(a) == len(b)
        for (da, na, ca), (db, nb, cb) in zip(a, b):
            assert (da, na) == (db, nb)
            np.testing.assert_array_equal(ca, cb)


def test_prewarm_builds_nothing_on_the_cpu(tmp_path):
    """Prewarm returns its futures: none for a CPU stack (no kernels) and
    none for the methods the reference does not prewarm."""
    _, ts, _ = stacks("shared")
    for method in ("shared", "fast", "exact"):
        runner = tckpt.SweepRunner(ts, PERIODS, DURATIONS,
                                   str(tmp_path / f"{method}.npz"),
                                   method=method)
        assert runner.prewarm(wait=True) == []
    assert tckpt.prewarm_shared_sweep("cpu") == []


def test_entry_points_default_to_the_card(tmp_path):
    """Without ``device`` the stack constructors and the streaming loader
    put their tensors on the card; on a torch without CUDA they raise
    rather than fall back to the CPU."""
    from lightkurve_tpu_torch.io.fits import (BinTableHDU, HDUList, Header,
                                              PrimaryHDU, write_fits)
    path = str(tmp_path / "one.fits")
    t = np.arange(16) * 0.02
    write_fits(HDUList([PrimaryHDU(header=Header({})), BinTableHDU(
        data={"TIME": t, "PDCSAP_FLUX": np.ones(16),
              "PDCSAP_FLUX_ERR": np.ones(16)},
        header=Header({"EXTNAME": "LIGHTCURVE"}))]), path)
    arrays = (t[None], np.ones((1, 16)), np.ones((1, 16)),
              np.ones((1, 16), bool))
    constructors = (lambda: TStack.from_numpy(*arrays),
                    lambda: TStack.from_files([path]),
                    lambda: StreamingStackLoader([path], batch_size=1))
    assert config.default_device == "cuda"
    if torch.cuda.is_available():
        for build in constructors:
            assert build().device.type == "cuda"
    else:
        for build in constructors:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                build()
    assert TStack.from_numpy(*arrays, device="cpu").device.type == "cpu"
    assert os.path.exists(path)
