"""lightkurve_tpu_torch stacks and SweepRunner against lightkurve_tpu.

One stack, made with numpy from a seed, goes through both packages'
``LightCurveStack`` and ``SweepRunner(method="shared")`` on the CPU in
float64; checkpoints are shared between them.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lightkurve_tpu.batch import LightCurveStack as JStack
from lightkurve_tpu.parallel.checkpoint import SweepRunner as JRunner
from lightkurve_tpu_torch.batch import LightCurveStack as TStack
from lightkurve_tpu_torch.parallel.checkpoint import SweepRunner as TRunner

FIELDS = ("power", "depth", "depth_err", "depth_snr", "log_likelihood",
          "duration", "transit_time", "period")
PERIODS = np.linspace(1.5, 3.5, 64)
DURATIONS = np.array([0.1, 0.2])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def make_arrays(regime, B=6, n=500, seed=3):
    """Shared time grid, one injected transit per curve; 'uniform' has a
    constant flux_err per curve and no masked cadence, 'weighted'
    per-cadence flux_err and ~3% masked cadences."""
    rng = np.random.default_rng(seed)
    t = np.tile(np.arange(n) * 0.02 + 0.0011, (B, 1))
    p_inj = rng.uniform(1.8, 3.2, B)
    flux = 1.0 + 5e-4 * rng.standard_normal((B, n))
    for i in range(B):
        ph = np.mod(t[i] - 0.4 + p_inj[i] / 2, p_inj[i]) - p_inj[i] / 2
        flux[i, np.abs(ph) < 0.06] -= 6e-3
    if regime == "uniform":
        fe = np.tile(rng.uniform(4e-4, 6e-4, (B, 1)), (1, n))
        mask = np.ones((B, n), bool)
    else:
        fe = rng.uniform(4e-4, 6e-4, (B, n))
        mask = rng.random((B, n)) >= 0.03
        flux[~mask] = 0.0
    return (t, flux, fe, mask), p_inj


def stacks(regime):
    arrays, p_inj = make_arrays(regime)
    j = JStack(*(jnp.asarray(a) for a in arrays))
    return j, TStack.from_numpy(*arrays, dtype=torch.float64,
                                 device="cpu"), p_inj


def assert_state_equal(a, b, exact=False):
    for f in FIELDS:
        if exact:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)
        else:
            np.testing.assert_allclose(b[f], a[f], rtol=1e-9, atol=1e-12,
                                       err_msg=f)


@pytest.mark.parametrize("regime", ["uniform", "weighted"])
def test_sweep_matches_jax(tmp_path, regime):
    js, ts, p_inj = stacks(regime)
    kw = dict(chunk_periods=16, method="shared")
    ja = JRunner(js, PERIODS, DURATIONS, str(tmp_path / "j.npz"), **kw).run()
    tr = TRunner(ts, PERIODS, DURATIONS, str(tmp_path / "t.npz"), **kw)
    tb = tr.run()
    assert tr.done
    assert_state_equal(ja, tb)
    assert np.all(np.abs(tb["period"] - p_inj) / p_inj < 0.02)
    # the two packages write the same npz layout
    a, b = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k


@pytest.mark.parametrize("regime", ["uniform", "weighted"])
def test_port_resumes_jax_checkpoint(tmp_path, regime):
    """A checkpoint the JAX runner wrote after 2 of 4 chunks is finished
    by the port's runner; the result equals an uninterrupted JAX run."""
    js, ts, _ = stacks(regime)
    kw = dict(chunk_periods=16, method="shared")
    full = JRunner(js, PERIODS, DURATIONS, str(tmp_path / "full.npz"),
                   **kw).run()
    ck = str(tmp_path / "handoff.npz")
    j1 = JRunner(js, PERIODS, DURATIONS, ck, **kw)
    j1.run(max_chunks=2)
    assert not j1.done
    t2 = TRunner(ts, PERIODS, DURATIONS, ck, **kw)
    assert t2.next_chunk == 2
    out = t2.run()
    assert t2.done
    assert_state_equal(full, out)


@pytest.mark.parametrize("async_save", [False, True])
def test_kill_resume_bit_equal(tmp_path, async_save):
    """A killed port sweep resumed by a fresh runner ends bit-equal to an
    uninterrupted one."""
    _, ts, _ = stacks("weighted")
    kw = dict(chunk_periods=16, async_save=async_save, method="shared")
    full = TRunner(ts, PERIODS, DURATIONS, str(tmp_path / "full.npz"),
                   **kw).run()
    ck = str(tmp_path / "kill.npz")
    r1 = TRunner(ts, PERIODS, DURATIONS, ck, **kw)
    r1.run(max_chunks=2)
    assert not r1.done
    r2 = TRunner(ts, PERIODS, DURATIONS, ck, **kw)
    assert r2.next_chunk == 2
    out = r2.run()
    assert r2.done
    assert_state_equal(full, out, exact=True)
    saved = np.load(ck)
    assert int(saved["next_chunk"]) == r2.n_chunks
    assert_state_equal(full, {f: saved[f] for f in FIELDS}, exact=True)


def test_chunking_change_restarts_fresh(tmp_path):
    _, ts, _ = stacks("uniform")
    ck = str(tmp_path / "sweep.npz")
    kw = dict(method="shared")
    full = TRunner(ts, PERIODS, DURATIONS, str(tmp_path / "ref.npz"),
                   chunk_periods=16, **kw).run()
    TRunner(ts, PERIODS, DURATIONS, ck, chunk_periods=16,
            **kw).run(max_chunks=2)
    r2 = TRunner(ts, PERIODS, DURATIONS, ck, chunk_periods=32, **kw)
    assert r2.next_chunk == 0
    assert_state_equal(full, r2.run())


@pytest.mark.parametrize("regime", ["uniform", "weighted"])
def test_stack_bls_search_matches_jax(regime):
    js, ts, _ = stacks(regime)
    a = js.bls_search(PERIODS[::4], DURATIONS)
    b = ts.bls_search(PERIODS[::4], DURATIONS)
    for f in FIELDS:
        np.testing.assert_allclose(b[f].numpy(), np.asarray(a[f]),
                                   rtol=1e-9, atol=1e-12, err_msg=f)


def test_normalize_matches_jax():
    js, ts, _ = stacks("weighted")
    a, b = js.normalize(), ts.normalize()
    np.testing.assert_allclose(b.flux.numpy(), np.asarray(a.flux),
                               rtol=1e-12)
    np.testing.assert_allclose(b.flux_err.numpy(), np.asarray(a.flux_err),
                               rtol=1e-12)
