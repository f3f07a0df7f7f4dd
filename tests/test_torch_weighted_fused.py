"""K-WF's plain version and the weighted routes of lightkurve_tpu_torch
against lightkurve_tpu, float64 on the CPU.

The same numpy inputs go through both packages: the port's fused weighted
scan (``fused_scan_weighted`` on CPU tensors runs its plain version, the
staged fold and window scan) against ``_bls_shared_scan`` with the Pallas
window kernel (B3) in interpret mode.  Bar: identical finite/-inf
patterns and rtol 1e-9, exact objective ties allowed to rank either way
(``assert_same``); the plain version against its own parts bit for bit.
"""
import numpy as np
import pytest
import torch

from lightkurve_tpu.ops import bls as jbls
from lightkurve_tpu_torch.ops import bls as tbls
from lightkurve_tpu_torch.ops import (bls_fused, bls_fused_weighted,
                                      bls_staged_fold, bls_window)
from tests.test_torch_bls import transit_batch
from tests.test_torch_percurve import assert_same

FIELDS = ("power", "depth", "w_in", "transit_time", "duration")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def fresh_jax_caches():
    import gc

    import jax
    jax.clear_caches()
    gc.collect()
    yield


def weighted_inputs(rng, B=5, n=300, masked=0.03):
    """An injected-transit batch with per-cadence dy and ~3% masked
    cadences: ts, W and WY (n, B) as the port's entry point builds them
    (weights normalised to mean 1, flux mean-shifted), the periods and the
    grid geometry."""
    t, Y = transit_batch(rng, B, n)
    dy = rng.uniform(4e-4, 9e-4, (B, n))
    dy[rng.random((B, n)) < masked] = np.inf
    W = 1.0 / dy ** 2
    W = W / W[np.isfinite(W)].mean()
    mu = (W * Y).sum(1, keepdims=True) / W.sum(1, keepdims=True)
    ts = torch.from_numpy(t - t.min())
    Wt = torch.from_numpy(W.T.copy())
    WYt = torch.from_numpy((W * (Y - mu)).T.copy())
    pc = torch.from_numpy(np.linspace(1.2, 4.0, 23))
    d_phase, k_durs, dvals = 0.01, (10, 20), (0.1, 0.2)
    nbins = int(np.ceil(4.0 / d_phase))
    bound = bls_fused.max_nbins_bound(pc.numpy(), d_phase, torch.float64)
    return ts, Wt, WYt, pc, k_durs, dvals, d_phase, nbins, bound


@pytest.mark.parametrize("objective", ["likelihood", "snr"])
@pytest.mark.parametrize("wrap", [True, False])
def test_weighted_plain_is_fold_then_window_scan(rng, objective, wrap):
    """K-WF's plain version is the staged fold (K-SF's plain version)
    followed by K-W's plain window scan, bit for bit, in any chunking of
    the periods."""
    ts, W, WY, pc, k_durs, dvals, d_phase, nbins, bound = weighted_inputs(
        rng)
    like = objective == "likelihood"
    calls = bls_fused_weighted.fused_scan_weighted_plain.calls
    got = bls_fused_weighted.fused_scan_weighted(
        ts, W, WY, pc, k_durs, dvals, d_phase, nbins, bound, like, wrap,
        chunk=7)
    assert bls_fused_weighted.fused_scan_weighted_plain.calls == calls + 1
    WWY = torch.cat([W, WY], 1)
    csum, _, nbp = bls_staged_fold.staged_fold_plain(
        ts, WWY, pc, d_phase, nbins, bound, max(k_durs), wrap)
    want = bls_window.window_scan_plain(csum, nbp, pc, WWY.sum(0), k_durs,
                                        dvals, d_phase, like)
    assert set(got) == set(FIELDS)
    assert torch.isfinite(got["power"]).all()
    for k in FIELDS:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


@pytest.mark.mosaic_interpret
@pytest.mark.parametrize("objective", ["likelihood", "snr"])
@pytest.mark.parametrize("wrap", [True, False])
def test_weighted_fused_matches_jax_pallas_interpret(rng, objective, wrap,
                                                     fresh_jax_caches):
    """The port's weighted scan on the fused route (K-WF's plain version)
    ≡ the JAX package's ``_bls_shared_scan`` with the Pallas window kernel
    (B3) in interpret mode (B=128, its lane tile)."""
    ts, W, WY, pc, k_durs, dvals, d_phase, nbins, bound = weighted_inputs(
        rng, B=128, n=256)
    like = objective == "likelihood"
    a = jbls._bls_shared_scan(ts.numpy(), W.numpy(), WY.numpy(), pc.numpy(),
                              k_durs, dvals, d_phase, nbins, like, 8,
                              window_impl="pallas_interpret", wrap=wrap)
    calls = bls_fused_weighted.fused_scan_weighted_plain.calls
    b = tbls._bls_shared_scan(ts, W, WY, pc, k_durs, dvals, d_phase, nbins,
                              bound, like, 8, wrap=wrap, fold_impl="fused")
    assert bls_fused_weighted.fused_scan_weighted_plain.calls == calls + 1
    a = {k: np.asarray(v) for k, v in a.items()}
    fields = ("power", "depth", "depth_err", "depth_snr", "log_likelihood",
              "duration", "transit_time")
    assert set(fields) <= set(b)
    assert_same(a, b, f"{objective}/wrap={wrap}", fields=fields)


@pytest.mark.parametrize("objective", ["likelihood", "snr"])
def test_weighted_routes_agree_bit_for_bit(rng, objective):
    """On the CPU both weighted routes run the same fold and window
    arithmetic, through the entry point, each on its own plain version."""
    t, Y = transit_batch(rng, 6, 333)
    dy = rng.uniform(4e-4, 9e-4, Y.shape)
    dy[rng.random(Y.shape) < 0.03] = np.inf
    periods = np.linspace(1.2, 4.0, 23)
    durs = np.array([0.1, 0.2, 0.25])
    fused = bls_fused_weighted.fused_scan_weighted_plain.calls
    staged = bls_window.window_scan_plain.calls
    out = [tbls.bls_power_shared_batch(t, Y, dy, periods, durs, chunk=5,
                                       objective=objective, fold_impl=impl,
                                       device="cpu")
           for impl in ("fused", "staged")]
    assert bls_fused_weighted.fused_scan_weighted_plain.calls == fused + 1
    assert bls_window.window_scan_plain.calls == staged + 5
    for k in out[0]:
        np.testing.assert_array_equal(out[0][k].numpy(), out[1][k].numpy(),
                                      k)


def test_weighted_nan_past_its_rows(rng):
    """A period whose bins pass the caller's bound gets NaN in K-WF's plain
    version (as in the kernel), and the other periods are unchanged."""
    ts, W, WY, pc, k_durs, dvals, d_phase, nbins, bound = weighted_inputs(
        rng)
    args = (k_durs, dvals, d_phase, nbins)
    good = bls_fused_weighted.fused_scan_weighted(ts, W, WY, pc, *args,
                                                  bound)
    nbp = bls_fused.nbins_per_period(pc, d_phase)
    short = int(nbp[-2])                       # the last period passes it
    assert int(nbp[-1]) > short
    out = bls_fused_weighted.fused_scan_weighted(ts, W, WY, pc, *args, short)
    for f, v in out.items():
        assert torch.isnan(v[-1]).all(), f
        torch.testing.assert_close(v[:-1], good[f][:-1], rtol=0, atol=0)


def test_weighted_wrapper_refuses_non_cuda_devices():
    """Only CPU tensors take K-WF's plain version; any other device must
    launch the kernel or raise."""
    meta = torch.device("meta")
    W = torch.empty((16, 4), dtype=torch.float32, device=meta)
    ts = torch.empty((16,), dtype=torch.float32, device=meta)
    pc = torch.empty((3,), dtype=torch.float32, device=meta)
    with pytest.raises(ValueError, match="CUDA"):
        bls_fused_weighted.fused_scan_weighted(ts, W, W, pc, (2,), (0.1,),
                                               0.05, 40, 40)
