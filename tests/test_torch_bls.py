"""lightkurve_tpu_torch shared-grid BLS against lightkurve_tpu, float64.

The same numpy inputs go through ``lightkurve_tpu.ops.bls`` (CPU, x64;
Pallas kernels in interpret mode) and ``lightkurve_tpu_torch.ops.bls``
(CPU tensors, so the plain versions of the CUDA kernels).  Bar: identical
finite/-inf patterns and rtol 1e-9, atol 1e-12 on finite entries, with
exact objective ties allowed to rank either way (see ``assert_same``).
"""
import numpy as np
import pytest
import torch

from lightkurve_tpu.ops import bls as jbls
from lightkurve_tpu_torch.ops import bls as tbls
from lightkurve_tpu_torch.ops import bls_fused, bls_window

FIELDS = ("power", "depth", "depth_err", "depth_snr", "log_likelihood",
          "duration", "transit_time", "period")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def fresh_jax_caches():
    """Release compiled executables before a Pallas-interpret run (as the
    JAX package's own interpret tests do)."""
    import gc

    import jax
    jax.clear_caches()
    gc.collect()
    yield


def assert_same(a, b, tag=""):
    """Identical finite patterns and rtol 1e-9 on every field.  The two
    packages sum the fold in different orders, so two windows whose
    objectives tie to the last bits may rank either way: where the winning
    (duration, transit_time) differs, power must still agree to 1e-9 and
    such cells must stay rare; the other fields are compared where the
    winner is the same."""
    get = {k: (np.asarray(a[k]), b[k].numpy()) for k in FIELDS}
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


def transit_batch(rng, B, n, period=2.77, t0=2.0, dur=0.16, depth=4e-3,
                  spacing=None):
    t = (np.arange(n) * spacing if spacing
         else np.sort(rng.uniform(0, 15, n)))
    Y = 1.0 + 5e-4 * rng.normal(size=(B, n))
    ph = np.mod(t - t0 + period / 2, period) - period / 2
    Y[:, np.abs(ph) < dur / 2] -= depth
    return t, Y


def run_both(t, Y, dy, periods, durations, jax_kw=None, **kw):
    a = jbls.bls_power_shared_batch(t, Y, dy, periods, durations,
                                    **(jax_kw or {}), **kw)
    # dy stays a host array, so both packages auto-detect the regime alike
    b = tbls.bls_power_shared_batch(torch.from_numpy(t), torch.from_numpy(Y),
                                    dy, periods, durations, **kw)
    return a, b


@pytest.mark.parametrize("dy_case", ["none", "percurve_with_padding"])
@pytest.mark.parametrize("objective", ["likelihood", "snr"])
@pytest.mark.parametrize("edge_mode", ["wrap", "astropy"])
def test_uniform_matches_jax(rng, edge_mode, objective, dy_case):
    """Uniform path (plain version of K-F) ≡ the JAX staged scan, with a
    ragged batch (B=130) and n not a multiple of 128."""
    B, n = 130, 300
    t, Y = transit_batch(rng, B, n)
    dy = None
    if dy_case != "none":
        dy = np.tile(rng.uniform(4e-4, 9e-4, (B, 1)), (1, n))
        dy[-3:] = np.inf                       # batch-padding rows
    periods = np.linspace(1.2, 4.0, 29)
    a, b = run_both(t, Y, dy, periods, np.array([0.1, 0.2, 0.25]),
                    jax_kw=dict(fold_impl="xla"), uniform_weights=True,
                    objective=objective, edge_mode=edge_mode, chunk=8)
    assert_same(a, b, f"{edge_mode}/{objective}/{dy_case}")
    if dy is not None:
        assert np.all(np.isneginf(b["power"][-3:].numpy()))


@pytest.mark.mosaic_interpret
def test_uniform_matches_jax_fused_interpret(rng, fresh_jax_caches):
    """The port's uniform path ≡ the fused Pallas kernel in interpret mode
    (n=256, B=128, the shapes of the JAX package's own fused test)."""
    n, B, P = 256, 128, 37
    t, Y = transit_batch(rng, B, n, period=0.9, t0=0.3, dur=0.1,
                         depth=3e-3, spacing=0.02)
    a, b = run_both(t, Y, None, np.linspace(0.5, 1.7, P),
                    np.array([0.05, 0.1, 0.15]),
                    jax_kw=dict(fold_impl="fused_interpret"), chunk=8)
    assert_same(a, b, "fused_interpret")


def weighted_inputs(rng, B, n):
    t, Y = transit_batch(rng, B, n)
    dy = rng.uniform(4e-4, 9e-4, (B, n))
    dy[rng.random((B, n)) < 0.03] = np.inf    # ~3% masked cadences
    return t, Y, dy


@pytest.mark.parametrize("objective", ["likelihood", "snr"])
@pytest.mark.parametrize("edge_mode", ["wrap", "astropy"])
def test_weighted_matches_jax(rng, edge_mode, objective):
    """Weighted path (torch fold + plain version of K-W) ≡ the JAX XLA
    window scan, per-cadence dy with masked cadences, ragged B."""
    t, Y, dy = weighted_inputs(rng, 5, 333)
    a, b = run_both(t, Y, dy, np.linspace(1.2, 4.0, 23),
                    np.array([0.1, 0.2]), jax_kw=dict(window_impl="xla"),
                    objective=objective, edge_mode=edge_mode, chunk=4)
    assert_same(a, b, f"{edge_mode}/{objective}")


@pytest.mark.mosaic_interpret
def test_weighted_matches_jax_pallas_interpret(rng, fresh_jax_caches):
    """The port's weighted path ≡ the Pallas window kernel in interpret
    mode (B=128, its lane tile)."""
    t, Y, dy = weighted_inputs(rng, 128, 256)
    a, b = run_both(t, Y, dy, np.linspace(1.2, 4.0, 17),
                    np.array([0.1, 0.2]),
                    jax_kw=dict(window_impl="pallas_interpret"), chunk=8)
    assert_same(a, b, "pallas_interpret")


@pytest.mark.parametrize("case", ["uniform", "weighted"])
def test_bucket_matches_unbucketed(rng, case):
    """bucket=True only regroups periods by histogram size: outputs are
    bit-identical to the one-group scan."""
    B, n = 6, 512
    t = np.arange(n) * 0.01
    Y = torch.from_numpy(1.0 + 1e-3 * rng.normal(size=(B, n)))
    dy = None if case == "uniform" else torch.from_numpy(
        1e-3 * (1 + rng.random((B, n))))
    periods = np.linspace(0.3, 2.5, 120)      # several 128-row tiles
    durs = np.array([0.05, 0.1])
    a = tbls.bls_power_shared_batch(t, Y, dy, periods, durs, chunk=4)
    b = tbls.bls_power_shared_batch(t, Y, dy, periods, durs, chunk=4,
                                    bucket=True)
    for k in FIELDS:
        np.testing.assert_array_equal(a[k].numpy(), b[k].numpy(), err_msg=k)


def test_bucket_periods_matches_jax():
    periods = np.linspace(0.3, 9.0, 301)
    for d_phase, k_max in ((0.005, 66), (0.01, 1), (0.02, 17)):
        ga, ia = jbls._bucket_periods(periods, d_phase, k_max)
        gb, ib = tbls._bucket_periods(periods, d_phase, k_max)
        np.testing.assert_array_equal(ia, ib)
        assert len(ga) == len(gb)
        for (xa, na), (xb, nb) in zip(ga, gb):
            np.testing.assert_array_equal(xa, xb)
            assert na == nb


def test_detect_uniform_weights_matches_jax():
    B, N = 4, 50
    cases = [None, np.full((B, N), 1e-3), np.tile(np.arange(1.0, B + 1)[
        :, None], (1, N)), np.full(N, 1e-3), -np.full((B, N), 1e-3)]
    masked = np.full((B, N), 1e-3)
    masked[0, 5] = np.inf
    padded = np.full((B, N), 1e-3)
    padded[-1] = np.inf
    for dy in cases + [masked, padded]:
        assert jbls._detect_uniform_weights(dy) == \
            tbls._detect_uniform_weights(dy)
    assert tbls._detect_uniform_weights(padded)
    assert not tbls._detect_uniform_weights(masked)


def test_uniform_padding_rows_sort_last():
    """All-inf-dy rows (batch padding) report power = -inf, as in
    test_ops_bls.py's padding-rows case, and equal the JAX result."""
    rng = np.random.default_rng(0)
    n = 512
    t = np.arange(n) * 0.02
    flux = 1 + 0.001 * rng.standard_normal((2, n))
    flux[0, (t % 2.0) < 0.1] -= 0.05
    dy = np.ones((2, n))
    dy[1] = np.inf
    periods = np.linspace(1.5, 2.5, 64)
    a, b = run_both(t, flux, dy, periods, np.array([0.1]))
    assert_same(a, b, "padding")
    power = b["power"].numpy()
    assert np.all(np.isneginf(power[1]))
    assert np.isfinite(power[0]).all()
    assert int(np.argmax(power.max(axis=1))) == 0


def test_uniform_degenerate_durations_match_jax(rng):
    """Periods shorter than every duration have no valid window; the
    fallback statistics equal the JAX staged scan's and never win."""
    B, n = 3, 256
    t = np.arange(n) * 0.01
    Y = 1.0 + 1e-3 * rng.normal(size=(B, n))
    hp = 1.95 / 2
    Y[:, np.abs(np.mod(t + hp, 1.95) - hp) < 0.15] -= 0.01
    periods = np.array([0.11, 0.12, 1.9, 1.95, 2.0])
    a, b = run_both(t, Y, None, periods, np.array([0.3]), chunk=5,
                    uniform_weights=True)
    assert_same(a, b, "degenerate")
    assert np.all(np.argmax(b["power"].numpy(), axis=1) >= 2)


@pytest.mark.parametrize("objective", ["likelihood", "snr"])
def test_plain_kernels_match_staged_scans(rng, objective):
    """Calling the kernel modules directly on CPU tensors runs their plain
    versions and counts those calls, not kernel launches."""
    B, n = 4, 200
    t, Y = transit_batch(rng, B, n)
    ts = torch.from_numpy(t - t.min())
    Y0 = torch.from_numpy((Y - Y.mean(1, keepdims=True)).T.copy())
    pc = torch.linspace(1.2, 4.0, 9, dtype=torch.float64)
    like = objective == "likelihood"
    fl, wl = bls_fused.fused_scan_uniform.launches, \
        bls_window.window_scan.launches
    fc, wc = bls_fused.fused_scan_uniform_plain.calls, \
        bls_window.window_scan_plain.calls
    a = bls_fused.fused_scan_uniform(ts, Y0, pc, (10, 20), (0.1, 0.2), 0.01,
                                     400, 400, like)
    b = bls_fused.fused_scan_uniform_plain(ts, Y0, pc, (10, 20), (0.1, 0.2),
                                           0.01, 400, 400, like)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    WWY = torch.cat([torch.ones_like(Y0), Y0], 1)
    csum, nbp = tbls._weighted_fold(ts, WWY, pc, 0.01, 400, 400, 20)
    c = bls_window.window_scan(csum, nbp, pc, WWY.sum(0), (10, 20),
                               (0.1, 0.2), 0.01, like)
    assert set(c) == {"power", "depth", "w_in", "transit_time", "duration"}
    assert bls_fused.fused_scan_uniform.launches == fl
    assert bls_window.window_scan.launches == wl
    assert bls_fused.fused_scan_uniform_plain.calls == fc + 2
    assert bls_window.window_scan_plain.calls == wc + 1


def test_wrappers_refuse_non_cuda_devices():
    """Only CPU tensors take the plain versions: any other device must
    launch the kernel or raise, never fall back."""
    meta = torch.device("meta")
    Y0 = torch.empty((16, 4), dtype=torch.float32, device=meta)
    ts = torch.empty((16,), dtype=torch.float32, device=meta)
    pc = torch.empty((3,), dtype=torch.float32, device=meta)
    with pytest.raises(ValueError, match="CUDA"):
        bls_fused.fused_scan_uniform(ts, Y0, pc, (2,), (0.1,), 0.05, 40, 40)
    csum = torch.empty((3, 128, 8), dtype=torch.float32, device=meta)
    nbp = torch.empty((3,), dtype=torch.int32, device=meta)
    total = torch.empty((8,), dtype=torch.float32, device=meta)
    with pytest.raises(ValueError, match="CUDA"):
        bls_window.window_scan(csum, nbp, pc, total, (2,), (0.1,), 0.05)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_max_nbins_bound_matches_device_rule(rng, dtype):
    """The host bound equals nbins_per_period's largest value, period by
    period and over the grid, including periods on bin edges."""
    d_phase = 0.01
    edges = np.arange(50, 900) * d_phase
    periods = np.concatenate([edges, np.nextafter(edges, 0),
                              rng.uniform(0.5, 9.0, 300)])
    nbp = bls_fused.nbins_per_period(torch.as_tensor(periods, dtype=dtype),
                                     d_phase).numpy()
    got = [bls_fused.max_nbins_bound(periods[i:i + 1], d_phase, dtype)
           for i in range(len(periods))]
    np.testing.assert_array_equal(got, nbp)
    assert bls_fused.max_nbins_bound(periods, d_phase, dtype) == nbp.max()


def tile_edge_case():
    """A float64 grid whose longest period has one bin more by the
    device's rule (ceil(p * (1/d_phase))) than by the host's
    ceil(p / d_phase), where the host count plus the wrap rows fills the
    128-row tile exactly: a fold sized from the host count lacks the row
    that the last window of that period reads."""
    d_phase = 0.01
    periods = np.array([0.5, 0.6, 0.71 + 1e-16])
    durations = np.array([0.1, 0.58])
    k_durs = tuple(int(d / d_phase + 0.5) for d in durations)
    nbins = int(np.ceil(periods.max() / d_phase))
    bound = bls_fused.max_nbins_bound(periods, d_phase, torch.float64)
    assert (nbins, bound, k_durs) == (71, 72, (10, 58))
    assert (nbins + max(k_durs) - 1) % 128 == 0
    return d_phase, periods, durations, k_durs, nbins, bound


@pytest.mark.parametrize("kernel", ["fused", "window"])
def test_tile_edge_period_reads_inside_its_rows(rng, kernel):
    """At the tile edge the rows are sized from the device rule's bound,
    so every window lies inside them and the result is finite; rows sized
    from the host count alone give that period NaN, not a wrapped read."""
    d_phase, periods, durations, k_durs, nbins, bound = tile_edge_case()
    t, Y = transit_batch(rng, 3, 400, period=0.71, t0=0.2, dur=0.1,
                         spacing=0.004)
    ts = torch.from_numpy(t - t.min())
    Y0 = torch.from_numpy((Y - Y.mean(1, keepdims=True)).T.copy())
    pc = torch.from_numpy(periods)
    args = (k_durs, tuple(durations), d_phase)

    def scan(max_nbins_p):
        if kernel == "fused":
            return bls_fused.fused_scan_uniform(ts, Y0, pc, *args, nbins,
                                                max_nbins_p)
        WWY = torch.cat([torch.ones_like(Y0), Y0], 1)
        csum, nbp = tbls._weighted_fold(ts, WWY, pc, d_phase, nbins,
                                        max_nbins_p, max(k_durs))
        assert (csum.shape[1] >= int(nbp.max()) + max(k_durs) - 1) == (
            max_nbins_p == bound)
        return bls_window.window_scan(csum, nbp, pc, WWY.sum(0), *args)

    good = scan(bound)
    for v in good.values():
        assert torch.isfinite(v).all()
    short = scan(nbins)
    for f, v in short.items():
        assert torch.isnan(v[-1]).all(), f
        torch.testing.assert_close(v[:-1], good[f][:-1], rtol=0, atol=0)
