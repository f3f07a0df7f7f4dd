"""K-U's plain version, the staged uniform route and the route rule of
lightkurve_tpu_torch against lightkurve_tpu, float64 on the CPU.

The same numpy inputs go through both packages: the uniform window scan
against ``window_scan_pallas_uniform`` in interpret mode on identical
prefix sums, and the port's staged route (``fold_impl="staged"``: the torch
fold and K-U's plain version) against the JAX staged scan with both of its
window forms.  Bar: identical finite/-inf patterns and rtol 1e-9, exact
objective ties allowed to rank either way (``assert_same``).
"""
import numpy as np
import pytest
import torch

from lightkurve_tpu.ops import bls as jbls
from lightkurve_tpu.ops import bls_window_pallas as jwin
from lightkurve_tpu_torch.ops import bls as tbls
from lightkurve_tpu_torch.ops import bls_fused, bls_window
from tests.test_torch_bls import transit_batch
from tests.test_torch_percurve import assert_same

WINDOW_FIELDS = ("power", "depth", "n_in", "transit_time", "duration")


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


def fold_inputs(rng, B=128, n=256):
    """An injected-transit batch on a regular grid: ts, mean-shifted flux
    (n, B), periods and the grid geometry."""
    t, Y = transit_batch(rng, B, n, period=0.9, t0=0.3, dur=0.1, depth=3e-3,
                         spacing=0.02)
    ts = torch.from_numpy(t - t.min())
    Y0 = torch.from_numpy((Y - Y.mean(1, keepdims=True)).T.copy())
    pc = torch.from_numpy(np.linspace(0.5, 1.7, 13))
    d_phase, k_durs, dvals = 0.01, (5, 10, 15), (0.05, 0.1, 0.15)
    nbins = int(np.ceil(1.7 / d_phase))
    bound = bls_fused.max_nbins_bound(pc.numpy(), d_phase, torch.float64)
    return ts, Y0, pc, k_durs, dvals, d_phase, nbins, bound


def prefix_sums(rng, B=128, n=256, wrap=True):
    """The torch fold of :func:`fold_inputs`: the arguments of the uniform
    window scan (cs_y (C, npad, B), cs_n (C, npad), bins per period,
    periods, totals, n, durations, d_phase)."""
    ts, Y0, pc, k_durs, dvals, d_phase, nbins, bound = fold_inputs(rng, B, n)
    cs_y, cs_n, nbp = bls_fused.uniform_fold(ts, Y0, pc, d_phase, nbins,
                                             bound, max(k_durs), wrap)
    return (cs_y, cs_n, nbp, pc, Y0.sum(0), float(n), k_durs, dvals,
            d_phase)


@pytest.mark.mosaic_interpret
@pytest.mark.parametrize("objective", ["likelihood", "snr"])
def test_window_scan_uniform_plain_matches_pallas_interpret(
        rng, objective, fresh_jax_caches):
    """K-U's plain version ≡ the Pallas uniform window kernel (B1) in
    interpret mode, on identical prefix sums (B=128, its lane tile)."""
    args = prefix_sums(rng)
    like = objective == "likelihood"
    cs_y, cs_n, nbp, pc, tot_y, n_total, k_durs, dvals, d_phase = args
    a = jwin.window_scan_pallas_uniform(
        cs_y.numpy(), cs_n.numpy()[..., None], nbp.numpy(), pc.numpy(),
        tot_y.numpy(), n_total, k_durs, dvals, d_phase,
        use_likelihood=like, interpret=True)
    a = dict(a, n_in=a.pop("w_in"))
    calls = bls_window.window_scan_uniform_plain.calls
    b = bls_window.window_scan_uniform(*args, use_likelihood=like)
    assert bls_window.window_scan_uniform_plain.calls == calls + 1
    assert set(b) == set(WINDOW_FIELDS)
    assert torch.isfinite(b["power"]).all()
    assert_same(a, b, objective, fields=WINDOW_FIELDS)


@pytest.mark.parametrize("objective", ["likelihood", "snr"])
@pytest.mark.parametrize("wrap", [True, False])
def test_fused_plain_is_fold_then_window_scan(rng, objective, wrap):
    """K-F's plain version is the shared fold followed by K-U's plain
    window scan, bit for bit: one code path for both routes."""
    ts, Y0, pc, k_durs, dvals, d_phase, nbins, bound = fold_inputs(
        rng, B=5, n=300)
    like = objective == "likelihood"
    want = bls_fused.fused_scan_uniform_plain(ts, Y0, pc, k_durs, dvals,
                                              d_phase, nbins, bound, like,
                                              wrap, chunk=13)
    cs_y, cs_n, nbp = bls_fused.uniform_fold(ts, Y0, pc, d_phase, nbins,
                                             bound, max(k_durs), wrap)
    got = bls_window.window_scan_uniform(cs_y, cs_n, nbp, pc, Y0.sum(0),
                                         300.0, k_durs, dvals, d_phase, like)
    assert set(got) == set(WINDOW_FIELDS)
    for k in WINDOW_FIELDS:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


@pytest.mark.parametrize("bucket", [False, True])
@pytest.mark.parametrize("objective", ["likelihood", "snr"])
@pytest.mark.parametrize("edge_mode", ["wrap", "astropy"])
def test_staged_route_matches_jax_xla(rng, edge_mode, objective, bucket):
    """fold_impl='staged' (torch fold + K-U's plain version) ≡ the JAX
    staged scan with its XLA window form, ragged B and n, with and
    without period buckets."""
    B, n = 130, 300
    t, Y = transit_batch(rng, B, n)
    dy = np.tile(rng.uniform(4e-4, 9e-4, (B, 1)), (1, n))
    dy[-2:] = np.inf                          # batch-padding rows
    periods = np.linspace(0.4, 4.0, 31)       # several 128-row tiles
    kw = dict(uniform_weights=True, objective=objective,
              edge_mode=edge_mode, chunk=8, bucket=bucket)
    a = jbls.bls_power_shared_batch(t, Y, dy, periods, np.array([0.1, 0.2]),
                                    fold_impl="xla", window_impl="xla", **kw)
    calls = bls_window.window_scan_uniform_plain.calls
    b = tbls.bls_power_shared_batch(torch.from_numpy(t), torch.from_numpy(Y),
                                    dy, periods, np.array([0.1, 0.2]),
                                    fold_impl="staged", **kw)
    assert bls_window.window_scan_uniform_plain.calls > calls
    assert_same(a, b, f"{edge_mode}/{objective}/bucket={bucket}")
    assert np.all(np.isneginf(b["power"][-2:].numpy()))


@pytest.mark.mosaic_interpret
@pytest.mark.parametrize("bucket", [False, True])
@pytest.mark.parametrize("objective", ["likelihood", "snr"])
@pytest.mark.parametrize("edge_mode", ["wrap", "astropy"])
def test_staged_route_matches_jax_pallas_interpret(
        rng, edge_mode, objective, bucket, fresh_jax_caches):
    """fold_impl='staged' ≡ the JAX staged scan with the Pallas uniform
    window kernel (B1) in interpret mode (B=128, its lane tile)."""
    t, Y = transit_batch(rng, 128, 256, period=0.9, t0=0.3, dur=0.1,
                         depth=3e-3, spacing=0.02)
    periods = np.linspace(0.5, 2.2, 11)       # two 128-row tiles
    kw = dict(uniform_weights=True, objective=objective,
              edge_mode=edge_mode, chunk=8, bucket=bucket)
    durs = np.array([0.05, 0.1, 0.15])
    a = jbls.bls_power_shared_batch(t, Y, None, periods, durs,
                                    fold_impl="xla",
                                    window_impl="pallas_interpret", **kw)
    b = tbls.bls_power_shared_batch(torch.from_numpy(t), torch.from_numpy(Y),
                                    None, periods, durs, fold_impl="staged",
                                    **kw)
    assert_same(a, b, f"{edge_mode}/{objective}/bucket={bucket}")


@pytest.mark.parametrize("dtype, full_rows, fits_rows",
                         [(torch.float32, 1745, 3388),
                          (torch.float64, 886, 1745)])
def test_route_rule_at_the_boundary(monkeypatch, dtype, full_rows,
                                    fits_rows):
    """'auto' takes K-F while a block of 16 curves fits the device's opt-in
    shared memory (232,448 bytes on an H100: 3,388 rows in float32, 1,745
    in float64; K-F's full 32-curve tile fits 1,745 and 886) and the staged
    route past it; explicit choices pass through; the CPU has no limit."""
    optin = 232_448
    assert tbls.FUSED_MIN_TILE == 16
    assert bls_fused.fused_tile_fits(full_rows, dtype, optin)
    assert not bls_fused.fused_tile_fits(full_rows + 1, dtype, optin)
    assert bls_fused.fused_tile_fits(fits_rows, dtype, optin, tile=16)
    assert not bls_fused.fused_tile_fits(fits_rows + 1, dtype, optin,
                                         tile=16)
    assert bls_fused.fused_tile_fits(10 ** 6, dtype, None)
    itemsize = torch.empty((), dtype=dtype).element_size()
    assert bls_fused.fused_smem_bytes(full_rows, dtype) == (
        full_rows * (32 * itemsize + 4) + 512 * 4)
    monkeypatch.setattr(tbls, "shared_memory_optin", lambda device: optin)
    k_max = 66
    for rows, want in ((fits_rows, "fused"), (fits_rows + 1, "staged")):
        max_nbp = rows - k_max + 1
        assert tbls.fold_route("auto", max_nbp, k_max, dtype,
                               torch.device("cpu")) == want
    for impl in ("fused", "staged"):
        assert tbls.fold_route(impl, 10 ** 5, k_max, dtype,
                               torch.device("cpu")) == impl
    with pytest.raises(ValueError):
        tbls.fold_route("xla", 100, k_max, dtype, torch.device("cpu"))
    monkeypatch.undo()
    assert tbls.fold_route("auto", 10 ** 5, k_max, dtype,
                           torch.device("cpu")) == "fused"


def test_auto_route_per_bucket(rng, monkeypatch):
    """With bucket=True each period group goes through the route rule on
    its own rows: short periods take K-F, long ones the staged route, and
    the result equals one route for all periods."""
    B, n = 6, 512
    t = np.arange(n) * 0.01
    Y = torch.from_numpy(1.0 + 1e-3 * rng.normal(size=(B, n)))
    periods = np.linspace(0.3, 2.5, 60)       # 1-3 tiles of 128 rows
    durs = np.array([0.05, 0.1])
    # a limit that a 16-curve block of up to 256 float64 rows fits
    optin = bls_fused.fused_smem_bytes(256, torch.float64, tile=16)
    monkeypatch.setattr(tbls, "shared_memory_optin", lambda device: optin)
    fused_calls = bls_fused.fused_scan_uniform_plain.calls
    staged_calls = bls_window.window_scan_uniform_plain.calls
    got = tbls.bls_power_shared_batch(t, Y, None, periods, durs, chunk=4,
                                      bucket=True)
    assert bls_fused.fused_scan_uniform_plain.calls > fused_calls
    assert bls_window.window_scan_uniform_plain.calls > staged_calls
    want = tbls.bls_power_shared_batch(t, Y, None, periods, durs, chunk=4,
                                       fold_impl="fused")
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), k)


def test_staged_and_fused_routes_agree_bit_for_bit(rng):
    """On the CPU both routes run the same fold and window arithmetic."""
    t, Y = transit_batch(rng, 7, 333)
    periods = np.linspace(1.2, 4.0, 23)
    durs = np.array([0.1, 0.2, 0.25])
    out = [tbls.bls_power_shared_batch(t, Y, None, periods, durs, chunk=5,
                                       fold_impl=impl)
           for impl in ("fused", "staged")]
    for k in out[0]:
        np.testing.assert_array_equal(out[0][k].numpy(), out[1][k].numpy(),
                                      k)


def test_staged_route_slices_periods_to_free_memory(rng, monkeypatch):
    """The staged route folds as many periods per call as half the free
    device memory holds, at least one; the result does not depend on the
    slice."""
    npad, n, B = 3712, 38880, 2048            # two sectors, float32
    per = tbls.staged_fold_bytes(npad, n, B, 4)
    assert per == npad * n * 6 + 2 * npad * B * 4
    assert tbls.staged_slice(8, npad, n, B, 4, None) == 8
    assert tbls.staged_slice(8, npad, n, B, 4, 80 * 2 ** 30) == 8
    assert tbls.staged_slice(8, npad, n, B, 4, 6 * per) == 3
    assert tbls.staged_slice(8, npad, n, B, 4, per) == 1
    assert tbls._free_device_bytes(torch.device("cpu")) is None
    t, Y = transit_batch(rng, 7, 333)
    periods = np.linspace(1.2, 4.0, 23)
    durs = np.array([0.1, 0.2, 0.25])
    want = tbls.bls_power_shared_batch(t, Y, None, periods, durs, chunk=5,
                                       fold_impl="staged")
    monkeypatch.setattr(tbls, "_free_device_bytes", lambda device: 0)
    calls = bls_window.window_scan_uniform_plain.calls
    got = tbls.bls_power_shared_batch(t, Y, None, periods, durs, chunk=5,
                                      fold_impl="staged")
    assert bls_window.window_scan_uniform_plain.calls == calls + len(periods)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), k)


def test_window_scan_uniform_refuses_non_cuda_devices():
    """Only CPU tensors take the plain version; any other device must
    launch K-U or raise."""
    meta = torch.device("meta")
    cs_y = torch.empty((3, 128, 8), dtype=torch.float32, device=meta)
    cs_n = torch.empty((3, 128), dtype=torch.float32, device=meta)
    nbp = torch.empty((3,), dtype=torch.int32, device=meta)
    pc = torch.empty((3,), dtype=torch.float32, device=meta)
    tot = torch.empty((8,), dtype=torch.float32, device=meta)
    with pytest.raises(ValueError, match="CUDA"):
        bls_window.window_scan_uniform(cs_y, cs_n, nbp, pc, tot, 100.0, (2,),
                                       (0.1,), 0.05)


def test_window_scan_uniform_nan_past_its_rows(rng):
    """A period whose windows reach past the prefix rows gets NaN, the
    others are unchanged (K-W's rule)."""
    cs_y, cs_n, nbp, pc, tot_y, n_total, k_durs, dvals, d_phase = \
        prefix_sums(rng, B=4)
    good = bls_window.window_scan_uniform(cs_y, cs_n, nbp, pc, tot_y,
                                          n_total, k_durs, dvals, d_phase)
    short = nbp.clone()
    short[-1] = cs_y.shape[1]                 # its windows pass npad
    out = bls_window.window_scan_uniform(cs_y, cs_n, short, pc, tot_y,
                                         n_total, k_durs, dvals, d_phase)
    for f, v in out.items():
        assert torch.isnan(v[-1]).all(), f
        torch.testing.assert_close(v[:-1], good[f][:-1], rtol=0, atol=0)


@pytest.mark.mosaic_interpret
def test_all_invalid_windows_follow_the_staged_scan(rng, fresh_jax_caches):
    """A period shorter than every duration has no valid window.  The JAX
    package answers in two ways: its staged XLA scan reconstructs the
    statistics at bin 0 with n_in = n_out = 1 (depth = tot_y - 2 y_in,
    so a tiny positive power after the weight rescale), while its Pallas
    kernels (B1 window, B2 fused) keep their initial best, depth 0 and
    n_in 1 (power 0).  The port follows the staged scan, its default
    uniform path, on both routes (ROADMAP C).  Valid periods agree in all
    five."""
    t, Y = transit_batch(rng, 128, 256, period=0.9, t0=0.3, dur=0.1,
                         depth=3e-3, spacing=0.02)
    periods = np.array([0.11, 0.12, 0.9, 1.0])   # 0.11, 0.12 d: k > nbins_p
    durs = np.array([0.3])
    kw = dict(uniform_weights=True, chunk=4)
    staged_xla = jbls.bls_power_shared_batch(t, Y, None, periods, durs,
                                             fold_impl="xla",
                                             window_impl="xla", **kw)
    b1 = jbls.bls_power_shared_batch(t, Y, None, periods, durs,
                                     fold_impl="xla",
                                     window_impl="pallas_interpret", **kw)
    b2 = jbls.bls_power_shared_batch(t, Y, None, periods, durs,
                                     fold_impl="fused_interpret", **kw)
    for impl in ("fused", "staged"):
        port = tbls.bls_power_shared_batch(
            torch.from_numpy(t), torch.from_numpy(Y), None, periods, durs,
            fold_impl=impl, **kw)
        assert_same(staged_xla, port, impl)
    invalid = {name: {k: np.asarray(out[k])[:, :2] for k in out}
               for name, out in (("xla", staged_xla), ("B1", b1),
                                 ("B2", b2))}
    assert np.all(invalid["xla"]["depth"] != 0.0)
    assert np.all(invalid["xla"]["power"] > 0.0)
    for name in ("B1", "B2"):
        np.testing.assert_array_equal(invalid[name]["depth"], 0.0)
        np.testing.assert_array_equal(invalid[name]["power"], 0.0)
        assert_same({k: np.asarray(v)[:, 2:] for k, v in staged_xla.items()},
                    {k: np.asarray(v)[:, 2:] for k, v in
                     (b1 if name == "B1" else b2).items()}, name)
