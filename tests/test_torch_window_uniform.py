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
from lightkurve_tpu_torch.ops import (bls_fused, bls_fused_weighted,
                                      bls_staged_fold, bls_window)
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
    """K-F's plain version is the staged fold (K-SF's plain version)
    followed by K-U's plain window scan, bit for bit: one code path for
    both routes."""
    ts, Y0, pc, k_durs, dvals, d_phase, nbins, bound = fold_inputs(
        rng, B=5, n=300)
    like = objective == "likelihood"
    want = bls_fused.fused_scan_uniform_plain(ts, Y0, pc, k_durs, dvals,
                                              d_phase, nbins, bound, like,
                                              wrap, chunk=13)
    cs_y, cs_n, nbp = bls_staged_fold.staged_fold_plain(
        ts, Y0, pc, d_phase, nbins, bound, max(k_durs), wrap)
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


@pytest.mark.parametrize("dtype, weighted, full_rows, fits_rows",
                         [(torch.float32, False, 1729, 28536),
                          (torch.float64, False, 878, 19024),
                          (torch.float32, True, 891, 28536),
                          (torch.float64, True, 445, 14268)])
def test_route_rule_at_the_boundary(monkeypatch, dtype, weighted, full_rows,
                                    fits_rows):
    """'auto' takes the fused kernel (K-F, or K-WF for weights) while a
    block of one warp fits the device's opt-in shared memory (232,448
    bytes on an H100) and the staged route past it; the wrappers refuse
    the rows 'auto' would not take; a block of 32 warps fits
    ``full_rows``; explicit choices pass through; the CPU has no limit.  A
    block holds each warp's prefix columns (one, or two for weights), K-F's
    shared count column, 512 staged ids and masks and 16 run flags."""
    optin = 232_448
    cpu = torch.device("cpu")
    itemsize = torch.empty((), dtype=dtype).element_size()
    per_row = 32 * itemsize * (2 if weighted else 1) + (0 if weighted else 4)
    assert bls_fused.fused_smem_bytes(full_rows, dtype,
                                      weighted=weighted) == (
        full_rows * per_row + 512 * 8 + 16 * 4)
    assert bls_fused.fused_smem_bytes(full_rows, dtype,
                                      weighted=weighted) <= optin
    assert bls_fused.fused_smem_bytes(full_rows + 1, dtype,
                                      weighted=weighted) > optin
    assert bls_fused.fused_fits(10 ** 6, dtype, cpu, weighted)
    monkeypatch.setattr(bls_fused, "shared_memory_optin",
                        lambda device: optin)
    assert bls_fused.fused_fits(fits_rows, dtype, cpu, weighted)
    assert not bls_fused.fused_fits(fits_rows + 1, dtype, cpu, weighted)
    bls_fused.check_fused_rows(fits_rows, dtype, cpu, weighted)
    with pytest.raises(ValueError, match="fold_impl='staged'"):
        bls_fused.check_fused_rows(fits_rows + 1, dtype, cpu, weighted)
    k_max = 66
    for rows, want in ((fits_rows, "fused"), (fits_rows + 1, "staged")):
        max_nbp = rows - k_max + 1
        assert tbls.fold_route("auto", max_nbp, k_max, dtype, cpu,
                               weighted) == want
    for impl in ("fused", "staged"):
        assert tbls.fold_route(impl, 10 ** 5, k_max, dtype, cpu,
                               weighted) == impl
    with pytest.raises(ValueError):
        tbls.fold_route("xla", 100, k_max, dtype, cpu, weighted)
    monkeypatch.undo()
    assert tbls.fold_route("auto", 10 ** 5, k_max, dtype, cpu,
                           weighted) == "fused"


@pytest.mark.parametrize("weighted", [False, True])
def test_auto_route_follows_the_measured_crossovers(weighted):
    """'auto' is a pure function of shapes: on an H100 the fused kernel
    takes a call of 2048 curves or more up to 1,700 rows, one of 1024 up to
    2,600 and one of 256 up to 4,096, the staged route past them or
    wherever a one-warp block does not fit; any other device keeps the
    stated default, the fused kernel wherever it fits."""
    h100 = "NVIDIA H100 80GB HBM3"
    assert h100 in tbls.ROUTE_CROSSOVERS
    for curves, last_fused in ((4096, 1700), (2048, 1700), (2047, 2600),
                               (1024, 2600), (1023, 4096), (256, 4096),
                               (1, 4096)):
        for rows, want in ((824, "fused"), (last_fused, "fused"),
                           (last_fused + 1, "staged"), (27_005, "staged")):
            assert tbls.auto_route(rows, curves, weighted, h100,
                                   True) == want, (curves, rows)
        assert tbls.auto_route(824, curves, weighted, h100,
                               False) == "staged"
    for card in (None, "NVIDIA A100-SXM4-80GB"):
        assert tbls.auto_route(27_005, 2048, weighted, card, True) == "fused"
        assert tbls.auto_route(824, 2048, weighted, card, False) == "staged"


@pytest.mark.parametrize("weighted", [False, True])
def test_auto_route_per_bucket(rng, monkeypatch, weighted):
    """With bucket=True each period group goes through the route rule on
    its own rows: short periods take the fused kernel's plain version,
    long ones the staged route, and the result equals one route for all
    periods (uniform weights: K-F / K-U; per-cadence weights: K-WF /
    K-W)."""
    B, n = 6, 512
    t = np.arange(n) * 0.01
    Y = torch.from_numpy(1.0 + 1e-3 * rng.normal(size=(B, n)))
    dy = None
    fused_plain, staged_plain = (bls_fused.fused_scan_uniform_plain,
                                 bls_window.window_scan_uniform_plain)
    if weighted:
        dy = torch.from_numpy(1e-3 * (1 + rng.random((B, n))))
        fused_plain, staged_plain = (
            bls_fused_weighted.fused_scan_weighted_plain,
            bls_window.window_scan_plain)
    periods = np.linspace(0.3, 2.5, 60)       # 1-3 tiles of 128 rows
    durs = np.array([0.05, 0.1])
    # a limit that the narrowest "auto" block of up to 256 float64 rows fits
    optin = bls_fused.fused_smem_bytes(256, torch.float64, tile=1,
                                       weighted=weighted)
    monkeypatch.setattr(bls_fused, "shared_memory_optin",
                        lambda device: optin)
    fused_calls, staged_calls = fused_plain.calls, staged_plain.calls
    got = tbls.bls_power_shared_batch(t, Y, dy, periods, durs, chunk=4,
                                      bucket=True)
    assert fused_plain.calls > fused_calls
    assert staged_plain.calls > staged_calls
    want = tbls.bls_power_shared_batch(t, Y, dy, periods, durs, chunk=4,
                                       fold_impl="fused")
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), k)


def test_staged_and_fused_routes_agree_bit_for_bit(rng):
    """On the CPU both routes run the same fold and window arithmetic."""
    t, Y = transit_batch(rng, 7, 333)
    periods = np.linspace(1.2, 4.0, 23)
    durs = np.array([0.1, 0.2, 0.25])
    out = [tbls.bls_power_shared_batch(t, Y, None, periods, durs, chunk=5,
                                       fold_impl=impl, device="cpu")
           for impl in ("fused", "staged")]
    for k in out[0]:
        np.testing.assert_array_equal(out[0][k].numpy(), out[1][k].numpy(),
                                      k)


def test_staged_route_slices_periods_to_free_memory(rng, monkeypatch):
    """The staged route folds as many periods per call as half the free
    device memory holds, at least one; the result does not depend on the
    slice.  A period holds its prefix rows and its deposit indices, and
    nothing that grows with rows x cadences: a year of two-minute
    cadences folded at 300 d takes about half a gigabyte per period."""
    npad, n, B = 3712, 38880, 2048            # two sectors, float32
    per = tbls.staged_fold_bytes(npad, n, B, 4)
    assert per == npad * B * 4 + 64 * n + npad * (16 + 4)
    year = tbls.staged_fold_bytes(60_032, 262_800, B, 4)
    assert year < 2 ** 29
    assert tbls.staged_slice(8, 60_032, 262_800, B, 4, 75 * 2 ** 30) == 8
    assert tbls.staged_slice(8, npad, n, B, 4, None) == 8
    assert tbls.staged_slice(8, npad, n, B, 4, 80 * 2 ** 30) == 8
    assert tbls.staged_slice(8, npad, n, B, 4, 6 * per) == 3
    assert tbls.staged_slice(8, npad, n, B, 4, per) == 1
    assert tbls._free_device_bytes(torch.device("cpu")) is None
    t, Y = transit_batch(rng, 7, 333)
    periods = np.linspace(1.2, 4.0, 23)
    durs = np.array([0.1, 0.2, 0.25])
    want = tbls.bls_power_shared_batch(t, Y, None, periods, durs, chunk=5,
                                       fold_impl="staged", device="cpu")
    monkeypatch.setattr(tbls, "_free_device_bytes", lambda device: 0)
    calls = bls_window.window_scan_uniform_plain.calls
    got = tbls.bls_power_shared_batch(t, Y, None, periods, durs, chunk=5,
                                      fold_impl="staged", device="cpu")
    assert bls_window.window_scan_uniform_plain.calls == calls + len(periods)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), k)


def test_staged_weighted_route_slices_periods_to_free_memory(rng,
                                                             monkeypatch):
    """The staged weighted route sizes its period slice as the uniform one
    does, with the fold's two columns per curve ([w | w*y]); the result
    does not depend on the slice."""
    npad, n, B = 27136, 38880, 2048           # a one-warp block, float32
    per = tbls.staged_fold_bytes(npad, n, 2 * B, 4)
    assert per == npad * 2 * B * 4 + 64 * n + npad * (16 + 4)
    assert tbls.staged_slice(8, npad, n, 2 * B, 4, 75 * 2 ** 30) == 8
    assert tbls.staged_slice(8, npad, n, 2 * B, 4, 6 * per) == 3
    t, Y = transit_batch(rng, 7, 333)
    dy = 1e-3 * (1 + rng.random(Y.shape))
    periods = np.linspace(1.2, 4.0, 23)
    durs = np.array([0.1, 0.2, 0.25])
    kw = dict(chunk=5, fold_impl="staged", uniform_weights=False,
              device="cpu")
    want = tbls.bls_power_shared_batch(t, Y, dy, periods, durs, **kw)
    monkeypatch.setattr(tbls, "_free_device_bytes", lambda device: 0)
    calls = bls_window.window_scan_plain.calls
    got = tbls.bls_power_shared_batch(t, Y, dy, periods, durs, **kw)
    assert bls_window.window_scan_plain.calls == calls + len(periods)
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
