"""lightkurve_tpu_torch's LightCurve data model, the torch fold and binning
ops and the collection-to-stack bridge against lightkurve_tpu.

The same numpy inputs, made from a seed, go through both packages on the
CPU: the reference with x64 on (conftest), the port with its configuration
set to the CPU and float64 (the ``port_on_cpu`` fixture; by default the
port's single-curve classes run on the card in float32).  Bars:

- equal: ``normalize``, ``remove_nans``, ``fold``, ``bin`` in each mode,
  ``fill_gaps`` with a seed, ``create_transit_mask``, ``append``,
  ``stitch``, ``select_flux``, ``truncate``/``head``/``tail``, arithmetic,
  and the outlier mask of ``remove_outliers``;
- rtol 1e-10: ``flatten``, ``estimate_cdpp`` and the fluxes ``fill_gaps``
  draws with ``estimate_cdpp``'s spread;
- rtol 1e-12: ``ops/fold`` and ``ops/binning`` against the JAX ops;
- ``test_torch_percurve.assert_same``: ``from_collection`` -> ``bls_search``
  winners; ``stack[i]`` equals the JAX stack's member.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightkurve_tpu as jlk
import lightkurve_tpu_torch as tlk
from lightkurve_tpu.ops import binning as jbin
from lightkurve_tpu.ops import fold as jfold
from lightkurve_tpu_torch import config
from lightkurve_tpu_torch.batch import LightCurveStack as TStack
from lightkurve_tpu_torch.ops import binning as tbin
from lightkurve_tpu_torch.ops import fold as tfold
from test_torch_percurve import assert_same

RTOL = 1e-10
OPS_RTOL = 1e-12


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    """The port's single-curve classes on the CPU in float64, as the
    reference runs here with x64 on."""
    monkeypatch.setattr(config, "default_device", "cpu")
    monkeypatch.setattr(config, "default_dtype", torch.float64)


def values(col):
    return np.asarray(getattr(col, "value", col))


def assert_lc_equal(a, b, rtol=None, tag=""):
    """Same class name, columns, units, time format and scale, and the
    same values (bit for bit, NaN where NaN; or within ``rtol``)."""
    assert type(a).__name__ == type(b).__name__, tag
    assert list(a.columns) == list(b.columns), (tag, a.columns, b.columns)
    assert a.time.format == b.time.format and a.time.scale == b.time.scale
    for name in a.columns:
        ca, cb = a[name], b[name]
        assert str(getattr(ca, "unit", "")) == str(getattr(cb, "unit", "")), \
            (tag, name)
        va, vb = values(ca), values(cb)
        assert va.dtype == vb.dtype, (tag, name, va.dtype, vb.dtype)
        if rtol is None or va.dtype.kind not in "f":
            np.testing.assert_array_equal(vb, va, err_msg=f"{tag} {name}")
        else:
            np.testing.assert_allclose(vb, va, rtol=rtol, atol=0,
                                       err_msg=f"{tag} {name}")


def curve_columns(rng, n=400, nan_share=0.02, cadence=2.0 / 60 / 24 * 10,
                  t_start=1400.0):
    """A TESS-like curve: a rotation trend, one transiting planet (2.3 d,
    0.12 d, 3e-3), outliers, NaN cadences, a gap, quality flags and a
    cadence number."""
    t = t_start + np.arange(n) * cadence
    t[n // 2:] += 0.7                                  # a downlink gap
    flux = 1000.0 * (1 + 0.004 * np.sin(2 * np.pi * t / 3.1))
    ph = np.mod(t - 1400.4 + 1.15, 2.3) - 1.15
    flux[np.abs(ph) < 0.06] *= 1 - 3e-3
    flux += 0.3 * rng.standard_normal(n)
    flux[rng.random(n) < 0.01] += 8.0
    flux_err = rng.uniform(0.25, 0.35, n)
    flux[rng.random(n) < nan_share] = np.nan
    quality = np.where(rng.random(n) < 0.03, 128, 0).astype(np.int32)
    quality[rng.random(n) < 0.02] |= 1024
    return dict(time=t, flux=flux, flux_err=flux_err, quality=quality,
                cadenceno=np.arange(n, dtype=np.int64) + 5000)


def make_both(cols, cls="TessLightCurve", **kw):
    j = getattr(jlk, cls)(time=cols["time"], flux=cols["flux"],
                          flux_err=cols["flux_err"],
                          quality=cols["quality"],
                          cadenceno=cols["cadenceno"], **kw)
    t = getattr(tlk, cls)(time=cols["time"], flux=cols["flux"],
                          flux_err=cols["flux_err"],
                          quality=cols["quality"],
                          cadenceno=cols["cadenceno"], **kw)
    return j, t


@pytest.fixture
def pair(rng):
    return make_both(curve_columns(rng), meta={"TARGETID": 7,
                                               "MISSION": "TESS"})


def test_construction_and_columns_equal(pair):
    j, t = pair
    assert_lc_equal(j, t)
    assert j.meta == t.meta
    assert j.time.format == "btjd"
    assert_lc_equal(j["time", "flux"], t["time", "flux"])
    assert_lc_equal(j[10:50], t[10:50])
    assert_lc_equal(j[np.arange(0, 400, 7)], t[np.arange(0, 400, 7)])


@pytest.mark.parametrize("unit", ["unscaled", "percent", "ppt", "ppm"])
def test_normalize_equal(pair, unit):
    j, t = pair
    assert_lc_equal(j.normalize(unit), t.normalize(unit), tag=unit)
    assert j.normalize(unit).meta == t.normalize(unit).meta


def test_remove_nans_select_flux_truncate_equal(pair):
    j, t = pair
    assert_lc_equal(j.remove_nans(), t.remove_nans())
    j2, t2 = j.copy(), t.copy()
    j2["sap_flux"], t2["sap_flux"] = j.flux * 1.01, t.flux * 1.01
    assert_lc_equal(j2.select_flux("sap_flux"), t2.select_flux("sap_flux"))
    assert_lc_equal(j.truncate(1400.2, 1401.3), t.truncate(1400.2, 1401.3))
    assert_lc_equal(j.head(7), t.head(7))
    assert_lc_equal(j.tail(9), t.tail(9))


def test_arithmetic_equal(pair):
    j, t = pair
    jr, tr = j.remove_nans(), t.remove_nans()
    for op in (lambda a: a + 3.0, lambda a: 2.0 * a, lambda a: a / 4.0,
               lambda a: a - a, lambda a: a * a, lambda a: a / (a + 1.0),
               lambda a: 5.0 - a, lambda a: 1.0 / a):
        assert_lc_equal(op(jr), op(tr))


@pytest.mark.parametrize("sigma, kw", [(5.0, {}), (3.0, {}),
                                       (3.0, {"sigma_lower": 10.0}),
                                       (2.5, {"maxiters": 2})])
def test_remove_outliers_mask_equal(pair, sigma, kw):
    j, t = pair
    ja, jm = j.remove_outliers(sigma=sigma, return_mask=True, **kw)
    ta, tm = t.remove_outliers(sigma=sigma, return_mask=True, **kw)
    np.testing.assert_array_equal(tm, jm)
    assert_lc_equal(ja, ta)


@pytest.mark.parametrize("kw", [
    dict(window_length=101),
    dict(window_length=51, polyorder=3, break_tolerance=None, niters=1),
    dict(window_length=31, sigma=2.5, break_tolerance=3),
])
def test_flatten_rtol(pair, kw):
    j, t = pair
    jf, jt = j.flatten(return_trend=True, **kw)
    tf, tt = t.flatten(return_trend=True, **kw)
    assert_lc_equal(jf, tf, rtol=RTOL)
    assert_lc_equal(jt, tt, rtol=RTOL)
    assert jf.meta == tf.meta


def test_flatten_with_mask_rtol(pair):
    j, t = pair
    mask = j.create_transit_mask(2.3, 1400.4, 0.2)
    assert_lc_equal(j.flatten(window_length=61, mask=mask),
                    t.flatten(window_length=61, mask=mask), rtol=RTOL)


@pytest.mark.parametrize("kw", [{}, dict(transit_duration=5,
                                         savgol_window=51, sigma=3.0)])
def test_estimate_cdpp_rtol(pair, kw):
    j, t = pair
    a, b = j.estimate_cdpp(**kw), t.estimate_cdpp(**kw)
    assert str(a.unit) == str(b.unit) == "ppm"
    np.testing.assert_allclose(b.value, a.value, rtol=RTOL)


@pytest.mark.parametrize("kw", [
    dict(period=2.3),
    dict(period=2.3, epoch_time=1400.4),
    dict(period=2.3, epoch_time=1400.4, normalize_phase=True),
    dict(period=2.3, epoch_time=1400.4, epoch_phase=0.3, wrap_phase=1.0),
    dict(period=2.3, epoch_time=1400.4, epoch_phase=0.25, wrap_phase=0.8,
         normalize_phase=True),
])
def test_fold_equal(pair, kw):
    j, t = pair
    jf, tf = j.fold(**kw), t.fold(**kw)
    assert_lc_equal(jf, tf)
    for prop in ("cycle", "odd_mask", "even_mask"):
        np.testing.assert_array_equal(getattr(tf, prop), getattr(jf, prop))
    np.testing.assert_array_equal(values(tf.phase), values(jf.phase))
    assert str(tf.meta["PERIOD"]) == str(jf.meta["PERIOD"])


BIN_CASES = {
    "size": dict(time_bin_size=0.05),
    "size_start": dict(time_bin_size=0.05, time_bin_start=1400.1),
    "n_bins": dict(n_bins=37),
    "n_bins_end": dict(n_bins=20, time_bin_end=1401.5),
    "bins_int": dict(bins=25),
    "bins_array": dict(bins=np.linspace(1400.05, 1401.7, 14)),
    "blocks": dict(bins="blocks"),
    "scott": dict(bins="scott"),
    "binsize": dict(binsize=13),
    "start_array_end": dict(time_bin_start=np.array([1400.0, 1400.3,
                                                     1400.9, 1401.4]),
                            time_bin_end=1401.8),
    "start_array_size": dict(time_bin_start=np.array([1400.0, 1400.3,
                                                      1401.4]),
                             time_bin_size=0.2),
    "median": dict(time_bin_size=0.1, aggregate_func=np.nanmedian),
    "default": dict(),
}


@pytest.mark.parametrize("case", sorted(BIN_CASES))
def test_bin_equal(pair, case):
    j, t = pair
    kw = BIN_CASES[case]
    assert_lc_equal(j.bin(**kw), t.bin(**kw), tag=case)


def test_folded_bin_equal(pair):
    j, t = pair
    jf = j.fold(2.3, 1400.4).bin(time_bin_size=0.02)
    tf = t.fold(2.3, 1400.4).bin(time_bin_size=0.02)
    assert_lc_equal(jf, tf)
    assert str(tf.meta["PERIOD"]) == str(jf.meta["PERIOD"])


@pytest.mark.parametrize("cadenceno", [True, False])
def test_fill_gaps_seeded_equal(pair, cadenceno):
    """Equal, except the filled fluxes: their noise is drawn with the
    standard deviation of ``estimate_cdpp``, which goes through the flatten
    and so agrees to its rtol, not bit for bit (ROADMAP C)."""
    j, t = pair
    if not cadenceno:
        j, t = j.copy(), t.copy()
        j.remove_column("cadenceno")
        t.remove_column("cadenceno")
    jf, tf = j.fill_gaps(seed=11), t.fill_gaps(seed=11)
    filled = jf.quality >= 65536
    assert filled.any() and np.array_equal(tf.quality, jf.quality)
    np.testing.assert_allclose(tf.flux.value[filled], jf.flux.value[filled],
                               rtol=RTOL)
    jf.flux[filled] = tf.flux[filled] = 0.0
    assert_lc_equal(jf, tf)


def test_create_transit_mask_equal(pair):
    j, t = pair
    for args in [(2.3, 1400.4, 0.12), ([2.3, 0.9], [1400.4, 1400.1],
                                       [0.12, 0.3])]:
        np.testing.assert_array_equal(t.create_transit_mask(*args),
                                      j.create_transit_mask(*args))


def test_append_and_stitch_equal(rng):
    parts = [curve_columns(rng, n=150, t_start=1400.0 + 5 * k)
             for k in range(3)]
    pairs = [make_both(c, meta={"SECTOR": k}) for k, c in enumerate(parts)]
    js, ts = [p[0] for p in pairs], [p[1] for p in pairs]
    assert_lc_equal(js[0].append(js[1:]), ts[0].append(ts[1:]))
    jc, tc = jlk.LightCurveCollection(js), tlk.LightCurveCollection(ts)
    assert_lc_equal(jc.stitch(), tc.stitch())
    assert_lc_equal(jc.stitch(lambda x: x.remove_nans()),
                    tc.stitch(lambda x: x.remove_nans()))
    np.testing.assert_array_equal(tc.sector, jc.sector)
    assert len(tc[1:]) == len(jc[1:]) == 2


def test_ops_fold_match_jax(rng):
    t = np.sort(rng.uniform(0, 30, 500))
    for kw in (dict(), dict(epoch_time=1.7, epoch_phase=0.3),
               dict(epoch_time=1.7, epoch_phase=0.2, wrap_phase=0.7,
                    normalize_phase=True)):
        a = jfold.fold_phase(jnp.asarray(t), 2.71, **kw)
        b = tfold.fold_phase(torch.from_numpy(t), 2.71, **kw)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=OPS_RTOL,
                                   atol=1e-14)
    a = jfold.transit_mask(jnp.asarray(t), [2.71, 4.1], [1.2, 0.3],
                           [0.2, 0.5])
    b = tfold.transit_mask(torch.from_numpy(t), [2.71, 4.1], [1.2, 0.3],
                           [0.2, 0.5])
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    ph = np.array(jfold.fold_phase(jnp.asarray(t), 2.71))
    vals = 1 + 1e-3 * rng.standard_normal(500)
    mask = rng.random(500) > 0.1
    a = jfold.bin_folded(jnp.asarray(ph), jnp.asarray(vals),
                         jnp.asarray(mask), 40, -1.2, 1.2)
    b = tfold.bin_folded(torch.from_numpy(ph), torch.from_numpy(vals),
                         torch.from_numpy(mask), 40, -1.2, 1.2)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=OPS_RTOL)


def test_ops_binning_match_jax(rng):
    t = np.sort(rng.uniform(0, 10, 700))
    vals = 5 + rng.standard_normal(700)
    mask = rng.random(700) > 0.05
    a = jbin.bin_time(jnp.asarray(t), jnp.asarray(vals), jnp.asarray(mask),
                      0.5, 0.37, 30)                   # empty tail bins
    b = tbin.bin_time(torch.from_numpy(t), torch.from_numpy(vals),
                      torch.from_numpy(mask), 0.5, 0.37, 30)
    for x, y in zip(a, b):
        x, y = np.asarray(x), y.numpy()
        np.testing.assert_array_equal(np.isnan(y), np.isnan(x))
        np.testing.assert_allclose(y, x, rtol=OPS_RTOL)
    ids = rng.integers(0, 12, 700)
    a = jbin.bin_aggregate(jnp.asarray(vals), jnp.asarray(mask),
                           jnp.asarray(ids, jnp.int32), 12)
    b = tbin.bin_aggregate(torch.from_numpy(vals), torch.from_numpy(mask),
                           torch.from_numpy(ids), 12)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=OPS_RTOL)


def collection_pair(rng, B=24, n=300, ragged=False):
    """B curves sharing one time grid (or, ``ragged``, each cut short by
    a few cadences), a transit each, NaN cadences."""
    cols = []
    truth = rng.uniform(1.3, 2.6, B)
    for i in range(B):
        c = curve_columns(rng, n=n)
        ph = np.mod(c["time"] - 1400.2 + truth[i] / 2, truth[i]) \
            - truth[i] / 2
        c["flux"] = np.where(np.abs(ph) < 0.05, c["flux"] * (1 - 4e-3),
                             c["flux"])
        if ragged:
            c = {k: v[:n - 3 * (i % 4)] for k, v in c.items()}
        cols.append(c)
    pairs = [make_both(c, meta={"TICID": i}) for i, c in enumerate(cols)]
    return (jlk.LightCurveCollection([p[0] for p in pairs]),
            tlk.LightCurveCollection([p[1] for p in pairs]))


@pytest.mark.parametrize("ragged", [False, True])
def test_from_collection_search_and_members_match_jax(rng, ragged):
    """``to_stack`` -> ``bls_search`` winners equal the reference's (whose
    stack is padded to a power of two), and ``stack[i]`` gives the JAX
    stack's member."""
    jc, tc = collection_pair(rng, ragged=ragged)
    js = jc.to_stack()
    ts = tc.to_stack(device="cpu", dtype=torch.float64)
    assert js.shape[1] == 512 and ts.shape[1] == 300
    assert ts.time_format == js.time_format == "btjd"
    periods, durations = np.linspace(1.2, 2.8, 40), np.array([0.08, 0.12])
    a = js.bls_search(periods, durations)
    b = ts.bls_search(periods, durations)
    assert_same(a, b, tag=f"ragged={ragged}")
    for i in (0, 5, len(tc) - 1):
        assert_lc_equal(js[i], ts[i], tag=str(i))
        assert ts[i].meta == js[i].meta
    padded = tc.to_stack(device="cpu", dtype=torch.float64,
                         pad_to_pow2=True)
    assert padded.shape == js.shape
    for name in ("time", "flux", "flux_err", "mask"):
        np.testing.assert_array_equal(getattr(padded, name).numpy(),
                                      np.asarray(getattr(js, name)))


def test_single_curve_device_calls_refuse_without_cuda(pair, monkeypatch):
    """With the configuration at its defaults (the card) and no CUDA, the
    device calls raise instead of running on the CPU."""
    _, t = pair
    monkeypatch.setattr(config, "default_device", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    coll = tlk.LightCurveCollection([t, t])
    for call in (lambda: t.flatten(), lambda: t.remove_outliers(),
                 lambda: t.to_periodogram(),
                 lambda: t.remove_nans().to_periodogram("bls"),
                 lambda: t.estimate_cdpp(),
                 lambda: coll.to_stack(),
                 lambda: TStack.from_collection(coll)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()
    # the host methods need no device
    t.normalize().fold(2.3).bin(time_bin_size=0.05)
