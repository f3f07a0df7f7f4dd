"""The port's readers of the ten high-level science products against
lightkurve_tpu's: one synthetic file of each flavour (QLP, K2SFF, EVEREST,
CDIPS, PATHOS, TASOC, KEPSEISMIC, TGLC, ELEANOR and its GSFC lite form,
K2SC), written once and read by both packages' ``read``, with the
readers' options.  Bar: equal -- the class, every column (values, dtype
kind, unit), the times and their format, and every meta key.
"""
import numpy as np
import pytest

import lightkurve_tpu as jlk
import lightkurve_tpu_torch as tlk
from lightkurve_tpu.io import detect as jdetect
from lightkurve_tpu.io.fits import BinTableHDU, Header, open_fits
from lightkurve_tpu_torch.io import detect as tdetect
from lightkurve_tpu_torch.io import fits as tfits
from test_search_hlsp_products import N, _make_product, _table, _write

SHARED = ("QLP", "CDIPS", "EVEREST", "K2SFF", "PATHOS", "TASOC", "TGLC",
          "GSFC-ELEANOR-LITE")


def extra_product(tmp_path, flavor):
    """The flavours ``_make_product`` lacks, in its style."""
    rng = np.random.default_rng(len(flavor))
    f32 = np.float32
    flux = (1 + 1e-3 * rng.standard_normal(N)).astype(f32)
    if flavor == "KEPSEISMIC":
        table = BinTableHDU(data={"TIME": 54964.5 + 0.02 * np.arange(N),
                                  "FLUX": flux,
                                  "FLUX_ERR": np.full(N, 1e-4, f32)},
                            header=Header({"EXTNAME": "LIGHTCURVE",
                                           "MJDREF": 0.0}))
        return _write(tmp_path, "hlsp_kepseismic_kepler_phot_kplr"
                      "004448777-20d_kepler_v1_cor-filt-inp.fits",
                      {"ORIGIN": "CEA & SSI", "KEPLERID": 4448777,
                       "TELESCOP": "Kepler", "OBJECT": "KIC 4448777"}, table)
    if flavor == "K2SC":
        return _write(tmp_path, "hlsp_k2sc_k2_llc_211089792-c05_kepler_v2_"
                      "lc.fits",
                      {"CREATOR": "K2SC detrending pipeline",
                       "KEPLERID": 211089792, "TELESCOP": "Kepler",
                       "CAMPAIGN": 5},
                      _table({"FLUX": flux, "ERROR": np.full(N, 1e-3, f32),
                              "TREND_T": flux, "QUALITY": np.zeros(
                                  N, np.int32)}, bjdrefi=2454833))
    if flavor == "ELEANOR":
        quality = np.zeros(N, np.int32)
        quality[[3, 9]] = [2 ** 17, 4]
        return _write(tmp_path, "hlsp_eleanor_tess_ffi_tic0000000033_"
                      "s0001_tess_v0.2.1_lc.fits",
                      {"TELESCOP": "TESS", "LITE": False,
                       "PCORIGIN": "POSTCARD", "TIC_ID": 33, "SECTOR": 1},
                      _table({"CORR_FLUX": flux * 100, "RAW_FLUX": flux * 99,
                              "PCA_FLUX": flux * 98, "PSF_FLUX": flux * 97,
                              "FLUX_ERR": np.full(N, 0.1, f32),
                              "FLUX_BKG": np.full(N, 5.0, f32),
                              "QUALITY": quality,
                              "X_CENTROID": flux, "Y_CENTROID": flux,
                              "X_COM": flux, "Y_COM": flux,
                              "BARYCORR": np.full(N, 0.01),
                              "FFIINDEX": np.arange(N, dtype=float)}))
    raise ValueError(flavor)


@pytest.fixture(scope="module")
def products(tmp_path_factory):
    root = tmp_path_factory.mktemp("hlsp")
    paths = {f: _make_product(root, f)[1] for f in SHARED}
    for f in ("KEPSEISMIC", "K2SC", "ELEANOR"):
        paths[f] = extra_product(root, f)
    return paths


def values(col):
    return np.asarray(getattr(col, "value", col))


def assert_lc_equal(a, b):
    assert type(b).__name__ == type(a).__name__
    assert list(b.columns) == list(a.columns)
    for name in a.columns:
        va, vb = values(a[name]), values(b[name])
        assert vb.dtype.kind == va.dtype.kind, name
        if va.dtype.kind == "f":
            np.testing.assert_array_equal(vb, va, err_msg=name)
        else:
            assert np.array_equal(vb, va), name
        assert str(getattr(b[name], "unit", None)) == str(
            getattr(a[name], "unit", None)), name
    assert b.time.format == a.time.format
    assert set(b.meta) == set(a.meta)
    for k, v in a.meta.items():
        w = b.meta[k]
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(w, v, err_msg=k)
        else:
            assert str(w) == str(v), k


CASES = [("QLP", {}), ("QLP", dict(quality_bitmask="hard")),
         ("QLP", dict(flux_err_column="kspsap_flux_err")),
         ("CDIPS", {}), ("CDIPS", dict(include_inst_errs=True)),
         ("EVEREST", {}), ("K2SFF", {}), ("PATHOS", {}),
         ("PATHOS", dict(flux_column="AP4_FLUX_COR")), ("TASOC", {}),
         ("TGLC", {}), ("GSFC-ELEANOR-LITE", {}), ("ELEANOR", {}),
         ("ELEANOR", dict(quality_bitmask="hardest")),
         ("ELEANOR", dict(flux_column="RAW_FLUX")),
         ("KEPSEISMIC", {}), ("K2SC", {})]


@pytest.mark.parametrize("flavor, kw", CASES,
                         ids=[f"{f}-{'-'.join(k) or 'default'}"
                              for f, k in CASES])
def test_hlsp_read_equal(products, flavor, kw):
    path = products[flavor]
    kind = jdetect.detect_filetype(open_fits(path))
    assert tdetect.detect_filetype(tfits.open_fits(path)) == kind
    assert kind == flavor.replace("GSFC-ELEANOR-LITE", "ELEANOR")
    a, b = jlk.read(path, **kw), tlk.read(path, **kw)
    assert_lc_equal(a, b)
    assert b.meta["AUTHOR"] == a.meta["AUTHOR"]
    assert len(b) > 0


def test_hlsp_collection_reads_every_flavour(products):
    """``read_lc_collection`` of all ten flavours keeps every file."""
    paths = [products[f] for f in sorted(products)]
    coll = tlk.read_lc_collection(paths)
    assert len(coll) == len(paths)
    assert sorted(lc.meta["AUTHOR"] for lc in coll) == sorted(
        lc.meta["AUTHOR"] for lc in jlk.io.read_lc_collection(paths))


def test_hlsp_reader_errors_match(tmp_path):
    """A QLP file without its flux column fails in both packages with the
    path in the message."""
    path = _write(tmp_path, "broken_qlp.fits",
                  {"ORIGIN": "MIT/QLP", "TICID": 1, "TELESCOP": "TESS"},
                  BinTableHDU(data={"TIME": np.arange(5.0)},
                              header=Header({"EXTNAME": "LIGHTCURVE"})))
    for pkg in (jlk, tlk):
        with pytest.raises(Exception, match="broken_qlp") as info:
            pkg.read(path)
        assert type(info.value).__name__ == "LightkurveError"
