"""lightkurve_tpu_torch's units, time, quality flags, FITS reading, product
detection and ``read`` against lightkurve_tpu, on the same files.

Every file here is written by the port's writer (its FITS writer or
``LightCurve.to_fits``) from numpy inputs made from a seed, then read by
both packages.  Bar: equal -- unit and time conversions, FITS read-back
(headers and columns, bit for bit), ``detect_filetype`` on each header
variant, quality masks for each ``quality_bitmask``, and every column,
unit, time format and meta entry of what ``read`` returns.
"""
import importlib

import numpy as np
import pytest
import torch

import lightkurve_tpu as jlk
import lightkurve_tpu_torch as tlk
from lightkurve_tpu import time as jtime
from lightkurve_tpu import units as junits
from lightkurve_tpu import utils as jutils
from lightkurve_tpu.io import detect as jdetect
from lightkurve_tpu.io import fits as jfits
from lightkurve_tpu_torch import config
from lightkurve_tpu_torch import time as ttime
from lightkurve_tpu_torch import units as tunits
from lightkurve_tpu_torch import utils as tutils
from lightkurve_tpu_torch.io import detect as tdetect
from lightkurve_tpu_torch.io import fits as tfits
from test_torch_lightcurve import assert_lc_equal, curve_columns

# the modules (each package's ``io`` exports a function of the same name)
jread = importlib.import_module("lightkurve_tpu.io.read")
tread = importlib.import_module("lightkurve_tpu_torch.io.read")


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    monkeypatch.setattr(config, "default_device", "cpu")
    monkeypatch.setattr(config, "default_dtype", torch.float64)


def test_units_conversions_equal(rng):
    x = rng.uniform(0.5, 2.0, 50)
    for name in ("ppm", "ppt", "percent", "%", "d", "h", "min", "s", "uHz",
                 "1 / d", "mHz", "electron / s", "e-/s", "pix", "deg",
                 "arcsec", "BJD - 2457000"):
        a, b = junits.Unit.parse(name), tunits.Unit.parse(name)
        assert (a.scale, a.bases, str(a)) == (b.scale, b.bases, str(b)), name
    pairs = [("ppm", "percent"), ("ppt", "ppm"), ("d", "s"), ("h", "d"),
             ("uHz", "1 / d"), ("1 / d", "Hz"), ("mHz", "uHz")]
    for src, dst in pairs:
        a = junits.Quantity(x, src).to(dst)
        b = tunits.Quantity(x, src).to(dst)
        np.testing.assert_array_equal(b.value, a.value, err_msg=src)
        assert str(a.unit) == str(b.unit)
    a = (junits.Quantity(x, "d") ** -1).to(junits.uHz)
    b = (tunits.Quantity(x, "d") ** -1).to(tunits.uHz)
    np.testing.assert_array_equal(b.value, a.value)
    a = junits.Quantity(x, junits.electron_per_second) * 2 / junits.pixel
    b = tunits.Quantity(x, tunits.electron_per_second) * 2 / tunits.pixel
    np.testing.assert_array_equal(b.value, a.value)
    assert str(a.unit) == str(b.unit)


def test_time_conversions_equal(rng):
    v = rng.uniform(100, 3000, 40)
    for fmt in ("btjd", "bkjd", "jd", "mjd"):
        a, b = jtime.Time(v, format=fmt), ttime.Time(v, format=fmt)
        for attr in ("jd", "mjd", "bkjd", "btjd", "value"):
            np.testing.assert_array_equal(getattr(b, attr),
                                          getattr(a, attr), err_msg=attr)
        for to in ("btjd", "bkjd", "jd", "mjd"):
            np.testing.assert_array_equal(b.to_value(to), a.to_value(to))
        d_a = a - jtime.Time(v[:1], format=fmt)
        d_b = b - ttime.Time(v[:1], format=fmt)
        np.testing.assert_array_equal(d_b.to_value("d"), d_a.to_value("d"))
        np.testing.assert_array_equal((b + ttime.TimeDelta(0.25)).value,
                                      (a + jtime.TimeDelta(0.25)).value)
    np.testing.assert_array_equal(tutils.btjd_to_time(v).jd,
                                  jutils.btjd_to_time(v).jd)
    np.testing.assert_array_equal(tutils.bkjd_to_time(v).jd,
                                  jutils.bkjd_to_time(v).jd)
    assert ttime.TIME_FORMAT_OFFSETS == jtime.TIME_FORMAT_OFFSETS


@pytest.mark.parametrize("mission", ["Kepler", "Tess"])
@pytest.mark.parametrize("bitmask", ["none", "default", "hard", "hardest",
                                     None, 1 | 128 | 4096])
def test_quality_masks_equal(rng, mission, bitmask):
    q = rng.integers(0, 2 ** 21, 500) * (rng.random(500) < 0.3)
    a = getattr(jutils, f"{mission}QualityFlags").create_quality_mask(
        q, bitmask)
    b = getattr(tutils, f"{mission}QualityFlags").create_quality_mask(
        q, bitmask)
    np.testing.assert_array_equal(b, a)
    flags = getattr(tutils, f"{mission}QualityFlags")
    assert flags.decode(q[0] | 1) == getattr(
        jutils, f"{mission}QualityFlags").decode(q[0] | 1)


def assert_hdus_equal(a, b):
    assert len(a) == len(b)
    for ha, hb in zip(a, b):
        assert type(ha).__name__ == type(hb).__name__
        assert ha.header.items() == hb.header.items()
        if type(ha.data).__name__ == "TableData":
            assert ha.data.names == hb.data.names
            for name in ha.data.names:
                assert ha.data[name].dtype == hb.data[name].dtype
                np.testing.assert_array_equal(hb.data[name], ha.data[name])
        elif ha.data is None:
            assert hb.data is None
        else:
            np.testing.assert_array_equal(hb.data, ha.data)


def test_fits_read_back_equal(tmp_path, rng):
    """A file the port's writer wrote reads back to what was written, and
    the same as the reference reads it: headers, tables of every column
    type, images."""
    n = 41
    cols = {"TIME": rng.uniform(0, 30, n),
            "FLUX": rng.standard_normal(n).astype(np.float32),
            "Q": rng.integers(0, 2 ** 15, n).astype(np.int32),
            "I2": np.arange(n, dtype=np.int16), "I8": np.arange(n) * 10**10,
            "U1": np.arange(n, dtype=np.uint8), "L": np.arange(n) % 3 == 0,
            "S": np.array([f"r{i}" for i in range(n)]),
            "VEC": rng.standard_normal((n, 3)),
            "MAT": rng.standard_normal((n, 2, 3)).astype(np.float32)}
    header = {"TELESCOP": "TESS", "OBJECT": "it's", "TICID": 99,
              "FLAG": True, "RATIO": 0.125, "COMMENT": "one\ntwo"}
    image = rng.standard_normal((3, 4)).astype(np.float32)
    hdul = tfits.HDUList([
        tfits.PrimaryHDU(header=tfits.Header(header)),
        tfits.BinTableHDU(data=cols, header=tfits.Header(
            {"EXTNAME": "LIGHTCURVE", "TUNIT2": "e-/s"})),
        tfits.ImageHDU(data=image, name="APERTURE")])
    path = str(tmp_path / "w.fits")
    hdul.writeto(path)
    back = tfits.open_fits(path)
    assert_hdus_equal(jfits.open_fits(path), back)
    for name, arr in cols.items():
        np.testing.assert_array_equal(back[1].data[name], arr)
    np.testing.assert_array_equal(back["APERTURE"].data, image)
    for key, value in header.items():
        if key != "COMMENT":
            assert back[0].header[key] == value
    assert back[0].header.get("COMMENT") == "one\ntwo"
    gz = tmp_path / "w.fits.gz"
    import gzip
    gz.write_bytes(gzip.compress(open(path, "rb").read()))
    assert_hdus_equal(back, tfits.open_fits(str(gz)))


HEADER_VARIANTS = {
    "qlp": ({"ORIGIN": "MIT/QLP", "TELESCOP": "TESS"}, {}),
    "eleanor": ({"LITE": True, "PCORIGIN": "x", "TELESCOP": "TESS"}, {}),
    "pathos": ({"TELESCOP": "TESS"},
               {"cols": ["PSF_FLUX_RAW", "PSF_FLUX_COR", "AP4_FLUX_RAW",
                         "AP4_FLUX_COR", "SKY_LOCAL"]}),
    "tasoc": ({"ORIGIN": "TASOC/Aarhus"}, {}),
    "cdips": ({"ORIGIN": "CDIPS pipeline"}, {}),
    "k2sc": ({"CREATOR": "K2SC detrending"}, {}),
    "k2sff": ({"TELESCOP": "Kepler"},
              {"extname": "BESTAPER",
               "cols": ["T", "FRAW", "FCOR", "ARCLENGTH"]}),
    "everest": ({"COMMENT": "made by EVEREST", "TELESCOP": "Kepler"}, {}),
    "kepseismic": ({"ORIGIN": "CEA & SSI"}, {}),
    "tglc": ({"ORIGIN": "UCSB/TGLC"}, {}),
    "folded": ({"CREATOR": "lightkurve_tpu.FoldedLightCurve"
                           ".to_fits()", "TELESCOP": "TESS"}, {}),
    "kepler_lc": ({"CREATOR": "FluxExporter2PipelineModule",
                   "TELESCOP": "Kepler"}, {}),
    "kepler_tpf": ({"CREATOR": "TargetPixelExporterPipelineModule",
                    "TELESCOP": "Kepler"}, {}),
    "tess_lc": ({"CREATOR": "LightCurveExporterPipelineModule",
                 "TELESCOP": "TESS"}, {}),
    "tess_tpf": ({"CREATOR": "TargetPixelExporterPipelineModule",
                  "TELESCOP": "TESS"}, {}),
    "tess_stsci": ({"CREATOR": "x", "ORIGIN": "STScI/MAST",
                    "TELESCOP": "TESS"}, {}),
    "mission_only": ({"CREATOR": "LightCurve maker", "MISSION": "TESS"},
                     {}),
    "generic": ({"OBJECT": "star"}, {}),
    "unknown": ({"CREATOR": "someone", "TELESCOP": "TESS"}, {}),
}


def variant_file(tmp_path, name):
    h0, ext = HEADER_VARIANTS[name]
    names = ext.get("cols", ["TIME", "FLUX"])
    cols = {c: np.arange(5, dtype=float) for c in names}
    path = str(tmp_path / f"{name}.fits")
    tfits.write_fits(tfits.HDUList([
        tfits.PrimaryHDU(header=tfits.Header(h0)),
        tfits.BinTableHDU(data=cols, header=tfits.Header(
            {"EXTNAME": ext.get("extname", "LIGHTCURVE")}))]), path)
    return path


@pytest.mark.parametrize("name", sorted(HEADER_VARIANTS))
def test_detect_filetype_equal(tmp_path, name):
    path = variant_file(tmp_path, name)
    want = jdetect.detect_filetype(jfits.open_fits(path))
    assert tdetect.detect_filetype(tfits.open_fits(path)) == want
    # every detected type has its reader: both packages read the file, or
    # both refuse it with the same error
    results = []
    for read in (jread.read, tread.read):
        try:
            results.append(type(read(path)).__name__)
        except Exception as e:          # noqa: BLE001 - compared below
            results.append(type(e).__name__)
    assert results[1] == results[0]


def write_spoc(tmp_path, rng, name, mission="TESS", n=300):
    """A SPOC-style (or Kepler pipeline-style) light-curve file written
    with the port's FITS writer."""
    c = curve_columns(rng, n=n)
    kepler = mission == "Kepler"
    h0 = {"TELESCOP": mission, "MISSION": mission, "OBJECT": f"T {name}",
          "CREATOR": ("FluxExporter2PipelineModule" if kepler
                      else "LightCurveExporterPipelineModule"),
          "ORIGIN": "NASA/Ames", "RA_OBJ": 12.5, "DEC_OBJ": -30.25,
          ("KEPLERID" if kepler else "TICID"): 1234}
    t = c["time"] - (2454833.0 - 2457000.0 if kepler else 0.0)
    t[7] = np.nan                                     # a NaN time row
    table = {"TIME": t, "CADENCENO": c["cadenceno"].astype(np.int32),
             "SAP_FLUX": (c["flux"] * 1.02).astype(np.float32),
             "SAP_FLUX_ERR": c["flux_err"].astype(np.float32),
             "PDCSAP_FLUX": c["flux"].astype(np.float32),
             "PDCSAP_FLUX_ERR": c["flux_err"].astype(np.float32),
             ("SAP_QUALITY" if kepler else "QUALITY"): c["quality"],
             "MOM_CENTR1": rng.uniform(10, 11, n),
             "MOM_CENTR2": rng.uniform(20, 21, n)}
    units = {f"TUNIT{i}": u for i, u in enumerate(
        [("BJD - 2454833" if kepler else "BJD - 2457000, days"), "",
         "e-/s", "e-/s", "e-/s", "e-/s", "", "pixels", "pixels"], start=1)
        if u}
    path = str(tmp_path / f"{name}.fits")
    tfits.write_fits(tfits.HDUList([
        tfits.PrimaryHDU(header=tfits.Header(h0)),
        tfits.BinTableHDU(data=table, header=tfits.Header(dict(
            {"EXTNAME": "LIGHTCURVE", "TIMESYS": "TDB",
             "BJDREFI": 2454833 if kepler else 2457000, "BJDREFF": 0.0},
            **units)))]), path)
    return path


def assert_read_equal(a, b):
    assert_lc_equal(a, b)
    assert set(a.meta) == set(b.meta)
    for k, v in a.meta.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(b.meta[k], v, err_msg=k)
        else:
            assert b.meta[k] == v, k


@pytest.mark.parametrize("mission", ["TESS", "Kepler"])
@pytest.mark.parametrize("kw", [{}, {"quality_bitmask": "none"},
                                {"quality_bitmask": "hardest"},
                                {"flux_column": "sap_flux"}])
def test_read_mission_files_equal(tmp_path, rng, mission, kw):
    path = write_spoc(tmp_path, rng, "lc", mission)
    a, b = jlk.read(path, **kw), tlk.read(path, **kw)
    assert type(b).__name__ == f"{'Tess' if mission == 'TESS' else 'Kepler'}" \
        "LightCurve"
    assert_read_equal(a, b)
    generic = dict(filetype="generic", flux_column="pdcsap_flux")
    assert_read_equal(jread.read(path, **generic),
                      tread.read(path, **generic))


@pytest.mark.parametrize("cls", ["TessLightCurve", "KeplerLightCurve",
                                 "LightCurve"])
def test_to_fits_round_trip_equal(tmp_path, rng, cls):
    """A curve written by the port's ``to_fits`` reads back (by both
    packages) to the same curve, detected as its mission's type."""
    c = curve_columns(rng, n=200)
    mission = {"TessLightCurve": "TESS", "KeplerLightCurve": "Kepler",
               "LightCurve": None}[cls]
    meta = {"MISSION": mission, "TELESCOP": mission, "TARGETID": 5,
            "LABEL": "star 5"} if mission else {"LABEL": "star 5"}
    lc = getattr(tlk, cls)(time=c["time"], flux=c["flux"],
                           flux_err=c["flux_err"], quality=c["quality"],
                           cadenceno=c["cadenceno"], meta=meta)
    path = str(tmp_path / "rt.fits")
    lc.to_fits(path)
    back = tlk.read(path, quality_bitmask="none") if mission else \
        tread.read(path)
    assert_read_equal(jlk.read(path, quality_bitmask="none") if mission
                      else jread.read(path), back)
    np.testing.assert_array_equal(back.time.value, lc.time.value)
    np.testing.assert_array_equal(back.flux.value,
                                  c["flux"].astype(np.float32))
    assert type(back).__name__ == cls
    assert back.meta["FLUX_ORIGIN"] == "lightkurve.LightCurve.to_fits()"


def test_folded_to_fits_round_trip_equal(tmp_path, rng):
    c = curve_columns(rng, n=200)
    lc = tlk.LightCurve(time=c["time"], flux=c["flux"],
                        flux_err=c["flux_err"], meta={"TARGETID": 3})
    for normalize in (False, True):
        folded = lc.fold(2.3, 1400.4, normalize_phase=normalize)
        path = str(tmp_path / f"fold{normalize}.fits")
        folded.to_fits(path)
        back = tlk.read(path)
        assert type(back).__name__ == "FoldedLightCurve"
        assert_read_equal(jlk.read(path), back)
        np.testing.assert_allclose(back.time.value, folded.time.value,
                                   rtol=1e-15)
        assert back.meta["NORMALIZE_PHASE"] == normalize


def test_read_lc_collection_equal(tmp_path, rng, caplog):
    paths = [write_spoc(tmp_path, rng, f"c{i}") for i in range(3)]
    bad = str(tmp_path / "bad.fits")
    with open(bad, "wb") as f:
        f.write(b"not a fits file")
    tpf = variant_file(tmp_path, "tess_tpf")
    a = jread.read_lc_collection(paths + [bad, tpf])
    b = tread.read_lc_collection(paths + [bad, tpf])
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        assert_read_equal(x, y)
    # the target pixel file (one without QUALITY) is skipped with a warning
    assert any(r.name == "lightkurve_tpu_torch.io.read"
               and r.getMessage().startswith(f"Skipping {tpf}")
               for r in caplog.records)
    assert_lc_equal(jread.read_lc_collection(paths, stitch=True),
                    tread.read_lc_collection(paths, stitch=True))
    with pytest.raises(FileNotFoundError):
        tlk.read(str(tmp_path / "missing.fits"))
    with pytest.raises(tutils.LightkurveError):
        tlk.read(bad)
