"""lightkurve_tpu_torch's tabular exports and host hand-offs against
lightkurve_tpu's.

The same light curves (made from a seed) in both packages:
``to_pandas`` gives equal frames, ``to_csv`` equal text (the reference
tests' ``line_terminator`` spelling included), ``write`` of each ASCII
format equal files that each package reads back to equal curves, and
``write(format="fits")`` a file both read.  ``to_excel`` and the stingray
hand-offs fail alike where their packages are missing.  Then
``StreamingStackLoader.map`` (its results as host numpy, against the JAX
loader's) and ``io.native.available``.  Every test runs under the
tensor trap (``torch.Tensor.__array__`` raises), as a CUDA tensor would.
"""
import io

import numpy as np
import pandas as pd
import pytest
import torch

import lightkurve_tpu as jlk
import lightkurve_tpu_torch as tlk
from lightkurve_tpu.io import pipeline as jpipe
from lightkurve_tpu_torch import config
from lightkurve_tpu_torch.io import native as tnative
from lightkurve_tpu_torch.io import pipeline as tpipe
from test_torch_io import jax_native_reader, write_curves
from test_torch_plots import lc_pair

FORMATS = ["ascii.csv", "csv", "ascii.tab", "ascii.basic"]


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    monkeypatch.setattr(config, "default_device", "cpu")
    monkeypatch.setattr(config, "default_dtype", torch.float64)


@pytest.fixture(autouse=True)
def tensor_trap(monkeypatch):
    def refuse(self, *args, **kwargs):
        raise AssertionError("a tensor reached numpy without .cpu()")
    monkeypatch.setattr(torch.Tensor, "__array__", refuse)


def curve_pairs():
    """A light curve with extra columns, its fold and its bin, in both
    packages."""
    jl, tl = lc_pair(n=300)
    fold = dict(period=0.7, epoch_time=1500.2)
    return [(jl, tl), (jl.fold(**fold), tl.fold(**fold)),
            (jl.bin(time_bin_size=0.05), tl.bin(time_bin_size=0.05))]


@pytest.mark.parametrize("case", range(3))
def test_to_pandas_equal(case):
    jl, tl = curve_pairs()[case]
    want, got = jl.to_pandas(), tl.to_pandas()
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert got.index.name == "time"
    assert list(got.columns) == [c for c in tl.columns if c != "time"]


@pytest.mark.parametrize("kw", [{}, dict(line_terminator="\r\n"),
                                dict(lineterminator="\n", sep=";",
                                     float_format="%.6f")])
@pytest.mark.parametrize("case", range(3))
def test_to_csv_equal(case, kw):
    jl, tl = curve_pairs()[case]
    assert tl.to_csv(**kw) == jl.to_csv(**kw)


def test_to_csv_to_a_path_equal(tmp_path):
    jl, tl = curve_pairs()[0]
    jl.to_csv(str(tmp_path / "jax.csv"))
    tl.to_csv(str(tmp_path / "port.csv"))
    assert (tmp_path / "port.csv").read_text() == \
        (tmp_path / "jax.csv").read_text()
    buf = io.StringIO()
    tl.to_csv(buf)
    assert buf.getvalue() == (tmp_path / "jax.csv").read_text()


def assert_columns_equal(got, want):
    assert list(got.columns) == list(want.columns)
    for name in want.columns:
        a = np.asarray(getattr(want[name], "value", want[name]))
        b = np.asarray(getattr(got[name], "value", got[name]))
        np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("fmt", FORMATS)
def test_ascii_write_and_read_round_trip_equal(tmp_path, fmt):
    jl, tl = curve_pairs()[0]
    jl.write(str(tmp_path / "jax.txt"), format=fmt)
    tl.write(str(tmp_path / "port.txt"), format=fmt)
    assert (tmp_path / "port.txt").read_text() == \
        (tmp_path / "jax.txt").read_text()
    with pytest.raises(OSError, match="already exists"):
        tl.write(str(tmp_path / "port.txt"), format=fmt)
    tl.write(str(tmp_path / "port.txt"), format=fmt, overwrite=True)
    # each package reads the other's file
    want = jlk.LightCurve.read(str(tmp_path / "port.txt"), format=fmt)
    got = tlk.LightCurve.read(str(tmp_path / "jax.txt"), format=fmt)
    assert type(got).__name__ == type(want).__name__ == "LightCurve"
    assert_columns_equal(got, want)
    # pandas' default float parser may miss the written value by an ulp
    np.testing.assert_allclose(got.flux.value, tl.flux.value, rtol=1e-15)


def test_write_refuses_other_formats_alike(tmp_path):
    jl, tl = curve_pairs()[0]
    for lc in (jl, tl):
        with pytest.raises(ValueError, match="Unsupported write format"):
            lc.write(str(tmp_path / f"{type(lc).__module__}.x"),
                     format="votable")


def test_write_fits_read_by_both(tmp_path):
    jl, tl = curve_pairs()[0]
    path = str(tmp_path / "port.fits")
    tl.write(path, format="fits")
    with pytest.raises(OSError, match="already exists"):
        tl.write(path, format="fits")
    a, b = tlk.read(path), jlk.read(path)
    np.testing.assert_array_equal(a.flux.value, b.flux.value)
    np.testing.assert_array_equal(a.time.value, b.time.value)


def test_excel_and_stingray_fail_alike(tmp_path):
    jl, tl = curve_pairs()[0]
    try:
        import openpyxl  # noqa: F401
    except ImportError:
        for lc in (jl, tl):
            with pytest.raises(ImportError, match="openpyxl"):
                lc.to_excel(str(tmp_path / "x.xlsx"))
    else:
        jl.to_excel(str(tmp_path / "jax.xlsx"))
        tl.to_excel(str(tmp_path / "port.xlsx"))
        pd.testing.assert_frame_equal(pd.read_excel(tmp_path / "port.xlsx"),
                                      pd.read_excel(tmp_path / "jax.xlsx"))
    for pkg, lc in ((jlk, jl), (tlk, tl)):
        with pytest.raises(ImportError, match="stingray"):
            lc.to_stingray()
        with pytest.raises(ImportError, match="stingray"):
            pkg.LightCurve.from_stingray(None)


def test_streaming_loader_map_equal(tmp_path):
    """``map`` runs a function over every batch and hands back host numpy
    results: a dict of a device reduction, a tuple and a plain value."""
    import jax.numpy as jnp
    paths = write_curves(tmp_path, [40, 64, 50, 61, 33])

    def summary(stack, xp):
        flux = xp.where(stack.mask, stack.flux, 0.0)
        return {"sum": flux.sum(1), "pair": (stack.time[:, 0], 3),
                "n": len(stack.meta)}

    want = jpipe.StreamingStackLoader(paths, batch_size=2, dtype=jnp.float64,
                                      nthreads=2).map(
        lambda s: summary(s, jnp))
    got = tpipe.StreamingStackLoader(paths, batch_size=2,
                                     dtype=torch.float64, nthreads=2,
                                     device="cpu").map(
        lambda s: summary(s, torch))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert isinstance(g["sum"], np.ndarray)
        assert isinstance(g["pair"], tuple)
        assert isinstance(g["pair"][0], np.ndarray) and g["pair"][1] == 3
        np.testing.assert_array_equal(g["sum"], np.asarray(w["sum"]))
        np.testing.assert_array_equal(g["pair"][0], np.asarray(w["pair"][0]))
        assert g["n"] == w["n"] == 2


def test_native_available(monkeypatch):
    jax_native_reader()
    assert tnative.available() is True

    def broken():
        raise RuntimeError("building lk_fits_reader failed")
    monkeypatch.setattr(tnative, "library", broken)
    assert tnative.available() is False
