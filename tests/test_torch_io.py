"""lightkurve_tpu_torch FITS writing, native reading and streaming loader
against lightkurve_tpu, on the same files."""
import time

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lightkurve_tpu.io import fits as jfits
from lightkurve_tpu.io import native as jnative
from lightkurve_tpu.io import pipeline as jpipe
from lightkurve_tpu.batch import LightCurveStack as JStack
from lightkurve_tpu_torch.io import fits as tfits
from lightkurve_tpu_torch.io import native as tnative
from lightkurve_tpu_torch.io import pipeline as tpipe
from lightkurve_tpu_torch.batch import LightCurveStack as TStack


def hdu_sets(rng):
    n = 37
    header = {"TELESCOP": "TESS", "OBJECT": "it's a star", "TICID": 12345,
              "FLAG": True, "OFF": False, "RATIO": 0.1, "BAD": np.nan,
              "BIG": 1.5e300, "COMMENT": "line one\nline two",
              "HISTORY": "made from a seed"}
    sector = {"TIME": np.arange(n) * 0.00139 + 0.0011,
              "PDCSAP_FLUX": (1 + 1e-3 * rng.standard_normal(n)).astype(
                  np.float32),
              "PDCSAP_FLUX_ERR": np.full(n, 2e-4, np.float32),
              "QUALITY": np.zeros(n, np.int32)}
    mixed = {"F8": rng.standard_normal(n), "I2": np.arange(n, dtype=np.int16),
             "I8": np.arange(n, dtype=np.int64) * 10**10,
             "U1": np.arange(n, dtype=np.uint8), "L": np.arange(n) % 3 == 0,
             "S": np.array([f"row{i}" for i in range(n)]),
             "VEC": rng.standard_normal((n, 3)).astype(np.float32),
             "MAT": rng.standard_normal((n, 2, 3))}
    table_header = {"EXTNAME": "LIGHTCURVE", "TUNIT2": "e-/s",
                    "TTYPE9": "stale", "NAXIS2": 99}
    image = rng.standard_normal((4, 5))
    return {
        "sector_file": lambda m: m.HDUList([
            m.PrimaryHDU(header=m.Header(header)),
            m.BinTableHDU(data=sector, header=m.Header(table_header))]),
        "mixed_columns": lambda m: m.HDUList([
            m.PrimaryHDU(), m.BinTableHDU(data=mixed, name="MIX")]),
        "primary_image": lambda m: m.HDUList([
            m.PrimaryHDU(data=image,
                         header=m.Header({"BUNIT": "e-/s"}))]),
    }


@pytest.mark.parametrize("case", ["sector_file", "mixed_columns",
                                  "primary_image"])
def test_write_fits_byte_identical(tmp_path, case):
    make = hdu_sets(np.random.default_rng(1))[case]
    a, b = tmp_path / "jax.fits", tmp_path / "torch.fits"
    jfits.write_fits(make(jfits), str(a))
    tfits.write_fits(make(tfits), str(b))
    assert a.read_bytes() == b.read_bytes()
    with pytest.raises(OSError):
        tfits.write_fits(make(tfits), str(b))


def write_curves(directory, lengths, seed=4):
    """FITS light curves of the given lengths with NaN gaps in flux and
    time (leading, interior and trailing)."""
    rng = np.random.default_rng(seed)
    paths = []
    for i, n in enumerate(lengths):
        t = 1000.0 + np.arange(n) * 0.00139
        f = (1 + 1e-3 * rng.standard_normal(n)).astype(np.float32)
        fe = np.full(n, 1e-3, np.float32)
        f[rng.random(n) < 0.05] = np.nan
        if i % 2:
            t[:3] = np.nan
            t[n // 2] = np.nan
            t[-2:] = np.nan
            fe[5] = np.nan
        p = str(directory / f"lc{i}.fits")
        tfits.write_fits(tfits.HDUList([tfits.PrimaryHDU(), tfits.BinTableHDU(
            data={"TIME": t, "PDCSAP_FLUX": f, "PDCSAP_FLUX_ERR": fe})]), p)
        paths.append(p)
    return paths


#: how long a test waits for lightkurve_tpu's native reader (s)
JAX_NATIVE_WAIT_S = 120.0


def jax_native_reader():
    """Make sure lightkurve_tpu's native FITS reader is loaded.  That
    package compiles its library in place at first use, and under pytest's
    workers several processes may compile it at the same moment: one that
    opens the half-written file caches the pure-Python fallback for good.
    So probe again (the cached state reset) until the library loads, for
    at most :data:`JAX_NATIVE_WAIT_S`, and fail with the reason after
    that."""
    deadline = time.monotonic() + JAX_NATIVE_WAIT_S
    while True:
        jnative._LIB = None
        if jnative.available():
            return
        if time.monotonic() > deadline:
            pytest.fail(f"lightkurve_tpu's native FITS reader did not load "
                        f"within {JAX_NATIVE_WAIT_S:g} s, so the JAX side "
                        f"of this comparison has no native reader")
        time.sleep(0.5)


def test_native_reader_matches_jax(tmp_path):
    jax_native_reader()
    paths = write_curves(tmp_path, [50, 64, 33])
    for p in paths:
        assert tnative.table_rows(p) == jnative.table_rows(p)
        for col in ("TIME", "PDCSAP_FLUX", "PDCSAP_FLUX_ERR"):
            np.testing.assert_array_equal(tnative.read_column(p, col),
                                          jnative.read_column(p, col))
    for col in ("TIME", "PDCSAP_FLUX"):
        a, na = jnative.read_batch(paths, col, nthreads=2)
        b, nb = tnative.read_batch(paths, col, nthreads=2)
        np.testing.assert_array_equal(na, nb)
        np.testing.assert_array_equal(a, b)
    _, codes = tnative.read_batch(paths, "NO_SUCH_COLUMN")
    assert np.all(codes < 0)
    with pytest.raises(IOError):
        tnative.read_column(paths[0], "NO_SUCH_COLUMN")


@pytest.mark.parametrize("batch_size", [2, 5])
def test_streaming_loader_matches_jax(tmp_path, batch_size):
    """Same files, same batches: equal time, flux, flux_err and mask,
    including the padded final batch."""
    paths = write_curves(tmp_path, [40, 64, 50, 61, 33])
    ja = list(jpipe.StreamingStackLoader(paths, batch_size=batch_size,
                                         dtype=jnp.float64, nthreads=2))
    tb = list(tpipe.StreamingStackLoader(paths, batch_size=batch_size,
                                         dtype=torch.float64, nthreads=2,
                                         device="cpu"))
    assert len(ja) == len(tb) == -(-len(paths) // batch_size)
    for a, b in zip(ja, tb):
        assert b.shape == (batch_size, 64)
        for f in ("time", "flux", "flux_err", "mask"):
            np.testing.assert_array_equal(getattr(b, f).numpy(),
                                          np.asarray(getattr(a, f)), f)
        assert a.meta == b.meta
    assert tb[-1].meta[-1] == ({"PADDING": True} if len(paths) % batch_size
                               else {"FILENAME": paths[-1]})


@pytest.mark.parametrize("layout", ["clean", "head_gap", "interior_gap",
                                    "tail_gap", "one_good", "none_good"])
def test_assemble_host_stack_matches_jax(layout):
    rng = np.random.default_rng(9)
    t = 10 + np.arange(24) * 0.5
    f = 1 + rng.standard_normal(24)
    fe = np.full(24, 0.1)
    if layout == "head_gap":
        t[:4] = np.nan
    elif layout == "interior_gap":
        t[7:10] = np.nan
        f[12] = np.nan
    elif layout == "tail_gap":
        t[-5:] = np.nan
        fe[3] = -1.0
    elif layout == "one_good":
        f[:] = np.nan
        f[6] = 1.0
    elif layout == "none_good":
        t[:] = np.nan
    cols = (t[None], f[None], fe[None])
    for length in (None, 40):
        a = jpipe.assemble_host_stack(*cols, length=length)
        b = tpipe.assemble_host_stack(*cols, length=length)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_stack_from_files_matches_jax(tmp_path, monkeypatch):
    """Flux, errors, mask and meta equal JAX's from_files, which must have
    read through its native reader.  Times follow the streaming loader's
    repair rule (JAX's assemble_host_stack over the same columns), which
    keeps them increasing across interior gaps."""
    jax_native_reader()
    paths = write_curves(tmp_path, [40, 64, 50])
    native_reads = []
    read_batch = jnative.read_batch

    def counted(*args, **kwargs):
        native_reads.append(args[1])
        return read_batch(*args, **kwargs)

    monkeypatch.setattr(jnative, "read_batch", counted)
    a = JStack.from_files(paths, dtype=jnp.float64, nthreads=2)
    assert native_reads == ["TIME", "PDCSAP_FLUX", "PDCSAP_FLUX_ERR"], \
        "lightkurve_tpu's from_files did not take its native reader"
    b = TStack.from_files(paths, dtype=torch.float64, nthreads=2,
                          device="cpu")
    for f in ("flux", "flux_err", "mask"):
        np.testing.assert_array_equal(getattr(b, f).numpy(),
                                      np.asarray(getattr(a, f)), f)
    assert a.meta == b.meta
    cols = [jnative.read_batch(paths, c, stride=64, nthreads=2)[0]
            for c in ("TIME", "PDCSAP_FLUX", "PDCSAP_FLUX_ERR")]
    want = jpipe.assemble_host_stack(*cols)
    for f, w in zip(("time", "flux", "flux_err", "mask"), want):
        np.testing.assert_array_equal(getattr(b, f).numpy(), w, f)
    assert np.all(np.diff(b.time.numpy(), axis=1) > 0)
