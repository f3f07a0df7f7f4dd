"""lightkurve_tpu_torch — light curves and the batched transit search in
PyTorch and CUDA.

A port of ``lightkurve_tpu`` to PyTorch with hand-written CUDA kernels for
NVIDIA Hopper (sm_90a).  One curve at a time: :func:`read` gives a
``TessLightCurve`` or ``KeplerLightCurve`` (:mod:`.lightcurve`), whose
``remove_outliers``, ``flatten`` and ``to_periodogram``
(:mod:`.periodogram`) run as torch functions and whose ``normalize``,
``fold`` and ``bin`` are host numpy.  Many curves:
``read_lc_collection(paths).to_stack()`` gives a ``LightCurveStack``.  In
bulk, FITS files are read by the C++ column reader (:mod:`.io.native`) and
streamed into device stacks (:mod:`.io.pipeline`).  A stack is detrended
by the batched Savitzky-Golay flatten (:mod:`.ops.detrend`) and searched
with box least squares (:mod:`.ops.bls`: shared-time-grid kernels, mixed
grids by group, per-curve methods) in checkpointed chunks
(:mod:`.parallel.checkpoint`) or with Lomb-Scargle periodograms
(:mod:`.ops.lombscargle`, ``LightCurveStack.to_periodogram``).  Pixels:
:func:`read` also opens Kepler and TESS target pixel files
(:mod:`.targetpixelfile`), whose aperture photometry runs as torch
reductions (:mod:`.ops.photometry`) and whose systematics the regression
correctors remove (:mod:`.correctors`: PLD, SFF, CBV from local CBV
files, design matrices; the solves in :mod:`.ops.solve`); a
``TargetPixelFileCollection`` packs into a ``TPFStack`` whose
``pld_correct`` corrects every target in one batch.  :func:`read` also
opens the high-level science products (QLP, K2SFF, EVEREST, CDIPS,
PATHOS, TASOC, KEPSEISMIC, TGLC, ELEANOR, K2SC).  A periodogram's or a
light curve's ``to_seismology`` gives numax, Δν and the scaling-relation
estimates (:mod:`.seismology`; the windows' autocorrelations in one
batched FFT, :mod:`.ops.acf`).  PRF photometry fits a scene of stars and
a background to every cadence of a TPF at once (:mod:`.prf`, batched
Levenberg-Marquardt; ``TargetPixelFile.extract_prf_photometry``).
:mod:`.diagnostics` traces and times regions on the card;
:mod:`.roofline` counts the work of the hot paths against the card's
published peaks.

Archive search (:mod:`.search`, :mod:`.mast`): ``search_lightcurve(...)
.download_all().stitch()`` over a local archive, a recorded MAST
transport or the live archive over HTTP (:mod:`.mast_http`,
``HTTPMASTTransport``); :mod:`.interact_html` writes the standalone
explorers (``interact_bls(html=...)`` precomputes its BLS grid on the
card).  The plots import matplotlib and the tabular exports pandas inside
the call, so the package imports without either.  :data:`conf` holds the
user settings (:mod:`.config`).

Modules mirror ``lightkurve_tpu``'s names, and every name of its
``__all__`` resolves here.  Importing the package builds
nothing and needs neither a GPU nor ``nvcc``: kernels compile on first use
with a CUDA tensor.  Entry points put their tensors on the card unless the
caller passes ``device="cpu"``; the single-curve classes take the device
and dtype of :mod:`.config` (``default_device``, ``default_dtype``).  The
package never imports ``jax``.
"""
import importlib

__version__ = "0.1.0"

from . import diagnostics  # noqa: E402

_LAZY = {
    "conf": ".config",
    "Quantity": ".units",
    "Unit": ".units",
    "Time": ".time",
    "TimeDelta": ".time",
    "LightkurveError": ".utils",
    "LightkurveWarning": ".utils",
    "LightkurveDeprecationWarning": ".utils",
    "KeplerQualityFlags": ".utils",
    "TessQualityFlags": ".utils",
    "ops": ".ops",
    "LightCurve": ".lightcurve",
    "FoldedLightCurve": ".lightcurve",
    "KeplerLightCurve": ".lightcurve",
    "TessLightCurve": ".lightcurve",
    "LightCurveCollection": ".collections",
    "Periodogram": ".periodogram",
    "SNRPeriodogram": ".periodogram",
    "LombScarglePeriodogram": ".periodogram",
    "BoxLeastSquaresPeriodogram": ".periodogram",
    "read": ".io.read",
    "open": ".io.read",
    "read_lc_collection": ".io.read",
    "read_tpf_collection": ".io.read",
    "TargetPixelFile": ".targetpixelfile",
    "KeplerTargetPixelFile": ".targetpixelfile",
    "TessTargetPixelFile": ".targetpixelfile",
    "TargetPixelFileFactory": ".targetpixelfile",
    "TargetPixelFileCollection": ".collections",
    "TPFStack": ".batch",
    "DesignMatrix": ".correctors",
    "DesignMatrixCollection": ".correctors",
    "RegressionCorrector": ".correctors",
    "PLDCorrector": ".correctors",
    "SFFCorrector": ".correctors",
    "CBVCorrector": ".correctors",
    "CotrendingBasisVectors": ".correctors",
    "KeplerCotrendingBasisVectors": ".correctors",
    "TessCotrendingBasisVectors": ".correctors",
    "load_kepler_cbvs": ".correctors",
    "load_tess_cbvs": ".correctors",
    "Seismology": ".seismology",
    "SeismologyQuantity": ".seismology",
    "estimate_numax_acf2d": ".seismology.numax_estimators",
    "estimate_deltanu_acf2d": ".seismology.deltanu_estimators",
    "diagnose_numax_acf2d": ".seismology.numax_estimators",
    "diagnose_deltanu_acf2d": ".seismology.deltanu_estimators",
    "estimate_radius": ".seismology.stellar_estimators",
    "estimate_mass": ".seismology.stellar_estimators",
    "estimate_logg": ".seismology.stellar_estimators",
    "Corrector": ".correctors",
    "SparseDesignMatrix": ".correctors",
    "SparseDesignMatrixCollection": ".correctors",
    "create_spline_matrix": ".correctors",
    "create_sparse_spline_matrix": ".correctors",
    "KeplerLightCurveFile": ".lightcurvefile",
    "TessLightCurveFile": ".lightcurvefile",
    "search_lightcurve": ".search",
    "search_targetpixelfile": ".search",
    "search_tesscut": ".search",
    "search_lightcurvefile": ".search",
    "SearchResult": ".search",
    "MASTTransport": ".mast",
    "RecordedMASTTransport": ".mast",
    "HTTPMASTTransport": ".mast_http",
    "validate_method": ".utils",
    "running_mean": ".utils",
    "centroid_quadratic": ".utils",
    "bkjd_to_time": ".utils",
    "btjd_to_time": ".utils",
    "bkjd_to_astropy_time": ".utils",
    "btjd_to_astropy_time": ".utils",
    "show_citation_instructions": ".utils",
    "is_notebook": ".utils",
    "finalize_notebook_url": ".utils",
    "remote_jupyter_proxy_url": ".utils",
    "estimate_cdpp": ".convenience",
    "export_interact_bls_html": ".interact_html",
    "export_interact_html": ".interact_html",
    "export_interact_echelle_html": ".interact_html",
    "export_interact_sky_html": ".interact_html",
    "demo_sky_catalog": ".interact_html",
    "channel_to_module_output": ".utils",
    "module_output_to_channel": ".utils",
    "plot_image": ".utils",
    "LightCurveStack": ".batch",
    "SweepRunner": ".parallel.checkpoint",
    "StreamingStackLoader": ".io.pipeline",
    "bls_power_shared_batch": ".ops.bls",
    "bls_power": ".ops.bls",
    "bls_power_binned": ".ops.bls",
    "prewarm_shared_sweep": ".parallel.checkpoint",
    "flatten_batch": ".ops.detrend",
    "savgol_design_matrix": ".ops.savgol",
    "lombscargle_fast": ".ops.lombscargle",
    "lombscargle_fastchi2": ".ops.lombscargle",
}

__all__ = ["__version__"] + list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        module = importlib.import_module(_LAZY[name], __name__)
        return module if _LAZY[name] == "." + name else getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
