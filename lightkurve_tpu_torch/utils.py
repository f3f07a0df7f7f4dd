"""Host utilities: quality-flag bitmasks, validation, warnings, time
helpers and the bin-edge rules of ``LightCurve.bin``.

The part of ``lightkurve_tpu/utils.py`` the light-curve data model needs,
copied (the port never imports the JAX package): the Kepler/TESS QUALITY
bitmask vocabularies and ``create_quality_mask``, ``validate_method``,
``running_mean``, ``bkjd_to_time``/``btjd_to_time``, the automatic
histogram bin-edge rules (``calculate_bin_edges``) and, for the target
pixel files, the quadratic centroid (``centroid_quadratic``), and the
citation and notebook helpers (``show_citation_instructions``,
``is_notebook``, ``remote_jupyter_proxy_url``, ``finalize_notebook_url``).
The batched torch variants of the numeric helpers live in
:mod:`lightkurve_tpu_torch.ops`.

Also here: ``plot_image`` (matplotlib, imported inside the call) and the
SkyBot solar-system query (``_query_solar_system_objects``: pandas,
imported inside the call; the HTTP fetch a pluggable ``fetch(url)``).
Every array a plot or an export hands to matplotlib or pandas passes
through :func:`_strip_quantity`, which copies a tensor (on any device) to
the host with ``.cpu()`` explicitly.
"""
from __future__ import annotations

import logging
import os
import re

import numpy as np
import torch

from .units import Quantity

log = logging.getLogger(__name__)

__all__ = [
    "LightkurveError",
    "LightkurveWarning",
    "LightkurveDeprecationWarning",
    "QualityFlags",
    "KeplerQualityFlags",
    "TessQualityFlags",
    "validate_method",
    "running_mean",
    "bkjd_to_time",
    "btjd_to_time",
    "bkjd_to_astropy_time",
    "btjd_to_astropy_time",
    "calculate_bin_edges",
    "centroid_quadratic",
    "channel_to_module_output",
    "module_output_to_channel",
    "plot_image",
    "show_citation_instructions",
    "is_notebook",
    "remote_jupyter_proxy_url",
    "finalize_notebook_url",
]


class LightkurveError(Exception):
    """Class for all lightkurve_tpu_torch exceptions."""


class LightkurveWarning(Warning):
    """Class for all lightkurve_tpu_torch warnings."""


class LightkurveDeprecationWarning(LightkurveWarning):
    """Warning for deprecated features."""


def _strip_quantity(x):
    """``x`` as a host array: a Quantity's value, and a tensor (on any
    device) through one explicit copy to the host."""
    if isinstance(x, Quantity):
        x = x.value
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class QualityFlags:
    """Base class for mission QUALITY bitmask vocabularies."""

    STRINGS: dict = {}
    OPTIONS: dict = {}

    @classmethod
    def decode(cls, quality):
        """Convert a QUALITY integer into a list of human-readable strings."""
        quality = int(_strip_quantity(quality))
        return [v for k, v in cls.STRINGS.items() if quality & k]

    @classmethod
    def create_quality_mask(cls, quality_array, bitmask=None):
        """Boolean array flagging GOOD cadences given a bitmask.

        ``bitmask`` may be an int or one of 'none'/'default'/'hard'/'hardest'.
        Matches reference ``utils.py:79-130`` including the >20%-masked
        warning.
        """
        quality_array = _strip_quantity(quality_array).astype(np.int64)
        if bitmask is None:
            return np.ones(len(quality_array), dtype=bool)
        if isinstance(bitmask, str):
            try:
                bitmask = cls.OPTIONS[bitmask]
            except KeyError:
                raise ValueError(
                    f"quality_bitmask='{bitmask}' is not supported, expected "
                    f"one of {tuple(cls.OPTIONS.keys())}")
        mask = (quality_array & bitmask) == 0
        n = len(quality_array)
        n_masked = int((~mask).sum())
        pct = 100.0 * n_masked / max(n, 1)
        msg = (f"{pct:.0f}% ({n_masked}/{n}) of the cadences will be ignored "
               f"due to the quality mask (quality_bitmask={bitmask}).")
        if pct > 20:
            log.warning("Warning: " + msg)
        else:
            log.info(msg)
        return mask


class KeplerQualityFlags(QualityFlags):
    """Kepler QUALITY bitmask flags (Kepler Archive Manual, Table 2.3)."""

    AttitudeTweak = 1
    SafeMode = 2
    CoarsePoint = 4
    EarthPoint = 8
    ZeroCrossing = 16
    Desat = 32
    Argabrightening = 64
    ApertureCosmic = 128
    ManualExclude = 256
    SensitivityDropout = 1024
    ImpulsiveOutlier = 2048
    ArgabrighteningOnCCD = 4096
    CollateralCosmic = 8192
    DetectorAnomaly = 16384
    NoFinePoint = 32768
    NoData = 65536
    RollingBandInAperture = 131072
    RollingBandInMask = 262144
    PossibleThrusterFiring = 524288
    ThrusterFiring = 1048576

    DEFAULT_BITMASK = (AttitudeTweak | SafeMode | CoarsePoint | EarthPoint
                       | Desat | ManualExclude | DetectorAnomaly | NoData
                       | ThrusterFiring)
    HARD_BITMASK = (DEFAULT_BITMASK | SensitivityDropout | ApertureCosmic
                    | CollateralCosmic | PossibleThrusterFiring)
    HARDEST_BITMASK = 2096639

    OPTIONS = {"none": 0, "default": DEFAULT_BITMASK, "hard": HARD_BITMASK,
               "hardest": HARDEST_BITMASK}

    STRINGS = {
        1: "Attitude tweak",
        2: "Safe mode",
        4: "Coarse point",
        8: "Earth point",
        16: "Zero crossing",
        32: "Desaturation event",
        64: "Argabrightening",
        128: "Cosmic ray in optimal aperture",
        256: "Manual exclude",
        1024: "Sudden sensitivity dropout",
        2048: "Impulsive outlier",
        4096: "Argabrightening on CCD",
        8192: "Cosmic ray in collateral data",
        16384: "Detector anomaly",
        32768: "No fine point",
        65536: "No data",
        131072: "Rolling band in optimal aperture",
        262144: "Rolling band in full mask",
        524288: "Possible thruster firing",
        1048576: "Thruster firing",
    }


class TessQualityFlags(QualityFlags):
    """TESS QUALITY bitmask flags (TESS DPDD EXP-TESS-ARC-ICD-0014, Tab. 28)."""

    AttitudeTweak = 1
    SafeMode = 2
    CoarsePoint = 4
    EarthPoint = 8
    Argabrightening = 16
    Desat = 32
    ApertureCosmic = 64
    ManualExclude = 128
    Discontinuity = 256
    ImpulsiveOutlier = 512
    CollateralCosmic = 1024
    Straylight = 2048
    Straylight2 = 4096
    PlanetSearchExclude = 8192
    BadCalibrationExclude = 16384
    InsufficientTargets = 32768

    DEFAULT_BITMASK = (AttitudeTweak | SafeMode | CoarsePoint | EarthPoint
                       | Argabrightening | Desat | ManualExclude
                       | ImpulsiveOutlier | BadCalibrationExclude)
    HARD_BITMASK = (DEFAULT_BITMASK | ApertureCosmic | CollateralCosmic
                    | Straylight | Straylight2)
    HARDEST_BITMASK = 65535

    OPTIONS = {"none": 0, "default": DEFAULT_BITMASK, "hard": HARD_BITMASK,
               "hardest": HARDEST_BITMASK}

    STRINGS = {
        1: "Attitude tweak",
        2: "Safe mode",
        4: "Coarse point",
        8: "Earth point",
        16: "Argabrightening",
        32: "Desaturation event",
        64: "Cosmic ray in optimal aperture",
        128: "Manual exclude",
        256: "Discontinuity corrected",
        512: "Impulsive outlier",
        1024: "Cosmic ray in collateral data",
        2048: "Straylight",
        4096: "Straylight2",
        8192: "Planet Search Exclude",
        16384: "Bad Calibration Exclude",
        32768: "Insufficient Targets for Error Correction Exclude",
    }


def validate_method(method, supported_methods):
    """Lower-case ``method`` and raise ValueError if unsupported."""
    method = method.lower()
    if method in supported_methods:
        return method
    raise ValueError(f"method '{method}' is not supported; must be one of "
                     f"{supported_methods}")


def running_mean(data, window_size):
    """Moving average via cumulative sums (reference ``utils.py:374-387``)."""
    data = np.asarray(data, dtype=float)
    window_size = min(int(window_size), len(data))
    csum = np.cumsum(np.insert(data, 0, 0.0))
    return (csum[window_size:] - csum[:-window_size]) / float(window_size)


def bkjd_to_time(bkjd):
    """BKJD floats → :class:`~lightkurve_tpu_torch.time.Time`
    (reference ``utils.py:391-417``; non-finite values become 0)."""
    from .time import Time
    bkjd = np.atleast_1d(np.asarray(bkjd, dtype=float)).copy()
    bkjd[~np.isfinite(bkjd)] = 0
    return Time(bkjd, format="bkjd", scale="tdb")


def btjd_to_time(btjd):
    """BTJD floats → :class:`~lightkurve_tpu_torch.time.Time`
    (reference ``utils.py:420-441``)."""
    from .time import Time
    btjd = np.atleast_1d(np.asarray(btjd, dtype=float)).copy()
    btjd[~np.isfinite(btjd)] = 0
    return Time(btjd, format="btjd", scale="tdb")


# Pre-computed pseudo-inverse of the 3x3-patch quadratic design matrix
# P(x, y) = a + b x + c y + d x^2 + e x y + f y^2 sampled on the integer grid
# x, y in {-1, 0, 1} (Vakili & Hogg 2016, eqns 20-21).
def _quadratic_pinv():
    xs, ys = np.meshgrid([-1, 0, 1], [-1, 0, 1])
    x = xs.ravel()
    y = ys.ravel()
    A = np.stack([np.ones(9), x, y, x**2, x * y, y**2], axis=1)
    return np.linalg.pinv(A)


_QUAD_PINV = _quadratic_pinv()


def centroid_quadratic(data, mask=None):
    """Quadratic (Vakili & Hogg 2016) sub-pixel centroid of a 2D image.

    Fits P(x,y) = a + bx + cy + dx² + exy + fy² to the 3×3 patch centred on
    the brightest (unmasked) pixel and returns the (column, row) of the
    analytic maximum; (nan, nan) if degenerate (reference
    ``utils.py:601-703``).  ``mask`` is True where pixels are USED.
    """
    data = _strip_quantity(data).astype(float)
    if mask is not None:
        data = data.copy()
        data[~np.asarray(mask, dtype=bool)] = np.nan
    if not np.isfinite(data).any():
        return np.nan, np.nan
    yy, xx = np.unravel_index(np.nanargmax(data), data.shape)
    yy = min(max(yy, 1), data.shape[0] - 2)
    xx = min(max(xx, 1), data.shape[1] - 2)

    patch = data[yy - 1: yy + 2, xx - 1: xx + 2]
    if np.any(np.isnan(patch)):
        patch = patch.copy()
        patch[np.isnan(patch)] = np.nanmean(patch)

    a, b, c, d, e, f = _QUAD_PINV @ patch.ravel()
    det = 4 * d * f - e ** 2
    if abs(det) < 1e-6:
        return np.nan, np.nan
    xm = -(2 * f * b - c * e) / det
    ym = -(2 * d * c - b * e) / det
    return xx + xm, yy + ym


# reference public names (utils.py:388-441) — aliases of the _to_time
# helpers above
def bkjd_to_astropy_time(bkjd):
    """Alias of :func:`bkjd_to_time` under the reference's public name."""
    return bkjd_to_time(bkjd)


def btjd_to_astropy_time(btjd):
    """Alias of :func:`btjd_to_time` under the reference's public name."""
    return btjd_to_time(btjd)


# ---------------------------------------------------------------------------
# Automatic histogram bin-edge rules (astropy.stats equivalents), used by
# LightCurve.bin(bins='scott'|'freedman'|'knuth'|'blocks') — reference
# lightcurve.py:1613-1646 delegates to astropy's calculate_bin_edges.
# Host-side numpy: bin-edge selection is O(n) setup work, not kernel work.
# ---------------------------------------------------------------------------
def _edges_from_width(x, dx):
    """Uniform edges of width ``dx`` spanning [min(x), max(x)]."""
    lo, hi = float(np.min(x)), float(np.max(x))
    if dx <= 0 or not np.isfinite(dx):
        return np.array([lo, hi], dtype=float)
    nb = max(int(np.ceil((hi - lo) / dx)), 1)
    return lo + dx * np.arange(nb + 1)


def scott_bin_width(x):
    """Scott's rule: Δ = 3.5 σ / n^{1/3} (Scott 1979)."""
    x = np.asarray(x, dtype=float)
    return 3.5 * np.std(x) / x.size ** (1.0 / 3)


def freedman_bin_width(x):
    """Freedman-Diaconis rule: Δ = 2 IQR / n^{1/3} (Freedman & Diaconis
    1981)."""
    x = np.asarray(x, dtype=float)
    q25, q75 = np.percentile(x, [25, 75])
    return 2.0 * (q75 - q25) / x.size ** (1.0 / 3)


def knuth_bin_count(x, max_bins=None):
    """Knuth's Bayesian optimal number of uniform bins (Knuth 2006).

    Maximizes the marginal posterior
    ``F(M) = n·ln M + lnΓ(M/2) − M·lnΓ(½) − lnΓ(n + M/2) + Σ_k lnΓ(n_k + ½)``
    by direct search (robust, no optimizer dependency).
    """
    from scipy.special import gammaln
    x = np.sort(np.asarray(x, dtype=float))
    n = x.size
    if max_bins is None:
        max_bins = max(int(5 * n ** (1.0 / 3)) + 10, 20)
    best_m, best_f = 1, -np.inf
    for m in range(1, max_bins + 1):
        nk = np.histogram(x, bins=m)[0]
        f = (n * np.log(m) + gammaln(0.5 * m) - m * gammaln(0.5)
             - gammaln(n + 0.5 * m) + np.sum(gammaln(nk + 0.5)))
        if f > best_f:
            best_m, best_f = m, f
    return best_m


def bayesian_blocks(x, p0=0.05):
    """Bayesian-blocks change-point edges for point measurements
    (Scargle et al. 2013, 'events' fitness), O(n²) dynamic program."""
    x = np.sort(np.asarray(x, dtype=float))
    n = x.size
    edges = np.concatenate([x[:1], 0.5 * (x[1:] + x[:-1]), x[-1:]])
    block_length = x[-1] - edges
    # false-alarm prior calibrated as astropy does for the events fitness
    ncp_prior = 4.0 - np.log(73.53 * p0 * n ** -0.478)
    best = np.zeros(n)
    last = np.zeros(n, dtype=int)
    for r in range(n):
        width = block_length[: r + 1] - block_length[r + 1]
        width[width <= 0] = np.inf
        counts = np.arange(r + 1, 0, -1, dtype=float)
        fit = counts * (np.log(counts) - np.log(width)) - ncp_prior
        fit[1:] += best[:r]
        last[r] = int(np.argmax(fit))
        best[r] = fit[last[r]]
    # trace back the change points
    cp = []
    i = n
    while i > 0:
        cp.append(i)
        i = last[i - 1]
    cp.append(0)
    return edges[np.array(cp[::-1])]


def calculate_bin_edges(x, bins):
    """Histogram bin edges for an automatic method or a bin count
    (astropy.stats.calculate_bin_edges equivalent)."""
    x = np.asarray(x, dtype=float)
    if isinstance(bins, str):
        if bins == "scott":
            return _edges_from_width(x, scott_bin_width(x))
        if bins == "freedman":
            return _edges_from_width(x, freedman_bin_width(x))
        if bins == "knuth":
            m = knuth_bin_count(x)
            return np.linspace(float(np.min(x)), float(np.max(x)), m + 1)
        if bins == "blocks":
            return bayesian_blocks(x)
        raise ValueError(f"unknown bin method {bins!r}")
    return np.histogram_bin_edges(x, bins=bins)


# Kepler's CCD channels 1-84 map onto its 21 science modules (2-24 without
# 5 and 21), 4 outputs per module, in channel order
_KEPLER_MODULES = [2, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18,
                   19, 20, 22, 23, 24]


def channel_to_module_output(channel):
    """Return (module, output) for a Kepler CCD channel number 1-84."""
    channel = int(channel)
    if channel < 1 or channel > 84:
        raise ValueError("Channel number must be in the range 1-84.")
    idx = channel - 1
    return _KEPLER_MODULES[idx // 4], idx % 4 + 1


def module_output_to_channel(module, output):
    """Return the Kepler CCD channel for a (module, output) pair."""
    module, output = int(module), int(output)
    if module not in _KEPLER_MODULES:
        raise ValueError(f"Module {module} is not a science module.")
    if output < 1 or output > 4:
        raise ValueError("Output must be in the range 1-4.")
    return _KEPLER_MODULES.index(module) * 4 + output


def plot_image(image, ax=None, scale="linear", origin="lower",
               xlabel="Pixel Column Number", ylabel="Pixel Row Number",
               clabel="Flux", title=None, show_colorbar=True,
               vmin=None, vmax=None, **kwargs):
    """Plot a 2D image with sensible defaults (reference ``utils.py:444``);
    ``image`` may be a tensor on any device."""
    import matplotlib.pyplot as plt
    from matplotlib import colors
    image = _strip_quantity(image)
    if ax is None:
        _, ax = plt.subplots()
    if vmin is None or vmax is None:
        finite = image[np.isfinite(image)]
        if len(finite):
            lo, hi = np.percentile(finite, [1, 99])
            vmin = lo if vmin is None else vmin
            vmax = hi if vmax is None else vmax
    norm = None
    if scale == "log":
        norm = colors.LogNorm(vmin=max(vmin, 1e-12) if vmin else None,
                              vmax=vmax)
        vmin = vmax = None
    elif scale == "sqrt":
        norm = colors.PowerNorm(gamma=0.5, vmin=vmin, vmax=vmax)
        vmin = vmax = None
    elif scale != "linear":
        raise ValueError("scale must be 'linear', 'sqrt', or 'log'")
    im = ax.imshow(image, origin=origin, norm=norm, vmin=vmin, vmax=vmax,
                   **kwargs)
    if show_colorbar:
        plt.colorbar(im, ax=ax, label=clabel)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    if title:
        ax.set_title(title)
    return ax


def _default_skybot_fetch(url):
    """Resolve a SkyBot conesearch URL from recorded responses.

    ``$LIGHTKURVE_TPU_SKYBOT_FIXTURES`` may point to a JSON file mapping
    either full URLs or bare ``EPOCH`` values to recorded SkyBot text
    responses; absent that, the query raises with the reference's
    guidance (the live service is
    ``https://ssp.imcce.fr/webservices/skybot/``; pass ``fetch=`` to query
    it)."""
    import json
    fx = os.environ.get("LIGHTKURVE_TPU_SKYBOT_FIXTURES")
    if fx:
        with open(fx) as f:
            table = json.load(f)
        if url in table:
            return table[url]
        m = re.search(r"EPOCH=([\d.]+)", url)
        if m and m.group(1) in table:
            return table[m.group(1)]
        raise LightkurveError(
            f"SkyBot fixture file {fx} has no response recorded for "
            f"{url}")
    raise NotImplementedError(
        "Solar-system object queries require network access to the "
        "SkyBot service (https://ssp.imcce.fr/webservices/skybot/), "
        "which this package does not open by itself. Record responses in "
        "$LIGHTKURVE_TPU_SKYBOT_FIXTURES or pass a `fetch=` callable.")


def _query_solar_system_objects(ra, dec, times, radius=0.1,
                                location="kepler", cache=True,
                                show_progress=True, fetch=None):
    """List asteroids/comets crossing a cone at the given epochs
    (reference ``utils.py:705-794``).

    Runs the reference's SkyBot pipeline — observer-location codes
    (Kepler C55 / TESS C57), per-epoch conesearch URLs, the ``# Flag:
    -1`` error contract, pipe-delimited response parsing, and the
    Num/Name/Class/Mv/epoch result schema — against a pluggable
    ``fetch(url) -> text`` hook.

    Returns a `pandas.DataFrame` (None when no objects were found).
    """
    import pandas as pd

    if fetch is None:
        fetch = _default_skybot_fetch
    if location.lower() in ("kepler", "k2"):
        location = "C55"
    elif location.lower() == "tess":
        location = "C57"

    url = ("https://ssp.imcce.fr/webservices/skybot/api/conesearch.php?"
           "-mime=text&"
           f"-ra={ra}&-dec={dec}&-bd={radius}&-loc={location}&")

    df = None
    for time in np.atleast_1d(_strip_quantity(times)):
        text = fetch(url + f"EPOCH={time}")
        if text[:10] == "# Flag: -1":
            raise IOError(
                "SkyBot Solar System query failed.\n"
                "URL used:\n" + url + f"EPOCH={time}" + "\n"
                "Response received:\n" + text)
        import io as _io
        try:
            res = pd.read_csv(_io.StringIO(text), delimiter="|",
                              skiprows=2)
        except pd.errors.EmptyDataError:
            res = []
        if len(res) > 0:
            res["epoch"] = time
            res.rename({"# Num ": "Num", " Name ": "Name",
                        " Class ": "Class", " Mv ": "Mv"},
                       inplace=True, axis="columns")
            res = res[["Num", "Name", "Class", "Mv",
                       "epoch"]].reset_index(drop=True)
            df = res if df is None else pd.concat([df, res])
    if df is not None:
        df.reset_index(drop=True)
    return df


def show_citation_instructions():
    print("lightkurve_tpu_torch is a PyTorch and CUDA re-implementation of "
          "the lightkurve API. Please cite the lightkurve project "
          "(Lightkurve Collaboration, 2018, ascl:1812.013) and this package.")


def _get_notebook_environment():
    """'jupyter', 'colab', or 'terminal' (reference ``utils.py:822``)."""
    try:
        ipy = str(type(get_ipython())).lower()  # noqa: F821
        if "zmqshell" in ipy:
            return "jupyter"
        if "colab" in ipy:
            return "colab"
    except NameError:
        pass  # not running under IPython
    return "terminal"


def is_notebook():
    """True when running in a Jupyter/Colab notebook."""
    return _get_notebook_environment() in ("jupyter", "colab")


def remote_jupyter_proxy_url(port):
    """JupyterHub proxy URL for a local widget server port (reference
    ``utils.py:849-876``); ``port=None`` returns the origin host."""
    import os
    import urllib.parse
    base_url = os.environ["LK_JUPYTERHUB_EXTERNAL_URL"]
    host = urllib.parse.urlparse(base_url).netloc
    if port is None:
        return host
    service_url_path = os.environ["JUPYTERHUB_SERVICE_PREFIX"]
    proxy_url_path = "proxy/%d" % port
    user_url = urllib.parse.urljoin(base_url, service_url_path)
    return urllib.parse.urljoin(user_url, proxy_url_path)


def finalize_notebook_url(notebook_url):
    """Pass an explicit URL through; with ``LK_JUPYTERHUB_EXTERNAL_URL``
    set, return the proxy-URL callable; otherwise the local default
    (reference ``utils.py:878-906``).  An empty URL raises."""
    import os
    if notebook_url is not None:
        if isinstance(notebook_url, str) and not notebook_url.strip():
            raise ValueError(
                "Empty host value: pass a notebook_url like "
                "'localhost:8888'.")
        return notebook_url
    if os.environ.get("LK_JUPYTERHUB_EXTERNAL_URL"):
        return remote_jupyter_proxy_url
    return "localhost:8888"
