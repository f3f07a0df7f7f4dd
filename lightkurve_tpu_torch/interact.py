"""Interactive explorers (``lightkurve_tpu/interact.py``).

Lightkurve's widgets run a bokeh server in a notebook.  As in
``lightkurve_tpu``, each entry point has two renderings without bokeh:
with ``html="page.html"`` a standalone page (:mod:`.interact_html`), and
without it a static matplotlib figure (the three linked views of
``interact_bls``, reference ``interact_bls.py:602-1004``; the pixel
selector's median frame and aperture light curve, reference
``interact.py:999-1318``), matplotlib imported inside the call.  The sky
view without ``html=`` needs the live Gaia archive and raises.  The host
helpers the pages need (``get_lightcurve_y_limits``,
``_preprocess_lc_for_bls``, ``merge_nearby_tics``) live here too.
"""
from __future__ import annotations

import logging

import numpy as np

from .utils import LightkurveError, _strip_quantity

log = logging.getLogger(__name__)

__all__ = ["show_interact_widget_bls", "show_skyview_widget",
           "show_interact_widget", "get_lightcurve_y_limits",
           "merge_nearby_tics"]


def get_lightcurve_y_limits(flux):
    """Sensible Y-axis limits for a light-curve panel (reference
    ``interact.py:252-270``): 5-sigma clip, 1/99 percentiles, 10%
    margin.  NaN-safe (reference #679: limits must never be NaN).

    Accepts a flux array or any mapping with a ``"flux"`` entry (the
    reference takes a bokeh ColumnDataSource)."""
    if isinstance(flux, dict):
        flux = flux["flux"]
    elif isinstance(getattr(flux, "data", None), dict):
        flux = flux.data["flux"]       # bokeh-like ColumnDataSource
    flux = np.asarray(getattr(flux, "value", flux), dtype=float)
    finite = flux[np.isfinite(flux)]
    # 5-sigma clip around the median, like astropy.stats.sigma_clip
    med = np.median(finite)
    std = np.std(finite)
    if std > 0:
        finite = finite[np.abs(finite - med) <= 5 * std]
    low, high = np.nanpercentile(finite, (1, 99))
    margin = 0.10 * (high - low)
    return low - margin, high + margin


def _preprocess_lc_for_bls(lc):
    """Clean a light curve for the BLS panel (reference
    ``interact_bls.py:588-599``): drop NaNs and bring the flux to
    normalized dimensionless scale so it overlays the BLS model."""
    from .units import dimensionless
    clean = lc.remove_nans()
    if not clean.meta.get("NORMALIZED", False):
        clean = clean.normalize()
    elif clean.flux.unit != dimensionless:
        clean = clean.copy()
        clean["flux"] = clean.flux.to(dimensionless)
        if clean.flux_err is not None:
            clean["flux_err"] = clean.flux_err.to(dimensionless)
    return clean


def show_interact_widget_bls(lc, notebook_url=None, minimum_period=None,
                             maximum_period=None, resolution=2000,
                             html=None):
    """The BLS explorer (reference ``interact_bls.py:602-1004``): with
    ``html="path.html"``, a standalone page whose dense period grid (at
    least 20,000 periods) is precomputed on :data:`config.default_device`
    (see :func:`.interact_html.export_interact_bls_html`); without it, a
    static three-panel figure (BLS power, folded curve, whole curve) whose
    periodogram runs on the same device."""
    if html is not None:
        from .interact_html import export_interact_bls_html
        return export_interact_bls_html(
            lc, html, minimum_period=minimum_period,
            maximum_period=maximum_period,
            resolution=max(int(resolution), 20000))
    import matplotlib.pyplot as plt
    lc = _preprocess_lc_for_bls(lc)
    # the reference sizes the period grid as
    # linspace(min_p, max_p, resolution) (interact_bls.py:630-660)
    tv = _strip_quantity(lc.time.value).astype(np.float64)
    dt = float(np.median(np.diff(tv)))
    if minimum_period is None:
        minimum_period = max(4 * dt, 0.33 + dt)
    if maximum_period is None:
        maximum_period = (tv.max() - tv.min()) / 3.0
    periods = np.linspace(float(minimum_period), float(maximum_period),
                          int(resolution))
    pg = lc.to_periodogram(method="bls", period=periods)
    best_p = float(pg.period_at_max_power.value)
    t0 = pg.transit_time_at_max_power

    fig, axs = plt.subplots(3, 1, figsize=(9, 10))
    pg.plot(ax=axs[0], view="period")
    axs[0].axvline(best_p, c="r", ls="--", alpha=0.6,
                   label=f"P = {best_p:.4f} d")
    axs[0].legend()

    folded = lc.fold(period=best_p, epoch_time=t0)
    folded.scatter(ax=axs[1], s=1)
    model = pg.get_transit_model().fold(period=best_p, epoch_time=t0)
    mt, mf = _strip_quantity(model.time.value), _strip_quantity(model.flux)
    order = np.argsort(mt)
    axs[1].plot(mt[order], mf[order], "r-", lw=1, label="BLS model")
    axs[1].legend()

    lc.scatter(ax=axs[2], s=1)
    mask = pg.get_transit_mask()
    axs[2].scatter(_strip_quantity(lc.time.value)[mask],
                   _strip_quantity(lc.flux)[mask], s=2, c="r",
                   label="in transit")
    axs[2].legend()
    fig.tight_layout()
    return fig


def show_interact_widget(tpf, aperture_mask="default", exported_filename=None,
                         transform_func=None, ylim_func=None, html=None,
                         **kwargs):
    """The pixel selector (reference ``interact.py:999-1318``): with
    ``html="path.html"``, a standalone page (see
    :func:`.interact_html.export_interact_html`); without it, a static
    two-panel figure: the median frame with the selected aperture
    outlined, and the aperture light curve the widget would show live.
    ``exported_filename`` also writes that light curve to FITS (the
    widget's export button); ``transform_func`` is applied to it before
    display and ``ylim_func`` maps it to the panel's (ymin, ymax)
    (reference ``interact.py:1018-1040``)."""
    if html is not None:
        from .interact_html import export_interact_html
        return export_interact_html(tpf, html, aperture_mask=aperture_mask)
    import matplotlib.pyplot as plt
    if exported_filename is not None:
        # reference behavior (interact.py:1096-1104): coerce to str and
        # ensure a .fits suffix; this static panel writes only when asked
        exported_filename = str(exported_filename)
        if ".fits" not in exported_filename.lower():
            exported_filename += ".fits"
    fig, (ax_img, ax_lc) = plt.subplots(
        1, 2, figsize=(11, 4), gridspec_kw={"width_ratios": [1, 2]})
    mask = tpf._parse_aperture_mask(aperture_mask)
    if not mask.any():
        # reference interact.py:1087-1094: empty mask falls back to the
        # threshold mask, then to all pixels
        log.error("No pixels in `aperture_mask`, finding optimum aperture "
                  "using `tpf.create_threshold_mask`.")
        mask = tpf.create_threshold_mask()
    if not mask.any():
        log.error("No pixels in `aperture_mask`, using all pixels.")
        mask = tpf._parse_aperture_mask("all")
    tpf.plot(ax=ax_img, aperture_mask=mask)
    lc = tpf.to_lightcurve(aperture_mask=mask)
    if transform_func is not None:
        lc = transform_func(lc)
    lc.scatter(ax=ax_lc, s=2)
    if ylim_func is not None:
        ax_lc.set_ylim(*(float(getattr(v, "value", v))
                         for v in ylim_func(lc)))
    else:
        flux = _strip_quantity(lc.flux).astype(float)
        if np.isfinite(flux).any():
            ax_lc.set_ylim(*get_lightcurve_y_limits(flux))
    ax_lc.set_title(f"aperture SAP preview ({int(mask.sum())} px)")
    fig.tight_layout()
    if exported_filename is not None:
        lc.to_fits(path=exported_filename, overwrite=True,
                   aperture_mask=mask)
    return fig


def show_skyview_widget(tpf, *args, **kwargs):
    """The sky view (reference ``interact.py:1319``): with
    ``html="path.html"`` and an offline ``catalog`` (dict/rows with
    ra/dec and optional mag/id/pmra/pmdec, or a CSV/JSON path), a
    standalone page (see :func:`.interact_html.export_interact_sky_html`).
    Without ``html=`` the live widget needs bokeh and the Gaia archive:
    raises."""
    if kwargs.get("html") is not None:
        from .interact_html import export_interact_sky_html
        return export_interact_sky_html(
            tpf, kwargs.pop("html"),
            catalog=kwargs.pop("catalog", None),
            magnitude_limit=kwargs.pop("magnitude_limit", 18.0),
            aperture_mask=kwargs.pop("aperture_mask", "empty"),
            catalog_epoch=kwargs.pop("catalog_epoch", 2016.0))
    raise LightkurveError(
        "tpf.interact_sky() requires `bokeh` and network access to the "
        "Gaia archive, which are unavailable in this environment. "
        "Pass html='path.html' and an offline `catalog` to write a "
        "standalone sky widget instead.")


def merge_nearby_tics(catalog, tic_entries):
    """Merge a TIC nearby-target report into a Gaia-style catalog.

    Offline equivalent of the reference's ``_add_nearby_tics_if_tess``
    (``interact.py:121-220``), which crossmatches the ExoFOP "nearby
    target" report against the Gaia overlay of ``interact_sky``:

    - TIC rows carrying a Gaia source id that matches an existing
      catalog row annotate that row with ``tic`` (and ``tmag`` when
      present);
    - TIC rows without a Gaia counterpart are APPENDED as new sources
      with ``source_id = 0`` (their position comes from the report);
    - id columns of "weird" dtypes (strings, objects, missing values —
      the reference's pd.Int64Dtype regression, test_interact_sky
      _functions_add_nearby_tics_weird_dtype) are normalized via a
      tolerant per-value integer parse.

    Parameters
    ----------
    catalog : dict of arrays / list of row dicts
        Gaia-style catalog with ``ra``/``dec`` and ``id``/``source_id``.
    tic_entries : list of row dicts
        Nearby-TIC report rows: ``tic`` (id), optional ``gaia_id``,
        ``ra``/``dec`` (deg), optional ``tmag``.

    Returns
    -------
    (catalog, extra_columns, tooltip_extras) : the merged column dict,
    the names of the added columns, and tooltip label/field pairs —
    mirroring the reference helper's return shape.
    """
    def _to_int(v):
        try:
            iv = int(float(v))
            return iv
        except (TypeError, ValueError):
            return 0

    if isinstance(catalog, (list, tuple)):
        cols = {}
        for row in catalog:
            for k, v in dict(row).items():
                cols.setdefault(k, []).append(v)
        catalog = cols
    cat = {k.lower(): list(np.atleast_1d(v))
           for k, v in dict(catalog or {}).items()}
    n = len(cat.get("ra", []))
    id_key = "id" if "id" in cat else "source_id"
    ids = [_to_int(v) for v in cat.get(id_key, [0] * n)]
    cat[id_key] = ids
    cat.setdefault("ra", [np.nan] * n)
    cat.setdefault("dec", [np.nan] * n)
    cat["tic"] = [""] * n
    cat["tmag"] = [np.nan] * n

    by_gaia = {g: i for i, g in enumerate(ids) if g}
    for row in tic_entries or []:
        row = dict(row)
        tic = str(row.get("tic", row.get("TIC", "")))
        gid = _to_int(row.get("gaia_id", row.get("GAIA", 0)))
        tmag = row.get("tmag", row.get("Tmag", np.nan))
        if gid and gid in by_gaia:
            i = by_gaia[gid]
            cat["tic"][i] = tic
            cat["tmag"][i] = tmag
        else:
            new_row = {id_key: 0, "ra": row.get("ra", np.nan),
                       "dec": row.get("dec", np.nan), "tic": tic,
                       "tmag": tmag}
            for k in cat:
                cat[k].append(new_row.get(k, "" if k == "tic"
                                          else np.nan))
    extras = ["tic", "tmag"]
    tooltips = [("TIC", "@tic"), ("Tmag", "@tmag")]
    return cat, extras, tooltips
