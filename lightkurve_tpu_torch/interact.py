"""Interactive explorers (``lightkurve_tpu/interact.py``).

Lightkurve's widgets run a bokeh server in a notebook; the JAX package
adds static matplotlib panels.  Neither bokeh nor matplotlib is on the
card's machine, so the port keeps the ``html=`` routes, which write a
standalone page (:mod:`.interact_html`), and the host helpers those pages
need (``get_lightcurve_y_limits``, ``_preprocess_lc_for_bls``,
``merge_nearby_tics``).  Without ``html=`` each widget raises
``NotImplementedError`` naming ROADMAP A's plotting item.
"""
from __future__ import annotations

import numpy as np

__all__ = ["show_interact_widget_bls", "show_skyview_widget",
           "show_interact_widget", "get_lightcurve_y_limits",
           "merge_nearby_tics"]


def _not_ported(what):
    raise NotImplementedError(
        f"{what} without html= is not ported to lightkurve_tpu_torch "
        "(ROADMAP A, left out on purpose: plotting, no matplotlib or bokeh "
        "on the card's machine); pass html='page.html' to write the "
        "standalone page.")


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
    (see :func:`.interact_html.export_interact_bls_html`)."""
    if html is None:
        _not_ported("interact_bls")
    from .interact_html import export_interact_bls_html
    return export_interact_bls_html(
        lc, html, minimum_period=minimum_period,
        maximum_period=maximum_period,
        resolution=max(int(resolution), 20000))


def show_interact_widget(tpf, aperture_mask="default", exported_filename=None,
                         transform_func=None, ylim_func=None, html=None,
                         **kwargs):
    """The pixel selector (reference ``interact.py:999-1318``): with
    ``html="path.html"``, a standalone page (see
    :func:`.interact_html.export_interact_html`)."""
    if html is None:
        _not_ported("TargetPixelFile.interact")
    from .interact_html import export_interact_html
    return export_interact_html(tpf, html, aperture_mask=aperture_mask)


def show_skyview_widget(tpf, *args, **kwargs):
    """The sky view (reference ``interact.py:1319``): with
    ``html="path.html"`` and an offline ``catalog`` (dict/rows with
    ra/dec and optional mag/id/pmra/pmdec, or a CSV/JSON path), a
    standalone page (see :func:`.interact_html.export_interact_sky_html`).
    The live Gaia query needs the network, which the port does not use."""
    if kwargs.get("html") is None:
        _not_ported("TargetPixelFile.interact_sky")
    from .interact_html import export_interact_sky_html
    return export_interact_sky_html(
        tpf, kwargs.pop("html"),
        catalog=kwargs.pop("catalog", None),
        magnitude_limit=kwargs.pop("magnitude_limit", 18.0),
        aperture_mask=kwargs.pop("aperture_mask", "empty"),
        catalog_epoch=kwargs.pop("catalog_epoch", 2016.0))


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
