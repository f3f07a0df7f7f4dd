"""Pixel-cube photometry: masked reductions over (time, row, column).

Counterpart of ``lightkurve_tpu/ops/photometry.py``: aperture photometry,
moment centroids and the background estimate of the reference's target
pixel files, over cubes ``(..., t, h, w)``, so a stack of targets is one
batched reduction.  NaN marks a missing pixel.
"""
from __future__ import annotations

import torch

from .masked import masked_mean, masked_median

__all__ = ["aperture_photometry_cube", "centroid_moments_cube",
           "background_estimate_cube"]


def aperture_photometry_cube(flux, flux_err, aperture, flux_method="sum"):
    """Aperture photometry over a pixel cube.

    flux, flux_err : (..., t, h, w); aperture : (..., h, w) bool, the
    pixels taken; flux_method : ``"sum"``, ``"median"`` or ``"mean"``.
    Returns the flux and its error, (..., t): errors add in quadrature for
    ``"sum"`` (the median or mean of the squares otherwise).  A cadence
    with no finite pixel in the aperture, or whose whole image is zero,
    has NaN flux; one with no finite error in the aperture, NaN error."""
    if flux_method not in ("sum", "median", "mean"):
        raise ValueError("`flux_method` must be 'sum', 'median', or 'mean'.")
    tshape = flux.shape[:-2] + (-1,)
    f = flux.reshape(tshape)
    fe = flux_err.reshape(tshape)
    sel = aperture.reshape(aperture.shape[:-2] + (1, -1))
    finite_f = sel & torch.isfinite(f)
    finite_e = sel & torch.isfinite(fe)
    if flux_method == "sum":
        out_f = torch.where(finite_f, f, 0.0).sum(-1)
        out_e = torch.sqrt(torch.where(finite_e, fe * fe, 0.0).sum(-1))
    else:
        reduce = masked_median if flux_method == "median" else masked_mean
        out_f = reduce(f, finite_f)
        out_e = torch.sqrt(reduce(fe * fe, finite_e))
    all_zero = torch.all(f == 0.0, dim=-1)
    out_f = torch.where(~finite_f.any(-1) | all_zero, torch.nan, out_f)
    out_e = torch.where(~finite_e.any(-1), torch.nan, out_e)
    return out_f, out_e


def centroid_moments_cube(flux, aperture, column=0, row=0):
    """Flux-weighted centre of each cadence's aperture (the reference's
    moments), in absolute pixel coordinates: ``flux`` (..., t, h, w),
    ``aperture`` (..., h, w) bool.  Returns (column, row), each (..., t).
    As the reference's ``nansum(xx * mask * flux)``, a NaN pixel outside
    the aperture adds nothing."""
    h, w = flux.shape[-2:]
    dtype, device = flux.dtype, flux.device
    yy = torch.arange(h, dtype=dtype, device=device)[:, None] + row
    xx = torch.arange(w, dtype=dtype, device=device)[None, :] + column
    inside = aperture[..., None, :, :]
    ap = inside.to(dtype)
    fin = torch.isfinite(flux)
    total = torch.where(inside & fin, flux, 0.0).sum((-2, -1))
    col = torch.where(fin, xx * ap * flux, 0.0).sum((-2, -1)) / total
    row_c = torch.where(fin, yy * ap * flux, 0.0).sum((-2, -1)) / total
    return col, row_c


def background_estimate_cube(flux, background_mask):
    """Each cadence's median over the finite pixels of
    ``background_mask``: ``flux`` (..., t, h, w), ``background_mask``
    (..., h, w) or (..., t, h, w) bool.  Returns (..., t)."""
    tshape = flux.shape[:-2] + (-1,)
    f = flux.reshape(tshape)
    if background_mask.dim() == flux.dim() - 1:
        sel = background_mask.reshape(background_mask.shape[:-2] + (1, -1))
    else:
        sel = background_mask.reshape(tshape)
    return masked_median(f, sel & torch.isfinite(f))
