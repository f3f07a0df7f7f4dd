"""Pixel Response Function models.

Counterpart of ``lightkurve_tpu/prf/prfmodel.py`` (the reference's
``prf/prfmodel.py``): a PRF is a supersampled image, evaluated on the
detector grid by bilinear interpolation (four gathers per pixel) after the
focus transform (rotation and scales about the centre).  The image goes to
a device once per (model, device, dtype).  :meth:`_InterpolatedPRF.evaluate`
broadcasts over leading batch axes of its parameters, so a scene model
evaluates every cadence in one call, and :meth:`_InterpolatedPRF._evaluate`
gives the six partial images in closed form beside the image, for the
Levenberg-Marquardt fits of :mod:`.tpfmodel`.

``KeplerPRF`` reads the per-channel calibration files (Bryson 2010) from a
local directory only; ``SimpleKeplerPRF`` and ``GaussianPRF`` are analytic.
``plot`` draws the model's image with matplotlib, imported inside the
call, after one explicit copy of the image to the host.
"""
from __future__ import annotations

import glob
import logging
import os

import numpy as np
import torch

from .. import config
from ..utils import LightkurveError

log = logging.getLogger(__name__)

__all__ = ["KeplerPRF", "SimpleKeplerPRF", "GaussianPRF"]


def _placement(*values):
    """The device and dtype of a call: those of its first floating tensor
    argument, else :func:`config.resolve_device` and
    :data:`config.default_dtype`."""
    for v in values:
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            return v.device, v.dtype
    return config.resolve_device(None), config.default_dtype


def _edge_share(w):
    """The derivative of ``clip(w, 0, 1)`` inside the support: 1, and 0.5
    where ``w`` sits on 0 or 1 (the reference differentiates ``jnp.clip``
    as ``minimum(maximum(w, 0), 1)``, whose ties split the derivative)."""
    return torch.where((w == 0) | (w == 1), 0.5, 1.0).to(w.dtype)


class _InterpolatedPRF:
    """Shared machinery: a supersampled PRF image and its evaluation."""

    # subclasses set: supersampled_prf (Sy, Sx), oversample,
    # col_coord/row_coord, shape, column, row

    def _device_image(self, device, dtype):
        """The supersampled image and the pixel-centre coordinates as
        tensors on ``device`` in ``dtype``, made once per pair."""
        cache = self.__dict__.setdefault("_on_device", {})
        key = (torch.device(device), dtype)
        if key not in cache:
            cache[key] = tuple(
                torch.as_tensor(np.asarray(a, dtype=float), device=device)
                .to(dtype) for a in (self.supersampled_prf, self.col_coord,
                                     self.row_coord))
        return cache[key]

    def _evaluate(self, center_col, center_row, flux=1.0, scale_col=1.0,
                  scale_row=1.0, rotation_angle=0.0, jac=False,
                  separable=None):
        """The PRF image (..., H, W) for parameters of batch shape (...),
        and with ``jac`` its six derivatives (each (..., H, W)) with respect
        to (center_col, center_row, flux, scale_col, scale_row,
        rotation_angle): the interpolant's slopes in closed form, 0 outside
        the supersampled support, as the reference's ``jax.jacfwd`` gives
        them.  Off the supersampled grid's nodes both of the reference's
        forms give the bilinear slope; on a node (an integer supersampled
        coordinate, where a star sits on a pixel centre) the gather form
        gives half the slope of the cell above the node (``jnp.clip``'s
        tie), and the separable form, which the reference takes when the
        rotation is the plain number 0 (``separable=None`` decides so),
        what its hat functions' derivatives sum to there."""
        if separable is None:
            separable = isinstance(rotation_angle, (int, float, np.integer,
                                                    np.floating)) \
                and float(rotation_angle) == 0.0
        device, dtype = _placement(center_col, center_row, flux, scale_col,
                                   scale_row, rotation_angle)
        prf, cc, rc = self._device_image(device, dtype)
        p = [torch.as_tensor(x, device=device, dtype=dtype)
             for x in (center_col, center_row, flux, scale_col, scale_row,
                       rotation_angle)]
        p = [x[..., None, None] for x in torch.broadcast_tensors(*p)]
        center_col, center_row, flux, scale_col, scale_row, angle = p
        sy, sx = prf.shape
        os_ = self.oversample
        dcol = cc - center_col                               # (..., 1, W)
        drow = rc[:, None] - center_row                      # (..., H, 1)
        cosa, sina = torch.cos(angle), torch.sin(angle)
        rot_row = drow * cosa - dcol * sina
        rot_col = drow * sina + dcol * cosa
        fy = rot_row * scale_row * os_ + (sy - 1) / 2.0
        fx = rot_col * scale_col * os_ + (sx - 1) / 2.0
        x0 = torch.clamp(torch.floor(fx), 0, sx - 2)
        y0 = torch.clamp(torch.floor(fy), 0, sy - 2)
        wx = torch.clamp(fx - x0, 0.0, 1.0)
        wy = torch.clamp(fy - y0, 0.0, 1.0)
        inside = (fx >= 0) & (fx <= sx - 1) & (fy >= 0) & (fy <= sy - 1)
        flat = prf.reshape(-1)
        i00 = (y0 * sx + x0).long()
        v00, v01 = flat[i00], flat[i00 + 1]
        v10, v11 = flat[i00 + sx], flat[i00 + sx + 1]
        val = (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx
               + v10 * wy * (1 - wx) + v11 * wy * wx)
        val = torch.where(inside, val, 0.0)
        img = flux * val
        if not jac:
            return img
        # slopes of the interpolant along the supersampled axes
        sx_ = (1 - wy) * (v01 - v00) + wy * (v11 - v10)
        sy_ = (1 - wx) * (v10 - v00) + wx * (v11 - v01)
        if separable:
            # on a node n the hat functions' derivatives (jnp.abs' is +1
            # at 0, maximum's ties split) give P[n+1]/2 - P[n] - P[n-1]/2,
            # P beyond the image 0
            def before(i, step, ok):
                return torch.where(ok, flat[torch.where(ok, i - step, i)],
                                   0.0)

            def node(top, up, here, down):
                return (0.5 * torch.where(top, 0.0, up)
                        - torch.where(top, up, here)
                        - 0.5 * torch.where(top, here, down))
            vm0, vm1 = before(i00, 1, x0 > 0), before(i00 + sx, 1, x0 > 0)
            v0m, v1m = before(i00, sx, y0 > 0), before(i00 + 1, sx, y0 > 0)
            top_x, top_y = wx == 1, wy == 1
            cx = ((1 - wy) * node(top_x, v01, v00, vm0)
                  + wy * node(top_x, v11, v10, vm1))
            cy = ((1 - wx) * node(top_y, v10, v00, v0m)
                  + wx * node(top_y, v11, v01, v1m))
            sx_ = torch.where((wx == 0) | top_x, cx, sx_)
            sy_ = torch.where((wy == 0) | top_y, cy, sy_)
        else:
            sx_ = sx_ * _edge_share(wx)
            sy_ = sy_ * _edge_share(wy)
        gx = torch.where(inside, sx_, 0.0) * (os_ * flux)
        gy = torch.where(inside, sy_, 0.0) * (os_ * flux)
        gxs, gys = gx * scale_col, gy * scale_row
        return img, (gys * sina - gxs * cosa,                # center_col
                     -(gys * cosa + gxs * sina),             # center_row
                     val,                                    # flux
                     gx * rot_col,                           # scale_col
                     gy * rot_row,                           # scale_row
                     gxs * rot_row - gys * rot_col)          # rotation

    def evaluate(self, center_col, center_row, flux=1.0, scale_col=1.0,
                 scale_row=1.0, rotation_angle=0.0):
        """PRF image on the detector grid (reference ``:80-124``), a tensor
        (..., H, W) over the parameters' batch shape, on their device (the
        configured device for plain numbers)."""
        return self._evaluate(center_col, center_row, flux, scale_col,
                              scale_row, rotation_angle)

    __call__ = evaluate

    def gradient(self, center_col, center_row, flux=1.0, scale_col=1.0,
                 scale_row=1.0, rotation_angle=0.0):
        """The six partial images with respect to (center_col, center_row,
        flux, scale_col, scale_row, rotation_angle) as host arrays, the
        values of the reference's ``jax.jacfwd`` (which differentiates
        the gather form, every parameter traced)."""
        _, jac = self._evaluate(center_col, center_row, flux, scale_col,
                                scale_row, rotation_angle, jac=True,
                                separable=False)
        return [d.cpu().numpy() for d in jac]

    def plot(self, ax=None, **kwargs):
        """The PRF centred on the grid (reference ``prfmodel.py:215-240``)."""
        import matplotlib.pyplot as plt
        from ..utils import _strip_quantity
        if ax is None:
            _, ax = plt.subplots()
        img = _strip_quantity(self.evaluate(
            self.column + self.shape[1] / 2,
            self.row + self.shape[0] / 2))
        im = ax.imshow(img, origin="lower", **kwargs)
        plt.colorbar(im, ax=ax)
        return ax


class GaussianPRF(_InterpolatedPRF):
    """Analytic circular-Gaussian PRF (calibration-free)."""

    def __init__(self, shape, column=0, row=0, sigma=1.0, oversample=9,
                 radius=6):
        self.shape = tuple(shape)
        self.column = column
        self.row = row
        self.sigma = float(sigma)
        self.oversample = oversample
        n = 2 * radius * oversample + 1
        ax = (np.arange(n) - (n - 1) / 2) / oversample
        xx, yy = np.meshgrid(ax, ax)
        img = np.exp(-(xx ** 2 + yy ** 2) / (2 * sigma ** 2))
        # a per-detector-pixel flux density: the sampled PRF sums to ~1
        self.supersampled_prf = img / img.sum() * oversample ** 2
        self.col_coord = column + np.arange(0.5, shape[1] + 0.5)
        self.row_coord = row + np.arange(0.5, shape[0] + 0.5)


class SimpleKeplerPRF(GaussianPRF):
    """Idealized Kepler PRF: a Gaussian of the mission's typical ~1.5-px
    FWHM (the role of the reference's ``prfmodel.py:309-370``)."""

    def __init__(self, channel=1, shape=(11, 11), column=0, row=0):
        self.channel = channel
        super().__init__(shape=shape, column=column, row=row,
                         sigma=1.5 / 2.3548)


class KeplerPRF(_InterpolatedPRF):
    """Kepler PRF from the per-channel calibration files (Bryson 2010).

    Parameters
    ----------
    channel, shape, column, row : as in the reference
        (``prfmodel.py:17-78``).
    prf_dir : str
        Directory holding ``kplr*_prf.fits`` calibration files; nothing is
        downloaded.
    """

    def __init__(self, channel, shape, column, row, prf_dir=None):
        self.channel = channel
        self.shape = tuple(shape)
        self.column = column
        self.row = row
        self.oversample = 50  # Kepler PRF files are 50x supersampled
        self.col_coord = column + np.arange(0.5, shape[1] + 0.5)
        self.row_coord = row + np.arange(0.5, shape[0] + 0.5)
        self.supersampled_prf = self._load_calibration(prf_dir)

    def _load_calibration(self, prf_dir):
        """The five calibration images (four corners and the centre)
        weighted by inverse distance from the cutout's centre, as the
        reference interpolates them by detector position
        (``prfmodel.py:230-280``)."""
        from ..io.fits import open_fits
        from ..utils import channel_to_module_output
        if prf_dir is None:
            raise LightkurveError(
                "KeplerPRF requires the per-channel calibration FITS files, "
                "which are downloaded from MAST in the reference "
                "(prfmodel.py:215-292). Network is unavailable here; pass "
                "`prf_dir` pointing at local kplr*_prf.fits files, or use "
                "SimpleKeplerPRF / GaussianPRF.")
        module, output = channel_to_module_output(self.channel)
        pattern = os.path.join(prf_dir, f"kplr{module:02}.{output}*_prf.fits")
        hits = sorted(glob.glob(pattern))
        if not hits:
            raise LightkurveError(f"No PRF calibration file matching "
                                  f"{pattern}")
        hdul = open_fits(hits[0])
        prfs = []
        weights = []
        ref_col = self.column + 0.5 * self.shape[1]
        ref_row = self.row + 0.5 * self.shape[0]
        for hdu in hdul[1:]:
            if hdu.data is None or np.ndim(hdu.data) != 2:
                continue
            crval1 = hdu.header.get("CRVAL1P", 0)
            crval2 = hdu.header.get("CRVAL2P", 0)
            prfs.append(np.asarray(hdu.data, dtype=float))
            d = np.hypot(ref_col - crval1, ref_row - crval2)
            weights.append(1.0 / (d + 1e-6))
        if not prfs:
            raise LightkurveError("Calibration file contains no PRF images")
        weights = np.asarray(weights)
        weights /= weights.sum()
        out = np.zeros_like(prfs[0])
        for w, p in zip(weights, prfs):
            out += w * p
        return out
