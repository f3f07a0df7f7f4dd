"""Fixed-shape stacks of light curves as torch tensors.

Counterpart of ``lightkurve_tpu/batch.py`` (``LightCurveStack``).  A stack
holds ``time``, ``flux``, ``flux_err`` (B, N) and a boolean ``mask`` (True
for valid samples) on one device.  Padded samples carry ``mask=False``
and weight zero in every kernel; padded times continue the median cadence
so kernels never see non-finite or non-monotonic times.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .config import numpy_dtype, resolve_device, resolve_dtype
from .io.pipeline import assemble_host_stack
from .ops.masked import masked_median

__all__ = ["LightCurveStack"]


@dataclass
class LightCurveStack:
    """A fixed-shape stack of light curves: time/flux/flux_err (B, N) and
    mask, tensors on one device."""

    time: torch.Tensor
    flux: torch.Tensor
    flux_err: torch.Tensor
    mask: torch.Tensor
    meta: list = field(default_factory=list)
    time_format: str = "jd"

    @classmethod
    def from_numpy(cls, time, flux, flux_err, mask, device=None, dtype=None,
                   meta=None):
        """Build a stack from host arrays (B, N) on ``device`` (default
        the card; ``"cpu"`` for the plain versions) in ``dtype`` (default
        :data:`config.default_dtype`)."""
        dtype = resolve_dtype(dtype)
        device = resolve_device(device)

        def put(a, dt):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                   device=device)

        return cls(time=put(time, dtype), flux=put(flux, dtype),
                   flux_err=put(flux_err, dtype), mask=put(mask, torch.bool),
                   meta=list(meta or []))

    @classmethod
    def from_files(cls, paths, time_column="TIME",
                   flux_column="PDCSAP_FLUX",
                   flux_err_column="PDCSAP_FLUX_ERR", dtype=None,
                   device=None, nthreads=None):
        """Bulk-load mission FITS files into a stack with the native
        multithreaded column reader.  Columns are padded and repaired by
        :func:`~lightkurve_tpu_torch.io.pipeline.assemble_host_stack`, the
        streaming loader's rule (times stay increasing across gaps)."""
        from .io import native
        device = resolve_device(device)
        t, _ = native.read_batch(paths, time_column, nthreads=nthreads)
        f, _ = native.read_batch(paths, flux_column, stride=t.shape[1],
                                 nthreads=nthreads)
        fe, nrows = native.read_batch(paths, flux_err_column,
                                      stride=t.shape[1], nthreads=nthreads)
        cols = assemble_host_stack(t, f, None if np.any(nrows < 0) else fe,
                                   dtype=numpy_dtype(resolve_dtype(dtype)))
        return cls.from_numpy(*cols, device=device, dtype=dtype,
                              meta=[{"FILENAME": p} for p in paths])

    @property
    def shape(self):
        return tuple(self.time.shape)

    @property
    def device(self):
        return self.flux.device

    def __len__(self):
        return self.shape[0]

    def _replace(self, **kw):
        d = dict(time=self.time, flux=self.flux, flux_err=self.flux_err,
                 mask=self.mask, meta=self.meta,
                 time_format=self.time_format)
        d.update(kw)
        return LightCurveStack(**d)

    def normalize(self):
        """Divide each curve by its median over valid samples."""
        med = masked_median(self.flux, self.mask)[:, None]
        return self._replace(flux=self.flux / med,
                             flux_err=self.flux_err / torch.abs(med))

    def flatten(self, window_length=101, polyorder=2, break_tolerance=5,
                niters=3, sigma=3, return_trend=False):
        """Divide each curve by its Savitzky-Golay trend
        (:func:`~lightkurve_tpu_torch.ops.detrend.flatten_batch`; the
        reference's ``LightCurve.flatten`` over the whole stack).  The
        mask is kept; ``flux_err`` is divided by the trend too, so a
        search of the result takes the per-cadence weighted regime.
        ``break_tolerance=None`` disables gap splitting.  With
        ``return_trend`` also returns a stack whose flux is the trend."""
        from .ops.detrend import flatten_batch
        from .ops.savgol import savgol_design_matrix
        H = savgol_design_matrix(window_length,
                                 min(polyorder, window_length - 1))
        bt = np.nan if break_tolerance is None else float(break_tolerance)
        trend, _ = flatten_batch(self.time, self.flux, self.mask, H, bt,
                                 float(sigma), niters=int(niters))
        flat = self._replace(flux=self.flux / trend,
                             flux_err=self.flux_err / trend)
        if return_trend:
            return flat, self._replace(flux=trend)
        return flat

    def remove_outliers(self, sigma=5.0, **kwargs):
        """Mask (not delete) outliers of each curve
        (:func:`~lightkurve_tpu_torch.ops.stats.sigma_clip_mask`; keyword
        arguments go to it)."""
        from .ops.stats import sigma_clip_mask
        out = sigma_clip_mask(self.flux, mask=self.mask, sigma=sigma,
                              **kwargs)
        return self._replace(mask=self.mask & ~out)

    def estimate_cdpp_batch(self, transit_duration=13, savgol_window=101,
                            savgol_polyorder=2, sigma=5.0):
        """Each curve's Savitzky-Golay CDPP in ppm, as the reference's
        ``LightCurve.estimate_cdpp``: flatten, sigma-clip, the standard
        deviation of the running mean over ``transit_duration`` cadences
        (windows wholly of valid samples).  Returns a (B,) host array."""
        from .ops.masked import masked_std
        from .ops.stats import running_mean, sigma_clip_mask
        flat = self.flatten(window_length=savgol_window,
                            polyorder=savgol_polyorder)
        m = flat.mask & ~sigma_clip_mask(flat.flux, mask=flat.mask,
                                         sigma=sigma)
        med = masked_median(flat.flux, m)[:, None]
        norm = torch.where(m, (flat.flux / med - 1.0) * 1e6, 0.0)
        rm = running_mean(norm, transit_duration)
        full = running_mean(m.to(norm.dtype), transit_duration) > 0.999
        return masked_std(rm, full).cpu().numpy()

    def _grid_groups(self, shared=None):
        """Group rows by identical time grids.  Returns (gid, t_host):
        ``gid`` maps row → group index, groups numbered in the sorted order
        of their time rows (``np.unique``); ``t_host`` is None when all
        rows share one grid (checked on the device, no (B, N) host copy).
        Pass ``shared`` when the all-equal check has been made already."""
        if shared is None:
            shared = bool(torch.all(self.time == self.time[0:1]))
        if shared:
            return np.zeros(len(self), dtype=int), None
        t_host = self.time.cpu().numpy()
        _, gid = np.unique(t_host, axis=0, return_inverse=True)
        return np.asarray(gid).ravel(), t_host

    def bls_search(self, periods, durations, oversample=10,
                   objective="likelihood", shared_time=None, method="fast"):
        """Batched BLS over the stack; returns a dict of (B, P) tensors on
        the stack's device.

        When every curve shares one time grid (auto-detected, or forced
        with ``shared_time=True``) the search runs through the shared-grid
        kernels (:func:`~lightkurve_tpu_torch.ops.bls.bls_power_shared_batch`).
        A stack of a few distinct grids (one per sector or quarter) is
        grouped by grid, one shared-grid search per group.  An explicit
        ``shared_time=False``, a stack whose every row has its own grid, or
        ``method="exact"`` takes the per-curve exact search
        (:func:`~lightkurve_tpu_torch.ops.bls.bls_power`).
        """
        from .ops.bls import bls_power, bls_power_shared_batch
        if method not in ("fast", "exact"):
            raise ValueError(f"method must be 'fast' or 'exact' "
                             f"(got {method!r})")
        dtype = self.flux.dtype
        np_dtype = numpy_dtype(dtype)
        # grid values in the data dtype, as the reference casts them
        periods = np.asarray(periods.cpu() if isinstance(
            periods, torch.Tensor) else periods, np.float64).astype(np_dtype)
        durations = np.asarray(durations.cpu() if isinstance(
            durations, torch.Tensor) else durations,
            np.float64).astype(np_dtype)
        dy = torch.where(self.mask, self.flux_err,
                         torch.tensor(torch.inf, dtype=dtype,
                                      device=self.device))
        auto = shared_time is None
        if auto and method == "fast":
            shared_time = bool(torch.all(self.time == self.time[0:1]))
        if shared_time and method == "fast":
            return bls_power_shared_batch(
                self.time[0], self.flux, dy, periods, durations,
                oversample=oversample, objective=objective)
        if method == "fast" and auto:
            # mixed time grids: a shared-grid search per group of rows
            gid, _ = self._grid_groups(shared=False)
            if gid.max() + 1 < len(self):          # fewer grids than rows
                out = None
                for g in range(int(gid.max()) + 1):
                    rows = torch.as_tensor(np.nonzero(gid == g)[0],
                                           device=self.device)
                    sub = bls_power_shared_batch(
                        self.time[rows[0]], self.flux[rows], dy[rows],
                        periods, durations, oversample=oversample,
                        objective=objective)
                    if out is None:
                        out = {k: torch.empty((len(self),) + v.shape[1:],
                                              dtype=v.dtype,
                                              device=self.device)
                               for k, v in sub.items()}
                    for k, v in sub.items():
                        out[k][rows] = v
                return out
        return bls_power(self.time, self.flux, dy, periods, durations,
                         oversample=oversample, objective=objective)
