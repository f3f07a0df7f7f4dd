"""Fixed-shape stacks of light curves and of pixel cubes as torch tensors.

Counterpart of ``lightkurve_tpu/batch.py`` (``LightCurveStack``,
``TPFStack``).  A light-curve stack holds ``time``, ``flux``, ``flux_err``
(B, N) and a boolean ``mask`` (True for valid samples) on one device.
Padded samples carry ``mask=False`` and weight zero in every kernel;
padded times continue the median cadence so kernels never see non-finite
or non-monotonic times.  A pixel stack holds B target pixel files' cubes
(B, T, H, W) and apertures (B, H, W); its aperture photometry and PLD
correction give light-curve stacks.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .config import numpy_dtype, resolve_device, resolve_dtype
from .io.pipeline import assemble_host_stack
from .ops.masked import masked_median

__all__ = ["LightCurveStack", "TPFStack"]


def _bitceil(n):
    return 1 << (int(n) - 1).bit_length()


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
    def from_collection(cls, lcs, length=None, dtype=None, pad_to_pow2=False,
                        device=None):
        """Pack a sequence of ``LightCurve`` (e.g. a
        ``LightCurveCollection``) into a stack on ``device`` (default the
        card; ``"cpu"`` for the plain versions) in ``dtype`` (default
        :data:`config.default_dtype`).  Each curve fills the front of its
        row; NaN fluxes and the padding are masked (flux 0, flux_err 1) and
        padded times continue the curve's median cadence.  Rows are as long
        as the longest curve, or ``length``; ``pad_to_pow2`` rounds that up
        to a power of two as ``lightkurve_tpu`` does by default (off here:
        a kernel would read the padding)."""
        n_max = max(len(lc) for lc in lcs)
        if length is None:
            length = _bitceil(n_max) if pad_to_pow2 else n_max
        B = len(lcs)
        t = np.zeros((B, length))
        f = np.zeros((B, length))
        fe = np.ones((B, length))
        m = np.zeros((B, length), dtype=bool)
        metas = []
        for i, lc in enumerate(lcs):
            n = len(lc)
            tv = lc.time.value.astype(np.float64)
            fv = lc.flux.value.astype(np.float64)
            fev = lc.flux_err.value.astype(np.float64)
            t[i, :n] = tv
            f[i, :n] = np.nan_to_num(fv)
            fe[i, :n] = np.where(np.isfinite(fev) & (fev > 0), fev, 1.0)
            m[i, :n] = np.isfinite(fv)
            # padded times continue the median cadence
            if n < length and n > 1:
                dt = np.median(np.diff(tv))
                t[i, n:] = tv[-1] + dt * np.arange(1, length - n + 1)
            metas.append(dict(lc.meta))
        stack = cls.from_numpy(t, f, fe, m, device=device, dtype=dtype,
                               meta=metas)
        stack.time_format = lcs[0].time.format if len(lcs) else "jd"
        return stack

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

    def __getitem__(self, i):
        """Member ``i`` back as a host ``LightCurve`` of its valid
        cadences."""
        from .lightcurve import LightCurve
        from .time import Time
        from .units import Quantity, dimensionless
        m = self.mask[i].cpu().numpy()
        return LightCurve(
            time=Time(self.time[i].cpu().numpy()[m], format=self.time_format),
            flux=Quantity(self.flux[i].cpu().numpy()[m], dimensionless),
            flux_err=Quantity(self.flux_err[i].cpu().numpy()[m],
                              dimensionless),
            meta=self.meta[i] if i < len(self.meta) else {})

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

    def to_periodogram(self, minimum_frequency=None, maximum_frequency=None,
                       oversample_factor=1.0, normalization="psd",
                       sharded=False, mesh=None):
        """Batched fast Lomb-Scargle
        (:func:`~lightkurve_tpu_torch.ops.lombscargle.lombscargle_fast`)
        over one frequency grid for the whole stack.

        The grid comes from the FIRST curve's time row: from
        ``minimum_frequency`` (default one step) to ``maximum_frequency``
        (default its Nyquist frequency, 0.5 / median cadence) in steps of
        1 / (baseline x ``oversample_factor``).  Masked cadences weigh
        nothing (``dy = inf``).  A stack of a few distinct time grids runs
        one batched call per grid on that same frequency grid.  ``psd``
        is rescaled to the reference's units, 2 / (valid cadences x
        ``oversample_factor`` x step).  ``sharded=True`` runs
        :func:`~lightkurve_tpu_torch.parallel.grid.sharded_lombscargle` over
        ``mesh`` (default every rank of the process group on the targets
        axis; single-grid stacks only).

        Returns (frequency, power): a float64 host array (Nf,) and a
        (B, Nf) tensor on the stack's device.
        """
        t0 = self.time[0].cpu().numpy().astype(np.float64)
        nyquist = 0.5 / np.median(np.diff(t0))
        fs = 1.0 / (t0[-1] - t0[0]) / oversample_factor
        f0 = fs if minimum_frequency is None else float(minimum_frequency)
        fmax = nyquist if maximum_frequency is None else \
            float(maximum_frequency)
        Nf = int((fmax - f0) / fs)
        # masked cadences get zero weight through dy = inf
        dy = torch.where(self.mask, self.flux_err,
                         torch.tensor(torch.inf, dtype=self.flux.dtype,
                                      device=self.device))
        if sharded:
            if not bool(torch.all(self.time == self.time[0:1])):
                raise ValueError(
                    "sharded=True requires all curves to share one time "
                    "grid; group mixed-grid stacks first (the default "
                    "unsharded path does this automatically)")
            from .parallel.grid import sharded_lombscargle
            power = sharded_lombscargle(t0, self.flux, dy, f0, fs, Nf,
                                        mesh=mesh,
                                        normalization=normalization)
        else:
            power = self._lombscargle_groups(t0, dy, f0, fs, Nf,
                                             normalization)
        freqs = f0 + fs * np.arange(Nf)
        if normalization == "psd":
            n = self.mask.sum(dim=1, keepdim=True).to(torch.float64)
            power = power * 2.0 / (n * oversample_factor * fs).to(
                power.dtype)
        return freqs, power

    def _lombscargle_groups(self, t0, dy, f0, fs, Nf, normalization):
        """The unsharded fast Lomb-Scargle of :meth:`to_periodogram`: one
        batched call, or one per time grid of a mixed-grid stack."""
        from .ops.lombscargle import lombscargle_fast
        gid, t_host = self._grid_groups()
        if gid.max() == 0:
            return lombscargle_fast(t0, self.flux, f0, fs, Nf, dy=dy,
                                    normalization=normalization)
        power = torch.empty((len(self), Nf), dtype=self.flux.dtype,
                            device=self.device)
        for g in range(int(gid.max()) + 1):
            rows = np.nonzero(gid == g)[0]
            idx = torch.as_tensor(rows, device=self.device)
            power[idx] = lombscargle_fast(
                t_host[rows[0]], self.flux[idx], f0, fs, Nf, dy=dy[idx],
                normalization=normalization)
        return power

    def bls_search(self, periods, durations, oversample=10,
                   objective="likelihood", sharded=False, mesh=None,
                   shared_time=None, method="fast"):
        """Batched BLS over the stack; returns a dict of (B, P) tensors on
        the stack's device.  ``sharded=True`` runs
        :func:`~lightkurve_tpu_torch.parallel.grid.sharded_bls` over
        ``mesh`` (targets x period grid; default every rank of the process
        group on the grid axis), with ``shared_time`` as given, or False
        for ``method="exact"``.

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
        if sharded:
            from .parallel.grid import sharded_bls
            # an explicit method="exact" takes the per-curve exact search
            return sharded_bls(self.time, self.flux, dy, periods, durations,
                               oversample=oversample, objective=objective,
                               mesh=mesh,
                               shared_time=(False if method == "exact"
                                            else shared_time))
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


@dataclass
class TPFStack:
    """A stack of target pixel files: ``flux`` and ``flux_err`` (B, T, H,
    W) with NaN for missing pixels, ``time`` (B, T) and the apertures
    (B, H, W) bool, tensors on one device."""

    flux: torch.Tensor
    flux_err: torch.Tensor
    time: torch.Tensor
    aperture: torch.Tensor
    meta: list = field(default_factory=list)
    time_format: str = "btjd"

    @classmethod
    def from_collection(cls, tpfs, aperture_mask="default", dtype=None,
                        device=None):
        """Pack target pixel files of one shape (e.g. a
        ``TargetPixelFileCollection``) into a stack on ``device`` (default
        the card; ``"cpu"`` for the plain torch functions) in ``dtype``
        (default :data:`config.default_dtype`), each with the aperture
        ``aperture_mask`` gives it (``TargetPixelFile``'s rules)."""
        dtype = resolve_dtype(dtype)
        device = resolve_device(device)
        shapes = {t.shape for t in tpfs}
        if len(shapes) != 1:
            raise ValueError("All TPFs in a stack must share one shape; "
                             f"got {shapes}")

        def put(arrays, dt):
            return torch.as_tensor(np.stack(arrays), dtype=dt, device=device)

        return cls(flux=put([t.flux.value for t in tpfs], dtype),
                   flux_err=put([t.flux_err.value for t in tpfs], dtype),
                   time=put([t.time.value for t in tpfs], dtype),
                   aperture=put([t._parse_aperture_mask(aperture_mask)
                                 for t in tpfs], torch.bool),
                   meta=[dict(t.meta) for t in tpfs],
                   time_format=tpfs[0]._time_format)

    def __len__(self):
        return self.flux.shape[0]

    def _photometry(self, flux, flux_err, aperture):
        from .ops.photometry import aperture_photometry_cube
        f, fe = aperture_photometry_cube(flux, flux_err, aperture)
        mask = torch.isfinite(f)
        return (torch.nan_to_num(f),
                torch.where(torch.isfinite(fe), fe, 1.0), mask)

    def extract_aperture_photometry(self):
        """Summed aperture photometry of every target
        (:func:`~lightkurve_tpu_torch.ops.photometry.aperture_photometry_cube`)
        as a :class:`LightCurveStack`: cadences without a finite flux are
        masked (flux 0), errors without a finite value are 1."""
        f, fe, mask = self._photometry(self.flux, self.flux_err,
                                       self.aperture)
        return LightCurveStack(time=self.time, flux=f, flux_err=fe,
                               mask=mask, meta=self.meta,
                               time_format=self.time_format)

    def pld_correct(self, pld_order=1, n_pca_terms=3, sigma=5.0, niters=5):
        """Pixel-level decorrelation of every target → corrected
        :class:`LightCurveStack`, the batched form of ``PLDCorrector``
        (``lightkurve_tpu``'s ``TPFStack.pld_correct``).

        Per target: the aperture's pixels divided by their sum each
        cadence, centred, reduced by randomized PCA to ``n_pca_terms``
        components (one test matrix for all, as the reference's vmapped
        call), a constant column appended, and the clipped ridge fit
        (:func:`~lightkurve_tpu_torch.ops.solve.iterative_clipped_regression`,
        ``niters`` fixed iterations, in float64 whatever the data dtype:
        ROADMAP C4); the model less its median (numpy's, over every
        cadence) is subtracted from the aperture flux.
        ``pld_order >= 2`` adds the PCA of the products of the order-1
        components, as the reference's batched approximation does.  All
        targets go as one batch of (B, T, k) tensors."""
        from .ops.solve import iterative_clipped_regression, randomized_pca
        cube, aperture = self.flux, self.aperture
        y, fe, mask = self._photometry(cube, self.flux_err, aperture)
        B, T = y.shape
        dtype, device = y.dtype, y.device
        # NaN pixels must not reach the regressors: zero them, as the
        # photometry does
        pix = (torch.where(torch.isfinite(cube), cube, 0.0)
               * aperture[:, None, :, :]).reshape(B, T, -1)
        pixn = pix / torch.clamp(pix.sum(2, keepdim=True), min=1e-30)
        del pix
        # centred before the SVD (fbpca's raw=False): the normalised pixels
        # sum to 1, so uncentred components would be collinear with the
        # constant column
        U = randomized_pca(pixn - pixn.mean(1, keepdim=True),
                           n_pca_terms)[0][..., :n_pca_terms]
        del pixn
        cols = [U]
        if pld_order >= 2:
            prods = (U[..., :, None] * U[..., None, :]).reshape(B, T, -1)
            U2 = randomized_pca(prods - prods.mean(1, keepdim=True),
                                n_pca_terms)[0]
            cols.append(U2[..., :n_pca_terms])
        cols.append(torch.ones((B, T, 1), dtype=dtype, device=device))
        # the fit in float64 whatever the data dtype (ROADMAP C4)
        X = torch.cat(cols, -1).double()
        k = X.shape[-1]
        w, _, _ = iterative_clipped_regression(
            X, y.double(), fe.double(), mask,
            torch.zeros(k, dtype=torch.float64, device=device),
            torch.full((k,), torch.inf, dtype=torch.float64, device=device),
            sigma=sigma, niters=niters)
        model = (X @ w[..., None])[..., 0]
        model = model - masked_median(model, torch.ones_like(mask))[:, None]
        return LightCurveStack(time=self.time,
                               flux=(y.double() - model).to(dtype),
                               flux_err=fe, mask=mask, meta=self.meta,
                               time_format=self.time_format)
