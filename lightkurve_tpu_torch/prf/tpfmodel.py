"""Scene models and PRF photometry.

Counterpart of ``lightkurve_tpu/prf/tpfmodel.py`` (the reference's
``prf/tpfmodel.py``): the scene (Σ stars × PRF + background) is a torch
function of a batch of free-parameter vectors, and
:meth:`PRFPhotometry.run` fits every cadence at once with a batched,
fixed-iteration Levenberg-Marquardt loop on the device.  The Jacobian is
the scene's in closed form (:meth:`.prfmodel._InterpolatedPRF._evaluate`),
the priors' gradient and Hessian are closed forms too (each prior acts on
one parameter), and each step is one batched Cholesky solve
(:func:`..ops.solve.chol_solve_small`).  The loop runs in float64 whatever
the cube's dtype (ROADMAP C4): the bilinear PRF has kinks at its
supersampled nodes, where the reference's derivative is not the slope,
and float32 positions (6e-5 px apart near column 1000) land on a node
and bounce off it, moving a cadence's flux by up to 5% against float64.

Priors follow the reference's vocabulary and calling convention
(``tpfmodel.py:75-244``): callable, returning a negative log-probability
penalty that is 0 at a Gaussian prior's mean; results come back in the
reference's containers, whose ``to_array``/``from_array`` use its
free-parameter order: [col, row, flux] per star, then background, focus,
motion.  The plots (``TPFModel.plot``, ``plot_diagnostics``,
``PRFPhotometry.plot_results``) draw with matplotlib, imported inside the
call, from host copies of the images and fits.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .. import config
from ..lightcurve import LightCurve
from ..units import Quantity, electron_per_second
from ..utils import _strip_quantity

log = logging.getLogger(__name__)

__all__ = ["UniformPrior", "GaussianPrior", "FixedValuePrior", "StarPrior",
           "BackgroundPrior", "FocusPrior", "MotionPrior",
           "StarParameters", "BackgroundParameters", "FocusParameters",
           "MotionParameters", "TPFModelParameters", "TPFModel",
           "PRFPhotometry"]

#: the strength of :class:`UniformPrior`'s quadratic walls
UNIFORM_WALL = 1e6
#: the strength of :class:`FixedValuePrior`'s pinning quadratic
FIXED_PIN = 1e12


def _tensor(x):
    """``x`` as a tensor (plain numbers in float64)."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        x, dtype=torch.float64)


def _tie_share(a, b):
    """The derivative of ``maximum(a, b)`` with respect to ``a``, as
    ``jax.grad`` gives it: 1 where ``a > b``, 0.5 on a tie, else 0."""
    return torch.where(a > b, 1.0, torch.where(a == b, 0.5, 0.0)).to(a.dtype)


# ---------------------------------------------------------------------------
# Priors (reference tpfmodel.py:75-244)
# ---------------------------------------------------------------------------
@dataclass
class UniformPrior:
    lb: float
    ub: float

    @property
    def mean(self):
        return 0.5 * (self.lb + self.ub)

    def penalty(self, x):
        # smooth barrier: a steep quadratic outside the box (the
        # reference's hard -inf logpdf would leave LM steps undefined)
        x = _tensor(x)
        below = torch.clamp(self.lb - x, min=0.0)
        above = torch.clamp(x - self.ub, min=0.0)
        return UNIFORM_WALL * (below ** 2 + above ** 2)

    def derivatives(self, x):
        """The penalty's first and second derivative at ``x``; on a wall
        (``x == lb`` or ``x == ub``) the second is half its outside value,
        as ``jax.hessian`` of ``maximum`` gives it."""
        sb = _tie_share(self.lb - x, torch.zeros_like(x))
        sa = _tie_share(x - self.ub, torch.zeros_like(x))
        below = torch.clamp(self.lb - x, min=0.0)
        above = torch.clamp(x - self.ub, min=0.0)
        grad = UNIFORM_WALL * (2 * above * sa - 2 * below * sb)
        return grad, 2 * UNIFORM_WALL * (sb * sb + sa * sa)

    evaluate = penalty
    __call__ = penalty


@dataclass
class GaussianPrior:
    mean: float
    var: float

    def penalty(self, x):
        return (x - self.mean) ** 2 / (2 * self.var)

    def derivatives(self, x):
        return (x - self.mean) / self.var, torch.full_like(x, 1 / self.var)

    evaluate = penalty
    __call__ = penalty


@dataclass
class FixedValuePrior:
    value: float

    @property
    def mean(self):
        return self.value

    def evaluate(self, x):
        """0 at the fixed value, +inf elsewhere (reference ``:113-121``,
        the user-facing prior probability)."""
        x = _tensor(x)
        return torch.where(x == self.value, 0.0, torch.inf).to(x.dtype)

    def penalty(self, x):
        """Optimization-time surrogate: a very steep quadratic that pins
        the parameter at ``value`` (the ±inf form of ``evaluate`` has no
        gradient to pin with)."""
        return FIXED_PIN * (x - self.value) ** 2

    def derivatives(self, x):
        return 2 * FIXED_PIN * (x - self.value), torch.full_like(
            x, 2 * FIXED_PIN)

    __call__ = evaluate


def _parse_prior(prior):
    """Scalars become FixedValuePrior (reference ``PriorContainer``)."""
    if isinstance(prior, (int, float, np.integer, np.floating)):
        return FixedValuePrior(float(prior))
    return prior


class _PriorContainer:
    def __call__(self, *params):
        return self.evaluate(*params)


@dataclass
class StarPrior(_PriorContainer):
    """Priors on one star's (col, row, flux) (reference ``:136-165``)."""
    col: object
    row: object
    flux: object = field(default_factory=lambda: UniformPrior(0.0, 1e10))
    targetid: Optional[str] = None

    def __post_init__(self):
        self.col = _parse_prior(self.col)
        self.row = _parse_prior(self.row)
        self.flux = _parse_prior(self.flux)

    def evaluate(self, col, row, flux):
        return (self.col.evaluate(col) + self.row.evaluate(row)
                + self.flux.evaluate(flux))


@dataclass
class BackgroundPrior(_PriorContainer):
    """Prior on the per-pixel background flux (reference ``:167-185``)."""
    flux: object = field(default_factory=lambda: FixedValuePrior(0.0))

    def __post_init__(self):
        self.flux = _parse_prior(self.flux)

    def evaluate(self, flux):
        return self.flux.evaluate(flux)


@dataclass
class FocusPrior(_PriorContainer):
    """Priors on the focus parameters (reference ``:187-222``)."""
    scale_col: object = field(default_factory=lambda: GaussianPrior(1, 1e-4))
    scale_row: object = field(default_factory=lambda: GaussianPrior(1, 1e-4))
    rotation_angle: object = field(
        default_factory=lambda: UniformPrior(-3.1415, 3.1415))

    def __post_init__(self):
        self.scale_col = _parse_prior(self.scale_col)
        self.scale_row = _parse_prior(self.scale_row)
        self.rotation_angle = _parse_prior(self.rotation_angle)

    def evaluate(self, scale_col, scale_row, rotation_angle):
        return (self.scale_col.evaluate(scale_col)
                + self.scale_row.evaluate(scale_row)
                + self.rotation_angle.evaluate(rotation_angle))


@dataclass
class MotionPrior(_PriorContainer):
    """Priors on pointing shifts (reference ``:224-244``)."""
    shift_col: object = field(default_factory=lambda: GaussianPrior(0.0, 1.0))
    shift_row: object = field(default_factory=lambda: GaussianPrior(0.0, 1.0))

    def __post_init__(self):
        self.shift_col = _parse_prior(self.shift_col)
        self.shift_row = _parse_prior(self.shift_row)

    def evaluate(self, shift_col, shift_row):
        return (self.shift_col.evaluate(shift_col)
                + self.shift_row.evaluate(shift_row))


# ---------------------------------------------------------------------------
# Parameter containers (reference tpfmodel.py:246-430)
# ---------------------------------------------------------------------------
@dataclass
class StarParameters:
    col: float
    row: float
    flux: float
    err_col: Optional[float] = None
    err_row: Optional[float] = None
    err_flux: Optional[float] = None
    fitted: bool = True


@dataclass
class BackgroundParameters:
    flux: float = 0.0
    err_flux: Optional[float] = None
    fitted: bool = True


@dataclass
class FocusParameters:
    scale_col: float = 1.0
    scale_row: float = 1.0
    rotation_angle: float = 0.0
    fitted: bool = False


@dataclass
class MotionParameters:
    shift_col: float = 0.0
    shift_row: float = 0.0
    fitted: bool = False


class TPFModelParameters:
    """All parameters of a TPFModel (reference ``:312-430``)."""

    def __init__(self, stars=None, background=None, focus=None, motion=None):
        self.stars = list(stars or [])
        self.background = background or BackgroundParameters()
        self.focus = focus or FocusParameters()
        self.motion = motion or MotionParameters()

    def __repr__(self):
        out = [f"<TPFModelParameters: {len(self.stars)} star(s)>"]
        out += [f"  {s}" for s in self.stars]
        out += [f"  {self.background}", f"  {self.focus}", f"  {self.motion}"]
        return "\n".join(out)

    def to_array(self):
        """Free parameters as a flat array in the reference's ordering:
        [col, row, flux] per star, background, focus, motion
        (reference ``:360-388``)."""
        arr = []
        for star in self.stars:
            arr.extend([star.col, star.row, star.flux])
        if self.background.fitted:
            arr.append(self.background.flux)
        if self.focus.fitted:
            arr.extend([self.focus.scale_col, self.focus.scale_row,
                        self.focus.rotation_angle])
        if self.motion.fitted:
            arr.extend([self.motion.shift_col, self.motion.shift_row])
        return np.array(arr, dtype=float).ravel()

    def from_array(self, array):
        """Inverse of ``to_array()`` (reference ``:390-430``)."""
        array = np.asarray(array, dtype=float).ravel()
        idx = 0
        stars = []
        for _ in range(len(self.stars)):
            stars.append(StarParameters(col=array[idx], row=array[idx + 1],
                                        flux=array[idx + 2]))
            idx += 3
        if self.background.fitted:
            background = BackgroundParameters(flux=array[idx], fitted=True)
            idx += 1
        else:
            background = self.background
        if self.focus.fitted:
            focus = FocusParameters(scale_col=array[idx],
                                    scale_row=array[idx + 1],
                                    rotation_angle=array[idx + 2],
                                    fitted=True)
            idx += 3
        else:
            focus = self.focus
        if self.motion.fitted:
            motion = MotionParameters(shift_col=array[idx],
                                      shift_row=array[idx + 1], fitted=True)
        else:
            motion = self.motion
        return TPFModelParameters(stars=stars, background=background,
                                  focus=focus, motion=motion)


def _as_params(params):
    """Free-parameter vectors as a tensor: a tensor stays where it is, an
    array goes to :func:`config.resolve_device` in
    :data:`config.default_dtype`."""
    if isinstance(params, TPFModelParameters):
        params = params.to_array()
    if isinstance(params, torch.Tensor):
        return params
    return torch.as_tensor(np.asarray(params, dtype=float),
                           device=config.resolve_device(None)).to(
                               config.default_dtype)


class TPFModel:
    """Scene model: Σ stars × PRF(focus, motion) + constant background
    (reference ``tpfmodel.py:446-620``).

    The free-parameter vector follows the reference's ordering
    ([col, row, flux] per star, then background/focus/motion as enabled
    by ``fit_background``/``fit_focus``/``fit_motion``).
    """

    def __init__(self, star_priors=None, background_prior=None, prf=None,
                 focus_prior=None, motion_prior=None, prfmodel=None,
                 fit_background=True, fit_focus=False, fit_motion=False):
        self.star_priors = list(star_priors or [])
        self.background_prior = background_prior or BackgroundPrior()
        self.focus_prior = focus_prior or FocusPrior()
        self.motion_prior = motion_prior or MotionPrior()
        self.prfmodel = prfmodel if prfmodel is not None else prf
        self.fit_background = fit_background
        self.fit_focus = fit_focus
        self.fit_motion = fit_motion

    # ``prf=`` and ``.prf`` are accepted aliases of ``prfmodel``
    @property
    def prf(self):
        return self.prfmodel

    @prf.setter
    def prf(self, value):
        self.prfmodel = value

    @classmethod
    def from_tpf(cls, tpf, star_priors=None, prf=None, **kwargs):
        """Build a model from a TPF: one star at the brightest pixel with
        flux prior from the median image (reference ``:620-660``)."""
        from .prfmodel import GaussianPRF, SimpleKeplerPRF
        med = np.nanmedian(tpf.flux.value, axis=0)
        if prf is None:
            if tpf.mission in ("Kepler", "K2") and tpf.meta.get("CHANNEL"):
                prf = SimpleKeplerPRF(channel=tpf.meta["CHANNEL"],
                                      shape=tpf.shape[1:],
                                      column=tpf.column, row=tpf.row)
            else:
                prf = GaussianPRF(shape=tpf.shape[1:], column=tpf.column,
                                  row=tpf.row)
        if star_priors is None:
            r, c = np.unravel_index(np.nanargmax(med), med.shape)
            total = float(np.nansum(med))
            star_priors = [StarPrior(
                col=GaussianPrior(tpf.column + c + 0.5, 1.0),
                row=GaussianPrior(tpf.row + r + 0.5, 1.0),
                flux=UniformPrior(0.0, max(10 * total, 1.0)),
                targetid=tpf.targetid)]
        return cls(star_priors=star_priors, prfmodel=prf, **kwargs)

    @property
    def n_stars(self):
        return len(self.star_priors)

    def get_initial_guesses(self):
        """Prior means as a TPFModelParameters (reference ``:496-527``)."""
        stars = [StarParameters(col=sp.col.mean, row=sp.row.mean,
                                flux=sp.flux.mean)
                 for sp in self.star_priors]
        background = BackgroundParameters(
            flux=self.background_prior.flux.mean, fitted=self.fit_background)
        focus = FocusParameters(
            scale_col=self.focus_prior.scale_col.mean,
            scale_row=self.focus_prior.scale_row.mean,
            rotation_angle=self.focus_prior.rotation_angle.mean,
            fitted=self.fit_focus)
        motion = MotionParameters(
            shift_col=self.motion_prior.shift_col.mean,
            shift_row=self.motion_prior.shift_row.mean,
            fitted=self.fit_motion)
        return TPFModelParameters(stars=stars, background=background,
                                  focus=focus, motion=motion)

    def initial_guess(self):
        """Flat free-parameter vector of the prior means."""
        return self.get_initial_guesses().to_array()

    # -- the scene as a function of free-parameter vectors ----------------
    def _free_priors(self):
        """The prior of each free parameter, in the vector's order."""
        out = []
        for sp in self.star_priors:
            out += [sp.col, sp.row, sp.flux]
        if self.fit_background:
            out.append(self.background_prior.flux)
        if self.fit_focus:
            fp = self.focus_prior
            out += [fp.scale_col, fp.scale_row, fp.rotation_angle]
        if self.fit_motion:
            out += [self.motion_prior.shift_col, self.motion_prior.shift_row]
        return out

    def _unpack(self, params):
        """Split free vectors (..., k) into (cols, rows, fluxes) (..., S)
        and the background, focus and motion (..., or the prior means
        where not fitted)."""
        S = self.n_stars
        cols = params[..., 0:3 * S:3]
        rows = params[..., 1:3 * S:3]
        fluxes = params[..., 2:3 * S:3]
        idx = 3 * S
        if self.fit_background:
            bkg = params[..., idx]
            idx += 1
        else:
            bkg = self.background_prior.flux.mean
        if self.fit_focus:
            focus = (params[..., idx], params[..., idx + 1],
                     params[..., idx + 2])
            idx += 3
        else:
            fp = self.focus_prior
            focus = (fp.scale_col.mean, fp.scale_row.mean,
                     fp.rotation_angle.mean)
        if self.fit_motion:
            motion = (params[..., idx], params[..., idx + 1])
        else:
            motion = (self.motion_prior.shift_col.mean,
                      self.motion_prior.shift_row.mean)
        return cols, rows, fluxes, bkg, focus, motion

    def _scene(self, params, jac=False):
        """The scene (..., H, W) for free vectors ``params`` (..., k) and
        with ``jac`` its Jacobian (..., H, W, k)."""
        cols, rows, fluxes, bkg, focus, motion = self._unpack(params)
        scale_col, scale_row, rot = focus
        shift_col, shift_row = motion
        img = params.new_zeros(params.shape[:-1] + tuple(self.prfmodel.shape))
        parts = []
        for s in range(self.n_stars):
            out = self.prfmodel._evaluate(
                cols[..., s] + shift_col, rows[..., s] + shift_row,
                fluxes[..., s], scale_col=scale_col, scale_row=scale_row,
                rotation_angle=rot, jac=jac)
            if jac:
                out, d = out
                parts.append(d)
            img = img + out
        img = img + (bkg[..., None, None] if isinstance(bkg, torch.Tensor)
                     else bkg)
        if not jac:
            return img
        columns = []
        for d in parts:
            columns += d[:3]
        if self.fit_background:
            columns.append(torch.ones_like(img))
        for fitted, which in ((self.fit_focus, (3, 4, 5)),
                              (self.fit_motion, (0, 1))):
            if fitted:
                for i in which:
                    total = torch.zeros_like(img)
                    for d in parts:
                        total = total + d[i]
                    columns.append(total)
        return img, torch.stack(columns, dim=-1)

    def predict_from_array(self, params):
        """Scene image(s) for free-parameter vector(s) (..., k), a tensor
        on the parameters' device (an array goes to the configured one)."""
        return self._scene(_as_params(params))

    def predict(self, params=None):
        """Synthetic image for a TPFModelParameters (or array, or the
        prior means when omitted) as a host array (reference
        ``:529-568``)."""
        if params is None:
            params = self.get_initial_guesses()
        return self.predict_from_array(params).cpu().numpy()

    def logp_prior(self, params):
        """Prior evaluated at a point in parameter space (reference
        ``tpfmodel.py:589-611``; like the reference's priors, ``evaluate``
        returns the negative log density, so this equals
        :meth:`prior_penalty`)."""
        return float(self.prior_penalty(_as_params(params)))

    def prior_penalty(self, params):
        """Total negative-log-prior of free vector(s) (..., k)."""
        params = _as_params(params)
        cols, rows, fluxes, bkg, focus, motion = self._unpack(params)
        pen = 0.0
        for s, sp in enumerate(self.star_priors):
            pen = pen + sp.flux.penalty(fluxes[..., s])
            pen = pen + sp.col.penalty(cols[..., s])
            pen = pen + sp.row.penalty(rows[..., s])
        if self.fit_background:
            pen = pen + self.background_prior.flux.penalty(bkg)
        if self.fit_focus:
            fp = self.focus_prior
            pen = (pen + fp.scale_col.penalty(focus[0])
                   + fp.scale_row.penalty(focus[1])
                   + fp.rotation_angle.penalty(focus[2]))
        if self.fit_motion:
            pen = (pen + self.motion_prior.shift_col.penalty(motion[0])
                   + self.motion_prior.shift_row.penalty(motion[1]))
        return pen

    def _prior_derivatives(self, params):
        """Gradient (..., k) and Hessian diagonal (..., k) of
        :meth:`prior_penalty` (each prior acts on one parameter, so the
        Hessian is diagonal)."""
        pairs = [prior.derivatives(params[..., i])
                 for i, prior in enumerate(self._free_priors())]
        return (torch.stack([g for g, _ in pairs], dim=-1),
                torch.stack([h for _, h in pairs], dim=-1))

    def fit(self, data, n_iter=50, damping=1e-3, **kwargs):
        """Fit one image; returns a TPFModelParameters with the fitted
        values (reference ``:570-618``; the engine is PRFPhotometry's LM,
        so scipy-style kwargs like ``tol``/``options`` are accepted and
        ignored)."""
        phot = PRFPhotometry(self)
        fitted = phot.run(np.asarray(data, dtype=float)[None, ...],
                          n_iter=n_iter, damping=damping)
        return self.get_initial_guesses().from_array(fitted[0])

    def gradient(self, params=None):
        """Gradient images of the scene w.r.t. every free parameter: a
        list of ``(h, w)`` host arrays, the exact Jacobian (the reference's
        ``jax.jacfwd`` of :meth:`predict_from_array`)."""
        if params is None:
            params = self.initial_guess()
        _, jac = self._scene(_as_params(params), jac=True)
        jac = jac.cpu().numpy()
        return [jac[..., i] for i in range(jac.shape[-1])]

    def _extent(self):
        return (self.prfmodel.column,
                self.prfmodel.column + self.prfmodel.shape[1],
                self.prfmodel.row,
                self.prfmodel.row + self.prfmodel.shape[0])

    def plot(self, *params, **kwargs):
        """Image of the model at a point in parameter space (reference
        ``tpfmodel.py:672-686``)."""
        from ..utils import plot_image
        img = self.predict(*params) if params else self.predict()
        return plot_image(img, title="TPF Model", extent=self._extent(),
                          **kwargs)

    def plot_diagnostics(self, data, figsize=(12, 4), *params, **kwargs):
        """Observed / fitted / residual image triptych (reference
        ``tpfmodel.py:687-718``).  Returns the fitted parameters."""
        import matplotlib.pyplot as plt
        from ..utils import plot_image
        fig, ax = plt.subplots(nrows=1, ncols=3, figsize=figsize)
        data = _strip_quantity(data)
        fit = self.fit(data)
        predicted = self.predict(fit)
        chan = getattr(self.prfmodel, "channel", None)
        extent = self._extent()
        plot_image(data, ax=ax[0],
                   title=f"Observed Data, Channel: {chan}", extent=extent,
                   **kwargs)
        plot_image(predicted, ax=ax[1],
                   title=f"Predicted Image, Channel: {chan}",
                   extent=extent, **kwargs)
        plot_image(data - predicted, ax=ax[2],
                   title=f"Residual Image, Channel: {chan}", extent=extent,
                   **kwargs)
        return fit

    def __repr__(self):
        out = [f"<TPFModel: {self.n_stars} star(s), "
               f"fit_background={self.fit_background}, "
               f"fit_focus={self.fit_focus}, "
               f"fit_motion={self.fit_motion}>"]
        out += [f"  {sp}" for sp in self.star_priors]
        out += [f"  {self.background_prior}", f"  {self.focus_prior}",
                f"  {self.motion_prior}", f"  {self.prfmodel}"]
        return "\n".join(out)


class PRFPhotometry:
    """Batched MAP PRF photometry (reference ``tpfmodel.py:700-851``).

    ``run`` fits every cadence at once: a batched Levenberg-Marquardt loop
    of fixed iterations on the device.
    """

    def __init__(self, model: TPFModel):
        self.model = model
        self.opt_params = None
        self.losses = None
        self._results = None

    def run(self, flux_cube, cadences=None, n_iter=20, damping=1e-3,
            device=None):
        """Fit every cadence of ``flux_cube`` (T, H, W), or the ones in
        ``cadences``; NaN pixels count as 0, as in the reference.  A tensor
        stays on its device in its dtype; an array goes to ``device``
        (:func:`config.resolve_device`: the card unless the caller passes
        ``"cpu"``) in :data:`config.default_dtype`.  The fit runs there in
        float64.  Returns the fitted vectors (T, k) as a float64 host
        array; ``opt_params``, ``losses`` and ``results`` come back once,
        after the loop."""
        if isinstance(flux_cube, torch.Tensor):
            cube = flux_cube if device is None else flux_cube.to(
                config.resolve_device(device))
        else:
            cube = torch.as_tensor(
                np.asarray(flux_cube, dtype=float),
                device=config.resolve_device(device)).to(config.default_dtype)
        if cube.ndim == 2:
            cube = cube[None, ...]
        if cadences is not None:
            cube = cube[torch.as_tensor(np.asarray(cadences),
                                        device=cube.device)]
        data = torch.nan_to_num(cube).reshape(cube.shape[0], -1).double()
        fitted = self._fit(data, int(n_iter), damping)
        losses = self._loss(fitted, data)
        self.opt_params = fitted.cpu().numpy()
        self.losses = losses.cpu().numpy()
        self._results = None
        return self.opt_params

    def _fit(self, data, n_iter, damping):
        """The LM loop over the batch (B, H·W): per iteration the scene and
        its Jacobian (B, H·W, k), ``g = Jᵀr + ∇prior``,
        ``H = JᵀJ + ∇²prior`` damped by ``damping·diag(H) + 1e-8·I``, one
        batched SPD solve and the trust-region clip ``|δ| ≤ 0.5(|p|+1)``."""
        from ..ops.solve import chol_solve_small
        model = self.model
        p0 = torch.as_tensor(model.initial_guess(), device=data.device).to(
            data.dtype)
        B, k = data.shape[0], p0.shape[0]
        p = p0.expand(B, k)
        eye = 1e-8 * torch.eye(k, dtype=data.dtype, device=data.device)
        for _ in range(n_iter):
            img, J = model._scene(p, jac=True)
            J = J.reshape(B, -1, k)
            r = img.reshape(B, -1) - data
            pg, ph = model._prior_derivatives(p)
            g = (J.mT @ r[..., None])[..., 0] + pg
            H = J.mT @ J + torch.diag_embed(ph)
            H = H + (damping * torch.diag_embed(
                torch.diagonal(H, dim1=-2, dim2=-1)) + eye)
            delta = chol_solve_small(H, g)
            max_step = 0.5 * (torch.abs(p) + 1.0)
            p = p - torch.clamp(delta, -max_step, max_step)
        return p

    def _loss(self, params, data):
        """``0.5·Σr² + prior penalty`` per cadence."""
        r = self.model._scene(params).reshape(data.shape) - data
        return 0.5 * torch.sum(r * r, dim=-1) + self.model.prior_penalty(
            params)

    @property
    def results(self):
        """Per-cadence TPFModelParameters (reference ``:766-780``), made
        from ``opt_params`` when first read."""
        if self._results is None and self.opt_params is not None:
            guesses = self.model.get_initial_guesses()
            self._results = [guesses.from_array(row)
                             for row in self.opt_params]
        return self._results

    def to_lightcurve(self, time=None, star=0):
        """Fitted flux time series of one star."""
        if self.opt_params is None:
            raise ValueError("call run() first")
        flux = self.opt_params[:, 3 * star + 2]
        if time is None:
            time = np.arange(len(flux), dtype=float)
        return LightCurve(time=time,
                          flux=Quantity(flux, electron_per_second))

    def get_residual_image(self, flux_cube, cadence=0):
        model = self.model.predict(self.opt_params[cadence])
        return _strip_quantity(flux_cube)[cadence] - model

    def plot_results(self, star_idx=0):
        """Plot every fitted model parameter over time (reference
        ``tpfmodel.py:814-840``): per-cadence star flux/col/row, motion,
        background, focus, and the final loss."""
        import matplotlib.pyplot as plt
        if self.results is None:
            raise ValueError("call run() first")
        fig, ax = plt.subplots(10, sharex=True, figsize=(6, 12))
        x = range(len(self.results))
        rows = [
            ("Flux", [r.stars[star_idx].flux for r in self.results]),
            ("Col", [r.stars[star_idx].col for r in self.results]),
            ("Row", [r.stars[star_idx].row for r in self.results]),
            ("Shift col", [r.motion.shift_col for r in self.results]),
            ("Shift row", [r.motion.shift_row for r in self.results]),
            ("Background", [r.background.flux for r in self.results]),
            ("Focus col", [r.focus.scale_col for r in self.results]),
            ("Focus row", [r.focus.scale_row for r in self.results]),
            ("Focus angle", [r.focus.rotation_angle for r in self.results]),
            ("Loss", list(self.losses)),
        ]
        for a, (label, series) in zip(ax, rows):
            a.plot(x, series)
            a.set_ylabel(label)
        return ax
