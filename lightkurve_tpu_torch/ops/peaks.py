"""1-D peak finding and the small Gaussian fit of the SFF corrector.

Counterpart of ``lightkurve_tpu/ops/peaks.py``:

* :func:`find_peaks_mask`, ``scipy.signal.find_peaks(x, distance=d)`` as a
  fixed-shape mask (plateau-aware local maxima, then highest-first
  suppression within ``distance``);
* :func:`fit_gaussian_lm`, a weighted Levenberg-Marquardt Gaussian fit,
  the reference's replacement for ``scipy.optimize.curve_fit`` in the SFF
  thruster-firing detector.  It runs its ``max_iter`` iterations with no
  host synchronisation: once the reference's loop would stop, the state
  stays as it is.
"""
from __future__ import annotations

import torch

from .solve import chol_solve_small

__all__ = ["find_peaks_mask", "fit_gaussian_lm"]


def _local_maxima_mask(x):
    """Local maxima of a 1-D tensor as scipy finds them: a run of equal
    samples between strictly smaller neighbours is one maximum, at the
    run's middle ``(start + end) // 2``."""
    n = x.shape[0]
    idx = torch.arange(n, device=x.device)
    true = torch.ones(1, dtype=torch.bool, device=x.device)
    changed = torch.cat([true, x[1:] != x[:-1]])
    start = torch.cummax(torch.where(changed, idx, 0), 0).values
    next_change = torch.cat([changed[1:], true])
    end_rev = torch.cummax(torch.where(next_change.flip(0), idx, 0), 0).values
    end = (n - 1) - end_rev.flip(0)
    prev_val = x[torch.clamp(start - 1, min=0)]
    next_val = x[torch.clamp(end + 1, max=n - 1)]
    interior = (start > 0) & (end < n - 1)
    is_peak_run = interior & (prev_val < x) & (next_val < x)
    return is_peak_run & (idx == (start + end) // 2)


def find_peaks_mask(x, distance):
    """Boolean mask of the peaks ``scipy.signal.find_peaks(x,
    distance=distance)`` returns: each highest remaining candidate is
    kept and every candidate closer than ``ceil(distance)`` (at least 1)
    to it dropped."""
    dist = max(float(torch.ceil(torch.tensor(float(distance)))), 1.0)
    cand = _local_maxima_mask(x)
    idx = torch.arange(x.shape[0], device=x.device)
    kept = torch.zeros_like(cand)
    remaining = cand
    while bool(remaining.any()):
        pos = torch.argmax(torch.where(remaining, x, -torch.inf))
        kept[pos] = True
        remaining = remaining & ~((idx - pos).abs() < dist)
    return kept


def fit_gaussian_lm(x, y, w, p0, max_iter=200):
    """Weighted Gaussian fit ``amp·exp(-((x - mu)/sig)²/2)`` by
    Levenberg-Marquardt: minimises ``Σ w²(f(x) - y)²`` (``w`` is 1/σ of
    ``curve_fit``'s ``sigma``) from ``p0`` = (amp, mu, sig).  The damped
    3×3 normal system is solved by :func:`chol_solve_small`.  Stops, as
    the reference, on a relative χ² change of an accepted step below
    1e-14, at ``max_iter`` iterations or when the damping saturates.
    Returns the tensor (amp, mu, sig)."""
    p = torch.as_tensor(p0, dtype=x.dtype, device=x.device)

    def model_and_jac(p):
        amp, mu, sig = p[0], p[1], p[2]
        z = (x - mu) / sig
        e = torch.exp(-0.5 * z * z)
        f = amp * e
        return f, torch.stack([e, f * z / sig, f * z * z / sig], dim=1)

    def chi2(p):
        return torch.sum(torch.square(w * (model_and_jac(p)[0] - y)))

    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    lam = torch.full((), 1e-3, dtype=x.dtype, device=x.device)
    c2 = chi2(p)
    rel = torch.full((), torch.inf, dtype=x.dtype, device=x.device)
    for i in range(int(max_iter)):
        running = (rel > 1e-14) & (lam < 1e12)
        f, J = model_and_jac(p)
        r = w * (y - f)
        Jw = J * w[:, None]
        JtJ = Jw.T @ Jw
        A = JtJ + lam * torch.diag(torch.diag(JtJ)) + 1e-30 * eye
        p_new = p + chol_solve_small(A, Jw.T @ r)
        c2_new = chi2(p_new)
        accept = running & (c2_new < c2)
        p = torch.where(accept, p_new, p)
        rel = torch.where(
            running, torch.where(accept, torch.abs(c2 - c2_new)
                                 / torch.clamp(c2, min=1e-30), torch.inf),
            rel)
        c2 = torch.where(accept, c2_new, c2)
        lam = torch.where(running, torch.clamp(
            torch.where(accept, lam * 0.3, lam * 4.0), 1e-12, 1e12), lam)
    return p
