"""Small dense linear algebra for the correctors.

Counterpart of ``lightkurve_tpu/ops/solve.py``: the weighted ridge solve
of the regression correctors, its fixed-iteration sigma-clip refit loop,
randomized PCA, the ElasticNet solver and the small SPD solve of the
Levenberg-Marquardt fits.  Every function broadcasts over leading batch
axes, so a stack of targets is one batched call (``TPFStack.pld_correct``),
and follows its inputs' device and dtype.  Matrix products run in full
float32 on the card (:func:`config.full_f32_matmul`), whatever the global
TF32 flag says.
"""
from __future__ import annotations

import torch

from ..config import full_f32_matmul
from .stats import sigma_clip_mask

__all__ = ["solve_regression", "iterative_clipped_regression",
           "randomized_pca", "gaussian_test_matrix", "chol_solve_small",
           "elasticnet_fista"]

#: the host checks of :func:`elasticnet_fista`'s convergence: one every
#: this many iterations (the iterations past convergence change nothing)
FISTA_CHECK_EVERY = 100


def chol_solve_small(A, b):
    """``x = A⁻¹ b`` for small symmetric positive-definite systems by
    batched Cholesky: ``A`` (..., k, k), ``b`` (..., k); returns (..., k).

    The reference's unrolled factorisation clamps each pivot at 1e-30;
    here the diagonal is clamped before the factorisation, which is the
    same wherever the pivot's row is zero off the diagonal (an all-zero
    Jacobian column of the LM fits, the case the clamp exists for).
    A factorisation that fails gives non-finite entries, without a host
    check."""
    diag = torch.diagonal(A, dim1=-2, dim2=-1)
    A = A + torch.diag_embed(torch.clamp(diag, min=1e-30) - diag)
    L, _ = torch.linalg.cholesky_ex(A)
    return torch.cholesky_solve(b[..., None], L)[..., 0]


def solve_regression(X, y, flux_err, mask, prior_mu=None, prior_sigma=None):
    """Weighted ridge solve ``w = (XᵀΣ⁻¹X + Λ)⁻¹ (XᵀΣ⁻¹y + Λμ)``.

    X : (..., n, k) design matrices; y, flux_err : (..., n); mask :
    (..., n) bool, True rows take part; prior_mu, prior_sigma : (..., k)
    Gaussian priors (σ = inf: unregularised).  Returns ``w`` (..., k) and
    the posterior precision (..., k, k)."""
    with full_f32_matmul(X.device):
        inv_var = torch.where(mask, 1.0 / torch.square(flux_err), 0.0)
        Xw = X * inv_var[..., None]
        sigma_w_inv = X.mT @ Xw
        B = (Xw.mT @ y[..., None])[..., 0]
        if prior_sigma is not None:
            prec = 1.0 / torch.square(prior_sigma)
            sigma_w_inv = sigma_w_inv + torch.diag_embed(
                prec.expand(B.shape))
            if prior_mu is not None:
                B = B + prior_mu * prec
        w = torch.linalg.solve(sigma_w_inv, B)
    return w, sigma_w_inv


def iterative_clipped_regression(X, y, flux_err, mask, prior_mu, prior_sigma,
                                 sigma=5.0, niters=5, clip_maxiters=5):
    """The regression correctors' fit loop, ``niters`` fixed iterations
    with no host synchronisation: each solves the ridge system on the
    current mask, then drops the residuals' outliers by sigma clipping.
    As the reference, the coefficients are those of the last fit, made
    before the last mask update.  Returns (w, final mask, posterior
    precision)."""
    m = mask
    w = sigma_w_inv = None
    with full_f32_matmul(X.device):
        for _ in range(int(niters)):
            w, sigma_w_inv = solve_regression(X, y, flux_err, m, prior_mu,
                                              prior_sigma)
            resid = y - (X @ w[..., None])[..., 0]
            m = m & ~sigma_clip_mask(resid, mask=m, sigma=sigma,
                                     maxiters=clip_maxiters)
    if w is None:
        k = X.shape[-1]
        w = X.new_zeros(X.shape[:-2] + (k,))
        sigma_w_inv = X.new_zeros(X.shape[:-2] + (k, k))
    return w, m, sigma_w_inv


def gaussian_test_matrix(seed, shape, dtype, device):
    """:func:`randomized_pca`'s Gaussian test matrix: standard normal
    draws from a ``torch.Generator`` seeded with ``seed``, made on the host
    so the card and the CPU get the same matrix."""
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    return torch.randn(shape, generator=gen, dtype=torch.float64).to(
        device=device, dtype=dtype)


def randomized_pca(A, k, n_iter=10, seed=0, oversample=2):
    """Randomized-SVD PCA (Halko et al. 2011), fbpca's ``pca``: ``A``
    (..., m, n); returns (U, s, Vt) of the ``k`` leading components,
    (..., m, k), (..., k), (..., k, n).  Every batch member shares one
    test matrix (:func:`gaussian_test_matrix` of ``seed``), as the
    reference's vmapped call does."""
    m, n = A.shape[-2:]
    l = min(k + oversample, min(m, n))
    G = gaussian_test_matrix(seed, (n, l), A.dtype, A.device)
    with full_f32_matmul(A.device):
        Q, _ = torch.linalg.qr(A @ G)
        for _ in range(int(n_iter)):
            Q, _ = torch.linalg.qr(A.mT @ Q)
            Q, _ = torch.linalg.qr(A @ Q)
        Ub, s, Vt = torch.linalg.svd(Q.mT @ A, full_matrices=False)
        U = Q @ Ub
    return U[..., :k], s[..., :k], Vt[..., :k, :]


def elasticnet_fista(X, y, alpha, l1_ratio, tol=1e-14, max_iter=50_000):
    """ElasticNet by FISTA with gradient-scheme restart, sklearn's
    objective without intercept:
    ``1/(2n)||y - Xw||² + α·ρ·||w||₁ + α(1-ρ)/2·||w||²``, on the normal
    equations ``G = XᵀX/n``, ``c = Xᵀy/n``.  Iterates until the largest
    step falls to ``tol`` (relative to ``max(1, |w|)``) or ``max_iter``;
    once converged the state stays as it is, so checking convergence on
    the host only every :data:`FISTA_CHECK_EVERY` iterations gives the
    reference's result.  Returns ``w`` (k,) and the iterations run (a
    multiple of :data:`FISTA_CHECK_EVERY` unless ``max_iter`` ended the
    loop)."""
    with full_f32_matmul(X.device):
        n = X.shape[0]
        G = (X.T @ X) / n
        c = (X.T @ y) / n
        lam1 = alpha * l1_ratio
        lam2 = alpha * (1.0 - l1_ratio)
        L = torch.linalg.eigvalsh(G)[-1] + lam2
        step = 1.0 / torch.clamp(L, min=torch.finfo(X.dtype).tiny)
        thr = lam1 * step

        def prox_step(v):
            z = v - step * (G @ v - c + lam2 * v)
            return torch.sign(z) * torch.clamp(torch.abs(z) - thr, min=0.0)

        w = X.new_zeros(X.shape[1])
        v = w
        t = torch.ones((), dtype=X.dtype, device=X.device)
        delta = torch.full((), torch.inf, dtype=X.dtype, device=X.device)
        i = 0
        while i < int(max_iter):
            active = delta > tol * torch.clamp(w.abs().max(), min=1.0)
            if i % FISTA_CHECK_EVERY == 0 and not bool(active):
                break
            w_new = prox_step(v)
            restart = torch.dot(v - w_new, w_new - w) > 0.0
            t_cur = torch.where(restart, 1.0, t)
            t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t_cur * t_cur))
            v_new = w_new + ((t_cur - 1.0) / t_new) * (w_new - w)
            delta_new = (w_new - w).abs().max()
            w = torch.where(active, w_new, w)
            v = torch.where(active, v_new, v)
            t = torch.where(active, t_new, t)
            delta = torch.where(active, delta_new, delta)
            i += 1
    return w, i
