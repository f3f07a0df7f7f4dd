"""Lomb-Scargle periodograms over batches of light curves.

Counterpart of ``lightkurve_tpu/ops/lombscargle.py``, in plain torch on
the device of the fluxes:

- :func:`lombscargle_direct` -- the exact generalized (floating-mean)
  Lomb-Scargle of Zechmeister & Kuerster (2009), astropy's ``slow``
  method, over frequency chunks (the last one ragged) whose sums are
  matrix products in full float32 (:func:`~lightkurve_tpu_torch.config.
  full_f32_matmul`: no TF32 rounding on the card).
- :func:`lombscargle_fast` -- the Press & Rybicki (1989) method, astropy's
  ``fast``: Lagrange extirpolation of order ``Mfft`` onto a regular grid
  (``index_add_`` along the last axis), then ``torch.fft.ifft``.  The
  phases that need float64 (absolute times x frequencies) are set up on
  the host (:func:`fast_precompute`) and cached per time grid.
- :func:`lombscargle_chi2` and :func:`lombscargle_fastchi2` -- the
  multi-term (chi2) periodogram, directly and from harmonic trig sums
  (Palmer 2009, astropy's ``fastchi2``).  Both solve the per-frequency
  normal equations by a Cholesky written out over entry lists of
  (..., Nf) tensors (:func:`_chol_quadform_rows`), whose ``rcond`` rank
  truncation keeps fastchi2 bounded where its approximate (A, b) are
  inconsistent; no stacked (..., Nf, M, M) matrix is formed.

Normalizations: 'standard', 'model', 'log', 'psd', with astropy's
semantics.  ``index_add_`` on a CUDA tensor adds with atomics, so reruns
on the card may differ in the last bits.
"""
from __future__ import annotations

from math import factorial

import numpy as np
import torch

from ..config import full_f32_matmul, numpy_dtype, on_device

__all__ = ["lombscargle_direct", "lombscargle_fast", "lombscargle_chi2",
           "lombscargle_fastchi2", "extirpolate", "extirpolate_batched",
           "trig_sum", "fast_precompute"]


def _host(t):
    """Times (tensor or array) as a host array, in their own dtype."""
    return np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t)


def _like(x, y):
    """``x`` (tensor or array) on ``y``'s device in ``y``'s dtype."""
    if isinstance(x, torch.Tensor):
        return x.to(device=y.device, dtype=y.dtype)
    return torch.as_tensor(np.asarray(x), dtype=y.dtype, device=y.device)


def _shifted_times(t, y):
    """The times of the direct methods as a tensor like ``y``.  A host
    array first has its minimum subtracted in its own dtype: JD-scale
    times lose ~0.25 d in float32, and the power is invariant to the
    shift.  A tensor is taken as already shifted."""
    if not isinstance(t, torch.Tensor):
        t = np.asarray(t)
        if t.size:
            t = t - t.min()
    return _like(t, y)


def _apply_normalization(power, YY, normalization, wsum):
    if normalization == "standard":
        return power / YY
    if normalization == "model":
        return power / (YY - power)
    if normalization == "log":
        return -torch.log1p(-power / YY)
    if normalization == "psd":
        return power * 0.5 * wsum
    raise ValueError(f"Unknown normalization {normalization!r}")


def _chunks(p, chunk):
    return [(lo, min(lo + chunk, p)) for lo in range(0, p, chunk)]


def lombscargle_direct(t, y, freqs, dy=None, normalization="standard",
                       fit_mean=True, center_data=True, chunk=512,
                       device=None):
    """Exact generalized Lomb-Scargle power at arbitrary frequencies.

    Parameters
    ----------
    t : (n,) times (a host array is origin-shifted first).
    y : (..., n) fluxes sharing ``t``; their device and dtype set the
        computation's.
    freqs : (p,) frequencies (cycles / unit time).
    dy : optional (n,) uncertainties; None gives uniform weights.  Padded
        samples are masked by ``dy = inf`` (weight 0).
    chunk : frequencies per chunk (the last chunk takes the rest).
    device : where a host-array ``y`` goes (default the card); a tensor
        ``y`` stays on its device unless this is given.

    Returns (..., p) powers.
    """
    y = on_device(y, device)
    t = _shifted_times(t, y)
    freqs = _like(freqs, y)
    w = torch.ones_like(t) if dy is None else 1.0 / torch.square(
        _like(dy, y))
    wsum = torch.sum(w)
    wn = w / wsum
    if fit_mean or center_data:
        y = y - torch.sum(wn * y, dim=-1, keepdim=True)
    YY = torch.sum(wn * y * y, dim=-1)

    def one_chunk(f):
        omega_t = 2.0 * np.pi * f[:, None] * t[None, :]        # (c, n)
        sin = torch.sin(omega_t)
        cos = torch.cos(omega_t)
        S2 = 2.0 * ((sin * cos) @ wn)
        C2 = 2.0 * ((0.5 - sin * sin) @ wn)
        if fit_mean:
            S = sin @ wn
            C = cos @ wn
            S2 = S2 - 2.0 * S * C
            C2 = C2 - (C * C - S * S)
        norm = torch.sqrt(1.0 + (S2 / C2) ** 2)
        C2w = 1.0 / norm
        S2w = (S2 / C2) / norm
        Cw = torch.sqrt(0.5 + 0.5 * C2w)
        Sw = np.sqrt(0.5) * torch.sign(S2w) * torch.sqrt(1.0 - C2w)
        cos_tau = cos * Cw[:, None] + sin * Sw[:, None]         # (c, n)
        sin_tau = sin * Cw[:, None] - cos * Sw[:, None]
        CC = (cos_tau * cos_tau) @ wn
        SS = (sin_tau * sin_tau) @ wn
        if fit_mean:
            CC = CC - (cos_tau @ wn) ** 2
            SS = SS - (sin_tau @ wn) ** 2
        YC = (y * wn) @ cos_tau.T                               # (..., c)
        YS = (y * wn) @ sin_tau.T
        return YC * YC / CC + YS * YS / SS

    with full_f32_matmul(y.device):
        powers = torch.cat([one_chunk(freqs[lo:hi])
                            for lo, hi in _chunks(freqs.shape[0], chunk)],
                           dim=-1)
    return _apply_normalization(powers, YY[..., None], normalization, wsum)


def lombscargle_chi2(t, y, freqs, dy=None, nterms=1,
                     normalization="standard", fit_mean=True,
                     center_data=True, chunk=256, device=None):
    """Multi-term (chi2) Lomb-Scargle, astropy's 'chi2' semantics.

    Power(f) is the weighted model sum of squares of the best-fit
    truncated Fourier series with ``nterms`` harmonics (and a bias column
    with ``fit_mean``), from the normal equations of each frequency: the
    designs of a chunk of frequencies form one (c, n, k) tensor, whose
    products run in full float32.  Arguments as
    :func:`lombscargle_direct`.
    """
    y = on_device(y, device)
    t = _shifted_times(t, y)
    freqs = _like(freqs, y)
    dy = torch.ones_like(t) if dy is None else _like(dy, y)
    w = 1.0 / torch.square(dy)
    ws = torch.sum(w)
    if center_data or fit_mean:
        y = y - torch.sum(w * y, dim=-1, keepdim=True) / ws
    yw = y / dy
    chi2_ref = torch.sum(yw * yw, dim=-1)
    k = 2 * nterms + (1 if fit_mean else 0)
    eye = 1e-30 * torch.eye(k, dtype=y.dtype, device=y.device)

    def one_chunk(f):
        omega_t = 2 * np.pi * f[:, None] * t[None, :]           # (c, n)
        cols = []
        if fit_mean:
            cols.append(torch.ones_like(omega_t))
        for m in range(1, nterms + 1):
            cols.append(torch.sin(m * omega_t))
            cols.append(torch.cos(m * omega_t))
        X = torch.stack(cols, dim=-1) / dy[:, None]             # (c, n, k)
        XTX = X.transpose(-1, -2) @ X                           # (c, k, k)
        XTy = (yw[..., None, None, :] @ X).squeeze(-2)          # (..., c, k)
        return _chol_quadform(XTX + eye, XTy)                   # (..., c)

    with full_f32_matmul(y.device):
        powers = torch.cat([one_chunk(freqs[lo:hi])
                            for lo, hi in _chunks(freqs.shape[0], chunk)],
                           dim=-1)
    return _chi2_normalize(powers, chi2_ref, normalization)


def _chol_quadform_rows(A_rows, b_rows, rcond=0.0):
    """``b^T A^-1 b`` for a small symmetric positive definite system given
    as entry lists (``A_rows[i][j]``, ``b_rows[i]``: tensors that
    broadcast against each other), by a Cholesky and forward substitution
    written out as elementwise ops (power = ||L^-1 b||^2).  Only the lower
    triangle of ``A_rows`` (``j <= i``) is read.  Callers add their own
    diagonal jitter; the clamp at 1e-30 only keeps the square root of an
    exactly singular pivot finite.

    ``rcond > 0`` truncates the rank: a pivot that has shrunk to
    ``rcond`` x its diagonal entry or below marks a numerically dependent
    column, whose contribution is dropped (``z_i = 0``: the projection
    onto the remaining columns).  Exact normal equations are consistent,
    so their quadform is bounded by ||y||^2 even when A is singular; when
    A and b carry independent approximation errors (the FFT trig sums) a
    tiny pivot divides noise by noise, and the truncation restores the
    bound.
    """
    M = len(b_rows)
    L = [[None] * M for _ in range(M)]
    inv = [None] * M
    for i in range(M):
        d = A_rows[i][i]
        for kk in range(i):
            d = d - L[i][kk] * L[i][kk]
        if rcond:
            healthy = d > rcond * A_rows[i][i]
            Lii = torch.sqrt(torch.where(healthy, d, 1.0))
            inv[i] = torch.where(healthy, 1.0 / Lii, 0.0)
        else:
            Lii = torch.sqrt(torch.clamp(d, min=1e-30))
            inv[i] = 1.0 / Lii
        L[i][i] = Lii
        for j in range(i + 1, M):
            s = A_rows[j][i]
            for kk in range(i):
                s = s - L[j][kk] * L[i][kk]
            L[j][i] = s * inv[i]
    z = [None] * M
    for i in range(M):
        s = b_rows[i]
        for kk in range(i):
            s = s - L[i][kk] * z[kk]
        z[i] = s * inv[i]
    return sum(zi * zi for zi in z)


def _chol_quadform(A, b):
    """``b^T A^-1 b`` for a stacked (..., k, k) symmetric positive
    definite ``A`` and a ``b`` that broadcasts to (..., k): the entry view
    of :func:`_chol_quadform_rows`."""
    M = A.shape[-1]
    return _chol_quadform_rows(
        [[A[..., i, j] for j in range(M)] for i in range(M)],
        [b[..., i] for i in range(M)])


def _bitceil(n):
    return 1 << (int(n) - 1).bit_length()


def _chi2_normalize(powers, chi2_ref, normalization):
    """The normalization of the chi2 (multi-term) methods."""
    if normalization == "psd":
        return 0.5 * powers
    if normalization == "standard":
        return powers / chi2_ref[..., None]
    if normalization == "model":
        return powers / (chi2_ref[..., None] - powers)
    if normalization == "log":
        return -torch.log1p(-powers / chi2_ref[..., None])
    raise ValueError(f"Unknown normalization {normalization!r}")


def lombscargle_fastchi2(t, y, f0, df, Nf, dy=None, nterms=1,
                         normalization="standard", fit_mean=True,
                         center_data=True, oversampling=5, Mfft=4,
                         rcond=1e-6, device=None):
    """FFT-accelerated multi-term (chi2) Lomb-Scargle on the regular grid
    ``f0 + df * [0, Nf)``: astropy's ``fastchi2`` (Palmer 2009).

    The normal equations of every frequency come from 2·nterms weight
    trig sums and nterms data trig sums (each one extirpolation and FFT,
    :func:`_trig_sum`), by the harmonic identities::

        sum w sin(m wt) sin(l wt) = (C_|m-l| - C_(m+l)) / 2
        sum w cos(m wt) cos(l wt) = (C_|m-l| + C_(m+l)) / 2
        sum w sin(m wt) cos(l wt) = (S_(m+l) + sign(m-l) S_|m-l|) / 2

    and are solved per frequency by :func:`_chol_quadform_rows`, at
    O((N + Nf log Nf)·nterms) against the direct method's
    O(N·Nf·nterms^2).  Accuracy against :func:`lombscargle_chi2` is set
    by ``oversampling`` and ``Mfft``.

    ``y`` may carry a leading batch axis over the shared ``t``.  With
    ``dy`` None or shared (n,), the normal matrices are assembled and
    factorized once per frequency for the batch; with per-curve (B, n)
    ``dy`` once per curve and frequency.

    ``rcond`` truncates numerically dependent harmonic columns: near the
    Nyquist frequency of a regular grid and near f -> 0 the sin(m wt)
    columns become collinear, the approximate (A, b) are inconsistent
    there, and the untruncated quadform reaches ~1e12 x the true power.
    1e-6 sits between the extirpolation noise and real pivots.

    ``device`` as in :func:`lombscargle_direct`.
    """
    if nterms < 1:
        raise ValueError("nterms must be >= 1 for the chi2 methods")
    t = _host(t)
    y = on_device(y, device)
    w = (torch.ones(t.shape, dtype=y.dtype, device=y.device) if dy is None
         else 1.0 / torch.square(_like(dy, y)))
    pres = [_fast_precompute_device(t, j * f0, j * df, Nf, oversampling,
                                    Mfft, y.dtype, y.device)
            for j in range(1, 2 * nterms + 1)]
    k = nterms
    ws = torch.sum(w, dim=-1)                               # (...,) or ()
    if center_data or fit_mean:
        y = y - (torch.sum(w * y, dim=-1, keepdim=True)
                 / torch.sum(w, dim=-1, keepdim=True))
    chi2_ref = torch.sum(w * y * y, dim=-1)
    yws = torch.sum(w * y, dim=-1)
    wy = w * y
    # the 3k harmonic trig sums: weights at j = 1..2k, data at m = 1..k
    Sw = [torch.zeros_like(ws)[..., None]] + [None] * (2 * k)
    Cw = [ws[..., None]] + [None] * (2 * k)
    for j in range(1, 2 * k + 1):
        Sw[j], Cw[j] = _trig_sum(pres[j - 1], w, Nf, Mfft)
    Sy = [None] * (k + 1)
    Cy = [None] * (k + 1)
    for m in range(1, k + 1):
        Sy[m], Cy[m] = _trig_sum(pres[m - 1], wy, Nf, Mfft)

    # columns as lombscargle_chi2's: [1?, sin w, cos w, sin 2w, ...]
    def xtx_entry(i, j):
        """(kind, harmonic) pairs: kind 0 = bias, 1 = sin, 2 = cos."""
        (ki, mi), (kj, mj) = i, j
        if ki == 0 and kj == 0:
            return Cw[0]
        if ki == 0 or kj == 0:
            kk, m = (kj, mj) if ki == 0 else (ki, mi)
            return Sw[m] if kk == 1 else Cw[m]
        d, s = abs(mi - mj), mi + mj
        if ki == 1 and kj == 1:
            return 0.5 * (Cw[d] - Cw[s])
        if ki == 2 and kj == 2:
            return 0.5 * (Cw[d] + Cw[s])
        m_sin, m_cos = (mi, mj) if ki == 1 else (mj, mi)
        sgn = 0.0 if m_sin == m_cos else (1.0 if m_sin > m_cos else -1.0)
        return 0.5 * (Sw[s] + sgn * Sw[d])

    def xty_entry(i):
        kind, m = i
        if kind == 0:
            return yws[..., None]           # the same at every frequency
        return Sy[m] if kind == 1 else Cy[m]

    cols = ([(0, 0)] if fit_mean else []) + [
        (kind, m) for m in range(1, k + 1) for kind in (1, 2)]
    # the lower triangle only: the solve reads nothing else
    A_rows = [[xtx_entry(ci, cj) if j <= i else None
               for j, cj in enumerate(cols)] for i, ci in enumerate(cols)]
    b_rows = [xty_entry(ci) for ci in cols]
    powers = _chol_quadform_rows(A_rows, b_rows, rcond=float(rcond))
    powers = powers.expand(chi2_ref.shape + (Nf,))
    return _chi2_normalize(powers, chi2_ref, normalization)


def extirpolate(xi, frac, y, N, M=4):
    """Press & Rybicki Lagrange extirpolation onto a length-``N`` grid.

    The sample position is ``x = xi + frac`` with ``xi = floor(x)`` an
    integer tensor and ``frac`` in [0, 1) (split on the host in float64).
    ``y`` is (..., n) and real; samples with ``frac == 0`` are deposited
    exactly at ``xi``, the rest spread over ``M`` neighbours.  Returns
    (..., N).  Rows of a (B, n) ``y`` share the sample positions, as a
    stack of curves on one time grid does: each of the ``M + 1`` deposits
    is one ``index_add_`` along the last axis of a (B, N + 1) tensor whose
    last column takes the zero deposits.  The deposits are summed in
    float64 and the sums rounded once to ``y``'s dtype: on the card the
    atomic adds land in an order that changes from run to run and with the
    rows of the call, and float32 sums in that order moved a row's power
    at the lowest frequencies by parts in a thousand (the floating mean's
    terms cancel there).  Summed in float64, each row's result is the same
    whatever the run and whichever rows share the call.
    """
    is_int = frac == 0
    frac_f = torch.where(is_int, 0.5, frac)
    ilo = torch.clamp(xi - M // 2, 0, N - M)
    offs = ((xi - ilo)[..., None] + frac_f[..., None]
            - torch.arange(M, device=frac.device))
    prod = torch.prod(offs, dim=-1)
    result = y.new_zeros(y.shape[:-1] + (N + 1,), dtype=torch.float64)
    last = y.ndim - 1
    result.index_add_(last, torch.where(is_int, xi, N),
                      torch.where(is_int, y, 0.0).double())
    numerator = torch.where(is_int, 0.0, y) * prod
    denominator = float(factorial(M - 1))
    for j in range(M):
        if j > 0:
            denominator *= j / (j - M)
        ind = ilo + (M - 1 - j)
        result.index_add_(last, ind, (
            numerator / (denominator * ((xi - ind) + frac_f))).double())
    return result[..., :N].to(y.dtype)


#: the reference's name for the (B, n) case, which :func:`extirpolate`
#: covers
extirpolate_batched = extirpolate


#: host set-ups and their device copies, for repeated calls on one time
#: grid (sector sweeps, per-grid groups of a stack): keyed on the time
#: array's content and the grid geometry, dtype and device; bounded FIFO
_PRE_CACHE = {}
_PRE_CACHE_MAX = 64


def _remember(key, value):
    if len(_PRE_CACHE) >= _PRE_CACHE_MAX:
        _PRE_CACHE.pop(next(iter(_PRE_CACHE)))
    _PRE_CACHE[key] = value
    return value


def _fast_precompute_device(t, f0, df, Nf, oversampling, Mfft, dtype,
                            device):
    """:func:`fast_precompute`, cached, as tensors on ``device``: ``xi``
    int64, the fractions and phases in ``dtype`` (cast on the host, as
    the reference casts them), ``Nfft`` an int."""
    t = np.asarray(t)
    base_key = (hash(t.tobytes()), t.shape, t.dtype.str, float(f0),
                float(df), int(Nf), int(oversampling), int(Mfft), dtype)
    pre = _PRE_CACHE.get(("host",) + base_key)
    if pre is None:
        pre = fast_precompute(t, f0, df, Nf, oversampling, Mfft)
        np_dtype = numpy_dtype(dtype)
        pre = _remember(("host",) + base_key, dict(pre, **{
            k: pre[k].astype(np_dtype)
            for k in ("frac", "ph_hr", "ph_hi", "ph_fr", "ph_fi")}))
    key = ("device", str(device)) + base_key
    hit = _PRE_CACHE.get(key)
    if hit is None:
        hit = _remember(key, {
            k: v if k == "Nfft" else torch.as_tensor(
                v, dtype=torch.int64 if k == "xi" else dtype, device=device)
            for k, v in pre.items()})
    return hit


def fast_precompute(t, f0, df, Nf, oversampling=5, Mfft=4):
    """Host float64 set-up of :func:`lombscargle_fast`: each sample's grid
    position split into an int32 bin ``xi`` and a fraction ``frac``, the
    grid length ``Nfft``, and the unit-modulus phase corrections (as
    cosine and sine) that need float64."""
    t = np.asarray(t, dtype=np.float64)
    Nfft = _bitceil(Nf * oversampling)
    t0 = t.min()
    tnorm = ((t - t0) * Nfft * df) % Nfft
    xi = np.floor(tnorm)
    frac = tnorm - xi
    # a float64 frac within 2^-25 of 1.0 rounds to exactly 1.0 in float32,
    # which makes the Lagrange factor of the next grid point 0/0 = NaN, and
    # the FFT spreads it to every frequency: re-split such samples into the
    # next bin while still in float64
    carry = frac.astype(np.float32) >= 1.0
    xi = np.where(carry, (xi + 1) % Nfft, xi)
    frac = np.where(carry, 0.0, frac)
    f = f0 + df * np.arange(Nf)
    ang_h = 2 * np.pi * ((f0 * (t - t0)) % 1.0)
    ang_f = 2 * np.pi * ((t0 * f) % 1.0)
    return dict(
        xi=xi.astype(np.int32), frac=frac, Nfft=Nfft,
        ph_hr=np.cos(ang_h), ph_hi=np.sin(ang_h),
        ph_fr=np.cos(ang_f), ph_fi=np.sin(ang_f),
    )


def _trig_sum(pre, h, Nf, Mfft):
    """(S, C) = sum h sin/cos(2 pi f t) on the regular grid of ``pre``
    (from :func:`_fast_precompute_device`), for ``h`` (n,) or (B, n): the
    phase-shifted payloads extirpolated, one complex inverse FFT, the
    frequency phases applied."""
    Nfft = pre["Nfft"]
    hr = h * pre["ph_hr"]
    hi = h * pre["ph_hi"]
    g = torch.complex(extirpolate(pre["xi"], pre["frac"], hr, Nfft, Mfft),
                      extirpolate(pre["xi"], pre["frac"], hi, Nfft, Mfft))
    spec = torch.fft.ifft(g)[..., :Nf]
    fr, fi = spec.real, spec.imag
    out_r = fr * pre["ph_fr"] - fi * pre["ph_fi"]
    out_i = fr * pre["ph_fi"] + fi * pre["ph_fr"]
    return Nfft * out_i, Nfft * out_r


def trig_sum(t, h, df, Nf, f0=0.0, freq_factor=1, oversampling=5, Mfft=4,
             device=None):
    """(S, C) = sum h sin/cos(2 pi f t) at f = freq_factor·(f0 + df·[0,
    Nf)): the float64 set-up on the host, the sums on ``h``'s device
    (``device`` as in :func:`lombscargle_direct`)."""
    h = on_device(h, device)
    pre = _fast_precompute_device(_host(t), f0 * freq_factor,
                                  df * freq_factor, Nf, oversampling, Mfft,
                                  h.dtype, h.device)
    return _trig_sum(pre, h, Nf, Mfft)


def _row_sum(x):
    """Each row's sum (keeping the last axis), summed in float64 and
    rounded once to ``x``'s dtype: the card's reduction order depends on
    the number of rows, and float32 sums in either order differ."""
    return torch.sum(x, dim=-1, keepdim=True, dtype=torch.float64).to(
        x.dtype)


def lombscargle_fast(t, y, f0, df, Nf, dy=None, normalization="standard",
                     fit_mean=True, center_data=True, oversampling=5, Mfft=4,
                     device=None):
    """Press-Rybicki fast Lomb-Scargle on the regular grid
    ``f0 + df * [0, Nf)``.

    ``t`` is the (n,) time grid (host array or tensor; set up in float64
    on the host); ``y`` (n,) or (B, n) fluxes on it, whose device and
    dtype set the computation's; ``dy`` None, (n,) or (B, n) (``inf``
    masks a sample).  Accuracy against :func:`lombscargle_direct` is set
    by ``oversampling`` and ``Mfft``, as in astropy's 'fast' method.
    ``device`` as in :func:`lombscargle_direct`.  Returns powers shaped
    like ``y`` with ``Nf`` frequencies.  The sums over each curve are
    made in float64 (:func:`extirpolate`, :func:`_row_sum`), so a curve's
    power does not depend on the other curves of the call.
    """
    t = _host(t)
    y = on_device(y, device)
    if dy is None:
        w = torch.ones_like(y)
    else:
        w = (1.0 / torch.square(_like(dy, y))).expand(y.shape)
    pre1 = _fast_precompute_device(t, f0, df, Nf, oversampling, Mfft,
                                   y.dtype, y.device)
    pre2 = _fast_precompute_device(t, 2 * f0, 2 * df, Nf, oversampling,
                                   Mfft, y.dtype, y.device)

    ws = _row_sum(w)
    if center_data or fit_mean:
        y = y - _row_sum(w * y) / ws
    Sh, Ch = _trig_sum(pre1, w * y, Nf, Mfft)
    S2, C2 = _trig_sum(pre2, w, Nf, Mfft)
    if fit_mean:
        S, C = _trig_sum(pre1, w, Nf, Mfft)
        tan_2omega_tau = (S2 - 2 * S * C / ws) / (C2 - (C * C - S * S) / ws)
    else:
        tan_2omega_tau = S2 / C2
    norm = torch.sqrt(1 + tan_2omega_tau * tan_2omega_tau)
    C2w = 1.0 / norm
    S2w = tan_2omega_tau / norm
    Cw = np.sqrt(0.5) * torch.sqrt(1 + C2w)
    Sw = np.sqrt(0.5) * torch.sign(S2w) * torch.sqrt(1 - C2w)
    YY = _row_sum(w * y * y)
    YC = Ch * Cw + Sh * Sw
    YS = Sh * Cw - Ch * Sw
    CC = 0.5 * (ws + C2 * C2w + S2 * S2w)
    SS = 0.5 * (ws - C2 * C2w - S2 * S2w)
    if fit_mean:
        CC = CC - (C * Cw + S * Sw) ** 2 / ws
        SS = SS - (S * Cw - C * Sw) ** 2 / ws
    power = YC * YC / CC + YS * YS / SS
    return _apply_normalization(power, YY, normalization, 1.0)
