"""Seeded light curves of a configuration, made on the device.

A frozen copy of the idea of ``lightkurve_tpu_torch``'s seeded generators
(the synthetic sector of ``tools/make_sector.py`` and ``chip_smoke.py``
phase 10's SPOC-like model), written here so that no change to the
program changes the data a cell reads.  A configuration's ``time`` block
gives the one time grid every curve shares; its ``assumed`` block gives
the model of each curve:

- per-cadence uncertainties ``flux_err[0..1] x flux_err[2]``;
- a stellar trend, a sinusoid of ``rotation_amplitude`` at a period in
  ``rotation_period_days`` and a linear drift of up to ``drift`` over the
  baseline;
- one box transit per curve, its depth, period and epoch drawn per curve;
- white noise at the uncertainties, ``outlier_share`` of the cadences
  raised by ``outlier_sigma`` uncertainties;
- exactly ``round(masked_share * n)`` masked cadences per curve, at random
  places, so that every curve and every seed has the same number of
  valid cadences (the same shapes).

Every draw comes from a ``torch.Generator`` on the device, seeded from the
run's seed and the name of the stream, in a few calls of the whole
stack's size.
"""
from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

__all__ = ["time_grid", "stream_seed", "generator", "make_stack",
           "period_grid", "masked_count"]


def time_grid(cfg):
    """The configuration's shared time grid, a float64 host array: each
    ``[offset, count]`` segment is ``count`` cadences from
    ``start + offset``."""
    tb = cfg["time"]
    cad = float(tb["cadence_days"])
    parts = [float(tb["start"]) + float(off) + cad * np.arange(int(cnt))
             for off, cnt in tb["segments"]]
    return np.concatenate(parts)


def stream_seed(seed, stream):
    """A 63-bit seed for the named stream of run ``seed`` (any integer)."""
    digest = hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed, stream, device):
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream))
    return g


def masked_count(cfg, n):
    return int(round(float(cfg["assumed"]["masked_share"]) * n))


def _uniform(g, shape, lo, hi, device, dtype=torch.float64):
    u = torch.rand(shape, generator=g, device=device, dtype=dtype)
    return lo + (hi - lo) * u


def make_stack(cfg, seed, stream, curves, device, t=None):
    """One stack of ``curves`` curves of the configuration's model.

    Returns a dict of device tensors in float32 -- ``flux``, ``flux_err``
    (B, n) and ``mask`` (B, n, True where valid) -- with the host float64
    time grid ``time`` (n,) and the truth (host float64 arrays:
    ``period``, ``epoch``, ``depth``).  Masked cadences hold flux 0 and
    flux_err 1, the stack convention of ``LightCurveStack``."""
    a = cfg["assumed"]
    if t is None:
        t = time_grid(cfg)
    n = t.size
    B = int(curves)
    g = generator(seed, stream, device)
    f64 = torch.float64
    tt = torch.as_tensor(t - t[0], dtype=f64, device=device)
    span = float(t[-1] - t[0])
    lo, hi, sigma0 = (float(v) for v in a["flux_err"])
    dy = sigma0 * _uniform(g, (B, n), lo, hi, device, torch.float32)
    amp = _uniform(g, (B, 1), *a["rotation_amplitude"], device)
    p_rot = _uniform(g, (B, 1), *a["rotation_period_days"], device)
    phase = _uniform(g, (B, 1), 0.0, 2 * math.pi, device)
    drift = _uniform(g, (B, 1), -float(a["drift"]), float(a["drift"]),
                     device)
    period = _uniform(g, (B, 1), *a["transit_period_days"], device)
    epoch = period * torch.rand((B, 1), generator=g, device=device,
                                dtype=f64)
    depth = _uniform(g, (B, 1), *a["transit_depth"], device)
    half = 0.5 * float(a["transit_duration_days"])
    trend = (1.0 + amp * torch.sin(2 * math.pi * tt / p_rot + phase)
             + drift * tt / span)
    ph = torch.remainder(tt - epoch + 0.5 * period, period) - 0.5 * period
    flux = (1.0 - depth * (ph.abs() < half)) * trend
    del trend, ph
    flux += dy * torch.randn((B, n), generator=g, device=device,
                             dtype=torch.float32)
    out = torch.rand((B, n), generator=g, device=device) < float(
        a["outlier_share"])
    flux += out * (float(a["outlier_sigma"]) * dy)
    del out
    m = masked_count(cfg, n)
    order = torch.argsort(torch.rand((B, n), generator=g, device=device),
                          dim=1)
    mask = torch.ones((B, n), dtype=torch.bool, device=device)
    mask.scatter_(1, order[:, :m], False)
    del order
    flux = flux.to(torch.float32)
    flux = torch.where(mask, flux, 0.0)
    dy = torch.where(mask, dy, 1.0)
    return dict(time=t, flux=flux, flux_err=dy, mask=mask,
                period=period[:, 0].cpu().numpy(),
                epoch=(epoch[:, 0].cpu().numpy() + t[0]),
                depth=depth[:, 0].cpu().numpy())


def period_grid(cfg, t=None):
    """The configuration's trial periods (float64 host array): lightkurve's
    default grid (``autoperiod``: evenly spaced in frequency, from
    max(4 median dt, max duration + median dt) to a third of the
    baseline, spacing ``frequency_factor x min duration / baseline**2``)
    or an explicit ``linspace``."""
    spec = cfg["search"]["periods"]
    if spec["kind"] == "linspace":
        return np.linspace(float(spec["start"]), float(spec["stop"]),
                           int(spec["num"]))
    if spec["kind"] != "autoperiod":
        raise ValueError(f"unknown period grid kind {spec['kind']!r}")
    if t is None:
        t = time_grid(cfg)
    durations = np.asarray(cfg["search"]["durations"], np.float64)
    return autoperiod(t, durations, float(spec["frequency_factor"]))


def autoperiod(t, durations, frequency_factor=10.0):
    """lightkurve's default BLS grid for times ``t`` (its
    ``from_lightcurve`` with astropy's ``autoperiod``)."""
    t = np.asarray(t, np.float64)
    dt = np.median(np.diff(t))
    min_period = max(dt * 4, np.max(durations) + dt)
    baseline = np.max(t) - np.min(t)
    max_period = baseline / 3.0
    df = frequency_factor * np.min(durations) / baseline ** 2
    f_max, f_min = 1.0 / min_period, 1.0 / max_period
    nf = 1 + int(np.round((f_max - f_min) / df))
    return 1.0 / (f_max - df * np.arange(nf))
