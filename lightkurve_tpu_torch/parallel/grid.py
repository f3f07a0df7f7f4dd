"""Mesh construction and sharded searches on ``torch.distributed``.

Counterpart of ``lightkurve_tpu/parallel/grid.py``.  The mesh has the
reference's two axes:

- ``targets``: data parallelism over light curves (each shard holds a
  block of rows of the (B, N) stack);
- ``grid``: the period axis of the search, each shard scanning its block
  of trial periods against its rows.

The reference is single-controller (``shard_map``: one process holds the
whole arrays and gets the whole result).  Here every rank is a process
(one per device, or several sharing one card) in an initialised process
group, and the call shape is kept: every rank calls a sharded function
with the WHOLE arrays, computes the block its mesh coordinate names with
the single-device functions (``ops.bls``, ``ops.lombscargle``,
``ops.detrend``, ``TPFStack.pld_correct``), and gets the WHOLE result back
through one gather per mesh axis.  There are no collectives before that
gather, as in the reference.  The caller initialises the process group
(``torchrun`` style); nothing here starts one.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from ..config import resolve_device
from ..diagnostics import span
from .checkpoint import _FIELDS

__all__ = ["Mesh", "make_mesh", "sharded_bls", "sharded_lombscargle",
           "sharded_flatten", "sharded_pld_photometry", "best_candidates"]

AXES = ("targets", "grid")


def _grouped():
    return dist.is_available() and dist.is_initialized()


class Mesh:
    """A (targets, grid) mesh of ranks.

    Attributes
    ----------
    shape : ``{"targets": nt, "grid": ng}``, as the reference's
        ``mesh.shape``.
    ranks : (nt, ng) int array of the global ranks on the mesh.
    coordinate : this rank's (targets, grid) index, ``None`` off the mesh.
    device : this rank's torch device.
    device_mesh : the ``torch.distributed.device_mesh.DeviceMesh`` it
        wraps (``mesh_dim_names=("targets", "grid")``), ``None`` for the
        1x1 mesh of a process without a process group.

    Each gather through the mesh is a span ``mesh.gather`` (attributes
    ``axis``, ``ranks``; :mod:`lightkurve_tpu_torch.diagnostics`), from
    the end of this rank's device work to the gathered result.
    """

    def __init__(self, ranks, device, device_mesh=None):
        self.ranks = np.asarray(ranks, dtype=int)
        nt, ng = self.ranks.shape
        self.shape = {"targets": nt, "grid": ng}
        self.device = device
        self.device_mesh = device_mesh
        rank = dist.get_rank() if device_mesh is not None else 0
        hit = np.argwhere(self.ranks == rank)
        self.coordinate = tuple(int(c) for c in hit[0]) if len(hit) else None

    def __repr__(self):
        return (f"Mesh({self.shape}, coordinate={self.coordinate}, "
                f"device={self.device})")

    @property
    def is_lead(self):
        """Whether this rank is the mesh's first, the one that writes
        files for the mesh."""
        return self.coordinate == (0, 0)

    def _member(self):
        if self.coordinate is None:
            raise ValueError(f"rank {dist.get_rank()} is not on the mesh "
                             f"{self.ranks.tolist()}")
        return self.coordinate

    def gather(self, x, axis):
        """``x`` of every rank along mesh ``axis`` (``"targets"`` or
        ``"grid"``) with this rank's other coordinate, in coordinate
        order: one ``all_gather`` within the axis's group.  Every block
        must have one shape."""
        size = self.shape[axis]
        if size == 1:
            return [x]
        group = self.device_mesh.get_group(axis)
        x = x.contiguous()
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
        with span("mesh.gather", axis=axis, ranks=size):
            blocks = [torch.empty_like(x) for _ in range(size)]
            dist.all_gather(blocks, x, group=group)
        dim = AXES.index(axis)
        # the group's ranks in group-rank order, each put at its coordinate
        order = [int(np.argwhere(self.ranks == r)[0][dim])
                 for r in dist.get_process_group_ranks(group)]
        out = [None] * size
        for i, pos in enumerate(order):
            out[pos] = blocks[i]
        return out

    def barrier(self):
        """Wait for every rank of the mesh: a barrier along one axis, then
        along the other, reaches every rank."""
        if self.device_mesh is None:
            return
        for axis in AXES:
            if self.shape[axis] > 1:
                dist.barrier(group=self.device_mesh.get_group(axis))


def _rank_device():
    """This rank's device: :data:`config.default_device` (a CUDA device
    raises without CUDA); a CUDA device without an index is
    ``cuda:(local rank % devices)``, so ranks of one host share its cards
    round robin."""
    dev = resolve_device()
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def make_mesh(n_targets_axis=None, n_grid_axis=None, devices=None):
    """Create a (targets, grid) mesh over the ranks.

    ``devices`` are ranks of the initialised default process group (default
    all of them; every rank of the group calls this, in the same order).
    Defaults, as the reference's: every rank on the ``grid`` axis (period
    sharding).  Without a process group the mesh is 1x1 on
    :data:`config.default_device` (the card, raising where there is none
    unless the caller set ``"cpu"``).  With one, each rank's device is
    that device with the rank's index (:func:`_rank_device`).
    """
    grouped = _grouped()
    if devices is None:
        devices = list(range(dist.get_world_size())) if grouped else [0]
    n = len(devices)
    if n_targets_axis is None and n_grid_axis is None:
        n_targets_axis, n_grid_axis = 1, n
    elif n_targets_axis is None:
        n_targets_axis = n // n_grid_axis
    elif n_grid_axis is None:
        n_grid_axis = n // n_targets_axis
    if n_targets_axis * n_grid_axis != n:
        raise ValueError(f"mesh {n_targets_axis}x{n_grid_axis} != {n} "
                         "devices")
    ranks = np.asarray(devices, dtype=int).reshape(n_targets_axis,
                                                   n_grid_axis)
    if not grouped:
        if n != 1:
            raise ValueError(f"a mesh of {n} ranks needs an initialised "
                             "process group")
        return Mesh(ranks, resolve_device())
    from torch.distributed.device_mesh import DeviceMesh
    dev = _rank_device()
    dm = DeviceMesh(dev.type, torch.as_tensor(ranks),
                    mesh_dim_names=AXES)
    return Mesh(ranks, dev, dm)


def _default_targets_mesh(mesh):
    """The reference's default of the targets-only functions: every rank
    on the ``targets`` axis."""
    if mesh is not None:
        return mesh
    n = dist.get_world_size() if _grouped() else 1
    return make_mesh(n_targets_axis=n, n_grid_axis=1)


def _block(x, lo, hi, device, pad=None, repeat_first=False):
    """Rows ``lo:hi`` of ``x`` (host array or tensor) as a tensor on
    ``device``; rows past the end are ``pad``, or with ``repeat_first`` row
    0 again."""
    n = x.shape[0]
    if isinstance(x, torch.Tensor):
        part = x[lo:min(hi, n)].to(device)
        first = x[:1].to(device)
    else:
        part = torch.as_tensor(np.ascontiguousarray(x[lo:min(hi, n)]),
                               device=device)
        first = torch.as_tensor(np.ascontiguousarray(x[:1]), device=device)
    extra = hi - max(lo, n) if hi > n else 0
    if extra <= 0:
        return part
    shape = (extra,) + tuple(part.shape[1:])
    fill = (first.expand(shape) if repeat_first
            else torch.full(shape, pad, dtype=part.dtype, device=device))
    return torch.cat([part, fill])


def _targets_block(mesh, B):
    """This rank's rows (lo, hi) of a B-row stack padded to a multiple of
    the ``targets`` axis."""
    ti = mesh._member()[0]
    nt = mesh.shape["targets"]
    bs = -(-B // nt)
    return ti * bs, (ti + 1) * bs


def _gather_targets(mesh, parts, B):
    """Every rank's fields ``parts`` (tensors of this rank's rows) along
    the ``targets`` axis, trimmed to B rows.  Ranks of one grid coordinate
    gather among themselves: on a 2-D mesh the result on each rank is
    assembled from the copies its own grid column computed (the other
    columns computed the same rows)."""
    dtype = parts[0].dtype
    x = torch.stack([p.to(dtype) for p in parts])
    out = torch.cat(mesh.gather(x, "targets"), dim=1)[:, :B]
    return [o.to(p.dtype) if p.dtype == torch.bool else o
            for o, p in zip(out, parts)]


def sharded_bls(time, flux, dy, periods, durations, oversample=10,
                objective="likelihood", mesh=None, chunk=16,
                shared_time=None, uniform_weights=None):
    """BLS over (B, N) stacks x (P,) periods, sharded over the mesh.

    Every rank passes the whole arrays (host arrays or tensors); targets
    shard over the ``targets`` axis, the period grid over the ``grid``
    axis.  Returns the same dict as ``ops.bls.bls_power`` with (B, P)
    tensors on the mesh's device, on every rank (padded rows and periods
    trimmed).  When the batch shares one time grid each shard runs
    ``ops.bls.bls_power_shared_batch`` (whose route rule picks the fused
    kernel or the staged route for the shard's curves and periods), else
    the per-curve exact ``ops.bls.bls_power``.
    """
    from ..ops.bls import (_detect_uniform_weights, _host_f64, bls_power,
                           bls_power_shared_batch)
    mesh = make_mesh() if mesh is None else mesh
    ng = mesh.shape["grid"]
    gi = mesh._member()[1]
    B, N = flux.shape
    # the regime is read from host arrays only, before any padding; pass
    # uniform_weights=True for per-curve-constant weights held as tensors
    if uniform_weights is None:
        uniform_weights = (_detect_uniform_weights(dy)
                           if dy is None or isinstance(dy, np.ndarray)
                           else False)
    # shared-time detection before padding; the padded rows repeat row 0
    # so a padded block keeps the property
    if shared_time is None:
        shared_time = bool((time == time[0:1]).all())
    p_all = (periods.cpu().numpy() if isinstance(periods, torch.Tensor)
             else np.asarray(periods))
    Pn = p_all.shape[0]
    ps = -(-Pn // ng)
    p_blk = p_all[gi * ps:(gi + 1) * ps]
    p_blk = np.concatenate([p_blk, np.full(ps - len(p_blk), p_all[-1],
                                           p_all.dtype)])
    # the grid geometry comes from the whole period array, before it is
    # split, so every shard folds into the same bins
    d_phase = float(np.min(_host_f64(durations))) / oversample
    nbins = int(np.ceil(float(np.max(p_all)) / d_phase))

    lo, hi = _targets_block(mesh, B)
    dev = mesh.device
    t = _block(time, lo, hi, dev, repeat_first=True)
    y = _block(flux, lo, hi, dev, pad=0.0)
    d = None if dy is None else _block(dy, lo, hi, dev, pad=np.inf)
    if shared_time:
        out = bls_power_shared_batch(
            t[0], y, d, p_blk, durations, oversample=oversample,
            objective=objective, nbins=nbins, d_phase=d_phase,
            uniform_weights=uniform_weights)
    else:
        out = bls_power(t, y, d, p_blk, durations, oversample=oversample,
                        objective=objective, chunk=chunk,
                        t0_count=nbins + 1, d_phase=d_phase)
    x = torch.stack([out[f] for f in _FIELDS])        # (F, B/nt, P/ng)
    del out
    x = torch.cat(mesh.gather(x, "grid"), dim=2)
    x = torch.cat(mesh.gather(x, "targets"), dim=1)
    return {f: x[i, :B, :Pn] for i, f in enumerate(_FIELDS)}


def sharded_lombscargle(time_row, flux, dy, f0, df, Nf, mesh=None,
                        normalization="psd"):
    """Batched fast Lomb-Scargle with targets sharded over the mesh's
    ``targets`` axis (default: every rank on it).

    The frequency grid is whole on every shard (the extirpolation FFT is
    global over the grid); each shard transforms its rows.  Returns the
    (B, Nf) power on the mesh's device, on every rank."""
    from ..ops.lombscargle import lombscargle_fast
    mesh = _default_targets_mesh(mesh)
    B = flux.shape[0]
    lo, hi = _targets_block(mesh, B)
    y = _block(flux, lo, hi, mesh.device, pad=0.0)
    d = _block(dy, lo, hi, mesh.device, pad=np.inf)
    t_host = np.asarray(time_row.cpu() if isinstance(time_row, torch.Tensor)
                        else time_row, dtype=np.float64)
    power = lombscargle_fast(t_host, y, f0, df, Nf, dy=d,
                             normalization=normalization)
    return _gather_targets(mesh, [power], B)[0]


def sharded_flatten(time, flux, mask, window_length=101, polyorder=2,
                    break_tolerance=5, niters=3, sigma=3, mesh=None):
    """Batched SG flatten with targets sharded over the mesh's ``targets``
    axis (default: every rank on it).

    Purely data-parallel: each shard runs ``ops.detrend.flatten_batch`` on
    its rows (padded rows: time, flux 1 and every sample valid).  Returns
    (trend, valid) as (B, N) tensors on the mesh's device, on every
    rank."""
    from ..ops.detrend import flatten_batch
    from ..ops.savgol import savgol_design_matrix
    mesh = _default_targets_mesh(mesh)
    B = flux.shape[0]
    lo, hi = _targets_block(mesh, B)
    dev = mesh.device
    t = _block(time, lo, hi, dev, pad=1.0)
    y = _block(flux, lo, hi, dev, pad=1.0)
    m = _block(mask, lo, hi, dev, pad=True)
    H = savgol_design_matrix(window_length,
                             min(polyorder, window_length - 1))
    bt = np.nan if break_tolerance is None else float(break_tolerance)
    trend, valid = flatten_batch(t, y, m, H, bt, float(sigma),
                                 niters=int(niters))
    return tuple(_gather_targets(mesh, [trend, valid], B))


def sharded_pld_photometry(tpf_stack, pld_order=1, n_pca_terms=3,
                           sigma=5.0, niters=5, mesh=None):
    """Aperture photometry + batched PLD with targets sharded over the
    mesh's ``targets`` axis (default: every rank on it).

    Each shard runs ``TPFStack.pld_correct`` on its targets (padded
    targets: flux, errors and times 1, the whole cutout as aperture);
    targets are independent, so nothing is exchanged before the gather.
    Returns (corrected flux, flux_err, mask) as (B, T) tensors on the
    mesh's device, on every rank."""
    from ..batch import TPFStack
    mesh = _default_targets_mesh(mesh)
    B = tpf_stack.flux.shape[0]
    lo, hi = _targets_block(mesh, B)
    dev = mesh.device
    shard = TPFStack(flux=_block(tpf_stack.flux, lo, hi, dev, pad=1.0),
                     flux_err=_block(tpf_stack.flux_err, lo, hi, dev,
                                     pad=1.0),
                     time=_block(tpf_stack.time, lo, hi, dev, pad=1.0),
                     aperture=_block(tpf_stack.aperture, lo, hi, dev,
                                     pad=True))
    out = shard.pld_correct(pld_order=pld_order, n_pca_terms=n_pca_terms,
                            sigma=sigma, niters=niters)
    return tuple(_gather_targets(mesh, [out.flux, out.flux_err, out.mask],
                                 B))


def best_candidates(power, periods, k=1):
    """Per-target top-k periods from a (B, P) power array (host-side)."""
    power = np.asarray(power.cpu() if isinstance(power, torch.Tensor)
                       else power)
    periods = np.asarray(periods.cpu() if isinstance(periods, torch.Tensor)
                         else periods)
    idx = np.argsort(power, axis=1)[:, ::-1][:, :k]
    return periods[idx], np.take_along_axis(power, idx, axis=1)
