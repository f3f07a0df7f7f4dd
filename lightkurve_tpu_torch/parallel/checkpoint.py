"""Checkpointed period-grid sweeps.

Counterpart of ``lightkurve_tpu/parallel/checkpoint.py``.
:class:`SweepRunner` walks a large period grid in chunks, reduces each
chunk's (B, P_chunk) BLS grids to per-curve winners on the device, keeps
the best-so-far winners on the host, and persists them (npz, the same
layout as ``lightkurve_tpu``'s) after every chunk, so an interrupted sweep
resumes from the last finished chunk -- including a sweep that
``lightkurve_tpu`` started.  Methods: ``"shared"`` (the shared-time-grid
kernels; a stack of several grids runs one shared-grid search per grid),
``"fast"`` (binned per-curve search) and ``"exact"`` (sorted-phase
per-curve search).  Given a mesh (:func:`.grid.make_mesh`), every rank of
the mesh runs the sweep with the whole stack and each chunk goes through
:func:`.grid.sharded_bls`; every rank holds the whole state, the mesh's
first rank writes the checkpoint, and every rank reads it on resume.
"""
from __future__ import annotations

import logging
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..config import numpy_dtype
from ..diagnostics import count, span

log = logging.getLogger(__name__)

__all__ = ["SweepRunner", "shared_sweep_geometries", "prewarm_shared_sweep"]

METHODS = ("shared", "fast", "exact")

_FIELDS = ("power", "depth", "depth_err", "depth_snr", "log_likelihood",
           "duration", "transit_time", "period")


def _reduce_winner(out, n_valid):
    """Device-side winner reduction: ONE stacked (F, B) tensor, the
    fields at each curve's first maximum of power over the first
    ``n_valid`` periods."""
    power = out["power"]
    cols = torch.arange(power.shape[1], device=power.device)
    power = torch.where(cols[None, :] < n_valid, power, -torch.inf)
    idx = torch.argmax(power, dim=1)[:, None]
    return torch.stack([torch.gather(out[f], 1, idx)[:, 0]
                        for f in _FIELDS])


def _host_bool(x):
    """A one-element device tensor read on the host, which waits for the
    device: counted as ``host_sync``."""
    count("host_sync")
    return bool(x)


def _k_max(durations, d_phase):
    return max(int(max(int(d / d_phase + 0.5), 1)) for d in durations)


def _chunk_nbins(pvals, d_phase, k_max):
    """The shared step's fold size for a chunk: its largest period's bins,
    quantized so bins plus wrap rows fill whole 128-row tiles."""
    nb = int(np.ceil(float(np.max(pvals)) / d_phase))
    tiles = max((nb + k_max - 1 + 127) // 128, 1)
    return tiles * 128 - (k_max - 1)


def shared_sweep_geometries(periods, durations, chunk_periods,
                            oversample=10):
    """The distinct (d_phase, nb_q, chunk periods) fold geometries a shared
    sweep over ``periods`` uses, in grid (= execution) order: the shared
    step sizes its fold per chunk (:func:`_chunk_nbins`), knowable up
    front from the grid alone."""
    periods = np.asarray(periods, dtype=np.float64)
    durations = np.asarray(durations, dtype=np.float64)
    d_phase = float(durations.min()) / oversample
    k_max = _k_max(durations, d_phase)
    geoms, seen = [], set()
    for lo in range(0, len(periods), chunk_periods):
        chunk = periods[lo:lo + chunk_periods]
        nb_q = _chunk_nbins(chunk, d_phase, k_max)
        if nb_q not in seen:
            seen.add(nb_q)
            geoms.append((d_phase, nb_q, chunk))
    return geoms


def prewarm_shared_sweep(device="cuda", wait=False):
    """Build and load the kernel library on one background thread, so the
    build overlaps the host work before the first chunk (the first batch's
    FITS parse).  Nothing else is compiled per shape.  Returns the list of
    futures (``[]`` for a CPU device, which needs no kernels);
    ``wait=True`` blocks until they are done.  The build holds a lock, so
    a sweep that needs the library meanwhile waits for this build."""
    if torch.device(device).type != "cuda":
        return []
    from ..ops._build import cuda_library
    pool = ThreadPoolExecutor(1, thread_name_prefix="lk-torch-prewarm")
    futures = [pool.submit(cuda_library)]
    pool.shutdown(wait=False)                  # the thread ends with its job
    if wait:
        for f in futures:
            f.result()
    return futures


class SweepRunner:
    """Chunked, resumable BLS sweep over a huge period grid.

    Parameters
    ----------
    stack : `~lightkurve_tpu_torch.batch.LightCurveStack`.
    periods : (P,) full period grid (float64 host array).
    durations : (D,) durations.
    checkpoint_path : str — npz file updated after each chunk.
    chunk_periods : int — grid points per device step.
    method : ``"fast"`` (binned per-curve search, the default),
        ``"exact"`` (sorted-phase per-curve search) or ``"shared"`` (the
        shared-time-grid kernels; rows on different grids run one
        shared-grid search per grid).
    async_save : write the npz on a background thread (one write in
        flight), so checkpoint IO overlaps device compute.
    mesh : a (targets, grid) mesh of ranks (:func:`.grid.make_mesh`):
        every rank of it builds its runner on the same stack and
        checkpoint path and runs it; each chunk, whatever the method, is
        one :func:`.grid.sharded_bls` call (the shared-grid search for a
        stack on one time grid, else the per-curve exact search).
    """

    def __init__(self, stack, periods, durations, checkpoint_path,
                 chunk_periods=4096, oversample=10, objective="likelihood",
                 method="fast", save_every=1, mesh=None, async_save=False):
        if method not in METHODS:
            raise ValueError(f"method must be one of {METHODS} "
                             f"(got {method!r})")
        self.stack = stack
        self.mesh = mesh
        self.periods = np.asarray(periods, dtype=np.float64)
        self.durations = np.asarray(durations, dtype=np.float64)
        self.checkpoint_path = checkpoint_path
        self.chunk_periods = int(chunk_periods)
        self.oversample = oversample
        self.objective = objective
        self.method = method
        self.save_every = max(int(save_every), 1)
        self.async_save = bool(async_save)
        self._save_pool = None
        self._pending_save = None
        B = len(stack)
        self.state = {f: np.full(B, np.nan) for f in _FIELDS}
        self.state["power"] = np.full(B, -np.inf)
        self.next_chunk = 0
        if os.path.exists(checkpoint_path):
            self._load()

    @property
    def n_chunks(self):
        return -(-len(self.periods) // self.chunk_periods)

    @property
    def done(self):
        return self.next_chunk >= self.n_chunks

    def prewarm(self, wait=False):
        """Start building this sweep's kernels on a background thread
        (shared method on the card, no mesh; see
        :func:`prewarm_shared_sweep`).  Returns the futures, ``[]`` where
        nothing is built."""
        if self.method != "shared" or self.mesh is not None:
            return []
        return prewarm_shared_sweep(self.stack.device, wait=wait)

    def _load(self):
        data = np.load(self.checkpoint_path)
        if len(data["periods"]) != len(self.periods) or not np.allclose(
                data["periods"], self.periods):
            log.warning("Checkpoint grid differs; starting fresh.")
            return
        # next_chunk is a chunk INDEX, meaningful only under the chunking
        # it was written with; checkpoints without the field restart
        ckpt_cp = int(data["chunk_periods"]) if "chunk_periods" in data \
            else -1
        if ckpt_cp != self.chunk_periods:
            log.warning(
                "Checkpoint chunk_periods %s differs from configured %d; "
                "starting fresh to keep grid coverage exact.", ckpt_cp,
                self.chunk_periods)
            return
        for f in _FIELDS:
            self.state[f] = data[f]
        self.next_chunk = int(data["next_chunk"])
        log.info("Resumed sweep at chunk %d/%d", self.next_chunk,
                 self.n_chunks)

    def _write_npz(self, payload):
        tmp = self.checkpoint_path + ".tmp.npz"   # .npz suffix: savez
        np.savez(tmp, **payload)                   # won't append another
        os.replace(tmp, self.checkpoint_path)

    def _save(self):
        if self.mesh is not None and not self.mesh.is_lead:
            return                      # one rank writes the mesh's file
        with span("sweep.save"):
            # _merge REPLACES the state arrays, so this snapshot by
            # reference stays consistent while a background write reads it
            payload = dict(periods=self.periods, next_chunk=self.next_chunk,
                           chunk_periods=self.chunk_periods, **self.state)
            if not self.async_save:
                self._write_npz(payload)
                return
            if self._save_pool is None:
                self._save_pool = ThreadPoolExecutor(
                    1, thread_name_prefix="lk-torch-sweep-ckpt")
            if self._pending_save is not None:
                self._pending_save.result()        # one write in flight
            self._pending_save = self._save_pool.submit(self._write_npz,
                                                        payload)

    def flush_saves(self):
        """Block until any in-flight checkpoint write lands, and stop the
        writer thread."""
        if self._pending_save is not None:
            self._pending_save.result()
            self._pending_save = None
        if self._save_pool is not None:
            self._save_pool.shutdown()
            self._save_pool = None

    def _make_step(self):
        """One chunk step: the BLS over a period chunk and the device-side
        winner reduction.  Returns a function of (host periods, n_valid)
        giving the (F, B) winners on the device."""
        from ..ops.bls import bls_power_shared_batch
        stack = self.stack
        dtype = stack.flux.dtype
        d_phase = float(self.durations.min()) / self.oversample
        # durations enter the search in the data dtype, as the reference's
        # step passes them
        durs = self.durations.astype(numpy_dtype(dtype))
        dy = torch.where(stack.mask, stack.flux_err,
                         torch.tensor(torch.inf, dtype=dtype,
                                      device=stack.device))
        if self.mesh is not None:
            return self._make_mesh_step(dy)
        if self.method != "shared":
            return self._make_percurve_step(d_phase, durs, dy)
        # per-curve-constant weights (all cadences valid, row-constant
        # flux_err) take the uniform regime
        err = stack.flux_err
        uniform = _host_bool(torch.all(stack.mask)) and _host_bool(
            torch.all(err == err[:, :1]))
        k_max = _k_max(self.durations, d_phase)
        oversample, objective = self.oversample, self.objective

        def search(t_row, flux, dy_rows, pvals, n_valid):
            out = bls_power_shared_batch(
                t_row, flux, dy_rows, pvals, durs, oversample=oversample,
                objective=objective, d_phase=d_phase,
                nbins=_chunk_nbins(pvals, d_phase, k_max), chunk=8,
                uniform_weights=uniform)
            return _reduce_winner(out, n_valid)

        time = stack.time
        if not _host_bool(torch.all(time == time[0:1])):
            return self._make_bucketed_step(search, dy)
        t_row = time[0].to(dtype)
        return lambda pvals, n_valid: search(t_row, stack.flux, dy, pvals,
                                             n_valid)

    def _make_mesh_step(self, dy):
        """The step on a mesh: every method through
        :func:`.grid.sharded_bls`, whose fold size is the chunk's own
        ``ceil(max(chunk) / d_phase)``, and the winner reduction on the
        gathered (B, P_chunk) result, on every rank."""
        from .grid import sharded_bls
        stack = self.stack
        err = stack.flux_err
        uniform = _host_bool(torch.all(stack.mask)) and _host_bool(
            torch.all(err == err[:, :1]))
        shared = _host_bool(torch.all(stack.time == stack.time[0:1]))
        # the durations stay a host float64 array: sharded_bls derives the
        # grid geometry (d_phase, nbins) from them, and a float32 round
        # trip would put the bin edges elsewhere than the unsharded
        # runner's float64 geometry does
        kw = dict(oversample=self.oversample, objective=self.objective,
                  mesh=self.mesh, uniform_weights=uniform,
                  shared_time=shared)

        def step(pvals, n_valid):
            out = sharded_bls(stack.time, stack.flux, dy, pvals,
                              self.durations, **kw)
            return _reduce_winner(out, n_valid)

        return step

    def _make_bucketed_step(self, search, dy):
        """The shared step for a stack whose rows lie on several time grids
        (one per sector or quarter): rows are bucketed by grid identity in
        first-seen order, each bucket runs one shared-grid search on its
        rows, and the winners are put back in row order on the device.
        Past 32 buckets the per-curve methods are likely faster, and a
        warning says so."""
        stack = self.stack
        count("host_sync")
        time_np = stack.time.cpu().numpy()
        B = time_np.shape[0]
        key_to_bucket, buckets = {}, []
        for i in range(B):
            key = time_np[i].tobytes()
            b = key_to_bucket.get(key)
            if b is None:
                key_to_bucket[key] = b = len(buckets)
                buckets.append([])
            buckets[b].append(i)
        if len(buckets) > 32:
            log.warning(
                "Bucketed sweep over %d distinct time grids for %d curves;"
                " per-curve methods (method='fast'/'exact') may be faster "
                "for fully heterogeneous batches.", len(buckets), B)
        log.info("Bucketed shared sweep: %d buckets (sizes %s)",
                 len(buckets), [len(b) for b in buckets])
        rows = [torch.as_tensor(b, device=stack.device) for b in buckets]
        segments = [(stack.time[r[0]], stack.flux[r], dy[r]) for r in rows]
        # position of each row in the buckets' concatenated winners
        back = torch.as_tensor(np.argsort(np.concatenate(buckets)),
                               device=stack.device)

        def step(pvals, n_valid):
            outs = [search(t_row, flux, dy_rows, pvals, n_valid)
                    for t_row, flux, dy_rows in segments]
            return torch.cat(outs, dim=1)[:, back]

        return step

    def _make_percurve_step(self, d_phase, durs, dy):
        """The per-curve step: every curve folds on its own time row, the
        binned search (``"fast"``) or the sorted-phase one (``"exact"``),
        sized for the grid's longest period."""
        from ..ops.bls import _binned, bls_power
        stack = self.stack
        fast = self.method == "fast"
        size = int(np.ceil(self.periods.max() / d_phase)) + (0 if fast
                                                             else 1)
        # the binned step bins by the product with 1/d_phase, as the
        # reference's compiled step does with its constant d_phase
        kernel, kw = ((_binned, dict(nbins=size, reciprocal=True)) if fast
                      else (bls_power, dict(t0_count=size)))
        oversample, objective = self.oversample, self.objective

        def step(pvals, n_valid):
            out = kernel(stack.time, stack.flux, dy, pvals, durs,
                         oversample=oversample, objective=objective,
                         d_phase=d_phase, **kw)
            return _reduce_winner(out, n_valid)

        return step

    def _merge(self, stacked):
        with span("sweep.merge"):
            out = {f: stacked[i] for i, f in enumerate(_FIELDS)}
            better = out["power"] > self.state["power"]
            for f in _FIELDS:
                self.state[f] = np.where(better, out[f], self.state[f])
            self.next_chunk += 1
            if (self.next_chunk % self.save_every == 0
                    or self.next_chunk >= self.n_chunks):
                self._save()
            log.info("Sweep chunk %d/%d done (best power so far: %.3g)",
                     self.next_chunk, self.n_chunks,
                     float(np.nanmax(self.state["power"])))

    @staticmethod
    def _to_host(winners):
        """Start the (F, B) winners' copy to pinned host memory; returns
        (host tensor, event or None)."""
        if winners.device.type != "cuda":
            return winners, None
        host = torch.empty(winners.shape, dtype=winners.dtype,
                           pin_memory=True)
        host.copy_(winners, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def run(self, max_chunks=None):
        """Process up to ``max_chunks`` chunks (all remaining by default),
        checkpointing every ``save_every`` merged chunks.  Pipelined two
        deep: chunk i+1 is dispatched before chunk i's winners are waited
        for, so the host merge and checkpoint IO overlap the device.  On a
        mesh the run ends with a barrier once the checkpoint is written, so
        a runner made next on any rank reads it whole.  Returns the
        best-so-far dict.

        Spans (:mod:`lightkurve_tpu_torch.diagnostics`): ``sweep`` around
        the run; ``sweep.prepare`` (the step's set-up); per chunk
        ``sweep.chunk`` with ``sweep.dispatch`` (its step and winner
        copy), then the previous chunk's ``sweep.wait`` and
        ``sweep.merge`` (with ``sweep.save``); the last chunk's wait and
        merge under ``sweep``; ``sweep.flush``."""
        n_do = self.n_chunks - self.next_chunk
        if max_chunks is not None:
            n_do = min(n_do, max_chunks)
        with span("sweep", chunks=n_do, curves=len(self.stack)):
            with span("sweep.prepare"):
                step = self._make_step()
            np_dtype = numpy_dtype(self.stack.flux.dtype)
            pending = None
            try:
                for i in range(self.next_chunk, self.next_chunk + n_do):
                    lo = i * self.chunk_periods
                    hi = min(lo + self.chunk_periods, len(self.periods))
                    with span("sweep.chunk", index=i, lo=lo, hi=hi):
                        pchunk = self.periods[lo:hi]
                        # pad the final chunk so every step has one shape
                        pad = self.chunk_periods - len(pchunk)
                        pvals = np.pad(pchunk, (0, pad),
                                       constant_values=pchunk[-1]
                                       ).astype(np_dtype)
                        with span("sweep.dispatch"):
                            nxt = self._to_host(step(pvals, len(pchunk)))
                        if pending is not None:
                            self._merge(self._wait(pending))
                        pending = nxt
                if pending is not None:
                    self._merge(self._wait(pending))
            finally:
                with span("sweep.flush"):
                    self.flush_saves()
            if self.mesh is not None:
                self.mesh.barrier()
        return dict(self.state)

    @staticmethod
    def _wait(pending):
        with span("sweep.wait"):
            host, done = pending
            if done is not None:
                done.synchronize()
            return host.numpy()
