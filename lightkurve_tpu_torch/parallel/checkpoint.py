"""Checkpointed period-grid sweeps.

Counterpart of ``lightkurve_tpu/parallel/checkpoint.py`` for the shared
time-grid method on one device.  :class:`SweepRunner` walks a large
period grid in chunks, reduces each chunk's (B, P_chunk) BLS grids to
per-curve winners on the device, keeps the best-so-far winners on the
host, and persists them (npz, the same layout as ``lightkurve_tpu``'s)
after every chunk, so an interrupted sweep resumes from the last
finished chunk -- including a sweep that ``lightkurve_tpu`` started.
"""
from __future__ import annotations

import logging
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..config import numpy_dtype

log = logging.getLogger(__name__)

__all__ = ["SweepRunner"]

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


class SweepRunner:
    """Chunked, resumable BLS sweep over a huge period grid.

    Parameters
    ----------
    stack : `~lightkurve_tpu_torch.batch.LightCurveStack` whose curves
        share one time grid.
    periods : (P,) full period grid (float64 host array).
    durations : (D,) durations.
    checkpoint_path : str — npz file updated after each chunk.
    chunk_periods : int — grid points per device step.
    method : only ``"shared"`` (the shared-time-grid kernels) is ported.
    async_save : write the npz on a background thread (one write in
        flight), so checkpoint IO overlaps device compute.
    """

    def __init__(self, stack, periods, durations, checkpoint_path,
                 chunk_periods=4096, oversample=10, objective="likelihood",
                 method="shared", save_every=1, async_save=False):
        if method != "shared":
            raise NotImplementedError(
                f"method={method!r}: only the shared-time-grid method is "
                "ported")
        self.stack = stack
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
        # _merge REPLACES the state arrays, so this snapshot by reference
        # stays consistent while a background write reads it
        payload = dict(periods=self.periods, next_chunk=self.next_chunk,
                       chunk_periods=self.chunk_periods, **self.state)
        if not self.async_save:
            self._write_npz(payload)
            return
        if self._save_pool is None:
            self._save_pool = ThreadPoolExecutor(
                1, thread_name_prefix="lk-torch-sweep-ckpt")
        if self._pending_save is not None:
            self._pending_save.result()            # one write in flight
        self._pending_save = self._save_pool.submit(self._write_npz, payload)

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
        """One chunk step: the shared-grid BLS over a period chunk and the
        device-side winner reduction.  Returns a function of (host
        periods, n_valid) giving the (F, B) winners on the device."""
        from ..ops.bls import bls_power_shared_batch
        stack = self.stack
        time = stack.time
        if not bool(torch.all(time == time[0:1])):
            raise NotImplementedError(
                "curves on different time grids (the bucketed step) are "
                "not ported yet")
        dtype = stack.flux.dtype
        np_dtype = numpy_dtype(dtype)
        d_phase = float(self.durations.min()) / self.oversample
        # durations enter the kernel in the data dtype, as the reference's
        # step passes them
        durs = self.durations.astype(np_dtype)
        # per-curve-constant weights (all cadences valid, row-constant
        # flux_err) take the uniform kernel
        err = stack.flux_err
        uniform = bool(torch.all(stack.mask)) and bool(
            torch.all(err == err[:, :1]))
        k_max = max(int(max(int(d / d_phase + 0.5), 1))
                    for d in self.durations)
        t_row = time[0].to(dtype)
        dy = torch.where(stack.mask, stack.flux_err,
                         torch.tensor(torch.inf, dtype=dtype,
                                      device=stack.device))
        oversample, objective = self.oversample, self.objective

        def step(pvals, n_valid):
            # per-chunk histogram size, quantized to a 128-row tile
            nb = int(np.ceil(float(np.max(pvals)) / d_phase))
            tiles = max((nb + k_max - 1 + 127) // 128, 1)
            nb_q = tiles * 128 - (k_max - 1)
            out = bls_power_shared_batch(
                t_row, stack.flux, dy, pvals, durs, oversample=oversample,
                objective=objective, d_phase=d_phase, nbins=nb_q, chunk=8,
                uniform_weights=uniform)
            return _reduce_winner(out, n_valid)

        return step

    def _merge(self, stacked):
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
        for, so the host merge and checkpoint IO overlap the device.
        Returns the best-so-far dict."""
        step = self._make_step()
        np_dtype = numpy_dtype(self.stack.flux.dtype)
        n_do = self.n_chunks - self.next_chunk
        if max_chunks is not None:
            n_do = min(n_do, max_chunks)
        pending = None
        try:
            for i in range(self.next_chunk, self.next_chunk + n_do):
                lo = i * self.chunk_periods
                hi = min(lo + self.chunk_periods, len(self.periods))
                pchunk = self.periods[lo:hi]
                # pad the final chunk so every step has one shape
                pad = self.chunk_periods - len(pchunk)
                pvals = np.pad(pchunk, (0, pad),
                               constant_values=pchunk[-1]).astype(np_dtype)
                nxt = self._to_host(step(pvals, len(pchunk)))
                if pending is not None:
                    self._merge(self._wait(pending))
                pending = nxt
            if pending is not None:
                self._merge(self._wait(pending))
        finally:
            self.flush_saves()
        return dict(self.state)

    @staticmethod
    def _wait(pending):
        host, done = pending
        if done is not None:
            done.synchronize()
        return host.numpy()
