"""Double-buffered host→device loading of FITS light-curve batches.

Counterpart of ``lightkurve_tpu/io/pipeline.py``.  A background worker
parses mission FITS files with the native C++ column reader into padded
fixed-shape ``(B, N)`` host arrays, pins them, and stages them in a
bounded queue.  The consumer issues the host→device copy of batch k+1 on
a side CUDA stream before it yields batch k, so the copy overlaps the
compute on batch k; the consumer's stream waits on the copy's event
before it touches the data.  Every batch shares one static shape.
"""
from __future__ import annotations

import os
import queue
import threading

import numpy as np
import torch

from ..config import numpy_dtype, resolve_device, resolve_dtype

__all__ = ["StreamingStackLoader", "assemble_host_stack"]

_SENTINEL = object()


def _bitceil(n):
    return 1 << (int(n) - 1).bit_length()


def assemble_host_stack(t, f, fe, length=None, dtype=np.float64):
    """Pad/repair raw (B, n) host columns into kernel-safe stack arrays.

    Returns numpy ``(time, flux, flux_err, mask)`` in ``dtype`` with NaNs
    converted to the mask convention: padded times continue each curve's
    median cadence (monotonic, finite), fluxes are zero-filled, errors
    one-filled where invalid.
    """
    dtype = np.dtype(dtype)
    t = np.asarray(t, dtype=dtype)
    f = np.asarray(f, dtype=dtype)
    if fe is None:
        fe = np.full_like(f, np.nan)
    fe = np.asarray(fe, dtype=dtype)
    mask = np.isfinite(t) & np.isfinite(f)
    if length is None:
        length = _bitceil(t.shape[1])
    pad = length - t.shape[1]
    if pad < 0:
        raise ValueError(f"batch has {t.shape[1]} cadences > static "
                         f"length {length}")
    if pad:
        t = np.pad(t, ((0, 0), (0, pad)), constant_values=np.nan)
        f = np.pad(f, ((0, 0), (0, pad)))
        fe = np.pad(fe, ((0, 0), (0, pad)))
        mask = np.pad(mask, ((0, 0), (0, pad)))
    # only rows with a non-finite time need repair
    needs_repair = np.nonzero(~np.isfinite(t).all(axis=1))[0]
    for i in needs_repair:
        good = np.where(mask[i])[0]
        if len(good) < 2:
            # keep any real sample's time; fabricate only the rest
            fab = np.arange(t.shape[1], dtype=dtype)
            if len(good) == 1:
                fab += t[i, good[0]] - good[0]
            keep = np.isfinite(t[i]) & np.isfinite(f[i])
            t[i] = np.where(keep, t[i], fab)
            continue
        dt = np.median(np.diff(t[i, good]))
        bad = np.nonzero(~np.isfinite(t[i]))[0]
        # interior gaps interpolate between finite neighbours; leading
        # gaps extrapolate backward and the tail forward
        tg = t[i, good]
        head = bad[bad < good[0]]
        interior = bad[(bad > good[0]) & (bad < good[-1])]
        tail = bad[bad >= good[-1]]
        if head.size:
            t[i, head] = tg[0] - dt * (good[0] - head)
        if interior.size:
            t[i, interior] = np.interp(interior, good, tg)
        if tail.size:
            t[i, tail] = tg[-1] + dt * (tail - good[-1])
    f = np.where(np.isfinite(f), f, 0.0)
    fe = np.where(np.isfinite(fe) & (fe > 0), fe, 1.0)
    return t, f, fe, mask


class StreamingStackLoader:
    """Iterate :class:`~lightkurve_tpu_torch.batch.LightCurveStack` batches
    on ``device`` over a list of FITS files, with background prefetch.

    Parameters
    ----------
    paths : FITS light-curve files (one target each).
    batch_size : targets per stack; the final batch is padded by repeating
        its last row, and padding rows carry ``{"PADDING": True}`` meta.
    prefetch : queue depth of parsed batches.
    time_column / flux_column / flux_err_column : FITS column names.
    length : static cadence axis; default: the bit-ceiled largest row
        count over the files (header reads).
    dtype : floating dtype of the stacks (default ``config.default_dtype``).
    device : where the stacks live (default the card; ``"cpu"`` for the
        plain versions).
    nthreads : native reader threads per batch.
    """

    def __init__(self, paths, batch_size=256, prefetch=2,
                 time_column="TIME", flux_column="PDCSAP_FLUX",
                 flux_err_column="PDCSAP_FLUX_ERR", length=None,
                 dtype=None, device=None, nthreads=None):
        self.paths = [os.fspath(p) for p in paths]
        self.batch_size = int(batch_size)
        self.prefetch = max(int(prefetch), 1)
        self.columns = (time_column, flux_column, flux_err_column)
        self.nthreads = nthreads
        self.dtype = resolve_dtype(dtype)
        self.device = resolve_device(device)
        self._length = length

    @property
    def length(self):
        if self._length is None:
            from . import native
            self._length = _bitceil(max(native.table_rows(p)
                                        for p in self.paths))
        return self._length

    def __len__(self):
        return -(-len(self.paths) // self.batch_size)

    def _parse(self, chunk):
        """Host columns of one batch: (time, flux, flux_err, mask)
        tensors (pinned when the device is CUDA) and the valid row
        count."""
        from . import native
        tc, fc, fec = self.columns
        t, nrows = native.read_batch(chunk, tc, nthreads=self.nthreads)
        bad = np.nonzero(nrows < 0)[0]
        if bad.size:
            raise IOError(f"native FITS reader failed for "
                          f"{[chunk[i] for i in bad[:5]]} "
                          f"(codes {nrows[bad[:5]].tolist()})")
        f, nrows_f = native.read_batch(chunk, fc, stride=t.shape[1],
                                       nthreads=self.nthreads)
        bad = np.nonzero(nrows_f < 0)[0]
        if bad.size:
            raise IOError(f"native FITS reader failed to read column {fc!r} "
                          f"from {[chunk[i] for i in bad[:5]]} "
                          f"(codes {nrows_f[bad[:5]].tolist()})")
        fe, nrows_fe = native.read_batch(chunk, fec, stride=t.shape[1],
                                         nthreads=self.nthreads)
        if np.any(nrows_fe < 0):
            fe = None                     # optional column
        n_valid = len(chunk)
        if n_valid < self.batch_size:     # keep B static: repeat last row
            reps = self.batch_size - n_valid
            t = np.concatenate([t, np.repeat(t[-1:], reps, axis=0)])
            f = np.concatenate([f, np.repeat(f[-1:], reps, axis=0)])
            if fe is not None:
                fe = np.concatenate([fe, np.repeat(fe[-1:], reps, axis=0)])
        host = [torch.from_numpy(np.ascontiguousarray(a)) for a in
                assemble_host_stack(t, f, fe, self.length,
                                    dtype=numpy_dtype(self.dtype))]
        if self.device.type == "cuda":
            host = [h.pin_memory() for h in host]
        return host, n_valid

    def _stage(self, host, copy_stream):
        """Start the copy of one batch to the device; returns the device
        tensors and the event that marks the copy's end."""
        if copy_stream is None:
            return host, None
        consumer = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(copy_stream):
            dev = [torch.empty(h.shape, dtype=h.dtype, device=self.device)
                   for h in host]
            for d, h in zip(dev, host):
                d.copy_(h, non_blocking=True)
            done = torch.cuda.Event()
            done.record(copy_stream)
        for d in dev:                     # used on the consumer's stream
            d.record_stream(consumer)
        return dev, done

    def __iter__(self):
        from ..batch import LightCurveStack
        _ = self.length                   # header scan before the worker
        q = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        chunks = [self.paths[i:i + self.batch_size]
                  for i in range(0, len(self.paths), self.batch_size)]

        def put(item):
            while not stop.is_set():      # never block forever if the
                try:                      # consumer abandoned us
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for chunk in chunks:
                    if not put((chunk, self._parse(chunk))):
                        return
            except Exception as exc:      # surfaced in the consumer
                put(exc)
            put(_SENTINEL)

        copy_stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        th = threading.Thread(target=worker, daemon=True,
                              name="lk-torch-stream-loader")
        th.start()
        try:
            staged = None
            while True:
                item = q.get()
                if item is _SENTINEL:
                    break
                if isinstance(item, Exception):
                    raise item
                chunk, (host, n_valid) = item
                # start batch k+1's copy before yielding batch k
                dev, done = self._stage(host, copy_stream)
                nxt = (chunk, n_valid, dev, done)
                if staged is not None:
                    yield self._stack(LightCurveStack, *staged)
                staged = nxt
            if staged is not None:
                yield self._stack(LightCurveStack, *staged)
        finally:
            stop.set()                    # unblock a mid-put worker
            th.join(timeout=10)

    def map(self, fn):
        """Run ``fn(stack)`` over every batch with loading overlapped;
        returns the list of results, each tensor in them copied to host
        numpy (``.cpu().numpy()``) through dicts, lists and tuples."""
        return [_tree_to_host(fn(stack)) for stack in self]

    def _stack(self, cls, chunk, n_valid, dev, done):
        if done is not None:
            torch.cuda.current_stream(self.device).wait_event(done)
        t, f, fe, m = dev
        return cls(time=t, flux=f, flux_err=fe, mask=m,
                   meta=[{"FILENAME": p} for p in chunk]
                   + [{"PADDING": True}] * (self.batch_size - n_valid))


def _tree_to_host(tree):
    """``tree`` with every tensor as a host numpy array (dicts, lists and
    tuples walked; other leaves kept)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _tree_to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to_host(v) for v in tree)
    return tree
