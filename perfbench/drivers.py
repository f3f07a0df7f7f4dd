"""What every traffic driver shares, and the lookup of a traffic's kind.

A traffic file's ``kind`` names a module ``perfbench/kinds/<kind>.py``
under the cell's root, found by name as the metric readers are.  The
module exports ``Driver``, a subclass of :class:`Driver` with ``setup``,
``step``, ``release`` and ``check``, and ``control(drv, prec)``, which
puts the plain reference computed in ``prec`` in the program's place for
:mod:`perfbench.limits`.  A new kind is a new file; a kind with no file
raises.

A driver counts its work into the run, keeps what the timed path
returned for the check, and after the window frees the program's state
and holds a sample of the outputs, drawn from the seed, against the plain
reference (:mod:`perfbench.check`).
"""
from __future__ import annotations

import importlib.util
import os

import numpy as np
import torch

from . import data

__all__ = ["Driver", "load_kind", "make", "sync"]


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def load_kind(root, kind):
    """The module of traffic kind ``kind``: ``<root>/perfbench/kinds/
    <kind>.py``."""
    path = os.path.join(root, "perfbench", "kinds", f"{kind}.py")
    if not os.path.isfile(path):
        raise ValueError(f"unknown traffic kind {kind!r}: no {path}")
    spec = importlib.util.spec_from_file_location(
        "perfbench_kind_" + kind.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make(cell, seed, device, run, tmp):
    """The driver of ``cell``'s traffic kind for one run."""
    return load_kind(cell.root, cell.traffic["kind"]).Driver(
        cell, seed, device, run, tmp)


class Driver:
    def __init__(self, cell, seed, device, run, tmp):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.run, self.tmp = run, tmp
        self.cfg, self.traffic = cell.config, cell.traffic
        self.attempted = self.failed = 0
        self.rng = np.random.default_rng(data.stream_seed(seed, "harness"))

    def span(self, name):
        return self.run.spans.span(name)

    def count(self, key, n):
        self.run.counters[key] = self.run.counters.get(key, 0) + n
