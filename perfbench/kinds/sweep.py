"""Traffic kind ``sweep``: a survey searching stacks of one time grid.

Set-up draws ``stacks`` stacks of the configuration's curves onto the
device from the seed; each step takes the next stack in turn, flattens
it and searches the configuration's whole period grid
(``SweepRunner(method="shared")``), closed loop.  The check holds
``check_curves_per_stack`` curves of each stack, drawn from the seed,
against the plain reference: their flattened flux after every step that
searched the stack, and the winners each of those searches returned.
"""
import os

import numpy as np
import torch

from perfbench import check as chk
from perfbench import data
from perfbench import drivers
from perfbench import reference as ref
from perfbench.drivers import sync
from perfbench.roofline import search_counts


class Driver(drivers.Driver):
    def __init__(self, *args):
        super().__init__(*args)
        self.fl = dict(self.cfg["flatten"])
        self.search = self.cfg["search"]

    def setup(self):
        from lightkurve_tpu_torch.batch import LightCurveStack
        t = data.time_grid(self.cfg)
        self.grid(t)
        B = int(self.cfg["curves"])
        n = t.size
        time_row = torch.as_tensor(self.t32, device=self.device)
        self.raw, self.stacks = [], []
        with self.span("data"):
            for s in range(int(self.traffic["stacks"])):
                d = data.make_stack(self.cfg, self.seed, f"stack{s}", B,
                                    self.device, t)
                self.stacks.append(LightCurveStack(
                    time=time_row.expand(B, n), flux=d["flux"],
                    flux_err=d["flux_err"], mask=d["mask"]))
            sync(self.device)
        self.sample = self.draw_sample(B)
        self.kept = [[] for _ in self.stacks]       # (flat rows, winners)
        self.i = 0
        self.search_stack(self.stacks[0], "warmup")

    def grid(self, t):
        self.t = t
        self.t32 = t.astype(np.float32)
        self.periods = data.period_grid(self.cfg, t)
        self.durations = np.asarray(self.search["durations"], np.float64)
        self.geom = ref.Geometry.of(self.periods, self.durations,
                                    self.search["oversample"])

    def flatten(self, stack):
        """The configuration's flatten of a stack: the body of
        ``LightCurveStack.flatten`` with ``ops.detrend.flatten_batch``
        tracking the configuration's ``program.flatten_max_segments``
        segment medians.  lightkurve's flatten takes every segment's own
        median; the stack's method tracks 16 and takes no option for
        more."""
        from lightkurve_tpu_torch.batch import LightCurveStack
        from lightkurve_tpu_torch.ops.detrend import flatten_batch
        from lightkurve_tpu_torch.ops.savgol import savgol_design_matrix
        fl = self.fl
        w = int(fl["window_length"])
        H = savgol_design_matrix(w, min(int(fl["polyorder"]), w - 1))
        bt = np.nan if fl["break_tolerance"] is None else \
            float(fl["break_tolerance"])
        trend, _ = flatten_batch(
            stack.time, stack.flux, stack.mask, H, bt, float(fl["sigma"]),
            niters=int(fl["niters"]),
            max_segments=int(self.cfg["program"]["flatten_max_segments"]))
        return LightCurveStack(time=stack.time, flux=stack.flux / trend,
                               flux_err=stack.flux_err / trend,
                               mask=stack.mask)

    def search_stack(self, stack, tag):
        """Flatten and search one stack; returns (flattened stack, winners
        host dict)."""
        from lightkurve_tpu_torch.parallel.checkpoint import SweepRunner
        with self.span("flatten"):
            flat = self.flatten(stack)
            sync(self.device)
        with self.span("sweep"):
            path = os.path.join(self.tmp, f"{tag}.npz")
            runner = SweepRunner(
                flat, self.periods, self.durations, path,
                chunk_periods=int(self.traffic["chunk_periods"]),
                oversample=self.search["oversample"],
                objective=self.search["objective"], method="shared",
                async_save=True)
            state = runner.run()
        if os.path.exists(path):
            os.remove(path)
        return flat, state

    def record_search(self, stack):
        B, n = stack.flux.shape
        valid = int(stack.mask.sum())
        self.run.searches.append(search_counts(
            valid, B, n, self.periods, self.durations,
            self.search["oversample"], weighted=True))
        self.count("curve_periods", B * len(self.periods))

    def judge(self, raw, got_flat, got_win):
        """(flattened-flux errors per curve, winner_gap, winner_err) of the
        program's flattened rows and winners against the reference, for
        curves ``raw`` (flux, flux_err, mask host arrays (K, n))."""
        flux, err, mask = raw
        rflat, rerr = zip(*(chk.reference_flatten(self.t32, f, m, e,
                                                  self.fl)
                            for f, e, m in zip(flux, err, mask)))
        rflat, rerr = np.stack(rflat), np.stack(rerr)
        f_err = [e for g in got_flat for e in chk.flat_errors(g, rflat,
                                                              mask)]
        dev = "cuda" if torch.cuda.is_available() else "cpu"
        ts = torch.as_tensor(self.t32.astype(np.float64)
                             - float(self.t32.min()), device=dev)
        y = torch.as_tensor(np.nan_to_num(rflat), device=dev)
        dy = torch.as_tensor(np.nan_to_num(rerr, nan=1.0), device=dev)
        valid = torch.as_tensor(mask, device=dev)
        grid = ref.bls_grid(ts, y, dy, valid, self.geom)
        best = grid["power"].max(1).values.cpu().numpy()
        gaps, errs = zip(*(chk.judge_winners(w, best, ts, y, dy, valid,
                                             self.geom,
                                             float(self.t32.min()))
                           for w in got_win))
        return f_err, max(gaps), max(errs)

    def numbers(self, f_err, gap, err):
        lim = self.traffic["limits"]
        return [("flat_err_curve_p99", chk.curve_p99(f_err),
                 lim["flat_err_curve_p99"]),
                ("winner_gap", gap, lim["winner_gap"]),
                ("winner_err", err, lim["winner_err"])]

    def draw_sample(self, B):
        k = int(self.traffic["check_curves_per_stack"])
        return [np.sort(self.rng.choice(B, k, replace=False))
                for _ in range(int(self.traffic["stacks"]))]

    def step(self):
        s = self.i % len(self.stacks)
        stack = self.stacks[s]
        self.attempted += 1
        flat, state = self.search_stack(stack, f"step{self.i}")
        rows = torch.as_tensor(self.sample[s], device=self.device)
        self.kept[s].append((flat.flux[rows].cpu().numpy(),
                             {f: v[self.sample[s]] for f, v in
                              state.items()}))
        self.record_search(stack)
        self.i += 1

    def release(self):
        self.raw = []
        for s, stack in enumerate(self.stacks):
            rows = torch.as_tensor(self.sample[s], device=self.device)
            self.raw.append(tuple(a[rows].cpu().numpy() for a in (
                stack.flux, stack.flux_err, stack.mask)))
        self.stacks = []
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        f_err, gap, err = [], 0.0, 0.0
        for s, kept in enumerate(self.kept):
            if not kept:
                continue
            a, b, c = self.judge(self.raw[s], [k[0] for k in kept],
                                 [k[1] for k in kept])
            f_err += a
            gap, err = max(gap, b), max(err, c)
        return self.numbers(f_err, gap, err)


def control(drv, prec):
    """Put the reference computed in ``prec`` in the program's place: the
    same stacks and the same sample as run ``drv.seed``, each sampled
    curve flattened and searched once by the reference."""
    t = data.time_grid(drv.cfg)
    drv.grid(t)
    B = int(drv.cfg["curves"])
    drv.sample = drv.draw_sample(B)
    drv.raw, drv.kept = [], []
    for s, rows in enumerate(drv.sample):
        d = data.make_stack(drv.cfg, drv.seed, f"stack{s}", B, drv.device, t)
        r = torch.as_tensor(rows, device=drv.device)
        raw = tuple(d[a][r].cpu().numpy() for a in ("flux", "flux_err",
                                                     "mask"))
        del d
        drv.raw.append(raw)
        drv.kept.append([_reference_search(drv, *raw, prec)])


def _reference_search(drv, flux, err, mask, prec):
    """The reference's flattened rows and winners, in ``prec``, for curves
    (K, n), reported as a float32 search reports them."""
    flat, ferr = zip(*(chk.reference_flatten(drv.t32, f, m, e, drv.fl,
                                             prec)
                       for f, e, m in zip(flux, err, mask)))
    flat, ferr = np.stack(flat), np.stack(ferr)
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    ts = torch.as_tensor(drv.t32.astype(np.float64)
                         - float(drv.t32.min()), device=dev)
    y = torch.as_tensor(np.nan_to_num(flat), device=dev)
    dy = torch.as_tensor(np.nan_to_num(ferr, nan=1.0), device=dev)
    valid = torch.as_tensor(mask, device=dev)
    grid = ref.bls_grid(ts, y, dy, valid, drv.geom, prec)
    win = chk.winners_of_grid(grid, drv.geom, float(drv.t32.min()))
    at = ref.bls_at(ts, y, dy, valid, drv.geom, win["best_index"],
                    win["k"], win["b"], prec)
    win["depth"] = at["depth"]
    win["period"] = win["period"].astype(np.float32).astype(np.float64)
    win["duration"] = win["duration"].astype(np.float32).astype(np.float64)
    return flat, win
