"""Traffic kind ``vet``: one user vetting curves one at a time through the
port's public single-curve path, as lightkurve documents it.

Set-up draws a host pool of ``pool`` curves of the configuration's model
from the seed, each on the configuration's float64 time grid with its
masked cadences' flux and flux_err NaN (as a SPOC PDCSAP file leaves
them), and runs one warm-up vet.  A step is one vet of the next curve of a
seeded order, in one client's closed loop::

    lc = LightCurve(time=Time(t, format="btjd"), flux=f, flux_err=e)
    pg = lc.flatten(window_length=...).to_periodogram(method="bls")

with the configuration's other flatten settings and its search (both
lightkurve's defaults), then the winner read to the host: the period at
the highest power, and the power, duration, transit time and depth
there.  The check holds ``check_vets`` of the window's vets, drawn from
the seed, against the plain reference in float64 on the float64 times:
each vet's flattened flux, and its winner against the reference's grid
of that curve's own times.  The curves whose gap test is hard are drawn
first (:func:`hard_gaps`), since a fault in the gap splits or the
segment medians shows only on them.

A run keeps a vet's output whole only while it is in one of two
reservoirs of ``check_vets`` each, drawn from the seed over the whole
window: one of the vets whose curve's gap test is hard, one of the rest
(:meth:`Driver.keep`).  Every other vet leaves its curve and its number of
periods, as a user's notebook keeps nothing of the vets it moves past; the
count of each search is made after the window from the grid of that
curve's own valid times.  A window of fewer than ``check_vets`` vets
raises.
"""
import numpy as np
import torch

from perfbench import check as chk
from perfbench import data
from perfbench import drivers
from perfbench import reference as ref
from perfbench.roofline import search_counts


def on_grid(values, grid, rtol):
    """Each reported value replaced by the grid point it was reported from,
    where one lies within ``rtol`` of it (a period comes back as 1/(1/p), a
    duration in the search's dtype); else left as it is, off the grid."""
    values = np.asarray(values, np.float64)
    grid = np.asarray(grid, np.float64)
    i = np.argmin(np.abs(grid[None, :] - values[:, None]), axis=1)
    return np.where(np.abs(grid[i] - values) <= rtol * np.abs(grid[i]),
                    grid[i], values)


#: curves a block of the pool's gap test takes at once on the device
ROWS = 256


def hard_gaps(t, valid, break_tolerance, max_segments=16, rtol=1e-6):
    """Whether lightkurve's gap test is hard on each curve of a pool of
    float64 times ``t`` (n,) and validity ``valid`` (P, n), a numpy array or
    a tensor on the device whose rows hold one number of valid cadences:
    it cuts the curve into more than ``max_segments`` segments, or a step
    between valid cadences lies within ``rtol`` of ``break_tolerance``
    median steps, where the times' rounding decides the cut (a run of 4
    masked cadences at 5).  A bool array (P,), taken :data:`ROWS` curves
    at a time on the mask's device with the float64 arithmetic of numpy's
    median."""
    v = torch.as_tensor(valid, dtype=torch.bool)
    hard = np.zeros(v.shape[0], bool)
    if break_tolerance is not None:
        tt = torch.as_tensor(np.asarray(t, np.float64), device=v.device)
        for lo in range(0, v.shape[0], ROWS):
            hard[lo:lo + ROWS] = _hard_rows(tt, v[lo:lo + ROWS],
                                            float(break_tolerance),
                                            max_segments, rtol)
    return hard


def _hard_rows(t, valid, break_tolerance, max_segments, rtol):
    n = valid.sum(1)
    if not bool((n == n[0]).all()):
        raise ValueError("the rows of a pool differ in their number of "
                         "valid cadences")
    dt = t.expand(valid.shape)[valid].view(valid.shape[0], -1).diff(dim=1)
    m = dt.shape[1]
    if m == 0:
        return np.zeros(valid.shape[0], bool)
    s = dt.sort(dim=1).values
    median = s[:, m // 2] if m % 2 else (s[:, m // 2 - 1] + s[:, m // 2]) / 2
    limit = break_tolerance * median[:, None]
    close = (dt - limit).abs() <= rtol * limit
    cuts = (dt > limit).sum(1) + 1
    return (close.any(1) | (cuts > max_segments)).cpu().numpy()


class Driver(drivers.Driver):
    def __init__(self, *args):
        super().__init__(*args)
        self.fl = dict(self.cfg["flatten"])
        self.search = self.cfg["search"]
        self.t = data.time_grid(self.cfg)
        # reservoirs of (pool index, flat, winner): [easy, hard] curves
        self.kept = ([], [])
        self.seen = [0, 0]              # vets of each so far
        self.searched = []              # (pool index, periods searched)
        self.sample = []                # the kept vets the check judges

    def draw_pool(self):
        """The pool as host arrays (P, n): flux and flux_err in float32 with
        NaN where masked, and the validity mask; with each curve's
        :func:`hard_gaps`, taken on the pool's device."""
        d = data.make_stack(self.cfg, self.seed, "pool",
                            int(self.traffic["pool"]), self.device, self.t)
        hard = hard_gaps(self.t, d["mask"], self.fl["break_tolerance"])
        valid = d["mask"].cpu().numpy()
        flux, err = (np.where(valid, d[k].cpu().numpy(), np.float32(np.nan))
                     for k in ("flux", "flux_err"))
        return flux, err, valid, hard

    def use_config(self):
        """Point the program's defaults at this run's device and the
        configuration's dtype; returns the previous ones."""
        from lightkurve_tpu_torch import config
        prev = (config.default_device, config.default_dtype)
        config.default_device = torch.device(self.device).type
        config.default_dtype = getattr(torch, self.cfg["dtype"])
        return prev

    def restore_config(self):
        from lightkurve_tpu_torch import config
        config.default_device, config.default_dtype = self.prev

    def setup(self):
        import lightkurve_tpu_torch  # noqa: F401  (imports are set-up)
        self.prev = self.use_config()
        with self.span("data"):
            self.flux, self.err, self.valid, hard = self.draw_pool()
        order_rng = np.random.default_rng(data.stream_seed(self.seed,
                                                           "order"))
        self.order = order_rng.permutation(self.flux.shape[0])
        # the steps visit positions 0 .. P - 2; the last curve warms up
        self.hard = hard[self.order[:-1]]
        self.i = 0
        self.vet(int(self.order[-1]))

    def vet(self, c):
        """One vet of pool curve ``c``: (flattened flux, winner, periods)."""
        from lightkurve_tpu_torch import LightCurve
        from lightkurve_tpu_torch.time import Time
        lc = LightCurve(time=Time(self.t, format="btjd"), flux=self.flux[c],
                        flux_err=self.err[c])
        with self.span("flatten"):
            flat = lc.flatten(window_length=int(self.fl["window_length"]),
                              polyorder=int(self.fl["polyorder"]),
                              break_tolerance=self.fl["break_tolerance"],
                              niters=int(self.fl["niters"]),
                              sigma=float(self.fl["sigma"]))
        with self.span("periodogram"):
            pg = flat.to_periodogram(
                method="bls", duration=self.search["durations"],
                oversample=self.search["oversample"],
                objective=self.search["objective"],
                frequency_factor=self.search["periods"]["frequency_factor"])
            win = dict(period=pg.period_at_max_power.value,
                       power=float(np.nanmax(pg.power.value)),
                       duration=pg.duration_at_max_power.value,
                       transit_time=pg.transit_time_at_max_power.value,
                       depth=pg.depth_at_max_power.value)
        win = {k: np.atleast_1d(np.asarray(v, np.float64))
               for k, v in win.items()}
        return flat.flux.value, win, 1.0 / pg.frequency.value

    def step(self):
        p = self.i % (len(self.order) - 1)
        c = int(self.order[p])
        self.attempted += 1
        flat, win, periods = self.vet(c)
        self.keep(int(self.hard[p]), (c, flat, win))
        self.searched.append((c, periods.size))
        self.count("curve_periods", periods.size)
        self.i += 1

    def keep(self, hard, out):
        """Keep a vet's output ``out`` in reservoir ``hard`` (1: its curve's
        gap test is hard) with the chance that leaves each reservoir a
        uniform draw of ``check_vets`` of its vets so far (Vitter's R);
        the output it replaces is freed."""
        k, n = int(self.traffic["check_vets"]), self.seen[hard]
        if n < k:
            self.kept[hard].append(out)
        else:
            j = int(self.rng.integers(n + 1))
            if j < k:
                self.kept[hard][j] = out
        self.seen[hard] = n + 1

    def record_searches(self):
        """The window's searches counted (:mod:`perfbench.roofline`) after
        the window, each on the grid lightkurve builds from its curve's own
        valid times; a grid's count (10-25 ms on the host for 4,564
        periods) is made once."""
        by_curve, by_grid = {}, {}
        for c, size in self.searched:
            if c not in by_curve:
                tv = self.t[self.valid[c]]
                periods = self.periods_of(tv)
                if periods.size != size:
                    raise RuntimeError(
                        f"curve {c}: the program searched {size} periods, "
                        f"its grid has {periods.size}")
                key = (tv.size, periods.tobytes())
                if key not in by_grid:
                    by_grid[key] = search_counts(
                        tv.size, 1, tv.size, periods,
                        self.search["durations"], self.search["oversample"],
                        weighted=True)
                by_curve[c] = by_grid[key]
            self.run.searches.append(by_curve[c])
        self.searched = []

    def draw_sample(self):
        """``check_vets`` of the window's vets: the kept hard ones, then the
        kept others in a seeded order; a window of fewer raises."""
        k = int(self.traffic["check_vets"])
        easy, hard = self.kept
        if sum(self.seen) < k:
            raise RuntimeError(
                f"the window made {sum(self.seen)} vets; the check needs "
                f"{k}: a longer window")
        easy = [easy[j] for j in self.rng.permutation(len(easy))]
        self.sample = (hard + easy)[:k]
        self.kept = ([], [])
        self.raw = {c: (self.flux[c], self.err[c], self.valid[c])
                    for c, _, _ in self.sample}

    def release(self):
        self.record_searches()
        self.draw_sample()
        self.flux = self.err = self.valid = None
        self.restore_config()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def judge(self, c, got_flat, got_win):
        """(flattened-flux errors, winner_gap, winner_err) of one vet of
        pool curve ``c`` against the reference in float64."""
        flux, err, valid = self.raw[c]
        rflat, rerr = chk.reference_flatten(self.t, flux, valid, err,
                                            self.fl)
        f_err = chk.flat_errors([got_flat], [rflat], [valid])
        dev = "cuda" if torch.cuda.is_available() else "cpu"
        tv = self.t[valid]
        geom = self.geometry(tv)
        ts = torch.as_tensor(tv - tv.min(), device=dev)
        y = torch.as_tensor(rflat[valid][None], device=dev)
        dy = torch.as_tensor(rerr[valid][None], device=dev)
        ok = torch.ones_like(y, dtype=torch.bool)
        best = ref.bls_grid(ts, y, dy, ok, geom)["power"].max(1).values
        win = dict(got_win)
        win["period"] = on_grid(win["period"], geom.periods, 1e-12)
        win["duration"] = on_grid(win["duration"], geom.durations, 1e-6)
        gap, werr = chk.judge_winners(win, best.cpu().numpy(), ts, y, dy, ok,
                                      geom, float(tv.min()),
                                      grid_dtype=np.float64)
        return f_err, gap, werr

    def periods_of(self, tv):
        """The trial periods lightkurve builds for a curve of times ``tv``."""
        return data.autoperiod(tv, np.asarray(self.search["durations"],
                                              np.float64),
                               float(self.search["periods"]
                                     ["frequency_factor"]))

    def geometry(self, tv):
        """The search grid lightkurve builds for a curve of times ``tv``."""
        return ref.Geometry.of(self.periods_of(tv), self.search["durations"],
                               self.search["oversample"])

    def check(self):
        f_err, gap, err = [], 0.0, 0.0
        for c, flat, win in self.sample:
            a, b, e = self.judge(c, flat, win)
            f_err += a
            gap, err = max(gap, b), max(err, e)
        lim = self.traffic["limits"]
        return [("flat_err_curve_p99", chk.curve_p99(f_err),
                 lim["flat_err_curve_p99"]),
                ("winner_gap", gap, lim["winner_gap"]),
                ("winner_err", err, lim["winner_err"])]


def control(drv, prec):
    """Put the reference computed in ``prec`` in the program's place: the
    pool of run ``drv.seed``, its first ``check_vets`` curves of the vet
    order each flattened and searched once by the reference, reported as
    the program reports a winner."""
    drv.flux, drv.err, drv.valid, _ = drv.draw_pool()
    order_rng = np.random.default_rng(data.stream_seed(drv.seed, "order"))
    order = order_rng.permutation(drv.flux.shape[0])
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    for c in order[:int(drv.traffic["check_vets"])]:
        c = int(c)
        flux, err, valid = drv.flux[c], drv.err[c], drv.valid[c]
        flat, ferr = chk.reference_flatten(drv.t, flux, valid, err, drv.fl,
                                           prec)
        tv = drv.t[valid]
        geom = drv.geometry(tv)
        ts = torch.as_tensor(tv - tv.min(), device=dev)
        y = torch.as_tensor(flat[valid][None], device=dev)
        dy = torch.as_tensor(ferr[valid][None], device=dev)
        ok = torch.ones_like(y, dtype=torch.bool)
        grid = ref.bls_grid(ts, y, dy, ok, geom, prec)
        win = chk.winners_of_grid(grid, geom, float(tv.min()))
        win["depth"] = ref.bls_at(ts, y, dy, ok, geom, win["best_index"],
                                  win["k"], win["b"], prec)["depth"]
        win["duration"] = win["duration"].astype(np.float32).astype(
            np.float64)
        drv.sample.append((c, flat, {k: win[k] for k in (
            "period", "power", "duration", "transit_time", "depth")}))
    drv.raw = {c: (drv.flux[c], drv.err[c], drv.valid[c])
               for c, _, _ in drv.sample}
