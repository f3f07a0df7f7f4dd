"""Kernel K-PC (the per-curve binned BLS in one launch) and its plain
version, with a numpy model of the kernel on the CPU.

The model (``kpc_*`` below) follows ``csrc/bls_curve_fused.cu`` step by
step: the remainder from the rounded quotient, the bin ids, the deposit of
each run of 32 samples (a segmented warp scan of the rounds its widest
group needs, or the leader's sums in ascending lane order), the warp
prefix scan of ``csrc/bls_fold_warp.cuh`` and the first maximum of the
window scan.  It is held against the plain version
(``ops/bls_curve._fold_plain``, ``curve_scan_plain``): the ids bit for
bit, the bin prefix sums within a few float64 roundings of the column's
sum of magnitudes, the winners' indices exactly and their statistics to
1e-12.  The route rule, the wrapper's refusal of other devices and the
``bls.curve.kernel`` counter are checked here too; the kernel itself only
on a card (the last test; ``--noconftest``, as this file imports no jax).
"""
from fractions import Fraction

import numpy as np
import pytest
import torch

from lightkurve_tpu_torch import diagnostics as diag
from lightkurve_tpu_torch.ops import bls, bls_curve

F64 = torch.float64
EPS = np.finfo(np.float64).eps
LANE = np.arange(32)


# --------------------------------------------------------------- inputs
def curves(seed, B=3, n=700, dy="per_sample", unsorted=False,
           dtype=np.float32):
    """B curves of 2-min cadences, each on its own grid (a gap, a start of
    its own), a 1e-3 box at 0.8-1.6 d, noise 5e-4: host times (B, n)
    float64, flux (B, n) and flux_err (5% of it inf: masked samples; or
    None) in ``dtype``."""
    rng = np.random.default_rng(seed)
    cad = 2.0 / 1440.0
    t = np.empty((B, n))
    y = 1.0 + 5e-4 * rng.standard_normal((B, n))
    for b in range(B):
        idx = np.arange(n) + (np.arange(n) >= n // 2) * int(rng.integers(
            30, 90))
        t[b] = 1325.0 + float(rng.uniform(0, 0.1)) + idx * cad
        p_inj = float(rng.uniform(0.8, 1.6))
        ph = np.mod(t[b] - t[b, 0] - 0.1, p_inj)
        y[b, ph < 0.08] -= 1e-3
        if unsorted:
            order = rng.permutation(n)
            t[b], y[b] = t[b, order], y[b, order]
    err = None
    if dy != "none":
        err = rng.uniform(4e-4, 9e-4, (B, n)).astype(dtype)
        err[rng.random((B, n)) < 0.05] = np.inf
    return t, y.astype(dtype), err


#: periods of the model tests: 0.03 d is shorter than 32 cadences, so its
#: runs hold the same bin in lanes that are not neighbours
PERIODS = np.array([0.03, 0.35, 0.5117, 0.9, 1.2345, 1.7, 2.3])
DURATIONS = np.array([0.02, 0.05, 0.08])
D_PHASE = 0.005


def grid(periods=PERIODS, durations=DURATIONS, d_phase=D_PHASE):
    nbins = int(np.ceil(periods.max() / d_phase))
    return (torch.from_numpy(periods), torch.from_numpy(durations),
            torch.tensor(d_phase, dtype=F64), nbins)


def fold_inputs(t, y, dy, device="cpu"):
    """(ts, w, wy) as ``_binned`` hands them to a route: float64 times
    from each curve's first sample, weights and weighted fluxes in the
    flux's dtype (``ops.bls._curve_inputs``)."""
    ts, w, wy, _, _, _ = bls._curve_inputs(
        t, torch.as_tensor(y, device=device), dy, PERIODS, DURATIONS)
    return ts, w, wy


# ---------------------------------------------------------------- model
def kpc_mod(x, p):
    """The kernel's x mod p for x >= 0, p > 0: q = trunc(x / p) rounded,
    the fma's exact x - q p (asserted representable), p added back where
    it is negative."""
    out = np.empty_like(x)
    for i, (xi, pi) in enumerate(zip(x.tolist(), np.broadcast_to(
            p, x.shape).tolist())):
        q = np.trunc(xi / pi)
        exact = Fraction(xi) - Fraction(q) * Fraction(pi)
        r = float(exact)
        assert Fraction(r) == exact, (xi, pi)
        out[i] = r + pi if r < 0 else r
    return out


def kpc_ids(ts, period, d_phase, nbins, reciprocal):
    """The kernel's fold bins of one curve (n,) at one period."""
    ph = kpc_mod(ts, period)
    pos = ph * (1.0 / d_phase) if reciprocal else ph / d_phase
    ids = np.trunc(pos).astype(np.int64)
    return np.clip(ids, 0, nbins - 1)


def shfl_up(v, off):
    return np.concatenate([v[..., :off], v[..., :-off]], axis=-1)


def kpc_deposit(ids, a, c, rows):
    """Exclusive prefix columns (2, rows) after the kernel's deposits of one
    curve: runs of 32 samples, bin b's group sum added to row b + 1."""
    cols = np.zeros((2, rows))
    n = len(ids)
    kinds = {"contiguous": 0, "scattered": 0}
    for c0 in range(0, n, 32):
        m = min(32, n - c0)
        rid = np.full(32, -1)
        rid[:m] = ids[c0:c0 + m]
        v = np.zeros((2, 32))
        v[0, :m], v[1, :m] = a[c0:c0 + m], c[c0:c0 + m]
        peers = rid[:, None] == rid[None, :]
        first = peers.argmax(1)
        last = 31 - peers[:, ::-1].argmax(1)
        size = peers.sum(1)
        contig = bool(np.all(last - first + 1 == size))
        s = v.copy()
        if contig:
            kinds["contiguous"] += 1
            widest = int(max(np.where(rid >= 0, size, 1)))
            off = 1
            while off < widest:
                s = np.where(LANE - off >= first, s + shfl_up(s, off), s)
                off <<= 1
            dep = LANE == last
        else:
            kinds["scattered"] += 1
            for lane in range(32):
                if first[lane] != lane:
                    continue
                for other in np.nonzero(peers[lane])[0][1:]:
                    s[:, lane] = s[:, lane] + v[:, other]
            dep = LANE == first
        for lane in np.nonzero(dep & (rid >= 0))[0]:
            cols[:, rid[lane] + 1] = cols[:, rid[lane] + 1] + s[:, lane]
    return cols, kinds


def kpc_prefix(col, rows):
    """``lk_warp_prefix``: inclusive prefix of col[0, rows), 32 rows a
    step; a row that adds nothing repeats the last row that did."""
    out = col.copy()
    carry = 0.0
    for r0 in range(0, rows, 32):
        v = np.zeros(32)
        m = min(32, rows - r0)
        v[:m] = col[r0:r0 + m]
        x = v.copy()
        last = np.where(v != 0, LANE, -1)
        for off in (1, 2, 4, 8, 16):
            y, ly = shfl_up(x, off), shfl_up(last, off)
            x = np.where(LANE >= off, x + y, x)
            last = np.where(LANE >= off, np.maximum(last, ly), last)
        x = x[np.where(last >= 0, last, LANE)]
        x = np.where(last >= 0, x + carry, carry)
        out[r0:r0 + m] = x[:m]
        carry = x[31]
    return out


def kpc_fold(ts, w, wy, period, d_phase, nbins, k_max, reciprocal):
    """The ids, the prefix columns (2, nbins + 1) (rows past the period's
    ``last`` unset, NaN) and the bins of one (curve, period), as K-PC
    holds them before its window scan."""
    nbp = int(min(np.ceil(period / d_phase), nbins))
    last = min(nbins, nbp + k_max)
    ids = kpc_ids(ts, period, d_phase, nbins, reciprocal)
    cols, kinds = kpc_deposit(ids, w.astype(np.float64),
                              wy.astype(np.float64), nbins + 1)
    cols[:, last + 1:] = np.nan
    for q in range(2):
        cols[q] = kpc_prefix(cols[q], last + 1)
    return ids, cols, nbp, kinds


def kpc_window(cw, cwy, s, k, nbp, nbins, wrap):
    """A window's sums as ``pc_window`` reads them (s, k arrays)."""
    e = s + k
    wraps = wrap & (e > nbp)
    e = np.where(wraps, np.clip(e - nbp, 0, nbins), np.minimum(e, nbins))
    tw, twy = cw[nbp], cwy[nbp]
    w_in = np.where(wraps, (tw - cw[s]) + cw[e], cw[e] - cw[s])
    wy_in = np.where(wraps, (twy - cwy[s]) + cwy[e], cwy[e] - cwy[s])
    return w_in, wy_in


def kpc_scan(cols, nbp, k_durs, nbins, like, wrap):
    """The winner of one (curve, period): its flat index and statistics.
    The lanes' first maxima of ascending runs combined with a strict test
    give the first maximum of the flattened (start, duration) order, NaN
    above every number: ``np.argmax``'s order."""
    cw, cwy = cols
    D = len(k_durs)
    s = np.repeat(np.arange(nbins), D)
    k = np.tile(k_durs, nbins)
    with np.errstate(all="ignore"):
        w_in, wy_in = kpc_window(cw, cwy, np.minimum(s, nbp), k, nbp, nbins,
                                 wrap)
        tw, twy = cw[nbp], cwy[nbp]
        w_out, wy_out = tw - w_in, twy - wy_in
        ok = (w_in > 0) & (w_out > 0) & (s < nbp) & (k <= nbp)
        wis, wos = np.where(ok, w_in, 1.0), np.where(ok, w_out, 1.0)
        depth = wy_out / wos - wy_in / wis
        err = np.sqrt(1.0 / wis + 1.0 / wos)
        snr = depth / err
        ll = 0.5 * wis * depth * depth
    obj = np.where(ok, ll if like else snr, -np.inf)
    i = int(np.argmax(obj))
    return i, dict(power=obj[i], depth=depth[i], depth_err=err[i],
                   depth_snr=snr[i], log_likelihood=ll[i])


def kpc_launch(ts, w, wy, pc, k, d_phase, nbins, like, wrap, reciprocal,
               layout=None):
    """The model of one K-PC call, with ``bls_curve._launch``'s arguments
    (the durations in bins ``k`` on the host, the grid's
    ``curve_layout``) and result: (stats dict of (B, P) float64, flat
    winner indices (B, P) int32).  Each period's columns hold its plan
    rows, or the L2 kernel's rows a column where the plan gives it 0 rows
    and lists it for that kernel; a period whose windows would read past
    them gets NaN, as in the kernel.  Without a layout every period's
    columns hold its own rows."""
    B, P, D = w.shape[0], pc.shape[0], len(k)
    if layout is None:
        rows, ws_rows = bls_curve.curve_rows(pc.numpy(), k, d_phase,
                                             nbins), 0
    else:
        plan, groups, n_long, _, _, ws_rows = layout
        plan = plan.numpy()
        rows = plan[D + groups + 1 + P:D + groups + 1 + 2 * P]
        longs = plan[D + groups + 1 + 2 * P:]
        assert len(longs) == n_long
        assert longs.tolist() == np.flatnonzero(rows == 0).tolist()
    stats = {f: np.empty((B, P)) for f in bls_curve._STATS}
    best = np.empty((B, P), dtype=np.int32)
    for b in range(B):
        for p in range(P):
            _, cols, nbp, _ = kpc_fold(ts[b].numpy(), w[b].numpy(),
                                       wy[b].numpy(), float(pc[p]), d_phase,
                                       nbins, int(k.max()), reciprocal)
            cap = rows[p] if rows[p] else ws_rows
            if min(nbins, nbp + int(k.max())) + 1 > cap:
                best[b, p] = 0
                for f in stats:
                    stats[f][b, p] = np.nan
                continue
            best[b, p], st = kpc_scan(cols, nbp, k, nbins, like, wrap)
            for f, v in st.items():
                stats[f][b, p] = v
    return ({f: torch.from_numpy(v) for f, v in stats.items()},
            torch.from_numpy(best))


# ---------------------------------------------------------------- tests
def test_the_remainder_from_the_rounded_quotient_is_fmod():
    """For x >= 0 and p > 0 the truncated rounded quotient is the true one
    or one more, so x - q p is exact in one fma and one add of p gives
    fmod's bits: random times to 30 d, periods from 1e-3 to 40 d, and
    times at, just below and just above multiples of the period."""
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 30, 4000)
    p = np.exp(rng.uniform(np.log(1e-3), np.log(40), 4000))
    m = np.floor(x / p)
    near = np.concatenate([m * p, np.nextafter(m * p, 0),
                           np.nextafter(m * p, np.inf)])
    xs = np.concatenate([x, near, [0.0]])
    ps = np.concatenate([p, p, p, p, [0.7]])
    np.testing.assert_array_equal(kpc_mod(xs, ps), np.fmod(xs, ps))


@pytest.mark.parametrize("reciprocal", [False, True])
@pytest.mark.parametrize("unsorted", [False, True])
def test_kpc_ids_are_the_plain_ids(reciprocal, unsorted):
    """The kernel's bin of every (curve, period, sample) equals the plain
    fold's, dividing by d_phase or multiplying by its rounded reciprocal,
    on sorted and unsorted times, bins on their edges included (periods
    of a whole number of bins)."""
    ts, w, wy = fold_inputs(*curves(11, unsorted=unsorted))
    periods = np.concatenate([PERIODS, [0.5, 1.0]])   # 100 and 200 bins
    pc, durs, dp, nbins = grid(periods)
    want, _, _, _ = bls_curve._fold_plain(ts, w, wy, pc, dp, nbins,
                                          reciprocal)
    for b in range(ts.shape[0]):
        for p in range(len(periods)):
            got = kpc_ids(ts[b].numpy(), periods[p], D_PHASE, nbins,
                          reciprocal)
            np.testing.assert_array_equal(got, want[b, p].numpy())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("dy", ["per_sample", "none"])
@pytest.mark.parametrize("unsorted", [False, True])
def test_kpc_prefix_sums_are_the_plain_sums(dtype, dy, unsorted):
    """The deposit and warp prefix give each period's exclusive bin prefix
    sums as the plain version does, which adds the same float64 values one
    by one in bin order where the kernel adds them by groups, then bins:
    float32 data sums exactly in float64 here in either order, so the
    sums are equal; float64 data within (n - 1) float64 roundings of the
    column's sum of magnitudes, the sum of both orders' worst-case bounds
    ((n - 1) u each, u = eps / 2).  Where the plain sums repeat a row (no
    sample in its bin) the kernel's repeat it bit for bit.  The 0.03-d
    period's runs are scattered; sorted times at the longer periods give
    contiguous runs."""
    t, y, err = curves(12, dy=dy, unsorted=unsorted, dtype=dtype)
    ts, w, wy = fold_inputs(t, y, err)
    n = ts.shape[1]
    pc, durs, dp, nbins = grid()
    k_max = int(bls_curve._k_bins(durs, dp).max())
    _, cw, cwy, nbins_p = bls_curve._fold_plain(ts, w, wy, pc, dp, nbins)
    seen = {"contiguous": 0, "scattered": 0}
    for b in range(ts.shape[0]):
        for p in range(len(PERIODS)):
            _, cols, nbp, kinds = kpc_fold(
                ts[b].numpy(), w[b].numpy(), wy[b].numpy(), PERIODS[p],
                D_PHASE, nbins, k_max, False)
            assert nbp == int(nbins_p[p])
            for k in seen:
                seen[k] += kinds[k]
            last = min(nbins, nbp + k_max)
            for q, (want, x) in enumerate(((cw, w), (cwy, wy))):
                want = want[b, p, :last + 1].numpy()
                got = cols[q, :last + 1]
                if dtype == np.float32:
                    np.testing.assert_array_equal(got, want)
                scale = np.abs(x[b].numpy().astype(np.float64)).sum()
                assert np.max(np.abs(got - want)) <= (n - 1) * EPS * scale
                same = want[1:] == want[:-1]
                np.testing.assert_array_equal(got[1:][same], got[:-1][same])
    assert seen["scattered"] > 0
    assert seen["contiguous"] > 0 or unsorted


CASES = [("per_sample", False, "likelihood", np.float32),
         ("none", False, "snr", np.float64),
         ("per_sample", True, "snr", np.float64),
         ("none", True, "likelihood", np.float32)]


@pytest.mark.parametrize("edge_mode", ["wrap", "astropy"])
@pytest.mark.parametrize("reciprocal", [False, True])
@pytest.mark.parametrize("dy, unsorted, objective, dtype", CASES)
def test_kpc_model_gives_the_plain_winners(edge_mode, reciprocal, dy,
                                           unsorted, objective, dtype):
    """Per (curve, period) the model's winner is the plain version's: the
    same duration and transit time (from the same flat index); both edge
    modes, both id conventions, masked samples or uniform weights, sorted
    or unsorted times, and a period shorter than 32 cadences.  On float32
    data, whose float64 sums are exact in any order here, power, depth,
    depth_err, depth_snr and log_likelihood are the same bits; on float64
    data within 1e-9: the sums round differently in the two orders (see
    the prefix test), and the depth, a difference of two weighted means
    near 1 (the per-curve search does not shift the flux), magnifies that
    by their ratio to it (~1e4 here; the largest reading is 4.8e-11)."""
    ts, w, wy = fold_inputs(*curves(13, dy=dy, unsorted=unsorted,
                                    dtype=dtype))
    pc, durs, dp, nbins = grid()
    like, wrap = objective == "likelihood", edge_mode == "wrap"
    want = bls_curve.curve_scan_plain(ts, w, wy, pc, durs, dp, nbins, like,
                                      wrap, reciprocal, chunk=3)
    k_durs = bls_curve._k_bins(durs, dp)
    stats, best = kpc_launch(ts, w, wy, pc, k_durs.numpy(), D_PHASE, nbins,
                             like, wrap, reciprocal)
    duration, t0 = bls_curve._from_best(best.long(), durs, k_durs, D_PHASE,
                                        pc)
    assert torch.equal(duration, want["duration"])
    assert torch.equal(t0, want["transit_time"])
    rtol = 0 if dtype == np.float32 else 1e-9
    for f, v in stats.items():
        torch.testing.assert_close(v, want[f], rtol=rtol, atol=0,
                                   equal_nan=True, msg=f)
    assert torch.isfinite(want["power"]).all()


def test_curve_scan_refuses_tensors_off_the_card():
    """The wrapper launches or raises: CPU (and meta) tensors are the
    caller's to route to the plain version."""
    ts, w, wy = fold_inputs(*curves(14, B=1, n=64))
    pc, durs, dp, nbins = grid()
    flags = (True, True, False, PERIODS, DURATIONS)
    with pytest.raises(ValueError, match="CUDA"):
        bls_curve.curve_scan(ts, w, wy, pc, durs, D_PHASE, nbins, *flags)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA"):
        bls_curve.curve_scan(ts.to(meta), w.to(meta), wy.to(meta),
                             pc.to(meta), durs.to(meta), D_PHASE, nbins,
                             *flags)


@pytest.mark.parametrize("device, want", [
    ("cuda", "kernel"), ("cuda:0", "kernel"), ("cpu", "plain"),
    ("meta", "plain")])
def test_curve_route_by_device(device, want):
    """A CUDA device takes K-PC whatever the grid (its L2 kernel takes the
    periods whose columns do not fit shared memory); any other device the
    plain version."""
    assert bls_curve.curve_route(device) == want
    assert bls_curve.curve_route(torch.device(device)) == want


#: the layout test's grid: d_phase 0.005 and durations of 10 and 66 bins,
#: so a period's rows are ceil(p / 0.005) + 67: 14,528 at 72.3025 d
#: (232,448 bytes, an H100's opt-in shared memory: fits), 14,529 at
#: 72.3075 d (does not)
LAYOUT_PERIODS = {"mixed": [0.5, 72.3025, 72.3075, 80.0, 3.0],
                  "all_short": [0.5, 3.0, 72.3025],
                  "all_long": [72.3075, 80.0]}


@pytest.mark.parametrize("case", sorted(LAYOUT_PERIODS))
def test_curve_layout_splits_at_shared_memory(monkeypatch, case):
    """``curve_layout``: a period whose two float64 columns fit a block's
    opt-in shared memory goes to the shared-memory kernel's blocks (their
    block sized for the longest such period), any other to the L2 kernel's
    list, in its order, with 0 rows in the plan; the L2 kernel's columns
    hold its longest period.  With no short period there is no block and
    no block query."""
    optin = 232_448
    asked = []

    def block(max_rows, dtype, device):
        asked.append(max_rows)
        return 8, 115_712, 2

    monkeypatch.setattr(bls_curve, "shared_memory_optin", lambda d: optin)
    monkeypatch.setattr(bls_curve, "curve_block", block)
    periods = np.asarray(LAYOUT_PERIODS[case])
    d_phase, k = 0.005, np.array([10, 66])
    nbins = int(np.ceil(periods.max() / d_phase))
    rows = bls_curve.curve_rows(periods, k, d_phase, nbins)
    long = 16 * rows > optin
    plan, groups, n_long, warps, smem, ws_rows = bls_curve.curve_layout(
        periods, k, d_phase, nbins, torch.float32, torch.device("cpu"))
    P = len(periods)
    plan = plan.numpy()
    assert plan[:2].tolist() == k.tolist()
    starts = plan[2:3 + groups]
    off = plan[3 + groups:3 + groups + P]
    got_rows = plan[3 + groups + P:3 + groups + 2 * P]
    longs = plan[3 + groups + 2 * P:]
    assert longs.tolist() == np.flatnonzero(long).tolist()
    assert n_long == long.sum()
    np.testing.assert_array_equal(got_rows, np.where(long, 0, rows))
    assert ws_rows == (rows[long].max() if long.any() else 0)
    if long.all():
        assert (groups, warps, smem, asked) == (0, 0, 0, [])
        assert starts.tolist() == [0] and not off.any()
    else:
        assert asked == [rows[~long].max()]
        assert (warps, smem) == (8, 115_712)
        assert starts[0] == 0 and starts[-1] == P
    if case == "mixed":
        assert rows[1:3].tolist() == [14_528, 14_529]
        assert long.tolist() == [False, False, True, True, False]


def test_curve_plan_gives_l2_periods_no_rows():
    """A period of 0 rows holds a warp of its block and no rows; a plan
    of only such periods has no block."""
    starts, off = bls_curve.curve_plan(np.array([300, 0, 500, 0, 200]), 2,
                                       16 * 1000)
    assert starts.tolist() == [0, 2, 4, 5]
    assert off.tolist() == [0, 300, 0, 500, 0]
    starts, off = bls_curve.curve_plan(np.array([0, 0, 0]), 2, 16 * 1000)
    assert starts.tolist() == [0] and off.tolist() == [0, 0, 0]


@pytest.mark.parametrize("items, rows, want", [
    (10, 20_000, 10), (10**6, 1_000, 16 * 132),
    (10**6, 100_000, (1 << 29) // 1_600_000), (1, 10**9, 1)])
def test_curve_slots(monkeypatch, items, rows, want):
    """The L2 kernel's warps: one a (curve, period), at most 16 an SM,
    their columns within 512 MiB, at least one."""
    class Props:
        multi_processor_count = 132

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: Props())
    assert bls_curve.curve_slots(items, rows, "cuda") == want


@pytest.mark.parametrize("on", [False, True])
def test_settle_waits_only_while_recording(monkeypatch, on):
    """``diagnostics.settle`` waits for a CUDA device while spans are
    recorded (so that a kernel's span holds its run) and never else, nor
    for the CPU."""
    waited = []
    monkeypatch.setattr(torch.cuda, "synchronize", waited.append)
    diag.reset()
    if on:
        diag.enable()
    try:
        diag.settle("cuda")
        diag.settle(torch.device("cpu"))
    finally:
        diag.disable()
        diag.reset()
    assert waited == ([torch.device("cuda")] if on else [])


@pytest.mark.parametrize("warps, smem", [(16, 115_712), (8, 57_344),
                                         (1, 30_912)])
def test_curve_plan_packs_periods_into_blocks(warps, smem):
    """The vet cell's grid (4,564 periods, 0.33-9.33 d, 6 durations to
    0.33 d): each period's rows are those its warp reads (its bins plus
    the longest duration, at most nbins, plus the leading 0); blocks take
    consecutive periods, at most ``warps``, their rows within ``smem``
    bytes, each period's rows after the ones before it in its block; a
    period that does not fit opens the next block."""
    import json

    from perfbench import data
    from perfbench.harness import ROOT
    with open(f"{ROOT}/perfbench/configs/tess_sector_vet.json") as f:
        cfg = json.load(f)
    periods = data.period_grid(cfg)
    durations = np.asarray(cfg["search"]["durations"], np.float64)
    d_phase = float(durations.min()) / 10
    nbins = int(np.ceil(periods.max() / d_phase))
    k = bls_curve.curve_k_bins(durations, d_phase)
    assert k.tolist() == bls_curve._k_bins(
        torch.from_numpy(durations), torch.tensor(d_phase,
                                                  dtype=F64)).tolist()
    rows = bls_curve.curve_rows(periods, k, d_phase, nbins)
    nbp = np.minimum(np.ceil(periods / d_phase), nbins)
    np.testing.assert_array_equal(rows, np.minimum(nbins, nbp + 66) + 1)
    assert (len(periods), nbins, rows.max()) == (4564, 1866, 1867)
    starts, off = bls_curve.curve_plan(rows, warps, smem)
    assert starts[0] == 0 and starts[-1] == len(periods)
    assert np.all(np.diff(starts) >= 1) and np.all(np.diff(starts) <= warps)
    for lo, hi in zip(starts[:-1], starts[1:]):
        assert off[lo] == 0
        np.testing.assert_array_equal(off[lo + 1:hi],
                                      np.cumsum(rows[lo:hi - 1]))
        assert 16 * rows[lo:hi].sum() <= smem
        if hi < len(periods):
            full = hi - lo == warps
            assert full or 16 * rows[lo:hi + 1].sum() > smem


@pytest.mark.parametrize("reciprocal", [False, True])
def test_the_route_counts_a_kernel_launch(monkeypatch, reciprocal):
    """On the CPU ``_binned`` runs the plain version (route ``binned``, its
    chunks, no ``bls.curve.kernel``; a CPU call is not among the plain
    version's ``calls``, which count it standing in for the kernel on a
    card).  Routed to the kernel, whose launch is the model here, with a
    shared memory that sends the two longest periods to the L2 kernel, it
    takes one chunk, counts one launch, reads ``binned_kernel`` and gives
    the plain version's bits (float32 data, whose float64 sums are exact
    in either order)."""
    t, y, dy = curves(15, B=2, n=500)

    def call():
        return bls._binned(t, torch.from_numpy(y), dy, PERIODS, DURATIONS,
                           d_phase=D_PHASE, reciprocal=reciprocal)

    diag.reset()
    diag.enable()
    try:
        plain_calls = bls_curve.curve_scan_plain.calls
        want = call()
        assert bls_curve.curve_scan_plain.calls == plain_calls
        spans, counts = diag.spans(), diag.counters()
        assert [s.attrs["route"] for s in spans
                if s.name == "bls.curve"] == ["binned"]
        assert "bls.curve.kernel" not in counts

        diag.reset()
        monkeypatch.setattr(bls, "curve_route", lambda dev: "kernel")
        monkeypatch.setattr(bls_curve, "_check_cuda", lambda *a: None)
        monkeypatch.setattr(bls_curve, "shared_memory_optin",
                            lambda dev: 16 * 300)
        monkeypatch.setattr(bls_curve, "curve_block",
                            lambda rows, dtype, dev: (16, 16 * 300, 2))
        monkeypatch.setattr(bls_curve, "_launch", kpc_launch)
        rows = bls_curve.curve_rows(PERIODS, bls_curve.curve_k_bins(
            DURATIONS, D_PHASE), D_PHASE, int(np.ceil(PERIODS.max()
                                                       / D_PHASE)))
        assert (16 * rows > 16 * 300).tolist() == [False] * 5 + [True] * 2
        launches = bls_curve.curve_scan.launches
        got = call()
        assert bls_curve.curve_scan.launches == launches + 1
        spans, counts = diag.spans(), diag.counters()
    finally:
        diag.disable()
        diag.reset()
    assert counts["bls.curve.kernel"] == 1
    assert counts["bls.curve.chunks"] == 1
    assert [s.attrs for s in spans if s.name == "bls.curve"] == [
        {"route": "binned_kernel", "periods": len(PERIODS), "chunks": 1}]
    assert [s.attrs for s in spans if s.name == "bls.curve.chunk"] == [
        {"index": 0, "periods": len(PERIODS)}]
    for f in want:
        assert torch.equal(got[f], want[f]), f


@pytest.mark.parametrize("B, n, each, want_by", [
    (2, 100, 1, "bytes"), (1, 2000, 64, "operations")])
def test_bound_curve_counts(B, n, each, want_by):
    """K-PC's least time (``roofline.bound_curve``): the float64 times and
    float32 weights and weighted fluxes read once, the grid, five float64
    statistics and an int32 index written per (curve, period); two adds a
    sample and one a row per column for the fold, 12 operations a window,
    at the float64 rate.  ``each`` periods of 100 bins and as many of
    200, durations of 10 and 20 bins."""
    from lightkurve_tpu_torch import roofline
    w = torch.ones((B, n), dtype=torch.float32)
    pc = torch.tensor([0.5] * each + [1.0] * each, dtype=F64)
    durs = torch.tensor([0.05, 0.1], dtype=F64)
    P = 2 * each
    rows = each * (121 + 201)                       # min(200, nbp + 20) + 1
    ops = 2 * B * (n * P + rows) + B * 12 * each * (100 * 2 + 200 * 2)
    nbytes = B * n * (8 + 2 * 4) + (P + 2) * 8 + B * P * 44
    t_bytes, t_ops = nbytes / 3.35e12, ops / 34e12
    got = roofline.bound_curve(torch.zeros((B, n), dtype=F64), w, w, pc,
                               durs, 0.005, 200)
    assert got == (max(t_bytes, t_ops) * 1e3, want_by)


# ------------------------------------------------------------- the card
def vet_curve():
    """The vet cell's first curve (``perfbench``'s seeded pool of the
    configuration ``tess_sector_vet``) flattened on the card by the public
    path, and its grid: host times, float32 flux and flux_err of the valid
    cadences, the periods and the durations."""
    import json

    from lightkurve_tpu_torch import LightCurve, config
    from lightkurve_tpu_torch.time import Time
    from perfbench import data
    from perfbench.harness import ROOT
    with open(f"{ROOT}/perfbench/configs/tess_sector_vet.json") as f:
        cfg = json.load(f)
    t = data.time_grid(cfg)
    d = data.make_stack(cfg, 4500000013, "pool", 1, "cuda", t)
    valid = d["mask"][0].cpu().numpy()
    flux = np.where(valid, d["flux"][0].cpu().numpy(), np.nan)
    err = np.where(valid, d["flux_err"][0].cpu().numpy(), np.nan)
    prev = (config.default_device, config.default_dtype)
    config.default_device, config.default_dtype = "cuda", torch.float32
    try:
        lc = LightCurve(time=Time(t, format="btjd"), flux=flux,
                        flux_err=err).remove_nans()
        flat = lc.flatten(window_length=901)
    finally:
        config.default_device, config.default_dtype = prev
    durations = np.asarray(cfg["search"]["durations"], np.float64)
    return (flat.time.value[None], flat.flux.value[None].astype(np.float32),
            flat.flux_err.value[None].astype(np.float32),
            data.period_grid(cfg, t), durations)


def long_curves(seed=17, B=2, n=20_000):
    """B curves of 30-min cadences over ~417 d (a 1-d gap every 30 d),
    5% masked, a 5e-4 box of 0.2 d at 40-90 d, noise 1e-4, and a grid of
    40 periods from 0.5 to 20 d and 40 from 60 to 100 d, whose columns
    (up to 20,067 rows) do not fit shared memory past ~72 d."""
    rng = np.random.default_rng(seed)
    cad = 30.0 / 1440.0
    idx = np.arange(n) + (np.arange(n) // 1440) * 48
    t = 120.0 + rng.uniform(0, 1, (B, 1)) + idx * cad
    y = 1.0 + 1e-4 * rng.standard_normal((B, n))
    p_inj = rng.uniform(40, 90, (B, 1))
    y[np.mod(t - t[:, :1] - 3.0, p_inj) < 0.2] -= 5e-4
    dy = np.full((B, n), 1e-4, np.float32)
    dy[rng.random((B, n)) < 0.05] = np.inf
    periods = np.concatenate([np.linspace(0.5, 20, 40),
                              np.linspace(60, 100, 40)])
    return t, y.astype(np.float32), dy, periods, np.array([0.05, 0.1, 0.2])


@pytest.mark.parametrize("name", ["vet", "five", "long", "long_looped"])
def test_kpc_against_the_plain_version_on_the_card(monkeypatch, name):
    """K-PC against the plain version on the card, both edge modes and
    both id conventions: on the vet cell's flattened curve over its grid
    of 4,564 periods, on 5 curves of their own grids, and on 2 long
    curves whose longest periods take the L2 kernel (``long_looped``: its
    workspace cut to 3 warps, which then take 40 (curve, period) items
    each in turn).  Every (curve, period) has the same winner (duration
    and transit time: the same start bin and duration) and its float64
    statistics within 1e-12; two launches give the same bits; through
    ``_binned`` the periodogram's best period is the same."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "false")
    from lightkurve_tpu_torch.ops.bls_fused import shared_memory_optin
    f64 = torch.float64
    t, y, dy, periods, durations = {
        "vet": vet_curve,
        "five": lambda: (*curves(16, B=5, n=4000), PERIODS, DURATIONS),
        "long": long_curves, "long_looped": long_curves}[name]()
    d_phase = float(np.min(durations)) / 10
    nbins = int(np.ceil(float(np.max(periods)) / d_phase))
    rows = bls_curve.curve_rows(periods, bls_curve.curve_k_bins(
        durations, d_phase), d_phase, nbins)
    n_long = int((16 * rows > shared_memory_optin("cuda")).sum())
    assert (n_long > 0) == name.startswith("long")
    if name == "long_looped":
        monkeypatch.setattr(bls_curve, "L2_WORKSPACE",
                            3 * 16 * int(rows.max()))
        assert bls_curve.curve_slots(2 * n_long, rows.max(), "cuda") == 3
    assert bls_curve.curve_route("cuda") == "kernel"
    ts, w, wy, _, pc, durs = bls._curve_inputs(
        t, torch.as_tensor(y, device="cuda"), dy, periods, durations)
    dp = torch.tensor(d_phase, dtype=f64, device="cuda")
    for edge_mode in ("wrap", "astropy"):
        for reciprocal in (False, True):
            tag = f"{name} {edge_mode} reciprocal={reciprocal}"
            args = (ts, w, wy, pc, durs)
            flags = (True, edge_mode == "wrap", reciprocal)
            host = (periods, durations)
            got = bls_curve.curve_scan(*args, d_phase, nbins, *flags,
                                       *host)
            again = bls_curve.curve_scan(*args, d_phase, nbins, *flags,
                                         *host)
            want = bls_curve.curve_scan_plain(
                *args, dp, nbins, *flags, chunk=32 if n_long else 256)
            torch.cuda.synchronize()
            for k in got:
                assert torch.equal(got[k], again[k]), (tag, k)
            for k in ("duration", "transit_time"):
                assert torch.equal(got[k], want[k]), (tag, k)
            for k in bls_curve._STATS:
                torch.testing.assert_close(got[k], want[k], rtol=1e-12,
                                           atol=0, msg=f"{tag} {k}")
            outs = []
            for route in ("kernel", "plain"):
                monkeypatch.setattr(bls, "curve_route",
                                    lambda dev, r=route: r)
                outs.append(bls._binned(t, torch.as_tensor(
                    y, device="cuda"), dy, periods, durations,
                    edge_mode=edge_mode, reciprocal=reciprocal))
            assert torch.equal(outs[0]["power"].argmax(-1),
                               outs[1]["power"].argmax(-1)), tag
