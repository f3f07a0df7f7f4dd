"""The staged fold of lightkurve_tpu_torch (K-SF's plain version, float64
on the CPU) against the one-hot folds it replaces, and its wrapper.

The same numpy inputs go through the bin-ordered fold
(``staged_fold_plain``: stable sort of the deposits, a running sum along
them) and the one-hot folds (``uniform_fold``, ``weighted_fold``: the
reference's XLA fold written in torch).  Bar: the bin counts and the count
prefix exactly; the prefix rows within 1e-12 of the column's sum of |x|,
an absolute bar because a mean-shifted prefix crosses zero (the two sum
in different orders).  The staged routes through the entry point are held
against the JAX package in ``test_torch_window_uniform.py`` and
``test_torch_weighted_fused.py``.
"""
import numpy as np
import pytest
import torch

from lightkurve_tpu_torch.ops import bls_fused, bls_fused_weighted, bls_window
from lightkurve_tpu_torch.ops import bls_staged_fold as sf
from tests.test_torch_bls import transit_batch

FOLD_TOL = 1e-12


def fold_case(rng, B=7, n=333, weighted=False):
    """An injected-transit batch: ts, the columns to fold (mean-shifted
    flux (n, B), or [w | w*y] (n, 2B) with ~3% masked cadences), periods
    over several 128-row tiles and the grid geometry."""
    t, Y = transit_batch(rng, B, n)
    ts = torch.from_numpy(t - t.min())
    if weighted:
        dy = rng.uniform(4e-4, 9e-4, (B, n))
        dy[rng.random((B, n)) < 0.03] = np.inf
        W = 1.0 / dy ** 2
        W = W / W[np.isfinite(W)].mean()
        mu = (W * Y).sum(1, keepdims=True) / W.sum(1, keepdims=True)
        X = torch.from_numpy(np.concatenate([W, W * (Y - mu)]).T.copy())
    else:
        X = torch.from_numpy((Y - Y.mean(1, keepdims=True)).T.copy())
    pc = torch.from_numpy(np.linspace(0.5, 3.7, 17))
    d_phase, k_max = 0.01, 25
    nbins = int(np.ceil(3.7 / d_phase))
    bound = bls_fused.max_nbins_bound(pc.numpy(), d_phase, torch.float64)
    return ts, X, pc, d_phase, nbins, bound, k_max


def assert_fold_close(got, want, X):
    """Prefix rows within FOLD_TOL of each column's sum of |x|."""
    assert got.shape == want.shape
    scale = X.abs().sum(0)
    assert torch.all((got - want).abs() <= FOLD_TOL * scale)


@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("n", [333, 256])
def test_staged_fold_matches_uniform_fold(rng, wrap, n):
    """The uniform regime: prefix rows, count prefix and bins per period
    as the one-hot fold gives them, ragged and tile-sized n."""
    ts, X, pc, d_phase, nbins, bound, k_max = fold_case(rng, n=n)
    cs, cn, nbp = sf.staged_fold_plain(ts, X, pc, d_phase, nbins, bound,
                                       k_max, wrap)
    cs1, cn1, nbp1 = bls_fused.uniform_fold(ts, X, pc, d_phase, nbins, bound,
                                            k_max, wrap)
    assert_fold_close(cs, cs1, X)
    torch.testing.assert_close(cn, cn1, rtol=0, atol=0)
    torch.testing.assert_close(nbp, nbp1, rtol=0, atol=0)
    assert cs.shape[1] == bls_fused.fold_rows(nbins, bound, k_max)


@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("B", [7, 1])
def test_staged_fold_matches_weighted_fold(rng, wrap, B):
    """The weighted regime's [w | w*y] columns, masked cadences included,
    ragged B."""
    ts, X, pc, d_phase, nbins, bound, k_max = fold_case(rng, B=B,
                                                         weighted=True)
    cs, _, nbp = sf.staged_fold_plain(ts, X, pc, d_phase, nbins, bound,
                                      k_max, wrap)
    cs1, nbp1 = bls_fused_weighted.weighted_fold(ts, X, pc, d_phase, nbins,
                                                 bound, k_max, wrap)
    assert_fold_close(cs, cs1, X)
    torch.testing.assert_close(nbp, nbp1, rtol=0, atol=0)


@pytest.mark.parametrize("wrap", [True, False])
def test_deposits_cover_the_rows(rng, wrap):
    """The deposit rows: every sample once, and in wrap mode again where
    its bin plus nbins_p lies below npad; row starts ascend to that count;
    the sources of a row keep time order, direct deposits first."""
    ts, X, pc, d_phase, nbins, bound, k_max = fold_case(rng)
    npad = bls_fused.fold_rows(nbins, bound, k_max)
    src, row_start, nbp = sf.fold_deposits(ts, pc, d_phase, nbins, npad,
                                           wrap)
    ids = bls_fused.fold_ids(ts, pc, d_phase, nbins)
    n = ts.shape[0]
    wrapped = (ids + nbp[:, None] < npad).sum(1) * wrap
    torch.testing.assert_close(row_start[:, -1], (n + wrapped).to(
        torch.int32), rtol=0, atol=0)
    assert torch.all(row_start[:, 1:] >= row_start[:, :-1])
    assert src.shape == (pc.shape[0], 2 * n if wrap else n)
    for c in range(pc.shape[0]):
        for r in (0, int(nbp[c]) - 1, int(nbp[c])):
            lo, hi = int(row_start[c, r]), int(row_start[c, r + 1])
            rows = src[c, lo:hi].long()
            direct = rows[ids[c, rows] == r]
            assert torch.all(direct[1:] > direct[:-1])
            assert torch.equal(rows[:direct.numel()], direct)


def test_exact_integer_period_interleaves_deposits(rng):
    """At 0.4 d and d_phase 0.01 the period is exactly 40 bins, and a
    sample just before 0.4 d folds to bin 40 = nbins_p: row 40 then holds a
    direct deposit and the wrap deposits of bin 0.  Both folds agree."""
    n, B = 400, 5
    t = np.sort(np.concatenate([[0.0, np.nextafter(0.4, 0.0)],
                                rng.uniform(0.0, 6.0, n - 2)]))
    Y = 1.0 + 1e-3 * rng.normal(size=(B, n))
    ts = torch.from_numpy(t)
    X = torch.from_numpy((Y - Y.mean(1, keepdims=True)).T.copy())
    pc = torch.tensor([0.4, 0.9], dtype=torch.float64)
    d_phase, nbins, k_max = 0.01, 90, 12
    bound = bls_fused.max_nbins_bound(pc.numpy(), d_phase, torch.float64)
    ids = bls_fused.fold_ids(ts, pc, d_phase, nbins)
    nbp = bls_fused.nbins_per_period(pc, d_phase)
    assert int(nbp[0]) == 40 and bool((ids[0] == 40).any())
    assert bool((ids[0] == 0).any())
    cs, cn, _ = sf.staged_fold_plain(ts, X, pc, d_phase, nbins, bound, k_max)
    cs1, cn1, _ = bls_fused.uniform_fold(ts, X, pc, d_phase, nbins, bound,
                                         k_max)
    assert_fold_close(cs, cs1, X)
    torch.testing.assert_close(cn, cn1, rtol=0, atol=0)


@pytest.mark.parametrize("wrap", [True, False])
def test_empty_rows_repeat_bit_for_bit(rng, wrap):
    """A row that receives no deposit repeats the row before it bit for
    bit, and rows before the first deposit are 0: the exact ties that the
    astropy edge mode's truncated windows rely on."""
    n, B = 120, 4
    t = np.sort(rng.uniform(0.0, 30.0, n))              # sparse: empty bins
    Y = 1.0 + 1e-3 * rng.normal(size=(B, n))
    ts = torch.from_numpy(t - t.min())
    X = torch.from_numpy((Y - Y.mean(1, keepdims=True)).T.copy())
    pc = torch.from_numpy(np.array([2.3, 2.9, 3.1]))
    d_phase, nbins, k_max = 0.01, 310, 20
    bound = bls_fused.max_nbins_bound(pc.numpy(), d_phase, torch.float64)
    cs, cn, nbp = sf.staged_fold_plain(ts, X, pc, d_phase, nbins, bound,
                                       k_max, wrap)
    empty = cn[:, 1:] == cn[:, :-1]                     # (C, npad - 1)
    assert bool(empty.any())
    same = (cs[:, 1:] == cs[:, :-1]).all(-1)
    assert torch.all(same[empty])
    before = cn == 0
    assert torch.all(cs[before] == 0.0)
    if not wrap:
        for c in range(pc.shape[0]):
            tail = cs[c, int(nbp[c]) - 1:]
            assert torch.equal(tail, tail[:1].expand_as(tail))


def test_staged_fold_runs_plain_on_cpu_and_refuses_other_devices(rng):
    """CPU tensors take the plain version (its call count rises, no
    launch is counted); a tensor on any other device must launch K-SF or
    raise, and the kernel's entry refuses a non-contiguous (n, cols)."""
    ts, X, pc, d_phase, nbins, bound, k_max = fold_case(rng)
    calls, launches = sf.staged_fold_plain.calls, sf.staged_fold.launches
    got = sf.staged_fold(ts, X, pc, d_phase, nbins, bound, k_max)
    want = sf.staged_fold_plain(ts, X, pc, d_phase, nbins, bound, k_max)
    assert sf.staged_fold_plain.calls == calls + 2
    assert sf.staged_fold.launches == launches
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA"):
        sf.staged_fold(ts.to(meta), X.to(meta), pc.to(meta), d_phase, nbins,
                       bound, k_max)

    class OnCard(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    with pytest.raises(ValueError, match="contiguous"):
        bls_window._check_cuda("X", X.T.as_subclass(OnCard), X.dtype)


@pytest.mark.parametrize("weighted", [False, True])
def test_staged_route_folds_with_the_staged_fold(rng, weighted):
    """The staged route of either regime folds through ``staged_fold``
    (on the CPU its plain version, once per slice of periods) and never
    through the one-hot folds."""
    t, Y = transit_batch(rng, 6, 333)
    dy = None
    if weighted:
        dy = rng.uniform(4e-4, 9e-4, Y.shape)
        dy[rng.random(Y.shape) < 0.03] = np.inf
    periods = np.linspace(1.2, 4.0, 23)
    calls = sf.staged_fold_plain.calls
    from lightkurve_tpu_torch.ops import bls as tbls

    def refuse(*args, **kwargs):
        raise AssertionError("the staged route ran a one-hot fold")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bls_fused, "uniform_fold", refuse)
        mp.setattr(bls_fused_weighted, "weighted_fold", refuse)
        out = tbls.bls_power_shared_batch(t, Y, dy, periods,
                                          np.array([0.1, 0.2]), chunk=5,
                                          fold_impl="staged", device="cpu")
    assert sf.staged_fold_plain.calls == calls + 5
    assert torch.isfinite(out["power"]).all()
