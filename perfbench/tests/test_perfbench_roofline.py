"""The roofline count: held at a hand-worked shape, and the same whichever
route the program takes."""
import pytest

from perfbench import harness, roofline
from perfbench.tests.tiny import cells_of_kind, tiny_root


def test_counts_at_a_hand_worked_shape():
    # d_phase 0.005 d; durations of 1 and 2 bins; periods of 4 and 6 bins:
    # windows 4*2 + 6*2 = 20, rows (4 + 1) + (6 + 1) = 12
    args = (25, 3, 10, [0.02, 0.03], [0.005, 0.01], 1)
    nbytes, ops = roofline.search_counts(*args, weighted=True)
    # fold 2 * (25 * 2 + 3 * 12) = 172, scan 3 * 12 * 20 = 720
    assert ops == 892
    # (2 * 3 * 10 + 10) * 4 + 30 mask, 8 * 3 * 8 winners, periods, durations
    assert nbytes == 280 + 30 + 192 + 16 + 16
    nbytes, ops = roofline.search_counts(30, 3, 10, [0.02, 0.03],
                                         [0.005, 0.01], 1, weighted=False)
    # fold (30 + 10) * 2 + 4 * 12 = 128, scan (3 * 7 + 6) * 20 = 540
    assert ops == 668
    assert nbytes == (30 + 10 + 3) * 4 + 192 + 16 + 16
    t, bound = roofline.least_seconds(3.35e12, 1.0)
    assert t == pytest.approx(1.0) and bound == "bytes"
    t, bound = roofline.least_seconds(1.0, 67e12)
    assert t == pytest.approx(1.0) and bound == "operations"


@pytest.mark.parametrize("cell", cells_of_kind("sweep"))
def test_count_is_the_same_on_either_route(tmp_path, monkeypatch, cell):
    """The count comes from the inputs handed over: forcing the fused or
    the staged route changes the kernels called, not the count."""
    from lightkurve_tpu_torch.ops import bls
    root = tiny_root(str(tmp_path))
    seen, counts, winners = {}, {}, {}
    real = bls.fold_route

    def forced(route):
        def pick(fold_impl, *a, **k):
            seen[route] = seen.get(route, 0) + 1
            return real(route, *a, **k)
        return pick

    for route in ("fused", "staged"):
        monkeypatch.setattr(bls, "fold_route", forced(route))
        run, checks, *_ = harness.run_cell(harness.load_cell(cell, root), 11,
                                           0.0, False, device="cpu")
        counts[route] = run.searches
        winners[route] = [v for _, v, _l in checks]
    assert seen["fused"] > 0 and seen["staged"] > 0
    assert counts["fused"] == counts["staged"]
    # on the CPU both routes' plain versions give the same bits
    assert winners["fused"] == winners["staged"]
