"""lightkurve_tpu_torch.roofline: the ported cost functions equal
lightkurve_tpu's exactly, the H100 peaks and their lookup, the fractions'
arithmetic, and the BLS kernels' bounds moved from chip_smoke.py, held to
the values the script's own helpers gave at these shapes before the move
(float32 and float64 CPU tensors)."""
import numpy as np
import pytest
import torch

from lightkurve_tpu import roofline as jroof
from lightkurve_tpu_torch import roofline as troof
from lightkurve_tpu_torch.ops.bls_fused import (fold_rows, max_nbins_bound,
                                                nbins_per_period)

COSTS = [
    ("ls_fast_cost", [(8192, 2048, 16384), (1000, 3, 500, 3, 2, False, 8)]),
    ("fastchi2_cost", [(8192, 1, 100_000, 3), (500, 4, 2048, 1, 5, 4, False,
                                               8)]),
    ("flatten_cost", [(19440, 2048, 901), (100, 3, 11, 5, 8)]),
    ("acf_windows_cost", [(32, 257, 4096), (1, 3, 100, 8)]),
    ("pld_photometry_cost", [(512, 19440, 11, 11, 3), (2, 100, 5, 4, 1, 8)]),
]


@pytest.mark.parametrize("name,arg_sets", COSTS)
def test_costs_equal_the_reference(name, arg_sets):
    for args in arg_sets:
        assert getattr(troof, name)(*args) == getattr(jroof, name)(*args)


def test_device_peaks():
    sxm = troof.device_peaks("NVIDIA H100 80GB HBM3")
    assert sxm["kind"] == "h100_sxm"
    assert (sxm["hbm"], sxm["f32"], sxm["f64"], sxm["tf32"], sxm["bf16"],
            sxm["f64_tensor"]) == (3.35e12, 67e12, 34e12, 494.7e12,
                                   989.4e12, 67e12)
    assert troof.device_peaks("NVIDIA H100 PCIe")["kind"] == "h100_pcie"
    assert troof.device_peaks("cpu")["kind"] == "cpu"
    assert troof.device_peaks(torch.device("cpu"))["kind"] == "cpu"
    assert troof.device_peaks("a CPU-only host")["kind"] == "cpu"
    for row in troof.PEAKS.values():
        assert set(row) == set(troof.PEAKS["h100_sxm"])


def test_fractions_of_peak():
    cost = {"flops": 6.7e12, "hbm_bytes": 3.35e11}
    out = troof.fractions_of_peak(cost, 0.5, "NVIDIA H100 80GB HBM3")
    assert out == {"flops": 6.7e12, "hbm_bytes_min": 3.35e11, "mfu": 0.2,
                   "membw_frac": 0.2, "peak_basis": "h100_sxm:f32"}
    out = troof.fractions_of_peak(cost, 0.5, "NVIDIA H100 PCIe",
                                  matmul_peak="tf32")
    assert out["mfu"] == round(6.7e12 / (0.5 * 378e12), 4)
    assert out["peak_basis"] == "h100_pcie:tf32"
    assert troof.fractions_of_peak(cost, 1.0, "cpu")["membw_frac"] == 3.35


def bound_args(dtype, n=300, B=6, d_phase=0.05 / 5):
    """Each bound's arguments at one small shape: ``n`` seeded times over
    12 d, ``B`` curves, 5 periods of 1-3 d, three durations."""
    rng = np.random.default_rng(5)
    t = np.sort(rng.uniform(0, 12.0, n))
    ts = torch.as_tensor(t - t.min(), dtype=dtype)
    durs = np.array([0.05, 0.1, 0.2])
    k_durs = tuple(int(max(int(d / d_phase + 0.5), 1)) for d in durs)
    periods = np.linspace(1.0, 3.0, 5)
    pc = torch.as_tensor(periods, dtype=dtype)
    max_nbp = max_nbins_bound(periods, d_phase, dtype)
    nbins, k_max = int(max_nbp), max(k_durs)
    npad = fold_rows(nbins, max_nbp, k_max)
    Y = torch.as_tensor(rng.standard_normal((n, B)), dtype=dtype)
    nbp = nbins_per_period(pc, d_phase)
    C = pc.shape[0]
    common = (k_durs, tuple(durs), d_phase)
    zeros = lambda *s: torch.zeros(s, dtype=dtype)  # noqa: E731
    return {
        "fused": (troof.bound_fused, (ts, Y, pc, *common, nbins, max_nbp)),
        "weighted_fused": (troof.bound_weighted_fused,
                           (ts, Y, Y, pc, *common, nbins, max_nbp)),
        "weighted": (troof.bound_weighted, (zeros(C, npad, 2 * B), nbp, pc,
                                            zeros(2 * B), *common)),
        "uniform": (troof.bound_uniform, (zeros(C, npad, B), zeros(C, npad),
                                          nbp, pc, zeros(B), float(n),
                                          *common)),
        "staged_fold": (troof.bound_staged_fold,
                        (ts, torch.cat([Y, Y], 1), pc, d_phase, nbins,
                         max_nbp, k_max)),
        "staged_fold_nowrap": (troof.bound_staged_fold,
                               (ts, Y, pc, d_phase, nbins, max_nbp, k_max,
                                False)),
    }


#: chip_smoke.py's bound_* before they moved, at these shapes (ms, by)
BOUNDS_BEFORE = {
    ("small", torch.float32): {
        "fused": (2.7056716417910446e-06, "bytes"),
        "weighted_fused": (4.862089552238806e-06, "bytes"),
        "weighted": (2.7715820895522386e-05, "bytes"),
        "uniform": (1.6245970149253732e-05, "bytes"),
        "staged_fold": (7.077253731343283e-05, "bytes"),
        "staged_fold_nowrap": (2.8591044776119405e-05, "bytes")},
    ("small", torch.float64): {
        "fused": (5.3994029850746275e-06, "bytes"),
        "weighted_fused": (9.71223880597015e-06, "bytes"),
        "weighted": (5.5419701492537316e-05, "bytes"),
        "uniform": (3.2479999999999994e-05, "bytes"),
        "staged_fold": (0.00013609552238805968, "bytes"),
        "staged_fold_nowrap": (5.3092537313432834e-05, "bytes")},
    ("fine", torch.float32): {
        "fused": (0.00021522611940298506, "operations"),
        "weighted_fused": (0.00036739820895522385, "operations"),
        "weighted": (0.002447448358208955, "bytes"),
        "uniform": (0.0012437898507462687, "bytes"),
        "staged_fold": (0.002545041194029851, "bytes"),
        "staged_fold_nowrap": (0.0012666328358208955, "bytes")},
    ("fine", torch.float64): {
        "fused": (0.00021522611940298506, "operations"),
        "weighted_fused": (0.00036739820895522385, "operations"),
        "weighted": (0.004894884776119403, "bytes"),
        "uniform": (0.0024875677611940297, "bytes"),
        "staged_fold": (0.005070347462686566, "bytes"),
        "staged_fold_nowrap": (0.0025137731343283583, "bytes")},
}
SHAPES = {"small": {}, "fine": dict(n=64, B=64, d_phase=0.001)}


@pytest.mark.parametrize("shape,dtype", list(BOUNDS_BEFORE))
def test_bounds_keep_their_values(shape, dtype):
    for name, (fn, args) in bound_args(dtype, **SHAPES[shape]).items():
        assert fn(*args) == BOUNDS_BEFORE[(shape, dtype)][name], name


def test_bound_peaks_are_the_sxm_row():
    assert troof.PEAK_BYTES_S == troof.PEAKS["h100_sxm"]["hbm"] == 3.35e12
    assert troof.PEAK_F32_S == troof.PEAKS["h100_sxm"]["f32"] == 67e12
