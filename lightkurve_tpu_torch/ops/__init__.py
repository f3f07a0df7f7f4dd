"""The device-side operations: shared-grid BLS and its CUDA kernels, and
the plain torch ops of the other paths (counterpart of
``lightkurve_tpu.ops``; the same names).

Not here: ``fft_pair``, ``ifft_pair`` and ``rfft_pair``
(``lightkurve_tpu/ops/fft.py`` splits complex FFTs into real pairs for a
TPU backend without complex numbers; the port calls ``torch.fft``).
"""
from .masked import (
    nan_to_mask,
    masked_sum,
    masked_mean,
    masked_std,
    masked_median,
    masked_var,
)
from .stats import sigma_clip_mask, running_mean as running_mean_op
from .savgol import savgol_design_matrix, savgol_filter_interp
from .detrend import flatten as flatten_op, flatten_batch
from .fold import fold_phase, transit_mask as transit_mask_op, bin_folded
from .binning import bin_time as bin_time_op
from .lombscargle import (
    lombscargle_direct,
    lombscargle_fast,
    lombscargle_chi2,
    extirpolate,
    trig_sum,
)
from .bls import (bls_power, bls_power_direct, bls_power_binned,
                  bls_objective_single)
from .solve import (
    solve_regression,
    iterative_clipped_regression,
    randomized_pca,
)
from .acf import autocorrelate_windows, acf2d
from .photometry import (
    aperture_photometry_cube,
    centroid_moments_cube,
    background_estimate_cube,
)
from .interp import interp_linear_extrap, pchip_interpolate

#: the reference's names the port leaves out, with the reason
NOT_PORTED = {name: "lightkurve_tpu/ops/fft.py is a TPU workaround"
              for name in ("fft_pair", "ifft_pair", "rfft_pair")}

__all__ = [
    "nan_to_mask", "masked_sum", "masked_mean", "masked_std",
    "masked_median", "masked_var",
    "sigma_clip_mask", "running_mean_op",
    "savgol_design_matrix", "savgol_filter_interp",
    "flatten_op", "flatten_batch",
    "fold_phase", "transit_mask_op", "bin_folded", "bin_time_op",
    "lombscargle_direct", "lombscargle_fast", "lombscargle_chi2",
    "extirpolate", "trig_sum",
    "bls_power", "bls_power_direct", "bls_power_binned",
    "bls_objective_single",
    "solve_regression", "iterative_clipped_regression", "randomized_pca",
    "autocorrelate_windows", "acf2d",
    "aperture_photometry_cube", "centroid_moments_cube",
    "background_estimate_cube",
    "interp_linear_extrap", "pchip_interpolate",
]
