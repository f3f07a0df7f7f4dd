"""PRF photometry (reference ``src/lightkurve/prf/``).

Counterpart of ``lightkurve_tpu/prf``: PRF models evaluated by bilinear
interpolation of a supersampled image, scene models of stars and a
background, and batched Levenberg-Marquardt photometry of every cadence
at once on the device.
"""
from .prfmodel import KeplerPRF, SimpleKeplerPRF, GaussianPRF
from .tpfmodel import (UniformPrior, GaussianPrior, FixedValuePrior,
                       StarPrior, BackgroundPrior, FocusPrior, MotionPrior,
                       TPFModel, PRFPhotometry)

__all__ = ["KeplerPRF", "SimpleKeplerPRF", "GaussianPRF", "UniformPrior",
           "GaussianPrior", "FixedValuePrior", "StarPrior",
           "BackgroundPrior", "FocusPrior", "MotionPrior", "TPFModel",
           "PRFPhotometry"]
