"""Model-family index.

Counterpart of ``lightkurve_tpu/models.py``: the PRF scene models
(``prf/``), the systematics design-matrix models (``correctors/``) and
the asteroseismic estimators (``seismology/``) under one roof.
"""
from .prf import (GaussianPRF, KeplerPRF, SimpleKeplerPRF, TPFModel,
                  PRFPhotometry, StarPrior, BackgroundPrior, FocusPrior,
                  MotionPrior, UniformPrior, GaussianPrior, FixedValuePrior)
from .correctors import (DesignMatrix, DesignMatrixCollection,
                         RegressionCorrector, SFFCorrector, PLDCorrector,
                         CBVCorrector, CotrendingBasisVectors)
from .seismology import Seismology, SeismologyQuantity

__all__ = [
    "GaussianPRF", "KeplerPRF", "SimpleKeplerPRF", "TPFModel",
    "PRFPhotometry", "StarPrior", "BackgroundPrior", "FocusPrior",
    "MotionPrior", "UniformPrior", "GaussianPrior", "FixedValuePrior",
    "DesignMatrix", "DesignMatrixCollection", "RegressionCorrector",
    "SFFCorrector", "PLDCorrector", "CBVCorrector",
    "CotrendingBasisVectors", "Seismology", "SeismologyQuantity",
]
