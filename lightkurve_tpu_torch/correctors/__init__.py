"""Systematics correctors (reference ``src/lightkurve/correctors/``).

Counterpart of ``lightkurve_tpu/correctors``: design matrices, the
regression corrector and its PLD and SFF forms, and the over-fitting
metric.  ``CBVCorrector`` and its basis-vector loaders are not ported yet
(ROADMAP A6's remainder).
"""
from .designmatrix import (
    DesignMatrix,
    DesignMatrixCollection,
    SparseDesignMatrix,
    SparseDesignMatrixCollection,
    create_spline_matrix,
    create_sparse_spline_matrix,
)
from .corrector import Corrector
from .regressioncorrector import RegressionCorrector
from .sffcorrector import SFFCorrector
from .pldcorrector import PLDCorrector
from .metrics import overfit_metric_lombscargle

__all__ = [
    "DesignMatrix", "DesignMatrixCollection", "SparseDesignMatrix",
    "SparseDesignMatrixCollection", "create_spline_matrix",
    "create_sparse_spline_matrix", "Corrector", "RegressionCorrector",
    "SFFCorrector", "PLDCorrector", "overfit_metric_lombscargle",
]
