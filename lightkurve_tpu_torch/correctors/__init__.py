"""Systematics correctors (reference ``src/lightkurve/correctors/``).

Counterpart of ``lightkurve_tpu/correctors``: design matrices, the
regression corrector and its PLD, SFF and CBV forms (the CBV loaders read
local files), and the over- and under-fitting metrics (the latter given
the neighbours' fluxes).
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
from .cbvcorrector import (
    CBVCorrector,
    CotrendingBasisVectors,
    KeplerCotrendingBasisVectors,
    TessCotrendingBasisVectors,
    load_kepler_cbvs,
    load_tess_cbvs,
)
from .metrics import (
    overfit_metric_lombscargle,
    underfit_metric_neighbors,
)

__all__ = [
    "DesignMatrix", "DesignMatrixCollection", "SparseDesignMatrix",
    "SparseDesignMatrixCollection", "create_spline_matrix",
    "create_sparse_spline_matrix", "Corrector", "RegressionCorrector",
    "SFFCorrector", "PLDCorrector", "CBVCorrector",
    "CotrendingBasisVectors", "KeplerCotrendingBasisVectors",
    "TessCotrendingBasisVectors", "load_kepler_cbvs", "load_tess_cbvs",
    "overfit_metric_lombscargle", "underfit_metric_neighbors",
]
