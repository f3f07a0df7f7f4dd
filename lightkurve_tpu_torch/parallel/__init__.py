"""Checkpointed period-grid sweeps and the sharded searches over a
(targets, grid) mesh of ``torch.distributed`` ranks (counterpart of
``lightkurve_tpu.parallel``)."""
from .grid import (make_mesh, sharded_bls, sharded_lombscargle,
                   sharded_flatten, sharded_pld_photometry, best_candidates)

__all__ = ["make_mesh", "sharded_bls", "sharded_lombscargle",
           "sharded_flatten", "sharded_pld_photometry", "best_candidates"]
