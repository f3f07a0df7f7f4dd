"""Abstract Corrector contract (reference ``correctors/corrector.py:12-153``).

A copy of ``lightkurve_tpu/correctors/corrector.py``.
"""
from __future__ import annotations

from abc import ABC, abstractmethod

__all__ = ["Corrector"]


class Corrector(ABC):
    """Abstract base class: every corrector exposes ``original_lc``,
    ``corrected_lc``, ``correct()`` and ``diagnose()``."""

    original_lc = None
    corrected_lc = None
    cadence_mask = None

    @abstractmethod
    def correct(self, **kwargs):
        """Returns a corrected LightCurve and caches it as
        ``self.corrected_lc``."""

    @abstractmethod
    def diagnose(self, **kwargs):
        """Returns plots which elucidate the most recent call to
        ``correct()``."""

    def _validate_corrected_lc(self):
        if self.corrected_lc is None:
            raise ValueError("You need to call the `correct()` method first.")

    def compute_overfit_metric(self, **kwargs):
        """Measure degree of over-fitting (reference ``corrector.py:96``)."""
        from .metrics import overfit_metric_lombscargle
        self._validate_corrected_lc()
        return overfit_metric_lombscargle(self.original_lc.normalize(),
                                          self.corrected_lc.normalize(),
                                          **kwargs)

    def compute_underfit_metric(self, **kwargs):
        """Measure degree of under-fitting (reference ``corrector.py:121``);
        the neighbours' fluxes come as ``neighbor_flux``
        (:func:`~.metrics.underfit_metric_neighbors`)."""
        from .metrics import underfit_metric_neighbors
        self._validate_corrected_lc()
        return underfit_metric_neighbors(self.corrected_lc.normalize(),
                                         **kwargs)
