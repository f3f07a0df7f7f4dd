"""Abstract Corrector contract (reference ``correctors/corrector.py:12-153``).

A copy of ``lightkurve_tpu/correctors/corrector.py``; the under-fitting
metric, which fetches neighbouring targets over the network, is not
ported and raises.
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
        """Measure degree of under-fitting (reference ``corrector.py:121``):
        not ported, it downloads the neighbouring targets' light curves."""
        raise NotImplementedError(
            "compute_underfit_metric is not ported to lightkurve_tpu_torch "
            "(ROADMAP A7: search.py and the archive client need the "
            "network, which the port does not use).")
