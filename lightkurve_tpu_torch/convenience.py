"""Convenience helpers (``lightkurve_tpu/convenience.py``)."""
import numpy as np

from .utils import show_citation_instructions  # noqa: F401

__all__ = ["show_citation_instructions", "estimate_cdpp"]


def estimate_cdpp(flux, **kwargs):
    """CDPP of a bare flux array in ppm: ``LightCurve.estimate_cdpp()`` on
    the flux at unit-spaced times (reference ``convenience.py:11-30``)."""
    from .lightcurve import LightCurve
    return LightCurve(time=np.arange(len(flux), dtype=float),
                      flux=flux).estimate_cdpp(**kwargs)
