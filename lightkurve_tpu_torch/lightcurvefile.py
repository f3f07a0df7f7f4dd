"""Deprecated LightCurveFile shims (``lightkurve_tpu/lightcurvefile.py``).

Lightkurve v1.x exposed ``KeplerLightCurveFile``/``TessLightCurveFile``
wrappers; v2 deprecated them in favor of ``read()``.  These shims keep the
names importable: each warns and returns what :func:`read` returns.
"""
import warnings

from .utils import LightkurveDeprecationWarning
from .io.read import read

__all__ = ["KeplerLightCurveFile", "TessLightCurveFile"]


def _deprecated_file_reader(name, **defaults):
    class _Shim:
        def __new__(cls, path, **kwargs):
            warnings.warn(
                f"`{name}` is deprecated, please use "
                "`lightkurve_tpu_torch.read()` instead.",
                LightkurveDeprecationWarning)
            merged = dict(defaults)
            merged.update(kwargs)
            return read(path, **merged)
    _Shim.__name__ = name
    return _Shim


KeplerLightCurveFile = _deprecated_file_reader("KeplerLightCurveFile")
TessLightCurveFile = _deprecated_file_reader("TessLightCurveFile")
