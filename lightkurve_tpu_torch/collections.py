"""Collections of light curves (reference ``collections.py``).

A copy of ``lightkurve_tpu/collections.py``'s ``Collection`` and
``LightCurveCollection``: ``stitch`` concatenates member curves after a
per-curve corrector function (default: normalize), as reference
``collections.py:173-228`` does, and ``to_stack`` packs the members into a
:class:`lightkurve_tpu_torch.batch.LightCurveStack` for the batched torch
functions and kernels; ``TargetPixelFileCollection.to_stack`` packs target
pixel files into a :class:`lightkurve_tpu_torch.batch.TPFStack`.  ``plot``
draws every member with matplotlib, imported inside the call.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np

from .time import Time
from .units import Quantity
from .utils import LightkurveWarning

__all__ = ["Collection", "LightCurveCollection",
           "TargetPixelFileCollection"]


class Collection:
    """Base list-like container (reference ``collections.py:18-143``)."""

    def __init__(self, items):
        self.data = list(items)

    def append(self, obj):
        self.data.append(obj)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, key):
        if isinstance(key, (int, np.integer)):
            return self.data[key]
        if isinstance(key, slice):
            return type(self)(self.data[key])
        key = np.asarray(key)
        if key.dtype == bool:
            # boolean masks must match the collection length exactly
            # (reference test_collection_getitem_by_boolean_array)
            if len(key) != len(self.data):
                raise IndexError(
                    f"boolean index of length {len(key)} does not match "
                    f"collection of length {len(self.data)}")
            return type(self)([d for d, k in zip(self.data, key) if k])
        if key.dtype.kind not in "iu":
            # follow ndarray fancy-indexing: non-int/bool arrays are invalid
            raise IndexError(
                f"arrays used as indices must be of integer or boolean "
                f"type (got {key.dtype})")
        try:
            return type(self)([self.data[int(i)] for i in key])
        except IndexError:
            raise IndexError(
                f"index out of range for collection of length "
                f"{len(self.data)}")

    def __setitem__(self, key, value):
        self.data[key] = value

    def __iter__(self):
        return iter(self.data)

    def __repr__(self):
        lines = [f"{type(self).__name__} of {len(self)} objects:"]
        for i, obj in enumerate(self.data):
            label = obj.meta.get("LABEL") if hasattr(obj, "meta") else ""
            lines.append(f"    {i}: {type(obj).__name__} (ID: "
                         f"{getattr(obj, 'targetid', None) or obj.meta.get('TARGETID') if hasattr(obj, 'meta') else ''}) {label}")
        return "\n".join(lines)

    def _safe_scalar_attr(self, name):
        """Per-member scalar attribute with ``np.nan`` for members that
        lack it, so the result supports numeric comparison/filtering
        (reference ``collections.py:104-106``)."""
        return np.array([getattr(o, name, np.nan) for o in self.data])

    @property
    def sector(self):
        """(TESS) member sectors; ``np.nan``/``None`` when absent."""
        return self._safe_scalar_attr("sector")

    @property
    def quarter(self):
        """(Kepler) member quarters; ``np.nan``/``None`` when absent."""
        return self._safe_scalar_attr("quarter")

    @property
    def campaign(self):
        """(K2) member campaigns; ``np.nan``/``None`` when absent."""
        return self._safe_scalar_attr("campaign")


class LightCurveCollection(Collection):
    """A list of LightCurves (reference ``collections.py:145-277``)."""

    @property
    def SAP_FLUX(self):
        """Deprecated v1.x alias (reference ``collections.py:165-171``):
        per-member ``SAP_FLUX`` copies."""
        import warnings
        from .utils import LightkurveDeprecationWarning
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", LightkurveDeprecationWarning)
            out = LightCurveCollection([lc.SAP_FLUX for lc in self])
        warnings.warn("`SAP_FLUX` is deprecated, use "
                      "`select_flux('sap_flux')` on the members instead.",
                      LightkurveDeprecationWarning)
        return out

    @property
    def PDCSAP_FLUX(self):
        """Deprecated v1.x alias (reference ``collections.py:157-163``):
        per-member ``PDCSAP_FLUX`` copies."""
        import warnings
        from .utils import LightkurveDeprecationWarning
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", LightkurveDeprecationWarning)
            out = LightCurveCollection([lc.PDCSAP_FLUX for lc in self])
        warnings.warn("`PDCSAP_FLUX` is deprecated, use "
                      "`select_flux('pdcsap_flux')` on the members "
                      "instead.", LightkurveDeprecationWarning)
        return out

    def stitch(self, corrector_func=lambda x: x.normalize()):
        """Concatenate the (corrected) member curves into one LightCurve,
        keeping only columns common to all members
        (reference ``collections.py:173-228``)."""
        if corrector_func is None:
            corrector_func = lambda x: x  # noqa: E731
        lcs = [corrector_func(lc) for lc in self.data]
        if not lcs:
            raise ValueError("The collection is empty")
        # intersection of column names (vstack join_type='inner')
        common = set(lcs[0].columns)
        for lc in lcs[1:]:
            common &= set(lc.columns)

        # same-name columns whose types cannot be merged (Quantity vs plain
        # array, or non-same-kind-castable dtypes) are excluded with a
        # warning (reference collections.py:198-226)
        def _kind(col):
            if isinstance(col, Time):
                return ("time", "f")
            kind = np.asarray(col).dtype.kind
            # all numeric kinds concatenate losslessly (int+float → float),
            # so they count as one compatibility class
            kind = "num" if kind in "iufb" else kind
            if isinstance(col, Quantity):
                return ("quantity", kind)
            return ("array", kind)

        incompatible = set()
        for name in common:
            k0 = _kind(lcs[0]._cols[name])
            for lc in lcs[1:]:
                k = _kind(lc._cols[name])
                if k[0] != k0[0] or k[1] != k0[1]:
                    incompatible.add(name)
                    break
        if incompatible:
            import warnings
            warnings.warn(
                "The following columns will be excluded from stitching "
                "because the column types are incompatible: "
                f"{incompatible}", LightkurveWarning)
            common -= incompatible
        ordered = [c for c in lcs[0].columns if c in common]

        fmt = lcs[0].time.format
        new_cols = OrderedDict()
        for name in ordered:
            parts = []
            for lc in lcs:
                col = lc._cols[name]
                if isinstance(col, Time):
                    parts.append(col.to_value(fmt))
                elif isinstance(col, Quantity):
                    parts.append(col.value)
                else:
                    parts.append(np.asarray(col))
            stacked = np.concatenate(parts)
            if name == "time":
                new_cols[name] = Time(stacked, format=fmt,
                                      scale=lcs[0].time.scale)
            elif isinstance(lcs[0]._cols[name], Quantity):
                new_cols[name] = Quantity(stacked, lcs[0]._cols[name].unit)
            else:
                new_cols[name] = stacked
        out = type(lcs[0]).__new__(type(lcs[0]))
        object.__setattr__(out, "meta", dict(lcs[0].meta))
        object.__setattr__(out, "_cols", new_cols)
        return out

    def to_stack(self, **kwargs):
        """Pack into a :class:`~lightkurve_tpu_torch.batch.LightCurveStack`
        (keyword arguments go to ``LightCurveStack.from_collection``: by
        default on the card, in :data:`config.default_dtype`)."""
        from .batch import LightCurveStack
        return LightCurveStack.from_collection(self, **kwargs)

    def plot(self, ax=None, offset=0.0, **kwargs):
        """Plot all curves with vertical offsets
        (reference ``collections.py:230-277``)."""
        import matplotlib.pyplot as plt
        if ax is None:
            _, ax = plt.subplots()
        for i, lc in enumerate(self.data):
            lc.plot(ax=ax, offset=i * offset,
                    label=lc.meta.get("LABEL"), **kwargs)
        return ax


class TargetPixelFileCollection(Collection):
    """A list of TargetPixelFiles (reference ``collections.py:279-313``)."""

    def plot(self, ax=None):
        """One image per member (reference ``collections.py:300-313``)."""
        import matplotlib.pyplot as plt
        if ax is None:
            _, ax = plt.subplots(len(self.data), 1,
                                 figsize=(7, 7 * len(self.data)))
        if len(self.data) == 1:
            self.data[0].plot(ax=ax)
        else:
            for a, tpf in zip(np.atleast_1d(ax), self.data):
                tpf.plot(ax=a)
        return ax

    def to_stack(self, **kwargs):
        """Pack the TPF cubes into a
        :class:`~lightkurve_tpu_torch.batch.TPFStack` (keyword arguments
        go to ``TPFStack.from_collection``)."""
        from .batch import TPFStack
        return TPFStack.from_collection(self, **kwargs)
