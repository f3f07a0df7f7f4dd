"""Package settings.

There is no backend switch: a CUDA tensor goes to the hand-written
kernels, a CPU tensor to their plain torch versions.
"""
from __future__ import annotations

import torch

__all__ = ["default_dtype", "resolve_dtype", "numpy_dtype"]

#: floating dtype of stacks built without an explicit ``dtype``
default_dtype = torch.float32


def resolve_dtype(dtype=None):
    """``dtype`` as a torch floating dtype (``None`` → ``default_dtype``);
    accepts torch dtypes, numpy dtypes and their names."""
    if dtype is None:
        return default_dtype
    if isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "name", None) or getattr(dtype, "__name__", None) \
        or str(dtype)
    table = {"float32": torch.float32, "float64": torch.float64}
    if name not in table:
        raise TypeError(f"unsupported dtype {dtype!r}")
    return table[name]


def numpy_dtype(dtype):
    """The numpy dtype of a torch dtype (host arrays that must round as
    the tensors do)."""
    return torch.empty((), dtype=dtype).numpy().dtype
