"""Package settings.

There is no backend switch: a CUDA tensor goes to the hand-written
kernels, a CPU tensor to their plain torch versions.  Entry points that
build tensors put them on the card unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

__all__ = ["default_dtype", "default_device", "resolve_dtype",
           "resolve_device", "on_device", "numpy_dtype", "full_f32_matmul"]

#: floating dtype of stacks built without an explicit ``dtype``
default_dtype = torch.float32

#: device of stacks built without an explicit ``device``
default_device = "cuda"


def resolve_device(device=None):
    """``device`` as a torch device (``None`` → :data:`default_device`).
    A CUDA device on a machine without one raises: nothing falls back to
    the CPU unless the caller asks for it."""
    device = torch.device(device if device is not None else default_device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested (the default) but CUDA is not "
            "available; pass device='cpu' to run the plain torch versions")
    return device


def on_device(y, device=None):
    """``y`` as a tensor, whose device and dtype set a computation's: a
    tensor stays on its device unless ``device`` is given; a host array
    goes to ``device`` (:func:`resolve_device`: the card unless the caller
    passes ``"cpu"``)."""
    if isinstance(y, torch.Tensor):
        return y if device is None else y.to(resolve_device(device))
    return torch.as_tensor(np.asarray(y), device=resolve_device(device))


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


@contextlib.contextmanager
def full_f32_matmul(device):
    """Run float32 matrix products on ``device`` in full float32 inside the
    block, whatever the global flag is: on the card a product may
    otherwise round its inputs to TF32."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
