"""Package settings.

There is no backend switch: a CUDA tensor goes to the hand-written
kernels, a CPU tensor to their plain torch versions.  Entry points that
build tensors put them on the card unless the caller passes
``device="cpu"``.

:data:`conf` is the user-settings namespace of ``lightkurve_tpu``'s
``config`` package (its three Lightkurve knobs), read from the same
``lightkurve.cfg`` and ``lightkurve_tpu.cfg`` files in the same
directories, with the same cache-directory order
(:func:`get_cache_dir`), so a user's settings carry over.
"""
from __future__ import annotations

import configparser
import contextlib
import os
import warnings

import numpy as np
import torch

__all__ = ["default_dtype", "default_device", "resolve_dtype",
           "resolve_device", "on_device", "numpy_dtype", "full_f32_matmul",
           "Conf", "conf", "get_config_dir", "get_cache_dir"]

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


# ---------------------------------------------------------------------------
# user settings (lightkurve_tpu/config/__init__.py:19-139)
# ---------------------------------------------------------------------------
class Conf:
    """Namespace of configuration items.  A file's other keys (the JAX
    package's backend and dtype knobs among them) are read without error
    and ignored; :meth:`save` keeps them.

    Attributes
    ----------
    search_result_display_extra_columns : list of str
        Extra columns shown in SearchResult reprs.
    cache_dir : str or None
        Directory for downloaded files; None → default resolution.
    warn_legacy_cache_dir : bool
        Warn if a legacy ``~/.lightkurve-cache`` directory exists.
    """

    def __init__(self):
        self.search_result_display_extra_columns = []
        self.cache_dir = None
        self.warn_legacy_cache_dir = True
        self._load()

    def _load(self):
        """Config files in load order: a Lightkurve ``lightkurve.cfg``
        first, then ``lightkurve_tpu.cfg`` overriding it."""
        for name in ("lightkurve.cfg", "lightkurve_tpu.cfg"):
            path = os.path.join(_config_dir(), name)
            if os.path.isfile(path):
                self._load_file(path)

    def _load_file(self, path):
        try:
            cp = configparser.ConfigParser()
            cp.read(path)
            # the package's own [lightkurve_tpu] section and Lightkurve's
            # astropy-style sections ([search], [config])
            sec = {}
            for name in ("search", "config", "lightkurve", "lightkurve_tpu"):
                if name in cp:
                    sec.update(dict(cp[name]))
            if "cache_dir" in sec:
                self.cache_dir = sec["cache_dir"]
            if "search_result_display_extra_columns" in sec:
                cols = sec["search_result_display_extra_columns"].strip()
                self.search_result_display_extra_columns = (
                    [c.strip() for c in cols.split(",") if c.strip()])
        except Exception as e:  # config must never break imports
            warnings.warn(f"Could not read config file {path}: {e}")

    def save(self):
        """Write the settings to ``lightkurve_tpu.cfg`` (its
        ``[lightkurve_tpu]`` section), keeping the keys of that section
        this namespace does not own."""
        path = os.path.join(get_config_dir(), "lightkurve_tpu.cfg")
        cp = configparser.ConfigParser()
        if os.path.isfile(path):
            cp.read(path)
        sec = dict(cp["lightkurve_tpu"]) if "lightkurve_tpu" in cp else {}
        sec.update({
            "cache_dir": self.cache_dir or "",
            "search_result_display_extra_columns": ",".join(
                self.search_result_display_extra_columns)})
        cp["lightkurve_tpu"] = sec
        with open(path, "w") as f:
            cp.write(f)

    def reload(self):
        self.__init__()


def _config_dir():
    xdg = os.environ.get("XDG_CONFIG_HOME")
    if xdg and os.path.isdir(xdg):
        return os.path.join(xdg, "lightkurve_tpu")
    return os.path.join(os.path.expanduser("~"), ".lightkurve_tpu",
                        "config")


def get_config_dir():
    """Return (creating if needed) the configuration directory:
    ``$XDG_CONFIG_HOME/lightkurve_tpu`` where ``$XDG_CONFIG_HOME`` exists,
    else ``~/.lightkurve_tpu/config``.  Reading the settings creates
    nothing."""
    base = _config_dir()
    os.makedirs(base, exist_ok=True)
    return base


def get_cache_dir():
    """Return (creating if needed) the download-cache directory, the first
    of: ``conf.cache_dir``, ``$LIGHTKURVE_CACHE_DIR``,
    ``$XDG_CACHE_HOME/lightkurve_tpu`` (where ``$XDG_CACHE_HOME``
    exists), ``~/.lightkurve_tpu/cache``."""
    cache = conf.cache_dir or os.environ.get("LIGHTKURVE_CACHE_DIR")
    if not cache:
        xdg = os.environ.get("XDG_CACHE_HOME")
        if xdg and os.path.isdir(xdg):
            cache = os.path.join(xdg, "lightkurve_tpu")
        else:
            cache = os.path.join(os.path.expanduser("~"),
                                 ".lightkurve_tpu", "cache")
    os.makedirs(cache, exist_ok=True)
    return cache


conf = Conf()
