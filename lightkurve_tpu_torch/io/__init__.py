"""FITS reading and writing, the per-product readers, the top-level
:func:`read` and the streaming stack loader (counterpart of
``lightkurve_tpu.io``; the same names)."""
from .fits import (Header, HDU, PrimaryHDU, ImageHDU, BinTableHDU, HDUList,
                   open_fits, write_fits)
from .detect import detect_filetype
from .read import read, open, read_lc_collection, read_tpf_collection
from .readers import (
    read_kepler_lightcurve, read_tess_lightcurve, read_qlp_lightcurve,
    read_k2sff_lightcurve, read_everest_lightcurve, read_cdips_lightcurve,
    read_pathos_lightcurve, read_tasoc_lightcurve,
    read_kepseismic_lightcurve, read_tglc_lightcurve,
    read_eleanor_lightcurve, read_k2sc_lightcurve, read_folded_lightcurve)
from .generic import read_generic_lightcurve
from .writers import lightcurve_to_fits
from .pipeline import StreamingStackLoader

__all__ = [
    "Header", "HDU", "PrimaryHDU", "ImageHDU", "BinTableHDU", "HDUList",
    "open_fits", "write_fits", "detect_filetype", "read", "open",
    "read_lc_collection", "read_tpf_collection", "read_generic_lightcurve",
    "lightcurve_to_fits", "StreamingStackLoader",
    "read_kepler_lightcurve", "read_tess_lightcurve", "read_qlp_lightcurve",
    "read_k2sff_lightcurve", "read_everest_lightcurve",
    "read_cdips_lightcurve", "read_pathos_lightcurve",
    "read_tasoc_lightcurve", "read_kepseismic_lightcurve",
    "read_tglc_lightcurve", "read_eleanor_lightcurve",
    "read_k2sc_lightcurve", "read_folded_lightcurve",
]
