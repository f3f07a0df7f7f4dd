"""FITS writer: primary HDUs and binary tables.

The writing half of ``lightkurve_tpu/io/fits.py`` (``_np_to_tform``,
``_bintable_bytes``, ``_image_bytes``, ``write_fits`` and the header and
HDU classes they use), so synthetic mission light curves can be written
where jax is absent.  Output is byte-identical to ``lightkurve_tpu``'s.
Reading goes through the native column reader (:mod:`.native`).
"""
from __future__ import annotations

import os
import re
from collections import OrderedDict

import numpy as np

__all__ = ["Card", "Header", "HDU", "PrimaryHDU", "BinTableHDU", "HDUList",
           "write_fits"]

BLOCK = 2880
CARDLEN = 80


class Card:
    __slots__ = ("keyword", "value", "comment")

    def __init__(self, keyword, value=None, comment=""):
        self.keyword = keyword
        self.value = value
        self.comment = comment or ""

    def __repr__(self):
        return f"Card({self.keyword!r}, {self.value!r}, {self.comment!r})"


class Header:
    """Ordered FITS header with dict-like access."""

    def __init__(self, cards=None):
        self.cards = []
        if isinstance(cards, Header):
            self.cards = [Card(c.keyword, c.value, c.comment)
                          for c in cards.cards]
        elif isinstance(cards, dict):
            for k, v in cards.items():
                self[k] = v        # routes commentary cards correctly
        elif cards:
            self.cards = list(cards)

    def _find(self, key):
        key = key.upper()
        for i, c in enumerate(self.cards):
            if c.keyword == key:
                return i
        return -1

    def __contains__(self, key):
        return self._find(key) >= 0

    def __getitem__(self, key):
        i = self._find(key)
        if i < 0:
            raise KeyError(key)
        return self.cards[i].value

    def get(self, key, default=None):
        i = self._find(key)
        return self.cards[i].value if i >= 0 else default

    def __setitem__(self, key, value):
        comment = ""
        if isinstance(value, tuple) and len(value) == 2:
            value, comment = value
        if key.upper() in ("COMMENT", "HISTORY"):
            # commentary cards carry their text in the comment slot and
            # repeat, one card per line
            for line in str(value).split("\n"):
                self.cards.append(Card(key.upper(), None, line))
            return
        i = self._find(key)
        if i >= 0:
            self.cards[i].value = value
            if comment:
                self.cards[i].comment = comment
        else:
            self.cards.append(Card(key.upper(), value, comment))

    def __len__(self):
        return len(self.cards)

    @staticmethod
    def _format_value(v):
        if isinstance(v, bool):
            return "T".rjust(20) if v else "F".rjust(20)
        if isinstance(v, (int, np.integer)):
            return str(int(v)).rjust(20)
        if isinstance(v, (float, np.floating)):
            if np.isnan(v):
                return "".rjust(20)
            return repr(float(v)).rjust(20)
        if v is None:
            return ""
        s = str(v).replace("'", "''")
        return f"'{s:<8s}'"

    def tobytes(self):
        out = []
        for c in self.cards:
            if c.keyword in ("COMMENT", "HISTORY", ""):
                card = f"{c.keyword:<8s}{c.comment}"
            else:
                card = f"{c.keyword:<8s}= {self._format_value(c.value)}"
                if c.comment:
                    card += f" / {c.comment}"
            out.append(card[:CARDLEN].ljust(CARDLEN))
        out.append("END".ljust(CARDLEN))
        data = "".join(out).encode("ascii", errors="replace")
        return data + b" " * ((-len(data)) % BLOCK)


class HDU:
    """Base header-data unit."""

    def __init__(self, data=None, header=None, name=None):
        self.header = Header(header)
        self.data = data
        if name is not None:
            self.header["EXTNAME"] = name


class PrimaryHDU(HDU):
    pass


class BinTableHDU(HDU):
    """Binary table HDU; ``data`` maps column names to arrays."""

    def __init__(self, data=None, header=None, name=None):
        if isinstance(data, dict):
            data = OrderedDict(data)
        super().__init__(data=data, header=header, name=name)


class HDUList(list):
    """List of HDUs."""

    def writeto(self, path, overwrite=False):
        write_fits(self, path, overwrite=overwrite)


def _np_to_tform(arr):
    kind = arr.dtype.kind
    shape = arr.shape[1:]
    repeat = int(np.prod(shape)) if shape else 1
    if kind == "b":
        return f"{repeat}L", arr.astype("u1") * (ord("T") - ord("F")) \
            + ord("F")
    if kind in "S U":
        if kind == "U":
            arr = np.char.encode(arr, "ascii")
        return f"{arr.dtype.itemsize}A", arr
    if kind == "u" and arr.dtype.itemsize == 1:
        return f"{repeat}B", arr
    if kind in "iu":
        size = arr.dtype.itemsize
        code = {2: "I", 4: "J", 8: "K"}.get(max(size, 2), "K")
        dt = {2: ">i2", 4: ">i4", 8: ">i8"}[max(size, 2)]
        return f"{repeat}{code}", arr.astype(dt)
    if kind == "f":
        if arr.dtype.itemsize <= 4:
            return f"{repeat}E", arr.astype(">f4")
        return f"{repeat}D", arr.astype(">f8")
    raise ValueError(f"Cannot serialize dtype {arr.dtype}")


def _bintable_bytes(hdu):
    cols = list(hdu.data.items()) if hdu.data is not None else []
    names, arrays, tforms, tdims = [], [], [], []
    nrows = len(cols[0][1]) if cols else 0
    for name, arr in cols:
        arr = np.asarray(arr)
        tform, conv = _np_to_tform(arr)
        names.append(name)
        arrays.append(conv)
        tforms.append(tform)
        tdims.append(arr.shape[1:])
    fmts = [(a.dtype, a.shape[1:]) if a.shape[1:] else a.dtype
            for a in arrays]
    dtype = np.dtype({"names": names, "formats": fmts}) if names else \
        np.dtype([])
    rec = np.zeros(nrows, dtype=dtype)
    for name, arr in zip(names, arrays):
        rec[name] = arr

    header = Header(hdu.header)
    header.cards = [c for c in header.cards
                    if c.keyword not in ("XTENSION", "BITPIX", "NAXIS",
                                         "NAXIS1", "NAXIS2", "PCOUNT",
                                         "GCOUNT", "TFIELDS")
                    and not re.fullmatch(r"T(TYPE|FORM|DIM|UNIT)\d+",
                                         c.keyword or "")]
    lead = [Card("XTENSION", "BINTABLE", "binary table extension"),
            Card("BITPIX", 8), Card("NAXIS", 2),
            Card("NAXIS1", dtype.itemsize), Card("NAXIS2", nrows),
            Card("PCOUNT", 0), Card("GCOUNT", 1),
            Card("TFIELDS", len(names))]
    for i, (name, tform, dims) in enumerate(zip(names, tforms, tdims),
                                            start=1):
        lead.append(Card(f"TTYPE{i}", name))
        lead.append(Card(f"TFORM{i}", tform))
        if dims and len(dims) > 1:
            lead.append(Card(f"TDIM{i}",
                             "(" + ",".join(str(d) for d in dims[::-1])
                             + ")"))
        unit = hdu.header.get(f"TUNIT{i}")
        if unit:
            lead.append(Card(f"TUNIT{i}", unit))
    header.cards = lead + header.cards
    body = rec.tobytes()
    return header.tobytes() + body + b"\x00" * ((-len(body)) % BLOCK)


def _image_bytes(hdu, primary=False):
    header = Header(hdu.header)
    header.cards = [c for c in header.cards
                    if c.keyword not in ("SIMPLE", "XTENSION", "BITPIX",
                                         "NAXIS", "EXTEND", "PCOUNT",
                                         "GCOUNT")
                    and not re.fullmatch(r"NAXIS\d+", c.keyword or "")]
    data = hdu.data
    lead = [Card("SIMPLE", True, "conforms to FITS standard") if primary
            else Card("XTENSION", "IMAGE", "image extension")]
    if data is None:
        lead += [Card("BITPIX", 8), Card("NAXIS", 0)]
    else:
        data = np.asarray(data)
        if data.dtype.kind == "f":
            data = data.astype(">f8") if data.dtype.itemsize > 4 \
                else data.astype(">f4")
            bitpix = -8 * data.dtype.itemsize
        else:
            data = data.astype(f">i{max(data.dtype.itemsize, 2)}")
            bitpix = 8 * data.dtype.itemsize
        lead.append(Card("BITPIX", bitpix))
        lead.append(Card("NAXIS", data.ndim))
        for i, n in enumerate(reversed(data.shape), start=1):
            lead.append(Card(f"NAXIS{i}", n))
    if primary:
        lead.append(Card("EXTEND", True))
    else:
        lead += [Card("PCOUNT", 0), Card("GCOUNT", 1)]
    header.cards = lead + header.cards
    out = header.tobytes()
    if data is not None:
        body = data.tobytes()
        out += body + b"\x00" * ((-len(body)) % BLOCK)
    return out


def write_fits(hdus, path, overwrite=False):
    """Serialize a list of HDUs to ``path`` (the first is the primary)."""
    if os.path.exists(path) and not overwrite:
        raise OSError(f"File exists: {path!r}; use overwrite=True")
    chunks = []
    for i, hdu in enumerate(hdus):
        if isinstance(hdu, BinTableHDU):
            chunks.append(_bintable_bytes(hdu))
        else:
            chunks.append(_image_bytes(hdu, primary=(i == 0)))
    with open(path, "wb") as f:
        for c in chunks:
            f.write(c)
