"""FITS reading and writing: primary and image HDUs, binary tables.

A copy of ``lightkurve_tpu/io/fits.py`` (the port never imports the JAX
package): the FITS 4.0 subset the mission products use -- primary and
image HDUs and binary tables (TFORM codes L, X, B, I, J, K, A, E, D with
vector repeats and TDIM reshaping, TSCAL/TZERO scaling).  Reading maps a
binary table onto a numpy structured dtype with ``np.frombuffer``; bulk
column loads of many files go through the native reader
(:mod:`.native`) instead.  Writing gives the same bytes as
``lightkurve_tpu``'s writer.
"""
from __future__ import annotations

import os
import re
from collections import OrderedDict

import numpy as np

__all__ = ["Header", "HDU", "PrimaryHDU", "ImageHDU", "BinTableHDU",
           "HDUList", "open_fits", "write_fits", "Card"]

BLOCK = 2880
CARDLEN = 80

# TFORM code → (numpy dtype char (big-endian), itemsize)
_TFORM_DTYPES = {
    "L": ("u1", 1),   # logical stored as 'T'/'F' bytes
    "X": ("u1", 1),   # bit array (byte-padded)
    "B": ("u1", 1),
    "I": (">i2", 2),
    "J": (">i4", 4),
    "K": (">i8", 8),
    "A": ("S", 1),
    "E": (">f4", 4),
    "D": (">f8", 8),
    "C": (">c8", 8),
    "M": (">c16", 16),
}


class Card:
    __slots__ = ("keyword", "value", "comment")

    def __init__(self, keyword, value=None, comment=""):
        self.keyword = keyword
        self.value = value
        self.comment = comment or ""

    def __repr__(self):
        return f"Card({self.keyword!r}, {self.value!r}, {self.comment!r})"


def _parse_value(raw):
    raw = raw.strip()
    if raw == "":
        return None
    if raw.startswith("'"):
        # FITS string: ends at an unescaped quote; '' escapes a quote
        out = []
        i = 1
        while i < len(raw):
            if raw[i] == "'":
                if i + 1 < len(raw) and raw[i + 1] == "'":
                    out.append("'")
                    i += 2
                    continue
                break
            out.append(raw[i])
            i += 1
        return "".join(out).rstrip()
    if raw == "T":
        return True
    if raw == "F":
        return False
    try:
        if re.fullmatch(r"[+-]?\d+", raw):
            return int(raw)
        return float(raw.replace("D", "E").replace("d", "e"))
    except ValueError:
        return raw


def _parse_card(card: bytes):
    text = card.decode("ascii", errors="replace")
    keyword = text[:8].strip()
    if keyword in ("COMMENT", "HISTORY", "") or text[8:10] != "= ":
        return Card(keyword, None, text[8:].strip())
    body = text[10:]
    # split value / comment at the first '/' outside a string
    in_str = False
    slash = None
    i = 0
    while i < len(body):
        c = body[i]
        if c == "'":
            if in_str and i + 1 < len(body) and body[i + 1] == "'":
                i += 2
                continue
            in_str = not in_str
        elif c == "/" and not in_str:
            slash = i
            break
        i += 1
    if slash is None:
        value_raw, comment = body, ""
    else:
        value_raw, comment = body[:slash], body[slash + 1:].strip()
    return Card(keyword, _parse_value(value_raw), comment)


class Header:
    """Ordered FITS header with dict-like access (astropy-free)."""

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
        if isinstance(key, int):
            return self.cards[key].value
        i = self._find(key)
        if i < 0:
            raise KeyError(key)
        return self.cards[i].value

    def get(self, key, default=None):
        if key.upper() in ("COMMENT", "HISTORY"):
            # commentary cards: join every card's text (astropy returns
            # a commentary-card list whose str() is the joined lines —
            # detect_filetype substring-checks str(h0.get("COMMENT")))
            texts = [c.comment for c in self.cards
                     if c.keyword == key.upper()]
            return "\n".join(texts) if texts else default
        i = self._find(key)
        return self.cards[i].value if i >= 0 else default

    def __setitem__(self, key, value):
        comment = ""
        if isinstance(value, tuple) and len(value) == 2:
            value, comment = value
        if key.upper() in ("COMMENT", "HISTORY"):
            # commentary cards carry their text in the comment slot and
            # repeat (one card per line), like astropy's add_comment
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

    def __delitem__(self, key):
        i = self._find(key)
        if i >= 0:
            del self.cards[i]

    def pop(self, key, default=None):
        i = self._find(key)
        if i < 0:
            return default
        return self.cards.pop(i).value

    def keys(self):
        return [c.keyword for c in self.cards]

    def items(self):
        return [(c.keyword, c.value) for c in self.cards]

    def comments(self, key):
        i = self._find(key)
        return self.cards[i].comment if i >= 0 else ""

    def extend(self, other):
        for k, v in (other.items() if hasattr(other, "items") else other):
            self[k] = v

    def copy(self):
        return Header(self)

    def __iter__(self):
        return iter(self.keys())

    def __len__(self):
        return len(self.cards)

    def __repr__(self):
        return "\n".join(f"{c.keyword:8s}= {c.value!r} / {c.comment}"
                         for c in self.cards)

    # -- serialization ---------------------------------------------------------
    @staticmethod
    def _format_value(v):
        if isinstance(v, bool):
            return "T".rjust(20) if v else "F".rjust(20)
        if isinstance(v, (int, np.integer)):
            return str(int(v)).rjust(20)
        if isinstance(v, (float, np.floating)):
            if np.isnan(v):
                return "".rjust(20)
            s = repr(float(v))
            return s.rjust(20)
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
                val = self._format_value(c.value)
                card = f"{c.keyword:<8s}= {val}"
                if c.comment:
                    card += f" / {c.comment}"
            out.append(card[:CARDLEN].ljust(CARDLEN))
        out.append("END".ljust(CARDLEN))
        data = "".join(out).encode("ascii", errors="replace")
        pad = (-len(data)) % BLOCK
        return data + b" " * pad


class HDU:
    """Base header-data unit."""

    def __init__(self, data=None, header=None, name=None):
        self.header = Header(header)
        self.data = data
        if name is not None:
            self.header["EXTNAME"] = name

    @property
    def name(self):
        return self.header.get("EXTNAME", "")

    def get(self, key, default=None):
        return self.header.get(key, default)


class PrimaryHDU(HDU):
    pass


class ImageHDU(HDU):
    pass


class TableData:
    """Column access for binary-table data (``data['COLNAME']``)."""

    def __init__(self, columns: "OrderedDict[str, np.ndarray]"):
        self._columns = columns

    def __getitem__(self, key):
        if isinstance(key, str):
            for name in self._columns:
                if name.upper() == key.upper():
                    return self._columns[name]
            raise KeyError(key)
        # row slicing
        return TableData(OrderedDict(
            (k, v[key]) for k, v in self._columns.items()))

    def __contains__(self, key):
        return any(name.upper() == key.upper() for name in self._columns)

    @property
    def names(self):
        return list(self._columns)

    def __len__(self):
        for v in self._columns.values():
            return len(v)
        return 0

    def items(self):
        return self._columns.items()


class BinTableHDU(HDU):
    """Binary table HDU; ``data`` is a :class:`TableData`."""

    def __init__(self, data=None, header=None, name=None):
        if isinstance(data, dict):
            data = TableData(OrderedDict(data))
        super().__init__(data=data, header=header, name=name)

    @property
    def columns(self):
        return self.data.names if self.data is not None else []


class HDUList(list):
    """List of HDUs with EXTNAME lookup."""

    def __getitem__(self, key):
        if isinstance(key, str):
            for hdu in self:
                if str(hdu.header.get("EXTNAME", "")).strip().upper() == \
                        key.strip().upper():
                    return hdu
            raise KeyError(f"No HDU named {key!r}")
        if isinstance(key, slice):
            return HDUList(list.__getitem__(self, key))
        return list.__getitem__(self, key)

    def writeto(self, path, overwrite=False):
        write_fits(self, path, overwrite=overwrite)

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------
def _read_header(buf, offset):
    cards = []
    end = False
    while not end:
        block = bytes(buf[offset: offset + BLOCK])
        if len(block) < BLOCK:
            raise ValueError("Truncated FITS header")
        offset += BLOCK
        for i in range(0, BLOCK, CARDLEN):
            card = block[i: i + CARDLEN]
            kw = card[:8].strip()
            if kw == b"END":
                end = True
                break
            if card.strip() == b"":
                continue
            cards.append(_parse_card(card))
    return Header(cards), offset


_TFORM_RE = re.compile(r"^(\d*)([LXBIJKAEDCMPQ])(.*)$")


def _image_dtype(bitpix):
    return {8: "u1", 16: ">i2", 32: ">i4", 64: ">i8",
            -32: ">f4", -64: ">f8"}[bitpix]


def _read_image(buf, offset, header):
    bitpix = header["BITPIX"]
    naxis = header["NAXIS"]
    shape = tuple(header[f"NAXIS{i}"] for i in range(naxis, 0, -1))
    count = int(np.prod(shape)) if shape else 0
    nbytes = count * abs(bitpix) // 8
    data = None
    if count:
        arr = np.frombuffer(buf, dtype=_image_dtype(bitpix), count=count,
                            offset=offset).reshape(shape)
        bscale = header.get("BSCALE", 1)
        bzero = header.get("BZERO", 0)
        if bscale != 1 or bzero != 0:
            arr = arr * bscale + bzero
        data = arr
    offset += nbytes + ((-nbytes) % BLOCK)
    return data, offset


def _read_bintable(buf, offset, header):
    nrows = header["NAXIS2"]
    rowbytes = header["NAXIS1"]
    tfields = header["TFIELDS"]
    names, formats, fieldinfo = [], [], []
    for i in range(1, tfields + 1):
        name = str(header.get(f"TTYPE{i}", f"col{i}")).strip()
        tform = str(header[f"TFORM{i}"]).strip()
        m = _TFORM_RE.match(tform)
        if not m:
            raise ValueError(f"Unsupported TFORM {tform!r}")
        repeat = int(m.group(1)) if m.group(1) else 1
        code = m.group(2)
        if code in ("P", "Q"):
            raise ValueError("Variable-length arrays are not supported")
        base, size = _TFORM_DTYPES[code]
        if code == "A":
            dt = f"S{repeat}"
            shape = ()
        elif code == "X":
            nbytes_f = (repeat + 7) // 8
            dt = "u1"
            shape = (nbytes_f,) if nbytes_f > 1 else ()
        else:
            dt = base
            shape = (repeat,) if repeat > 1 else ()
        tdim = header.get(f"TDIM{i}")
        if tdim:
            dims = tuple(int(x) for x in
                         str(tdim).strip("() ").split(","))[::-1]
            shape = dims
        names.append(name)
        formats.append((dt, shape) if shape else dt)
        fieldinfo.append((name, code,
                          header.get(f"TSCAL{i}", 1),
                          header.get(f"TZERO{i}", 0)))
    dtype = np.dtype({"names": names, "formats": formats})
    if dtype.itemsize != rowbytes:
        # heap/extra bytes at the end of each row: pad
        dtype = np.dtype({"names": names + ["_pad"],
                          "formats": formats
                          + [f"V{rowbytes - dtype.itemsize}"]})
    raw = np.frombuffer(buf, dtype=dtype, count=nrows, offset=offset)
    cols = OrderedDict()
    for name, code, tscal, tzero in fieldinfo:
        col = raw[name]
        if code == "L":
            col = col == ord("T")
        elif code == "A":
            col = np.char.strip(col.astype(str))
        elif tscal != 1 or tzero != 0:
            col = col * tscal + tzero
        else:
            col = col.astype(col.dtype.newbyteorder("="))
        cols[name] = col
    datasize = rowbytes * nrows + header.get("PCOUNT", 0)
    offset += datasize + ((-datasize) % BLOCK)
    return TableData(cols), offset


def open_fits(path_or_buf, memmap=True):
    """Read a FITS file into an :class:`HDUList`.

    Accepts a path (optionally gzipped, by extension or magic number) or a
    bytes buffer.
    """
    if isinstance(path_or_buf, HDUList):
        # already-open in-memory HDU list (the reference's read() accepts
        # an astropy HDUList, reference io/read.py:60-66)
        return path_or_buf
    if isinstance(path_or_buf, (bytes, bytearray)):
        buf = bytes(path_or_buf)
    elif hasattr(path_or_buf, "read"):
        buf = path_or_buf.read()
    else:
        path = os.fspath(path_or_buf)
        with open(path, "rb") as f:
            magic = f.read(2)
        if magic == b"\x1f\x8b" or str(path).endswith(".gz"):
            import gzip
            with gzip.open(path, "rb") as f:
                buf = f.read()
        elif memmap:
            buf = np.memmap(path, dtype="u1", mode="r")
            buf = memoryview(buf)
        else:
            with open(path, "rb") as f:
                buf = f.read()

    if bytes(buf[:6]) != b"SIMPLE":
        raise ValueError("Not a FITS file (missing SIMPLE card)")

    hdus = HDUList()
    offset = 0
    total = len(buf)
    first = True
    while offset < total:
        # skip trailing zero padding some writers add
        probe = bytes(buf[offset: offset + 8]).strip()
        if probe == b"":
            break
        header, offset = _read_header(buf, offset)
        xtension = str(header.get("XTENSION", "")).strip().upper()
        if first:
            data, offset = _read_image(buf, offset, header)
            hdus.append(PrimaryHDU(data=data, header=header))
            first = False
        elif xtension == "BINTABLE":
            data, offset = _read_bintable(buf, offset, header)
            hdus.append(BinTableHDU(data=data, header=header))
        elif xtension in ("IMAGE", ""):
            data, offset = _read_image(buf, offset, header)
            hdus.append(ImageHDU(data=data, header=header))
        elif xtension == "TABLE":
            # ASCII tables are rare in mission products; treat as opaque
            nbytes = header["NAXIS1"] * header["NAXIS2"]
            offset += nbytes + ((-nbytes) % BLOCK)
            hdus.append(HDU(data=None, header=header))
        else:
            raise ValueError(f"Unsupported XTENSION {xtension!r}")
    return hdus


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------
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
        width = arr.dtype.itemsize
        return f"{width}A", arr
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


def _bintable_bytes(hdu: BinTableHDU):
    cols = list(hdu.data.items()) if hdu.data is not None else []
    names, arrays, tforms, tdims = [], [], [], []
    nrows = len(hdu.data) if cols else 0
    for name, arr in cols:
        arr = np.asarray(arr)
        tform, conv = _np_to_tform(arr)
        names.append(name)
        arrays.append(conv)
        tforms.append(tform)
        tdims.append(arr.shape[1:])
    fmts = []
    for arr in arrays:
        shape = arr.shape[1:]
        fmts.append((arr.dtype, shape) if shape else arr.dtype)
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
    lead = []
    if primary:
        lead.append(Card("SIMPLE", True, "conforms to FITS standard"))
    else:
        lead.append(Card("XTENSION", "IMAGE", "image extension"))
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
    """Serialize an HDUList (or list of HDUs) to ``path``."""
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
