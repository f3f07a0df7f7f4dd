"""Minimal gnomonic (TAN) WCS for target pixel files.

A copy of ``lightkurve_tpu/wcs.py`` (host numpy; the port never imports
the JAX package).  The reference reconstructs an ``astropy.wcs.WCS`` from
the tabular per-column keywords of Kepler/TESS TPFs
(``targetpixelfile.py:401-441``).
Mission pixel files use the simple TAN projection, so this module
implements exactly that: a linear CD/PC transform plus the gnomonic
sky↔plane mapping — no astropy required.
"""
from __future__ import annotations

import numpy as np

__all__ = ["TanWCS"]

D2R = np.pi / 180.0


class TanWCS:
    """Gnomonic world coordinate system.

    Parameters
    ----------
    crpix : (2,) reference pixel (1-based, FITS convention).
    crval : (2,) reference RA, Dec in degrees.
    cd : (2, 2) linearized transform (deg/pixel).
    """

    def __init__(self, crpix, crval, cd):
        self.crpix = np.asarray(crpix, dtype=float)
        self.crval = np.asarray(crval, dtype=float)
        self.cd = np.asarray(cd, dtype=float)

    @classmethod
    def from_tpf_header(cls, header, colnum=5):
        """Build from tabular WCS keywords ``1CRPX{n}``-style for column
        ``colnum`` (the FLUX column in mission TPFs)."""
        g = header.get
        crpix = [g(f"1CRPX{colnum}", 1.0), g(f"2CRPX{colnum}", 1.0)]
        crval = [g(f"1CRVL{colnum}", 0.0), g(f"2CRVL{colnum}", 0.0)]
        cdelt = [g(f"1CDLT{colnum}", 1.0), g(f"2CDLT{colnum}", 1.0)]
        pc = np.array([
            [g(f"11PC{colnum}", 1.0), g(f"12PC{colnum}", 0.0)],
            [g(f"21PC{colnum}", 0.0), g(f"22PC{colnum}", 1.0)]])
        cd = pc * np.asarray(cdelt)[:, None]
        return cls(crpix, crval, cd)

    @classmethod
    def from_image_header(cls, header):
        """Build from standard image-HDU keywords (CRPIX1, CD1_1/PC1_1…)."""
        g = header.get
        crpix = [g("CRPIX1", 1.0), g("CRPIX2", 1.0)]
        crval = [g("CRVAL1", 0.0), g("CRVAL2", 0.0)]
        if "CD1_1" in header:
            cd = np.array([[g("CD1_1", 1.0), g("CD1_2", 0.0)],
                           [g("CD2_1", 0.0), g("CD2_2", 1.0)]])
        else:
            cdelt = [g("CDELT1", 1.0), g("CDELT2", 1.0)]
            pc = np.array([[g("PC1_1", 1.0), g("PC1_2", 0.0)],
                           [g("PC2_1", 0.0), g("PC2_2", 1.0)]])
            cd = pc * np.asarray(cdelt)[:, None]
        return cls(crpix, crval, cd)

    # -- transforms -----------------------------------------------------------
    def pixel_to_world(self, x, y, origin=0):
        """Pixel (x=column, y=row) → (RA, Dec) in degrees."""
        x = np.asarray(x, dtype=float) + (1 - origin)
        y = np.asarray(y, dtype=float) + (1 - origin)
        dx = x - self.crpix[0]
        dy = y - self.crpix[1]
        xi = (self.cd[0, 0] * dx + self.cd[0, 1] * dy) * D2R
        eta = (self.cd[1, 0] * dx + self.cd[1, 1] * dy) * D2R
        ra0 = self.crval[0] * D2R
        dec0 = self.crval[1] * D2R
        denom = np.cos(dec0) - eta * np.sin(dec0)
        ra = ra0 + np.arctan2(xi, denom)
        dec = np.arctan((np.sin(dec0) + eta * np.cos(dec0))
                        / np.sqrt(xi ** 2 + denom ** 2))
        return np.mod(ra / D2R, 360.0), dec / D2R

    def world_to_pixel(self, ra, dec, origin=0):
        """(RA, Dec) degrees → pixel (x=column, y=row)."""
        ra = np.asarray(ra, dtype=float) * D2R
        dec = np.asarray(dec, dtype=float) * D2R
        ra0 = self.crval[0] * D2R
        dec0 = self.crval[1] * D2R
        cosc = (np.sin(dec0) * np.sin(dec)
                + np.cos(dec0) * np.cos(dec) * np.cos(ra - ra0))
        xi = np.cos(dec) * np.sin(ra - ra0) / cosc / D2R
        eta = (np.cos(dec0) * np.sin(dec)
               - np.sin(dec0) * np.cos(dec) * np.cos(ra - ra0)) / cosc / D2R
        inv = np.linalg.inv(self.cd)
        dx = inv[0, 0] * xi + inv[0, 1] * eta
        dy = inv[1, 0] * xi + inv[1, 1] * eta
        return (dx + self.crpix[0] - (1 - origin),
                dy + self.crpix[1] - (1 - origin))

    def to_header_cards(self, colnum=5):
        """Tabular WCS keywords for serialization into a TPF header."""
        cards = {
            f"1CTYP{colnum}": "RA---TAN", f"2CTYP{colnum}": "DEC--TAN",
            f"1CRPX{colnum}": self.crpix[0], f"2CRPX{colnum}": self.crpix[1],
            f"1CRVL{colnum}": self.crval[0], f"2CRVL{colnum}": self.crval[1],
            f"1CUNI{colnum}": "deg", f"2CUNI{colnum}": "deg",
        }
        norm0 = np.hypot(self.cd[0, 0], self.cd[1, 0])
        norm1 = np.hypot(self.cd[0, 1], self.cd[1, 1])
        cards[f"1CDLT{colnum}"] = -norm0
        cards[f"2CDLT{colnum}"] = norm1
        cards[f"11PC{colnum}"] = self.cd[0, 0] / -norm0
        cards[f"12PC{colnum}"] = self.cd[0, 1] / norm1
        cards[f"21PC{colnum}"] = self.cd[1, 0] / -norm0
        cards[f"22PC{colnum}"] = self.cd[1, 1] / norm1
        return cards
