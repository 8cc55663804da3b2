"""Wavelet filter-bank registry (72 built-in wavelets + custom banks).

The PyTorch port's twin of ``pypwt_tpu.filters``: the same tables, the
same sign relations, the same aliases and refusals.  Filters stay NumPy
float64 arrays; the transforms round them to the data dtype where they
use them (``core.conv._as_taps``, ``ops.fused_dwt``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

from ._tables import TABLES

__all__ = [
    "FilterBank",
    "get_filter_bank",
    "wavelist",
    "bank_from_numpy",
    "MAX_FILTER_WIDTH",
]

# Same cap as the reference's constant-memory buffers (common.h:15); the
# CUDA level kernels size their tap arrays by it.
MAX_FILTER_WIDTH = 40

# Aliases accepted by the reference dispatcher (separable.cu:25,
# nonseparable.cu:44): these behave as haar.
_ALIASES = {
    "db1": "haar",
    "bior1.1": "haar",
    "rbior1.1": "haar",
    "rbio1.1": "haar",
}


@dataclass(frozen=True)
class FilterBank:
    """A 1D analysis/synthesis filter bank (pywt-compatible conventions).

    dec_lo/dec_hi: analysis (forward) low/high-pass,
    rec_lo/rec_hi: synthesis (inverse) low/high-pass.
    All arrays share the same even length ``hlen``.
    """

    name: str
    dec_lo: np.ndarray
    dec_hi: np.ndarray
    rec_lo: np.ndarray
    rec_hi: np.ndarray
    orthogonal: bool = False

    @property
    def hlen(self) -> int:
        return len(self.dec_lo)

    @staticmethod
    def from_lowpass(name: str, dec_lo, rec_lo, orthogonal=False):
        """Build the 4-filter bank from the low-pass pair:
        ``dec_hi[k] = (-1)^(k+1) rec_lo[k]``, ``rec_hi[k] = (-1)^k dec_lo[k]``.
        """
        dec_lo = np.asarray(dec_lo, dtype=np.float64)
        rec_lo = np.asarray(rec_lo, dtype=np.float64)
        if dec_lo.shape != rec_lo.shape or dec_lo.ndim != 1:
            raise ValueError("dec_lo/rec_lo must be 1D arrays of equal length")
        k = np.arange(len(dec_lo))
        sign = np.where(k % 2 == 0, 1.0, -1.0)
        dec_hi = -sign * rec_lo
        rec_hi = sign * dec_lo
        return FilterBank(name=name, dec_lo=dec_lo, dec_hi=dec_hi,
                          rec_lo=rec_lo, rec_hi=rec_hi, orthogonal=orthogonal)

    @staticmethod
    def custom(name: str, dec_lo, dec_hi, rec_lo, rec_hi):
        """A fully custom bank (reference analog: set_filters_forward/inverse,
        wt.cu:558-600).

        Odd filter lengths are rejected: the synthesis index algebra assumes
        even hlen.  Zero-pad odd banks to even length exactly as the
        reference demo does (CDF 9/7 to 10 taps, LeGall 5/3 to 6,
        demo.cpp:83-179).
        """
        arrs = [np.asarray(a, dtype=np.float64) for a in
                (dec_lo, dec_hi, rec_lo, rec_hi)]
        n = len(arrs[0])
        if any(a.ndim != 1 or len(a) != n for a in arrs):
            raise ValueError("all four filters must be 1D of equal length")
        if n % 2:
            raise ValueError(
                f"filter length {n} is odd: zero-pad the bank to an even "
                "length (the reference demo does the same for CDF 9/7 and "
                "LeGall 5/3, demo.cpp:83-179)")
        if n > MAX_FILTER_WIDTH:
            raise ValueError(
                f"filter length {n} exceeds MAX_FILTER_WIDTH={MAX_FILTER_WIDTH}")
        return FilterBank(name, *arrs)


def _canonical(name: str) -> str:
    n = name.lower().strip()
    n = _ALIASES.get(n, n)
    # accept "rbior2.2" spelling for "rbio2.2"
    m = re.match(r"^rbior(\d+\.\d+)$", n)
    if m:
        n = "rbio" + m.group(1)
    return n


_CACHE: dict = {}


def get_filter_bank(name: str) -> FilterBank:
    """Look up a built-in wavelet by name (case-insensitive)."""
    key = _canonical(name)
    if key in _CACHE:
        return _CACHE[key]
    if key not in TABLES:
        raise ValueError(f"unknown wavelet: {name!r}")
    dec_lo, rec_lo = TABLES[key]
    ortho = bool(key == "haar" or key.startswith(("db", "sym", "coif")))
    fb = FilterBank.from_lowpass(key, dec_lo, rec_lo, orthogonal=ortho)
    _CACHE[key] = fb
    return fb


def wavelist() -> list:
    """All built-in wavelet names (the reference's 72 + haar aliases)."""
    return sorted(TABLES)


def bank_from_numpy(name: str, dec_lo, dec_hi, rec_lo, rec_hi) -> FilterBank:
    """Carry a bank across from its four arrays (for instance the fields of
    a ``pypwt_tpu.filters.FilterBank``, custom banks included), with the
    same refusals as ``FilterBank.custom``."""
    return FilterBank.custom(name, dec_lo, dec_hi, rec_lo, rec_hi)
