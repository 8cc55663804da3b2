"""Stationary (undecimated) wavelet transform, 1D and batched-1D (the 1D
part of ``pypwt_tpu.core.swt``).

Equivalent of the reference's a-trous 1D drivers (separable.cu:519-537,
:653-672): every subband keeps the input length, level-l filters are
dilated by 2^(l-1), and the inverse rescales by 1/2 once.  The pyramid is
``[A, D1, ..., Dn]``; inputs are one signal ``(n,)`` or rows ``(R, n)``.

Each level routes through ``core.dwt.set_kernels`` like the DWT: on a CUDA
tensor to K10a/K10b (``ops.fused_dwt.swt1d_fused``/``iswt1d_fused``),
which take every float32 level, odd filter lengths and wraps wider than
the signal included; elsewhere to their plain versions.
"""

from __future__ import annotations

from ..ops import fused_dwt
from . import dwt


def use_k10a(x, fb, level) -> bool:
    """Routing decision for one stationary analysis level."""
    return dwt._route(fused_dwt.swt1d_fused, x,
                      fused_dwt.swt1d_unsupported(x, fb, level))


def use_k10b(a, d, fb, level) -> bool:
    """Routing decision for one stationary synthesis level."""
    return dwt._route(fused_dwt.iswt1d_fused, a,
                      fused_dwt.iswt1d_unsupported(a, d, fb, level))


def swt1d_level(x, fb, level):
    """One stationary analysis level along the last axis -> (a, d)."""
    if use_k10a(x, fb, level):
        return fused_dwt.swt1d_fused(x.contiguous(), fb, level)
    return fused_dwt.swt1d_plain(x, fb, level)


def iswt1d_level(a, d, fb, level):
    """One stationary synthesis level along the last axis."""
    if use_k10b(a, d, fb, level):
        return fused_dwt.iswt1d_fused(a.contiguous(), d.contiguous(), fb,
                                      level)
    return fused_dwt.iswt1d_plain(a, d, fb, level)


def swt1d(x, fb, levels):
    """Multi-level stationary 1D forward transform -> [A, D1, ..., Dn]."""
    a = x
    details = []
    for lev in range(1, levels + 1):
        a, d = swt1d_level(a, fb, lev)
        details.append(d)
    return [a] + details


def iswt1d(coeffs, fb):
    """Multi-level stationary 1D inverse."""
    levels = len(coeffs) - 1
    a = coeffs[0]
    for lev in range(levels, 0, -1):
        a = iswt1d_level(a, coeffs[lev], fb, lev)
    return a
