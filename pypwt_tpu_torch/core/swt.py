"""Stationary (undecimated) wavelet transform, separable, 1D, batched-1D
and 2D (the port of ``pypwt_tpu.core.swt``).

Equivalent of the reference's a-trous drivers (separable.cu:496-515,
:629-649 in 2D; :519-537, :653-672 in 1D): every subband keeps the input
size, level-l filters are dilated by 2^(l-1), and the inverse rescales by
1/2 per axis pass.  The pyramid is ``[A, D1, ..., Dn]`` in 1D, inputs one
signal ``(n,)`` or rows ``(R, n)``; ``[A, (H1, V1, D1), ...]`` in 2D, with
full-size planes, inputs one plane ``(Nr, Nc)`` or a stack
``(B, Nr, Nc)``.  H is the high-pass along axis -2 and the low-pass along
the last axis, as in the JAX fallback.

Each level routes through ``core.dwt.set_kernels`` like the DWT: on a CUDA
tensor to K10a/K10b (1D) or K8/K9 (2D, ``ops.fused_dwt``), which take
every float32 and float64 level, odd filter lengths and wraps wider than
the signal or plane included; elsewhere to their plain versions.  They
never decline: a level they do not cover on a CUDA tensor (float16)
raises, unless kernel mode ``"torch"`` asks for the plain version.  In
kernel mode ``"mxu"`` a float32 level whose dilated support fits in the
plane (2D) or row (1D) goes to the tensor-core forms K11a/K11b or
K12a/K12b (``ops.mxu_swt``, at ``core.dwt.mxu_precision()``; their banded
plain versions on a CPU tensor), every other one to K8/K9 or K10, as JAX's
``swt2d_level`` and ``swt1d_level`` route them.
"""

from __future__ import annotations

from ..ops import fused_dwt, mxu_swt
from . import dwt


def use_k10a(x, fb, level) -> bool:
    """Routing decision for one stationary analysis level."""
    return dwt._route(fused_dwt.swt1d_fused, x,
                      fused_dwt.swt1d_unsupported(x, fb, level))


def use_k10b(a, d, fb, level) -> bool:
    """Routing decision for one stationary synthesis level."""
    return dwt._route(fused_dwt.iswt1d_fused, a,
                      fused_dwt.iswt1d_unsupported(a, d, fb, level))


def use_k12a(x, fb, level) -> bool:
    """Routing decision for one stationary 1D analysis level in mode
    "mxu"."""
    return dwt.use_mxu(mxu_swt.swt1d_mxu_unsupported(x, fb, level))


def use_k12b(a, d, fb, level) -> bool:
    """Routing decision for one stationary 1D synthesis level in mode
    "mxu"."""
    return dwt.use_mxu(mxu_swt.iswt1d_mxu_unsupported(a, d, fb, level))


def swt1d_level(x, fb, level):
    """One stationary analysis level along the last axis -> (a, d)."""
    if use_k12a(x, fb, level):
        return mxu_swt.swt1d_mxu_fused(x.contiguous(), fb, level,
                                       dwt.mxu_precision())
    if use_k10a(x, fb, level):
        return fused_dwt.swt1d_fused(x.contiguous(), fb, level)
    return fused_dwt.swt1d_plain(x, fb, level)


def iswt1d_level(a, d, fb, level):
    """One stationary synthesis level along the last axis."""
    if use_k12b(a, d, fb, level):
        return mxu_swt.iswt1d_mxu_fused(a.contiguous(), d.contiguous(), fb,
                                        level, dwt.mxu_precision())
    if use_k10b(a, d, fb, level):
        return fused_dwt.iswt1d_fused(a.contiguous(), d.contiguous(), fb,
                                      level)
    return fused_dwt.iswt1d_plain(a, d, fb, level)


def use_k11a(x, fb, level) -> bool:
    """Routing decision for one stationary 2D analysis level in mode
    "mxu"."""
    return dwt.use_mxu(mxu_swt.swt2d_mxu_unsupported(x, fb, level))


def use_k11b(a, h, v, d, fb, level) -> bool:
    """Routing decision for one stationary 2D synthesis level in mode
    "mxu"."""
    return dwt.use_mxu(mxu_swt.iswt2d_mxu_unsupported(a, h, v, d, fb, level))


def use_k8(x, fb, level) -> bool:
    """Routing decision for one stationary 2D analysis level."""
    return dwt._route(fused_dwt.swt2d_fused, x,
                      fused_dwt.swt2d_unsupported(x, fb, level))


def use_k9(a, h, v, d, fb, level) -> bool:
    """Routing decision for one stationary 2D synthesis level."""
    return dwt._route(fused_dwt.iswt2d_fused, a,
                      fused_dwt.iswt2d_unsupported(a, h, v, d, fb, level))


def swt2d_level(x, fb, level):
    """One stationary 2D analysis level -> (a, h, v, d)."""
    if use_k11a(x, fb, level):
        return mxu_swt.swt2d_mxu_fused(x.contiguous(), fb, level,
                                       dwt.mxu_precision())
    if use_k8(x, fb, level):
        return fused_dwt.swt2d_fused(x.contiguous(), fb, level)
    return fused_dwt.swt2d_plain(x, fb, level)


def iswt2d_level(a, h, v, d, fb, level):
    """One stationary 2D synthesis level."""
    if use_k11b(a, h, v, d, fb, level):
        return mxu_swt.iswt2d_mxu_fused(
            *(s.contiguous() for s in (a, h, v, d)), fb, level,
            dwt.mxu_precision())
    if use_k9(a, h, v, d, fb, level):
        return fused_dwt.iswt2d_fused(
            *(s.contiguous() for s in (a, h, v, d)), fb, level)
    return fused_dwt.iswt2d_plain(a, h, v, d, fb, level)


def swt2d(image, fb, levels):
    """Multi-level stationary 2D forward transform -> [A, (H1, V1, D1),
    ..., (Hn, Vn, Dn)], every plane of the input's shape."""
    a = image
    details = []
    for lev in range(1, levels + 1):
        a, h, v, d = swt2d_level(a, fb, lev)
        details.append((h, v, d))
    return [a] + details


def iswt2d(coeffs, fb):
    """Multi-level stationary 2D inverse."""
    levels = len(coeffs) - 1
    a = coeffs[0]
    for lev in range(levels, 0, -1):
        h, v, d = coeffs[lev]
        a = iswt2d_level(a, h, v, d, fb, lev)
    return a


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
