"""Shape calculus for the coefficient pyramid (plain Python, copied from
``pypwt_tpu.core.shapes``).

Mirrors the reference's sizing rules:
* ``div2``: odd sizes round *up* when halved (utils.cu:23-27, pypwt.pyx:238-244)
* max decomposition level clamp ``ilog2(N/(hlen-1))`` (wt.cu:155-165)
* pyramid layout ``[A_n, (H1,V1,D1), ..., (Hn,Vn,Dn)]`` for 2D and
  ``[A_n, D1, ..., Dn]`` for (batched) 1D (common.cu:399-445).
"""

from __future__ import annotations

import math


def div2(n: int) -> int:
    """Subsampled size: N/2 if N even, (N+1)/2 if odd."""
    return (n + (n & 1)) // 2


def ilog2(n: int) -> int:
    """floor(log2(n)) for n >= 1, else 0 (utils.cu:14-20)."""
    if n < 1:
        return 0
    return int(math.floor(math.log2(n)))


def max_level(shape, hlen: int, ndim: int) -> int:
    """Maximum achievable decomposition level (wt.cu:155-165)."""
    if ndim == 2:
        n = min(shape)
    else:
        n = shape[-1]
    if hlen <= 1:
        return ilog2(n)
    return ilog2(n // (hlen - 1)) if n >= (hlen - 1) else 0


def clamp_levels(levels: int, shape, hlen: int, ndim: int) -> int:
    """Reference semantics: levels<1 forced to 1, then clamped to max_level."""
    levels = max(1, levels)
    wmax = max_level(shape, hlen, ndim)
    return min(levels, wmax) if wmax >= 1 else 1


def level_shapes_2d(nr: int, nc: int, levels: int, swt: bool) -> list:
    """Per-level detail-coefficient shapes, level 1 first (pypwt.pyx:247-258)."""
    if swt:
        return [(nr, nc)] * levels
    out = []
    for _ in range(levels):
        nr, nc = div2(nr), div2(nc)
        out.append((nr, nc))
    return out


def level_shapes_1d(n: int, levels: int, swt: bool) -> list:
    """Per-level detail lengths for (batched) 1D transforms."""
    if swt:
        return [n] * levels
    out = []
    for _ in range(levels):
        n = div2(n)
        out.append(n)
    return out
