"""Haar 2D path (the 2D part of ``pypwt_tpu.core.haar``).

On a CUDA tensor the levels run on K1/K2 with the haar bank, as the TPU
path runs the fused Pallas kernels (the butterfly values coincide with
the db1 filter pair up to float32 rounding).  Elsewhere -- CPU tensors,
``set_kernels("torch")``, levels the kernels decline -- they use the
reference's butterfly with a single 0.5 scaling (haar.cu:10-58), exact in
float32, unlike two 1/sqrt(2) passes.
"""

from __future__ import annotations

import torch

from ..filters import get_filter_bank
from ..ops import fused_dwt
from . import conv, dwt
from .shapes import div2

_HAAR = get_filter_bank("haar")


def _extend_even_2d(x):
    x = conv._odd_extend_last(x)
    return conv._odd_extend_last(x.transpose(-1, -2)).transpose(-1, -2)


def haar_dwt2d(x):
    """One 2D haar level -> (a, h, v, d) (haar.cu:10-37)."""
    if dwt.use_k1(x, _HAAR):
        return fused_dwt.dwt2d_fused(x.contiguous(), _HAAR)
    xe = _extend_even_2d(x)
    p00 = xe[..., 0::2, 0::2]
    p01 = xe[..., 0::2, 1::2]
    p10 = xe[..., 1::2, 0::2]
    p11 = xe[..., 1::2, 1::2]
    sy0 = p00 + p10  # column sums (AVG along rows)
    sy1 = p01 + p11
    dy0 = p00 - p10
    dy1 = p01 - p11
    a = 0.5 * (sy0 + sy1)
    v = 0.5 * (sy0 - sy1)
    h = 0.5 * (dy0 + dy1)
    d = 0.5 * (dy0 - dy1)
    return a, h, v, d


def haar_idwt2d(a, h, v, d, out_shape):
    """One 2D haar inverse level (haar.cu:41-58)."""
    if dwt.use_k2(a, h, v, d, _HAAR, out_shape):
        return fused_dwt.idwt2d_fused(a.contiguous(), h.contiguous(),
                                      v.contiguous(), d.contiguous(), _HAAR,
                                      out_shape)
    o00 = 0.5 * (a + h + v + d)
    o01 = 0.5 * (a + h - v - d)
    o10 = 0.5 * (a - h + v - d)
    o11 = 0.5 * (a - h - v + d)
    top = torch.stack([o00, o01], dim=-1)
    bot = torch.stack([o10, o11], dim=-1)
    out = torch.stack([top, bot], dim=-3).reshape(
        *o00.shape[:-2], 2 * o00.shape[-2], 2 * o00.shape[-1])
    return out[..., :out_shape[-2], :out_shape[-1]]


def haar_wavedec2(image, levels):
    a = image
    details = []
    for _ in range(levels):
        a, h, v, d = haar_dwt2d(a)
        details.append((h, v, d))
    return [a] + details


def haar_waverec2(coeffs, shape):
    levels = len(coeffs) - 1
    sizes = [tuple(shape[-2:])]
    for _ in range(levels):
        sizes.append((div2(sizes[-1][0]), div2(sizes[-1][1])))
    a = coeffs[0]
    for lev in range(levels, 0, -1):
        h, v, d = coeffs[lev]
        a = haar_idwt2d(a, h, v, d, sizes[lev - 1])
    return a
