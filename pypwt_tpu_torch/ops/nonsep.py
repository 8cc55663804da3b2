"""The non-separable level kernels: wrappers, plain versions, counts.

* K16 ``nsdwt2d_fused`` and K17 ``insdwt2d_fused``
  (``csrc/nonsep_dwt2d.cu``): one non-separable DWT level with four dense
  ``hlen x hlen`` filters, the decimating analysis (1 plane -> 4 planes of
  ``div2`` its size) and the 4-phase polyphase inverse.  They replace the
  TPU kernels ``pypwt_tpu/ops/nonsep_pallas.py::_build_ns_dwt2d`` (behind
  ``nsdwt2d_fused``) and ``::_build_ns_idwt2d`` (behind
  ``insdwt2d_fused``).
* K18a ``ns_swt2d_fused`` and K18b ``ins_swt2d_fused``
  (``csrc/nonsep_swt2d.cu``): one non-separable à-trous level, analysis
  (1 plane -> 4) and synthesis (4 planes -> 1, x 1/4).  They replace
  ``::_build_ns_swt2d`` (behind ``ns_swt2d_fused`` and
  ``ins_swt2d_fused``).

The TPU kernels factor each filter into rank-1 SVD terms because Mosaic
lowers no dense 2D stencil; the Hopper kernels are the direct stencils and
need no factoring.  Beside each kernel, as in ``ops.fused_dwt``: its plain
PyTorch version (the slice formulation of ``pypwt_tpu.core.nonsep``, at
every hlen: no convolution, so no cuDNN and no TF32), ``*_unsupported``
and the ``launches`` count.  Each kernel takes every float32 or float64
level its plain version takes (odd sizes, odd filter sizes, any batch).  A
wrapper given a CPU tensor runs the plain version; given a CUDA tensor it
launches the kernel or raises.  A float32 level's bank goes to the kernel
by value, rounded once to float32; a float64 level's (51,200 bytes at hlen
40, past CUDA's parameter limit) is laid out by the library
(``pypwt_ns_bank_f64``) from the bank's float64 values and uploaded once
per bank and device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.conv import (_as_taps, _odd_extend_2d, _pad2_periodic,
                         analysis_pads, swt_centre)
from ..core.shapes import div2
from ..filters import MAX_FILTER_WIDTH
from . import _build
from .fused_dwt import (F32_F64, _batch, _check_inputs, _check_launch,
                        _entry, _pair_unsupported, _plane_unsupported,
                        _stream, subbands_unsupported,
                        swt2d_plane_unsupported)


def _weights(F, dtype):
    return [_as_taps(row, dtype) for row in np.asarray(F)]


def nsdwt2d_plain(x, f2d):
    """One non-separable 2D analysis level in torch ops -> (a, h, v, d),
    each of size div2 of the input's, in the slice formulation."""
    hlen = f2d.hlen
    xe = _odd_extend_2d(x)
    xp = _pad2_periodic(xe, *analysis_pads(hlen))
    L_r = xe.shape[-2] // 2
    L_c = xe.shape[-1] // 2
    frev = [_weights(np.asarray(f)[::-1, ::-1], x.dtype) for f in f2d.dec]
    outs = [None] * 4
    for k in range(hlen):
        slab = xp[..., k: k + 2 * L_r: 2, :]
        for l in range(hlen):
            seg = slab[..., :, l: l + 2 * L_c: 2]
            for si in range(4):
                w = frev[si][k][l]
                if w == 0.0:
                    continue
                t = seg * w
                outs[si] = t if outs[si] is None else outs[si] + t
    shape = (*x.shape[:-2], L_r, L_c)
    return tuple(x.new_zeros(shape) if o is None else o for o in outs)


def insdwt2d_plain(a, h, v, d, f2d, out_shape):
    """One non-separable 2D synthesis level in torch ops (4-phase
    polyphase inverse, nonseparable.cu:176-225) -> image of ``out_shape``
    (its last two sizes)."""
    nr, nc = out_shape[-2], out_shape[-1]
    L_r = a.shape[-2]
    hlen = f2d.hlen
    hlen2 = hlen // 2
    sigma = 1 if hlen2 % 2 == 0 else 0
    c = hlen2 // 2
    Lout_r, Lout_c = (nr + 1) // 2, (nc + 1) // 2

    coeffs = torch.stack([a, h, v, d], dim=-3)  # (..., 4, L_r, L_c)

    # phase-dependent pads (same recipe as the 1D synthesis)
    def pad_for(p, L, Lout):
        delta = (p + sigma) >> 1
        start = delta - c
        lpad = max(-start, 0)
        rpad = max(start + Lout + hlen2 - 1 - L, 0)
        return start + lpad, lpad, rpad

    # all four phases share delta/lpad per parity; pad once with the max
    pads = {p: pad_for(p, L_r, Lout_r) for p in (0, 1)}
    lpad = max(pads[0][1], pads[1][1])
    rpad = max(pads[0][2], pads[1][2])
    xp = _pad2_periodic(coeffs, lpad, rpad)

    # rhs[(py*2+px), b, jy, jx] = F_b[hlen-1-2jy-offy, hlen-1-2jx-offx]
    rhs = np.zeros((4, 4, hlen2, hlen2))
    offs = {p: 1 - ((p + sigma) & 1) for p in (0, 1)}
    js = np.arange(hlen2)
    for py in (0, 1):
        for px in (0, 1):
            ty = hlen - 1 - 2 * js - offs[py]
            tx = hlen - 1 - 2 * js - offs[px]
            for b, F in enumerate(f2d.rec):
                rhs[py * 2 + px, b] = F[np.ix_(ty, tx)]

    outs = {}
    for py in (0, 1):
        by = pads[py][0] + lpad - pads[py][1]
        for px in (0, 1):
            bx = pads[px][0] + lpad - pads[px][1]
            win = xp[..., by: by + Lout_r + hlen2 - 1,
                     bx: bx + Lout_c + hlen2 - 1]
            acc = None
            for b in range(4):
                wb = win[..., b, :, :]
                taps = _weights(rhs[py * 2 + px, b], a.dtype)
                for jy in range(hlen2):
                    for jx in range(hlen2):
                        w = taps[jy][jx]
                        if w == 0.0:
                            continue
                        t = wb[..., jy: jy + Lout_r, jx: jx + Lout_c] * w
                        acc = t if acc is None else acc + t
            outs[(py, px)] = (a.new_zeros((*a.shape[:-2], Lout_r, Lout_c))
                              if acc is None else acc)

    top = torch.stack([outs[(0, 0)], outs[(0, 1)]], dim=-1)
    bot = torch.stack([outs[(1, 0)], outs[(1, 1)]], dim=-1)
    top = top.reshape(*top.shape[:-2], 2 * Lout_c)
    bot = bot.reshape(*bot.shape[:-2], 2 * Lout_c)
    out = torch.stack([top, bot], dim=-2).reshape(
        *top.shape[:-2], 2 * Lout_r, 2 * Lout_c)
    return out[..., :nr, :nc].contiguous()


def _stencil(planes, filters, level, inverse, scale=1.0):
    """sum over planes p and taps (k, l) of w_p[k, l] * p[r + (s-k) f,
    c + (s-l) f] for each filter set in ``filters`` (one list of filters
    per output), in the slice form of ``pypwt_tpu.core.nonsep``."""
    hlen = filters[0][0].shape[0]
    s = swt_centre(hlen, inverse)
    factor = 1 << (level - 1)
    lpad = (hlen - 1 - s) * factor
    nr, nc = planes[0].shape[-2], planes[0].shape[-1]
    padded = [_pad2_periodic(p, lpad, max(s, 0) * factor) for p in planes]
    dtype = planes[0].dtype
    # taps rounded to the data dtype, then scaled by a power of two: exact
    weights = [[[[w * scale for w in _as_taps(row, dtype)] for row in F]
                for F in fs] for fs in filters]
    outs = [None] * len(filters)
    for k in range(hlen):
        oy = lpad + (s - k) * factor
        for l in range(hlen):
            ox = lpad + (s - l) * factor
            for pi, xp in enumerate(padded):
                seg = xp[..., oy: oy + nr, ox: ox + nc]
                for oi in range(len(filters)):
                    w = weights[oi][pi][k][l]
                    if w == 0.0:
                        continue
                    t = seg * w
                    outs[oi] = t if outs[oi] is None else outs[oi] + t
    return [torch.zeros_like(planes[0]) if o is None else o for o in outs]


def ns_swt2d_plain(x, f2d, level):
    """One non-separable stationary analysis level in torch ops ->
    (a, h, v, d), each of the input's shape."""
    return tuple(_stencil([x], [[F] for F in f2d.dec], level, False))


def ins_swt2d_plain(a, h, v, d, f2d, level):
    """One non-separable stationary synthesis level in torch ops, x 1/4."""
    return _stencil([a, h, v, d], [f2d.rec], level, True, 0.25)[0]


def _filter_unsupported(f2d):
    if not 1 <= f2d.hlen <= MAX_FILTER_WIDTH:
        return f"filter size {f2d.hlen} (1..{MAX_FILTER_WIDTH})"
    return None


def nsdwt2d_unsupported(x, f2d):
    """Why K16 cannot take ``x``, or None if it can."""
    return (_plane_unsupported(x, "input", F32_F64)
            or _filter_unsupported(f2d))


def insdwt2d_unsupported(a, h, v, d, f2d, out_shape):
    """Why K17 cannot take these subbands, or None if it can."""
    return (subbands_unsupported(a, h, v, d, out_shape, F32_F64)
            or _filter_unsupported(f2d))


def _ns_unsupported(t, what, f2d, level):
    return (swt2d_plane_unsupported(t, what, level)
            or _filter_unsupported(f2d))


def ns_swt2d_unsupported(x, f2d, level):
    """Why K18a cannot take ``x`` at ``level``, or None if it can."""
    return _ns_unsupported(x, "input", f2d, level)


def ins_swt2d_unsupported(a, h, v, d, f2d, level):
    """Why K18b cannot take these coefficients, or None if it can."""
    return (_ns_unsupported(a, "coefficient", f2d, level)
            or _pair_unsupported(a, h) or _pair_unsupported(a, v)
            or _pair_unsupported(a, d))


_HOST_BANKS: dict = {}
_DEVICE_BANKS: dict = {}

# pypwt_ns_bank_f64's layouts, by kernel
_LAYOUTS = {"K16": 0, "K17": 1, "K18a": 2, "K18b": 3}


def _host_bank(filters, dtype=np.float32):
    """The four filters as one array [b][k][l] of ``dtype`` (float32:
    rounded once; float64: the values as they are), cached by value so that
    the pointer handed to the kernel stays alive."""
    f = np.ascontiguousarray(np.stack(filters), dtype=np.float64)
    key = (f.tobytes(), f.shape, np.dtype(dtype).str)
    t = _HOST_BANKS.get(key)
    if t is None:
        t = _HOST_BANKS[key] = np.ascontiguousarray(f.astype(dtype))
    return t


def _bank_arg(lib, filters, kernel, like):
    """The bank argument of ``kernel`` for a level of ``like``: the host
    float32 bank (passed by value), or for float64 the device copy of the
    kernel's layout, made once per bank and device."""
    if like.dtype != torch.float64:
        return _host_bank(filters).ctypes.data
    f = _host_bank(filters, np.float64)
    key = (f.tobytes(), f.shape, kernel, str(like.device))
    t = _DEVICE_BANKS.get(key)
    if t is None:
        hlen = f.shape[-1]
        host = np.empty(4 * hlen * hlen, np.float64)
        err = lib.pypwt_ns_bank_f64(f.ctypes.data, hlen, _LAYOUTS[kernel],
                                    host.ctypes.data)
        _check_launch(lib, err, f"{kernel} float64 bank")
        t = _DEVICE_BANKS[key] = torch.from_numpy(host).to(like.device)
    return t.data_ptr()


def nsdwt2d_fused(x, f2d):
    """K16: one non-separable analysis level -> (a, h, v, d), each
    ``(B?, div2(Nr), div2(Nc))``.  CPU tensor: the plain version."""
    if x.device.type == "cpu":
        return nsdwt2d_plain(x, f2d)
    _check_inputs("K16 (nsdwt2d)", nsdwt2d_unsupported(x, f2d), x)
    lib = _build.load_library()
    nr, nc = x.shape[-2], x.shape[-1]
    shape = (*x.shape[:-2], div2(nr), div2(nc))
    a, h, v, d = (torch.empty(shape, dtype=x.dtype, device=x.device)
                  for _ in range(4))
    bank = _bank_arg(lib, f2d.dec, "K16", x)
    err = _entry(lib, "pypwt_ns_dwt2d", x)(
        x.data_ptr(), a.data_ptr(), h.data_ptr(), v.data_ptr(), d.data_ptr(),
        _batch(x), nr, nc, bank, f2d.hlen, x.device.index, _stream(x))
    _check_launch(lib, err, "K16 (nsdwt2d)")
    nsdwt2d_fused.launches += 1
    return a, h, v, d


def insdwt2d_fused(a, h, v, d, f2d, out_shape):
    """K17: one non-separable synthesis level -> ``(B?, *out_shape[-2:])``.
    CPU tensors: the plain version."""
    if a.device.type == "cpu":
        return insdwt2d_plain(a, h, v, d, f2d, out_shape)
    name = "K17 (insdwt2d)"
    _check_inputs(name, insdwt2d_unsupported(a, h, v, d, f2d, out_shape),
                  a, h, v, d)
    lib = _build.load_library()
    nr, nc = out_shape[-2], out_shape[-1]
    out = torch.empty((*a.shape[:-2], nr, nc), dtype=a.dtype, device=a.device)
    bank = _bank_arg(lib, f2d.rec, "K17", a)
    err = _entry(lib, "pypwt_ins_dwt2d", a)(
        a.data_ptr(), h.data_ptr(), v.data_ptr(), d.data_ptr(),
        out.data_ptr(), _batch(a), a.shape[-2], a.shape[-1], nr, nc, bank,
        f2d.hlen, a.device.index, _stream(a))
    _check_launch(lib, err, name)
    insdwt2d_fused.launches += 1
    return out


def ns_swt2d_fused(x, f2d, level):
    """K18a: one non-separable stationary analysis level -> (a, h, v, d),
    each of the input's shape ``(B?, Nr, Nc)``.  CPU tensor: the plain
    version."""
    if x.device.type == "cpu":
        return ns_swt2d_plain(x, f2d, level)
    _check_inputs("K18a (ns_swt2d)", ns_swt2d_unsupported(x, f2d, level), x)
    lib = _build.load_library()
    a, h, v, d = (torch.empty_like(x) for _ in range(4))
    bank = _bank_arg(lib, f2d.dec, "K18a", x)
    err = _entry(lib, "pypwt_ns_swt2d", x)(
        x.data_ptr(), a.data_ptr(), h.data_ptr(), v.data_ptr(), d.data_ptr(),
        _batch(x), x.shape[-2], x.shape[-1], level,
        swt_centre(f2d.hlen, False), bank, f2d.hlen, x.device.index,
        _stream(x))
    _check_launch(lib, err, "K18a (ns_swt2d)")
    ns_swt2d_fused.launches += 1
    return a, h, v, d


def ins_swt2d_fused(a, h, v, d, f2d, level):
    """K18b: one non-separable stationary synthesis level, x 1/4 -> the
    coefficients' shape.  CPU tensors: the plain version."""
    if a.device.type == "cpu":
        return ins_swt2d_plain(a, h, v, d, f2d, level)
    name = "K18b (ins_swt2d)"
    _check_inputs(name, ins_swt2d_unsupported(a, h, v, d, f2d, level),
                  a, h, v, d)
    lib = _build.load_library()
    out = torch.empty_like(a)
    bank = _bank_arg(lib, f2d.rec, "K18b", a)
    err = _entry(lib, "pypwt_ins_swt2d", a)(
        a.data_ptr(), h.data_ptr(), v.data_ptr(), d.data_ptr(),
        out.data_ptr(), _batch(a), a.shape[-2], a.shape[-1], level,
        swt_centre(f2d.hlen, True), bank, f2d.hlen, a.device.index,
        _stream(a))
    _check_launch(lib, err, name)
    ins_swt2d_fused.launches += 1
    return out


KERNELS = (nsdwt2d_fused, insdwt2d_fused, ns_swt2d_fused, ins_swt2d_fused)

for _k in KERNELS:
    _k.launches = 0
