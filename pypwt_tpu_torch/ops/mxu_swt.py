"""K11a/K11b and K12a/K12b: one separable 2D and one batched-1D stationary
(a-trous) level and their inverses as banded products on the tensor cores
(the port of ``pypwt_tpu.ops.mxu_swt``'s kernels).

* K11a ``swt2d_mxu_fused`` (``csrc/tc_swt2d.cu``) replaces
  ``pypwt_tpu/ops/mxu_swt.py::swt2d_level_fused_mxu``
  (``_build_swt2d_mxu``): one analysis level -> a, h, v, d, each of the
  input's shape ``(B?, Nr, Nc)``;
* K11b ``iswt2d_mxu_fused`` (same source) replaces
  ``::iswt2d_level_fused_mxu`` (``_build_iswt2d_mxu``): its inverse, 1/2
  per axis pass;
* K12a ``swt1d_mxu_fused`` (``csrc/tc_swt1d.cu``) replaces
  ``::swt1d_level_fused_mxu`` (``_build_swt1d_mxu``): one level of rows
  ``(R, n)`` or one signal ``(n,)`` -> a, d of its shape; K12b
  ``iswt1d_mxu_fused`` (same source) replaces ``::iswt1d_level_fused_mxu``
  (``_build_iswt1d_mxu``): its inverse, one 1/2.  One signal is a
  ``(1, n)`` row, which covers JAX's folded forms
  ``::swt1d_long_fused_mxu`` / ``::iswt1d_long_fused_mxu`` (K15);
* K28's SWT half (same source as K11a/K11b): ``swt2d_sharded_mxu_fused``
  and ``iswt2d_sharded_mxu_fused`` replace ``::build_swt2d_sharded_mxu``
  and ``::build_iswt2d_sharded_mxu``, K11a/K11b's levels of one row shard
  with its edge rows from exchanged halo tensors (``parallel.spatial``),
  covered where the dilated support fits in the shard's rows (the columns;
  the rows come from the halos).

Each pass is the banded dilated map of the JAX kernels: a block of ``b``
outputs of (lo, hi) is ``D (2b, K) @ xp[bq : bq + K]``, ``K = b +
(hlen-1) * 2^(level-1)`` (synthesis: ``S (b, 2K) @ [lop; hip]``), on
planes padded periodically by ``(hlen-1-s) * 2^(level-1)`` on the left,
first along axis -2, then along the last axis, as JAX's kernels order
them.  The plain versions take blocks of ``_BLOCK`` outputs: the TPU's
block sizes and its polyphase reshape (``_pick_b``, ``_poly_t``) fitted
its 128-wide tiles and give the same map.  The kernels take rows and
columns of one residue class mod 2^(level-1) per block, so their band is
the compact level-1 one at every level.  The matrix functions are copies
of JAX's (float64 numpy, cast once to float32).  Precisions and the
CPU/CUDA rule as in ``ops.mxu_dwt``.

``*_unsupported`` covers at least what JAX covers: float32 planes, stacks
or rows, any bank of up to 40 taps, any level whose dilated support fits
in the plane or row (JAX refuses a wider one, ``mxu_swt.py:339-341``,
``:511-513``, ``:577-579``, and so does this port); the router
(``core.swt``) sends every other level to K8/K9 or K10.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import conv
from . import _build
from .fused_dwt import (F32, _batch, _check_inputs, _check_launch,
                        _dtype_unsupported, _host_taps, _rows, _stream,
                        halo_array, iswt1d_unsupported,
                        iswt2d_sharded_unsupported, iswt2d_unsupported,
                        swt1d_unsupported, swt2d_sharded_unsupported,
                        swt2d_unsupported)
from .mxu_dwt import check_precision, matrix, operand

_BLOCK = 64  # outputs per banded block of the plain versions


def swt_analysis_matrix(dec_lo, dec_hi, b, level):
    """D (2b, K), K = b + (hlen-1)*t: rows [lo_b; hi_b] of the a-trous
    analysis map out[i] = sum_k f[k] x[i + (s-k)*t] with s = hlen//2 and
    t = 2^(level-1) (conv.swt_analysis_last / separable.cu:409-448).
    Operates on input slices padded with lpad = (hlen-1-s)*t on the
    left."""
    flo = np.asarray(dec_lo, np.float64)
    fhi = np.asarray(dec_hi, np.float64)
    hlen = len(flo)
    t = 1 << (level - 1)
    s = hlen // 2
    lpad = (hlen - 1 - s) * t
    K = b + (hlen - 1) * t
    D = np.zeros((2 * b, K), np.float64)
    for i in range(b):
        for k in range(hlen):
            j = lpad + (s - k) * t + i
            D[i, j] += flo[k]
            D[b + i, j] += fhi[k]
    return np.ascontiguousarray(D, np.float32), K


def swt_synthesis_matrix(rec_lo, rec_hi, b, level):
    """S (b, 2K), K = b + (hlen-1)*t: the a-trous synthesis map from
    stacked [lo_slice; hi_slice] to b outputs, including the reference's
    1/2-per-pass rescale (conv.swt_synthesis_last / separable.cu:553-584).
    s = hlen//2 - 1 for even hlen."""
    flo = np.asarray(rec_lo, np.float64)
    fhi = np.asarray(rec_hi, np.float64)
    hlen = len(flo)
    t = 1 << (level - 1)
    s = hlen // 2 - 1 if hlen % 2 == 0 else hlen // 2
    lpad = (hlen - 1 - s) * t
    K = b + (hlen - 1) * t
    S = np.zeros((b, 2 * K), np.float64)
    for i in range(b):
        for k in range(hlen):
            j = lpad + (s - k) * t + i
            S[i, j] += flo[k] * 0.5
            S[i, K + j] += fhi[k] * 0.5
    return np.ascontiguousarray(S, np.float32), K


def _blocks(n):
    b = min(_BLOCK, n)
    return b, *divmod(n, b)


def _swt_ana_last(x, fb, level, prec):
    """Banded a-trous analysis along the last axis -> lo, hi of its
    length."""
    xp = conv.periodic_pad_last(x, *conv.swt_pads(fb.hlen, level, False))
    return _swt_ana_core(xp, fb, level, prec, x.shape[-1])


def _swt_ana_core(xp, fb, level, prec, n):
    """Banded a-trous analysis of a padded signal (``conv.swt_pads``)
    along the last axis -> lo, hi of length n."""
    xp = operand(xp, prec)
    b, nfull, r = _blocks(n)
    los, his = [], []
    for size, count, start in ((b, nfull, 0), (r, 1, b * nfull)):
        if not size or not count:
            continue
        D, K = matrix(xp, prec, swt_analysis_matrix, fb.dec_lo, fb.dec_hi,
                      size, level)
        y = xp[..., start:].unfold(-1, K, size)[..., :count, :] @ D.T
        los.append(y[..., :size].flatten(-2))
        his.append(y[..., size:].flatten(-2))
    return torch.cat(los, -1), torch.cat(his, -1)


def _swt_syn_last(lo, hi, fb, level, prec):
    """Banded a-trous synthesis along the last axis (1/2 in the matrix)."""
    pads = conv.swt_pads(fb.hlen, level, True)
    return _swt_syn_core(conv.periodic_pad_last(lo, *pads),
                         conv.periodic_pad_last(hi, *pads), fb, level, prec,
                         lo.shape[-1])


def _swt_syn_core(lop, hip, fb, level, prec, n):
    """Banded a-trous synthesis of padded coefficient signals
    (``conv.swt_pads(hlen, level, True)``) -> length n."""
    lop, hip = operand(lop, prec), operand(hip, prec)
    b, nfull, r = _blocks(n)
    outs = []
    for size, count, start in ((b, nfull, 0), (r, 1, b * nfull)):
        if not size or not count:
            continue
        S, K = matrix(lop, prec, swt_synthesis_matrix, fb.rec_lo, fb.rec_hi,
                      size, level)
        z = torch.cat([lop[..., start:].unfold(-1, K, size)[..., :count, :],
                       hip[..., start:].unfold(-1, K, size)[..., :count, :]],
                      -1)
        outs.append((z @ S.T).flatten(-2))
    return torch.cat(outs, -1)


def swt2d_mxu_plain(x, fb, level, prec="highest"):
    """One stationary analysis level as banded products -> (a, h, v, d),
    each of the input's shape: along axis -2, then the last axis (K8's
    subbands: h is the high-pass along axis -2)."""
    check_precision(prec)
    lo_r, hi_r = (t.transpose(-1, -2) for t in _swt_ana_last(
        x.transpose(-1, -2), fb, level, prec))
    a, v = _swt_ana_last(lo_r, fb, level, prec)
    h, d = _swt_ana_last(hi_r, fb, level, prec)
    return a, h, v, d


def iswt2d_mxu_plain(a, h, v, d, fb, level, prec="highest"):
    """One stationary synthesis level as banded products: along axis -2
    t1 = syn(a, h), t2 = syn(v, d), then the last axis."""
    check_precision(prec)
    t1, t2 = (_swt_syn_last(p.transpose(-1, -2), q.transpose(-1, -2), fb,
                            level, prec).transpose(-1, -2)
              for p, q in ((a, h), (v, d)))
    return _swt_syn_last(t1, t2, fb, level, prec)


def swt2d_sharded_mxu_plain(x, top, bot, fb, level, prec="highest"):
    """K28's stationary analysis map: ``swt2d_mxu_plain`` on a row shard,
    axis -2 on the rows extended by its halos (unwrapped), then the last
    axis periodically."""
    check_precision(prec)
    xp = torch.cat([top, x, bot], -2).transpose(-1, -2)
    lo_r, hi_r = (t.transpose(-1, -2) for t in _swt_ana_core(
        xp, fb, level, prec, x.shape[-2]))
    a, v = _swt_ana_last(lo_r, fb, level, prec)
    h, d = _swt_ana_last(hi_r, fb, level, prec)
    return a, h, v, d


def iswt2d_sharded_mxu_plain(a, h, v, d, halos, fb, level, prec="highest"):
    """K28's stationary synthesis map: ``iswt2d_mxu_plain`` on a row
    shard's planes, axis -2 on the rows extended by each plane's halos."""
    check_precision(prec)
    ext = [torch.cat([halos[2 * i], p, halos[2 * i + 1]], -2).transpose(-1, -2)
           for i, p in enumerate((a, h, v, d))]
    n = a.shape[-2]
    t1, t2 = (_swt_syn_core(lo, hi, fb, level, prec, n).transpose(-1, -2)
              for lo, hi in ((ext[0], ext[1]), (ext[2], ext[3])))
    return _swt_syn_last(t1, t2, fb, level, prec)


def _support_unsupported(t, fb, level, inverse, ndim=2):
    """Why the dilated support of ``level`` passes the last ``ndim`` axes
    of ``t`` (the plane, or the row), or None."""
    sizes = tuple(t.shape[-ndim:])
    lp, rp = conv.swt_pads(fb.hlen, level, inverse)
    if max(lp, rp) > min(sizes):
        what = (f"the plane {sizes[0]} x {sizes[1]}" if ndim == 2
                else f"the row of {sizes[0]} samples")
        return (f"dilated support of level {level} ({max(lp, rp)} samples) "
                f"wider than {what}")
    return None


def _float32_unsupported(t, what):
    return _dtype_unsupported(t, what, F32)


def swt2d_mxu_unsupported(x, fb, level):
    """Why K11a cannot take ``x`` at ``level``, or None if it can."""
    return (_float32_unsupported(x, "input")
            or swt2d_unsupported(x, fb, level)
            or _support_unsupported(x, fb, level, False))


def iswt2d_mxu_unsupported(a, h, v, d, fb, level):
    """Why K11b cannot take these coefficients, or None if it can."""
    return (_float32_unsupported(a, "coefficient")
            or iswt2d_unsupported(a, h, v, d, fb, level)
            or _support_unsupported(a, fb, level, True))


def swt1d_mxu_unsupported(x, fb, level):
    """Why K12a cannot take rows ``x`` at ``level``, or None if it can
    (JAX's ``swt1d_level_fused_mxu``: float32, the dilated support within
    the row)."""
    return (_float32_unsupported(x, "input")
            or swt1d_unsupported(x, fb, level)
            or _support_unsupported(x, fb, level, False, 1))


def iswt1d_mxu_unsupported(a, d, fb, level):
    """Why K12b cannot take these coefficients, or None if it can."""
    return (_float32_unsupported(a, "coefficient")
            or iswt1d_unsupported(a, d, fb, level)
            or _support_unsupported(a, fb, level, True, 1))


def swt1d_mxu_plain(x, fb, level, prec="highest"):
    """K12a's map: one batched-1D stationary analysis level as banded
    products along the last axis -> (a, d), each of the input's shape."""
    check_precision(prec)
    return _swt_ana_last(x, fb, level, prec)


def iswt1d_mxu_plain(a, d, fb, level, prec="highest"):
    """K12b's map: its inverse as banded products (one 1/2)."""
    check_precision(prec)
    return _swt_syn_last(a, d, fb, level, prec)


def swt2d_mxu_fused(x, fb, level, prec="highest"):
    """K11a: one stationary analysis level on the tensor cores -> (a, h, v,
    d), each of the input's shape.  CPU tensor: the plain version."""
    check_precision(prec)
    if x.device.type == "cpu":
        return swt2d_mxu_plain(x, fb, level, prec)
    _check_inputs("K11a (swt2d_mxu)", swt2d_mxu_unsupported(x, fb, level), x)
    lib = _build.load_library()
    a, h, v, d = (torch.empty_like(x) for _ in range(4))
    lo, hi = _host_taps(fb.dec_lo), _host_taps(fb.dec_hi)
    err = lib.pypwt_tc_swt2d(
        x.data_ptr(), a.data_ptr(), h.data_ptr(), v.data_ptr(), d.data_ptr(),
        _batch(x), x.shape[-2], x.shape[-1], level,
        conv.swt_centre(fb.hlen, False), lo.ctypes.data, hi.ctypes.data,
        fb.hlen, int(prec == "bf16"), x.device.index, _stream(x))
    _check_launch(lib, err, "K11a (swt2d_mxu)")
    swt2d_mxu_fused.launches += 1
    return a, h, v, d


def iswt2d_mxu_fused(a, h, v, d, fb, level, prec="highest"):
    """K11b: one stationary synthesis level on the tensor cores -> the
    coefficients' shape.  CPU tensors: the plain version."""
    check_precision(prec)
    if a.device.type == "cpu":
        return iswt2d_mxu_plain(a, h, v, d, fb, level, prec)
    _check_inputs("K11b (iswt2d_mxu)",
                  iswt2d_mxu_unsupported(a, h, v, d, fb, level), a, h, v, d)
    lib = _build.load_library()
    out = torch.empty_like(a)
    lo, hi = _host_taps(fb.rec_lo), _host_taps(fb.rec_hi)
    err = lib.pypwt_tc_iswt2d(
        a.data_ptr(), h.data_ptr(), v.data_ptr(), d.data_ptr(),
        out.data_ptr(), _batch(a), a.shape[-2], a.shape[-1], level,
        conv.swt_centre(fb.hlen, True), lo.ctypes.data, hi.ctypes.data,
        fb.hlen, int(prec == "bf16"), a.device.index, _stream(a))
    _check_launch(lib, err, "K11b (iswt2d_mxu)")
    iswt2d_mxu_fused.launches += 1
    return out


def swt1d_mxu_fused(x, fb, level, prec="highest"):
    """K12a: one batched-1D stationary analysis level on the tensor cores ->
    (a, d), each of the input's shape.  CPU tensor: the plain version."""
    check_precision(prec)
    if x.device.type == "cpu":
        return swt1d_mxu_plain(x, fb, level, prec)
    _check_inputs("K12a (swt1d_mxu)", swt1d_mxu_unsupported(x, fb, level), x)
    lib = _build.load_library()
    a, d = torch.empty_like(x), torch.empty_like(x)
    lo, hi = _host_taps(fb.dec_lo), _host_taps(fb.dec_hi)
    err = lib.pypwt_tc_swt1d(
        x.data_ptr(), a.data_ptr(), d.data_ptr(), _rows(x), x.shape[-1],
        level, conv.swt_centre(fb.hlen, False), lo.ctypes.data,
        hi.ctypes.data, fb.hlen, int(prec == "bf16"), x.device.index,
        _stream(x))
    _check_launch(lib, err, "K12a (swt1d_mxu)")
    swt1d_mxu_fused.launches += 1
    return a, d


def iswt1d_mxu_fused(a, d, fb, level, prec="highest"):
    """K12b: one batched-1D stationary synthesis level on the tensor cores
    -> the coefficients' shape.  CPU tensors: the plain version."""
    check_precision(prec)
    if a.device.type == "cpu":
        return iswt1d_mxu_plain(a, d, fb, level, prec)
    _check_inputs("K12b (iswt1d_mxu)",
                  iswt1d_mxu_unsupported(a, d, fb, level), a, d)
    lib = _build.load_library()
    out = torch.empty_like(a)
    lo, hi = _host_taps(fb.rec_lo), _host_taps(fb.rec_hi)
    err = lib.pypwt_tc_iswt1d(
        a.data_ptr(), d.data_ptr(), out.data_ptr(), _rows(a), a.shape[-1],
        level, conv.swt_centre(fb.hlen, True), lo.ctypes.data,
        hi.ctypes.data, fb.hlen, int(prec == "bf16"), a.device.index,
        _stream(a))
    _check_launch(lib, err, "K12b (iswt1d_mxu)")
    iswt1d_mxu_fused.launches += 1
    return out


def swt2d_sharded_mxu_unsupported(x, top, bot, fb, level):
    """Why K28's stationary analysis cannot take shard ``x`` and its halos
    at ``level``, or None (K11a's coverage along the columns)."""
    return (_float32_unsupported(x, "input")
            or swt2d_sharded_unsupported(x, top, bot, fb, level)
            or _support_unsupported(x, fb, level, False, 1))


def iswt2d_sharded_mxu_unsupported(a, h, v, d, halos, fb, level):
    """Why K28's stationary synthesis cannot take these planes and
    halos, or None."""
    return (_float32_unsupported(a, "coefficient")
            or iswt2d_sharded_unsupported(a, h, v, d, halos, fb, level)
            or _support_unsupported(a, fb, level, True, 1))


def swt2d_sharded_mxu_fused(x, top, bot, fb, level, prec="highest"):
    """K28, stationary analysis: K11a's level of a row shard -> (a, h, v,
    d), each of the shard's shape.  CPU tensors: the plain version."""
    check_precision(prec)
    if x.device.type == "cpu":
        return swt2d_sharded_mxu_plain(x, top, bot, fb, level, prec)
    name = "K28 (swt2d_sharded_mxu)"
    _check_inputs(name,
                  swt2d_sharded_mxu_unsupported(x, top, bot, fb, level),
                  x, top, bot)
    lib = _build.load_library()
    a, h, v, d = (torch.empty_like(x) for _ in range(4))
    lo, hi = _host_taps(fb.dec_lo), _host_taps(fb.dec_hi)
    err = lib.pypwt_tc_swt2d_sharded(
        x.data_ptr(), top.data_ptr(), bot.data_ptr(), a.data_ptr(),
        h.data_ptr(), v.data_ptr(), d.data_ptr(), _batch(x), x.shape[-2],
        x.shape[-1], level, conv.swt_centre(fb.hlen, False), top.shape[-2],
        bot.shape[-2], lo.ctypes.data, hi.ctypes.data, fb.hlen,
        int(prec == "bf16"), x.device.index, _stream(x))
    _check_launch(lib, err, name)
    swt2d_sharded_mxu_fused.launches += 1
    return a, h, v, d


def iswt2d_sharded_mxu_fused(a, h, v, d, halos, fb, level, prec="highest"):
    """K28, stationary synthesis: K11b's level of a row shard's planes and
    their eight halos -> the planes' shape.  CPU tensors: the plain
    version."""
    check_precision(prec)
    if a.device.type == "cpu":
        return iswt2d_sharded_mxu_plain(a, h, v, d, halos, fb, level, prec)
    name = "K28 (iswt2d_sharded_mxu)"
    _check_inputs(name, iswt2d_sharded_mxu_unsupported(a, h, v, d, halos,
                                                       fb, level),
                  a, h, v, d, *halos)
    lib = _build.load_library()
    out = torch.empty_like(a)
    lo, hi = _host_taps(fb.rec_lo), _host_taps(fb.rec_hi)
    ptrs = halo_array(halos)
    err = lib.pypwt_tc_iswt2d_sharded(
        a.data_ptr(), h.data_ptr(), v.data_ptr(), d.data_ptr(),
        ctypes.addressof(ptrs), out.data_ptr(), _batch(a), a.shape[-2],
        a.shape[-1], level, conv.swt_centre(fb.hlen, True),
        halos[0].shape[-2], halos[1].shape[-2], lo.ctypes.data,
        hi.ctypes.data, fb.hlen, int(prec == "bf16"), a.device.index,
        _stream(a))
    _check_launch(lib, err, name)
    iswt2d_sharded_mxu_fused.launches += 1
    return out


KERNELS = (swt2d_mxu_fused, iswt2d_mxu_fused, swt1d_mxu_fused,
           iswt1d_mxu_fused, swt2d_sharded_mxu_fused,
           iswt2d_sharded_mxu_fused)

# counts start at 0; ``ops.reset_counts`` zeroes them with the others
for _k in KERNELS:
    _k.launches = 0
