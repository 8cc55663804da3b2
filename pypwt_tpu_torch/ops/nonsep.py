"""The non-separable stationary level kernels: wrappers, plain versions,
counts.

* K18a ``ns_swt2d_fused`` and K18b ``ins_swt2d_fused``
  (``csrc/nonsep_swt2d.cu``): one non-separable à-trous level with four
  dense ``hlen x hlen`` filters, analysis (1 plane -> 4) and synthesis
  (4 planes -> 1, x 1/4).  They replace the TPU kernel
  ``pypwt_tpu/ops/nonsep_pallas.py::_build_ns_swt2d`` (behind
  ``ns_swt2d_fused`` and ``ins_swt2d_fused``), which factored each filter
  into rank-1 SVD terms because Mosaic lowers no dense 2D stencil; the
  Hopper kernels are the direct stencil and need no factoring.

Beside each kernel, as in ``ops.fused_dwt``: its plain PyTorch version
(the slice formulation of ``pypwt_tpu.core.nonsep``, at every hlen: no
convolution, so no cuDNN and no TF32), ``*_unsupported`` and the
``launches``/``declined`` counts (``declined`` stays 0: an uncovered
level on a CUDA tensor raises).  A wrapper given a CPU tensor runs the
plain version; given a CUDA tensor it launches the kernel or raises.  The
bank goes to the kernel by value, rounded once to float32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.conv import _as_taps, _pad2_periodic, swt_centre
from ..filters import MAX_FILTER_WIDTH
from . import _build
from .fused_dwt import (_batch, _check_launch, _pair_unsupported, _require,
                        _stream, swt2d_plane_unsupported)


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


def _ns_unsupported(t, what, f2d, level):
    why = swt2d_plane_unsupported(t, what, level)
    if why:
        return why
    if not 1 <= f2d.hlen <= MAX_FILTER_WIDTH:
        return f"filter size {f2d.hlen} (1..{MAX_FILTER_WIDTH})"
    return None


def ns_swt2d_unsupported(x, f2d, level):
    """Why K18a cannot take ``x`` at ``level``, or None if it can."""
    return _ns_unsupported(x, "input", f2d, level)


def ins_swt2d_unsupported(a, h, v, d, f2d, level):
    """Why K18b cannot take these coefficients, or None if it can."""
    return (_ns_unsupported(a, "coefficient", f2d, level)
            or _pair_unsupported(a, h) or _pair_unsupported(a, v)
            or _pair_unsupported(a, d))


_HOST_BANKS: dict = {}


def _host_bank(filters):
    """The four filters as one float32 array [b][k][l], rounded once and
    cached by value so that the pointer handed to the kernel stays alive."""
    f = np.ascontiguousarray(np.stack(filters), dtype=np.float64)
    key = f.tobytes()
    t = _HOST_BANKS.get(key)
    if t is None:
        t = _HOST_BANKS[key] = np.ascontiguousarray(f.astype(np.float32))
    return t


def ns_swt2d_fused(x, f2d, level):
    """K18a: one non-separable stationary analysis level -> (a, h, v, d),
    each of the input's shape ``(B?, Nr, Nc)``.  CPU tensor: the plain
    version."""
    if x.device.type == "cpu":
        return ns_swt2d_plain(x, f2d, level)
    _require(x.is_cuda, "K18a (ns_swt2d)", f"device {x.device}")
    why = ns_swt2d_unsupported(x, f2d, level)
    _require(why is None, "K18a (ns_swt2d)", why)
    _require(x.is_contiguous(), "K18a (ns_swt2d)", "non-contiguous input")
    lib = _build.load_library()
    a, h, v, d = (torch.empty_like(x) for _ in range(4))
    bank = _host_bank(f2d.dec)
    err = lib.pypwt_ns_swt2d(
        x.data_ptr(), a.data_ptr(), h.data_ptr(), v.data_ptr(), d.data_ptr(),
        _batch(x), x.shape[-2], x.shape[-1], level,
        swt_centre(f2d.hlen, False), bank.ctypes.data, f2d.hlen,
        x.device.index, _stream(x))
    _check_launch(lib, err, "K18a (ns_swt2d)")
    ns_swt2d_fused.launches += 1
    return a, h, v, d


def ins_swt2d_fused(a, h, v, d, f2d, level):
    """K18b: one non-separable stationary synthesis level, x 1/4 -> the
    coefficients' shape.  CPU tensors: the plain version."""
    if a.device.type == "cpu":
        return ins_swt2d_plain(a, h, v, d, f2d, level)
    _require(a.is_cuda, "K18b (ins_swt2d)", f"device {a.device}")
    why = ins_swt2d_unsupported(a, h, v, d, f2d, level)
    _require(why is None, "K18b (ins_swt2d)", why)
    _require(all(s.is_contiguous() for s in (a, h, v, d)),
             "K18b (ins_swt2d)", "non-contiguous input")
    lib = _build.load_library()
    out = torch.empty_like(a)
    bank = _host_bank(f2d.rec)
    err = lib.pypwt_ins_swt2d(
        a.data_ptr(), h.data_ptr(), v.data_ptr(), d.data_ptr(),
        out.data_ptr(), _batch(a), a.shape[-2], a.shape[-1], level,
        swt_centre(f2d.hlen, True), bank.ctypes.data, f2d.hlen,
        a.device.index, _stream(a))
    _check_launch(lib, err, "K18b (ins_swt2d)")
    ins_swt2d_fused.launches += 1
    return out


KERNELS = (ns_swt2d_fused, ins_swt2d_fused)

for _k in KERNELS:
    _k.launches = 0
    _k.declined = 0
