"""The shift-aware 2D DWT level kernels of cycle spinning: wrappers, plain
versions, counts.

* K19 ``dwt2d_shifted_fused`` (``csrc/dwt2d.cu``, K1's pair body with
  the roll in its row table and its window's read shift): one separable
  analysis level of ``roll(x, (sr, sc), (-2, -1))`` without materialising
  the roll, with an optional soft or hard threshold of h, v and d by
  ``beta`` at the store.  It replaces ``pypwt_tpu/ops/pallas_dwt.py::dwt2d_fused_shifted``
  (``_build_dwt2d_shifted``), and, the shift being a runtime integer, the
  analysis halves of the phase-select (``_build_dwt2d_phasesel``: shift =
  the phase bits), dynamic-shift (``_build_dwt2d_dynshift``) and
  multi-shift (``_build_dwt2d_multishift``: one launch per spin) kernels.
* K20 ``idwt2d_unshift_fused`` (``csrc/idwt2d.cu``, K2's kernel with a
  shifted output index): ``scale * (roll(idwt2d(a, h, v, d), (-sr, -sc),
  (-2, -1)) [+ acc])``, the spin accumulator and the average's scale fused
  into the store.  It replaces ``::idwt2d_fused_unshift``
  (``_build_idwt2d_shifted``) and the synthesis halves of the phase-select,
  dynamic-shift and multi-unshift (one accumulating launch per spin)
  kernels.

Each takes every shift (reduced mod the plane size here), every float32
plane or stack and every size, odd ones included, that its plain version
takes.  Beside each: its plain PyTorch version (``torch.roll`` around the
plain level of ``ops.fused_dwt``, the threshold of ``core.thresh``, the
accumulator and the scale), ``*_unsupported`` and the ``launches`` count.
A wrapper given a CPU tensor runs the plain version; given a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..core import thresh
from ..core.shapes import div2
from . import _build
from .fused_dwt import (_bank_unsupported, _batch, _check_inputs,
                        _check_launch, _host_taps, _plane_unsupported,
                        _stream, dwt2d_plain, idwt2d_plain,
                        subbands_unsupported)

# threshold epilogue of K19: its kernel's mode argument
MODES = {None: 0, "soft": 1, "hard": 2}


def dwt2d_shifted_plain(x, fb, sr, sc, mode=None, beta=0.0):
    """K19's map in torch ops: the analysis level of x rolled by
    (sr, sc), h, v and d thresholded by ``beta`` if ``mode`` is "soft" or
    "hard"."""
    a, h, v, d = dwt2d_plain(torch.roll(x, (sr, sc), (-2, -1)), fb)
    if mode is None:
        return a, h, v, d
    th = thresh._soft if mode == "soft" else thresh._hard
    return a, th(h, beta), th(v, beta), th(d, beta)


def idwt2d_unshift_plain(a, h, v, d, fb, out_shape, sr, sc, acc=None,
                         scale=1.0):
    """K20's map in torch ops: ``scale * (roll(y, (-sr, -sc)) [+ acc])``,
    y the synthesis level of ``out_shape``."""
    y = torch.roll(idwt2d_plain(a, h, v, d, fb, out_shape), (-sr, -sc),
                   (-2, -1))
    if acc is not None:
        y = acc + y
    return y if scale == 1.0 else y * scale


def dwt2d_shifted_unsupported(x, fb, mode=None):
    """Why K19 cannot take ``x``, or None if it can."""
    if mode not in MODES:
        return f"threshold mode {mode!r} (None, 'soft' or 'hard')"
    return _plane_unsupported(x, "input") or _bank_unsupported(fb)


def idwt2d_unshift_unsupported(a, h, v, d, fb, out_shape, acc=None):
    """Why K20 cannot take these subbands, or None if it can."""
    why = (subbands_unsupported(a, h, v, d, out_shape)
           or _bank_unsupported(fb, 2))
    if why or acc is None:
        return why
    shape = (*a.shape[:-2], out_shape[-2], out_shape[-1])
    if tuple(acc.shape) != shape or acc.dtype != a.dtype \
            or acc.device != a.device:
        return (f"accumulator {tuple(acc.shape)} {acc.dtype} is not the "
                f"output's {shape} {a.dtype} on {a.device}")
    return None


def dwt2d_shifted_fused(x, fb, sr, sc, mode=None, beta=0.0):
    """K19: one analysis level of x rolled by (sr, sc) -> (a, h, v, d),
    each ``(B?, div2(Nr), div2(Nc))``; ``mode`` "soft" or "hard"
    thresholds h, v and d by ``beta``.  CPU tensor: the plain version."""
    if x.device.type == "cpu":
        return dwt2d_shifted_plain(x, fb, sr, sc, mode, beta)
    _check_inputs("K19 (dwt2d_shifted)",
                  dwt2d_shifted_unsupported(x, fb, mode), x)
    lib = _build.load_library()
    nr, nc = x.shape[-2], x.shape[-1]
    shape = (*x.shape[:-2], div2(nr), div2(nc))
    a, h, v, d = (torch.empty(shape, dtype=x.dtype, device=x.device)
                  for _ in range(4))
    lo, hi = _host_taps(fb.dec_lo), _host_taps(fb.dec_hi)
    err = lib.pypwt_dwt2d_shifted(
        x.data_ptr(), a.data_ptr(), h.data_ptr(), v.data_ptr(), d.data_ptr(),
        _batch(x), nr, nc, int(sr) % nr, int(sc) % nc, MODES[mode],
        float(beta), lo.ctypes.data, hi.ctypes.data, fb.hlen, x.device.index,
        _stream(x))
    _check_launch(lib, err, "K19 (dwt2d_shifted)")
    dwt2d_shifted_fused.launches += 1
    return a, h, v, d


def idwt2d_unshift_fused(a, h, v, d, fb, out_shape, sr, sc, acc=None,
                         scale=1.0):
    """K20: ``scale * (roll(idwt2d(a, h, v, d), (-sr, -sc)) [+ acc])`` ->
    ``(B?, *out_shape[-2:])``.  CPU tensors: the plain version."""
    if a.device.type == "cpu":
        return idwt2d_unshift_plain(a, h, v, d, fb, out_shape, sr, sc, acc,
                                    scale)
    _check_inputs("K20 (idwt2d_unshift)",
                  idwt2d_unshift_unsupported(a, h, v, d, fb, out_shape, acc),
                  a, h, v, d, *(() if acc is None else (acc,)))
    lib = _build.load_library()
    nr, nc = out_shape[-2], out_shape[-1]
    out = torch.empty((*a.shape[:-2], nr, nc), dtype=a.dtype, device=a.device)
    lo, hi = _host_taps(fb.rec_lo), _host_taps(fb.rec_hi)
    err = lib.pypwt_idwt2d_unshift(
        a.data_ptr(), h.data_ptr(), v.data_ptr(), d.data_ptr(),
        None if acc is None else acc.data_ptr(), out.data_ptr(), _batch(a),
        a.shape[-2], a.shape[-1], nr, nc, int(sr) % nr, int(sc) % nc,
        float(scale), lo.ctypes.data, hi.ctypes.data, fb.hlen,
        a.device.index, _stream(a))
    _check_launch(lib, err, "K20 (idwt2d_unshift)")
    idwt2d_unshift_fused.launches += 1
    return out


KERNELS = (dwt2d_shifted_fused, idwt2d_unshift_fused)

for _k in KERNELS:
    _k.launches = 0
