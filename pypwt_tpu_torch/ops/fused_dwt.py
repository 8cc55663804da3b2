"""Separable 2D DWT level kernels K1/K2: wrappers, plain versions, counts.

K1 (``csrc/dwt2d.cu``) is one analysis level and replaces
``pypwt_tpu/ops/pallas_dwt.py::dwt2d_fused``; K2 (``csrc/idwt2d.cu``) is
one synthesis level and replaces ``::idwt2d_fused``.  Beside each kernel:

* its plain PyTorch version (``dwt2d_plain``/``idwt2d_plain``): the
  ``core.conv`` primitives composed for one level, exactly as the JAX
  package's ``core/dwt.py`` fallback composes them;
* ``*_unsupported``, which says before launch, from dtype, rank, shape and
  bank, why the kernel cannot take a call (None if it can) -- the port's
  form of the JAX wrappers returning None;
* counts on the wrapper: ``launches`` (kernel launches) and ``declined``
  (levels on a CUDA tensor that the dispatcher in ``core.dwt`` sent to the
  plain version because the kernel does not cover them).

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor it
launches the kernel or raises.  Taps are float32, rounded once from the
bank's float64 filters (as ``pallas_dwt._taps`` / ``conv._as_taps``), and
handed to the kernel by value, so a call copies nothing to the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import conv
from ..filters import MAX_FILTER_WIDTH
from . import _build

_MAX_GRID = 65535  # grid y and z limit (rows of tiles, batch)
_TILE = 32         # coefficient rows per block in both kernels


def dwt2d_plain(x, fb):
    """One separable analysis level in torch ops -> (a, h, v, d)."""
    t1, t2 = conv.analysis_last(x, fb.dec_lo, fb.dec_hi)
    t1 = t1.transpose(-1, -2)
    t2 = t2.transpose(-1, -2)
    a, h = conv.analysis_last(t1, fb.dec_lo, fb.dec_hi)
    v, d = conv.analysis_last(t2, fb.dec_lo, fb.dec_hi)
    return (a.transpose(-1, -2).contiguous(), h.transpose(-1, -2).contiguous(),
            v.transpose(-1, -2).contiguous(), d.transpose(-1, -2).contiguous())


def idwt2d_plain(a, h, v, d, fb, out_shape):
    """One separable synthesis level in torch ops -> image of ``out_shape``
    (its last two sizes)."""
    nr, nc = out_shape[-2], out_shape[-1]
    at, ht, vt, dt = (s.transpose(-1, -2) for s in (a, h, v, d))
    t1 = conv.synthesis_last(at, ht, fb.rec_lo, fb.rec_hi, nr)
    t2 = conv.synthesis_last(vt, dt, fb.rec_lo, fb.rec_hi, nr)
    t1 = t1.transpose(-1, -2)
    t2 = t2.transpose(-1, -2)
    return conv.synthesis_last(t1, t2, fb.rec_lo, fb.rec_hi, nc).contiguous()


def _bank_unsupported(fb):
    if fb.hlen % 2 or not 2 <= fb.hlen <= MAX_FILTER_WIDTH:
        return f"filter length {fb.hlen} (even, 2..{MAX_FILTER_WIDTH})"
    return None


def _plane_unsupported(t, what):
    if t.dtype != torch.float32:
        return f"{what} dtype {t.dtype} (float32 only)"
    if t.ndim not in (2, 3):
        return f"{what} rank {t.ndim} (2 or 3)"
    if t.ndim == 3 and not 1 <= t.shape[0] <= _MAX_GRID:
        return f"batch {t.shape[0]} (1..{_MAX_GRID})"
    return None


def dwt2d_unsupported(x, fb):
    """Why K1 cannot take ``x`` with bank ``fb``, or None if it can."""
    why = _plane_unsupported(x, "input") or _bank_unsupported(fb)
    if why:
        return why
    nr, nc = x.shape[-2], x.shape[-1]
    if nr < 2 or nc < 2 or nr % 2 or nc % 2:
        return f"plane {nr}x{nc} (even sizes only)"
    if -(-(nr // 2) // _TILE) > _MAX_GRID:
        return f"{nr} rows (too many tiles for the grid)"
    return None


def idwt2d_unsupported(a, h, v, d, fb, out_shape):
    """Why K2 cannot take these coefficients, or None if it can."""
    why = _plane_unsupported(a, "coefficient") or _bank_unsupported(fb)
    if why:
        return why
    if not (a.shape == h.shape == v.shape == d.shape):
        return "subbands of different shapes"
    if not (a.dtype == h.dtype == v.dtype == d.dtype):
        return "subbands of different dtypes"
    if not (a.device == h.device == v.device == d.device):
        return "subbands on different devices"
    lr, lc = a.shape[-2], a.shape[-1]
    if lr < 1 or lc < 1:
        return "empty subbands"
    if (out_shape[-2], out_shape[-1]) != (2 * lr, 2 * lc):
        return (f"output {tuple(out_shape[-2:])} is not twice the "
                f"coefficients {lr}x{lc} (odd-size level)")
    if -(-lr // _TILE) > _MAX_GRID:
        return f"{lr} coefficient rows (too many tiles for the grid)"
    return None


_HOST_TAPS: dict = {}


def _host_taps(f):
    """float32 taps of one float64 filter, cached by value so that the
    pointer handed to the kernel stays alive."""
    f = np.asarray(f, dtype=np.float64)
    key = f.tobytes()
    t = _HOST_TAPS.get(key)
    if t is None:
        t = _HOST_TAPS[key] = np.ascontiguousarray(f.astype(np.float32))
    return t


def _check_launch(lib, err, name):
    if err != 0:
        msg = lib.pypwt_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: cudaError {err} ({msg})")


def _require(cond, name, why):
    if not cond:
        raise ValueError(f"{name} does not take this input: {why}")


def dwt2d_fused(x, fb):
    """K1: one separable analysis level -> (a, h, v, d), each
    (B?, Nr/2, Nc/2).  CPU tensor: the plain version."""
    if x.device.type == "cpu":
        return dwt2d_plain(x, fb)
    _require(x.is_cuda, "K1 (dwt2d)", f"device {x.device}")
    why = dwt2d_unsupported(x, fb)
    _require(why is None, "K1 (dwt2d)", why)
    _require(x.is_contiguous(), "K1 (dwt2d)", "non-contiguous input")
    lib = _build.load_library()
    nr, nc = x.shape[-2], x.shape[-1]
    batch = x.shape[0] if x.ndim == 3 else 1
    shape = (*x.shape[:-2], nr // 2, nc // 2)
    a, h, v, d = (torch.empty(shape, dtype=x.dtype, device=x.device)
                  for _ in range(4))
    lo, hi = _host_taps(fb.dec_lo), _host_taps(fb.dec_hi)
    err = lib.pypwt_dwt2d(
        x.data_ptr(), a.data_ptr(), h.data_ptr(), v.data_ptr(), d.data_ptr(),
        batch, nr, nc, lo.ctypes.data, hi.ctypes.data, fb.hlen,
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    _check_launch(lib, err, "K1 (dwt2d)")
    dwt2d_fused.launches += 1
    return a, h, v, d


def idwt2d_fused(a, h, v, d, fb, out_shape):
    """K2: one separable synthesis level -> (B?, 2Lr, 2Lc).  CPU tensors:
    the plain version."""
    if a.device.type == "cpu":
        return idwt2d_plain(a, h, v, d, fb, out_shape)
    _require(a.is_cuda, "K2 (idwt2d)", f"device {a.device}")
    why = idwt2d_unsupported(a, h, v, d, fb, out_shape)
    _require(why is None, "K2 (idwt2d)", why)
    _require(all(s.is_contiguous() for s in (a, h, v, d)), "K2 (idwt2d)",
             "non-contiguous input")
    lib = _build.load_library()
    lr, lc = a.shape[-2], a.shape[-1]
    batch = a.shape[0] if a.ndim == 3 else 1
    out = torch.empty((*a.shape[:-2], 2 * lr, 2 * lc), dtype=a.dtype,
                      device=a.device)
    lo, hi = _host_taps(fb.rec_lo), _host_taps(fb.rec_hi)
    err = lib.pypwt_idwt2d(
        a.data_ptr(), h.data_ptr(), v.data_ptr(), d.data_ptr(),
        out.data_ptr(), batch, lr, lc, lo.ctypes.data, hi.ctypes.data,
        fb.hlen, a.device.index,
        torch.cuda.current_stream(a.device).cuda_stream)
    _check_launch(lib, err, "K2 (idwt2d)")
    idwt2d_fused.launches += 1
    return out


dwt2d_fused.launches = 0
dwt2d_fused.declined = 0
idwt2d_fused.launches = 0
idwt2d_fused.declined = 0

KERNELS = (dwt2d_fused, idwt2d_fused)


def reset_counts():
    """Set every kernel's ``launches`` and ``declined`` count to 0."""
    for k in KERNELS:
        k.launches = 0
        k.declined = 0
