"""The DWT and SWT level kernels: wrappers, plain versions, counts.

Each kernel replaces a TPU kernel of ``pypwt_tpu/ops/pallas_dwt.py``:

* K1 ``dwt2d_fused`` (``csrc/dwt2d.cu``): one separable 2D analysis level
  (``::dwt2d_fused``); K2 ``idwt2d_fused`` (``csrc/idwt2d.cu``): one 2D
  synthesis level (``::idwt2d_fused``);
* K3 ``dwt1d_fused`` (``csrc/dwt1d.cu``) and K4 ``idwt1d_fused``
  (``csrc/idwt1d.cu``): one batched-1D analysis / synthesis level
  (``::dwt1d_fused``, ``::idwt1d_fused``);
* K10a ``swt1d_fused`` and K10b ``iswt1d_fused`` (``csrc/swt1d.cu``): one
  batched-1D stationary level and its inverse (``::swt1d_level_fused``,
  ``::iswt1d_level_fused``);
* K8 ``swt2d_fused`` and K9 ``iswt2d_fused`` (``csrc/swt2d.cu``): one
  separable 2D stationary level and its inverse (``::swt2d_level_fused``,
  ``::iswt2d_level_fused``), on a plane ``(Nr, Nc)`` or a stack
  ``(B, Nr, Nc)``;
* the row-sharded levels of ``parallel.spatial``: K26a
  ``dwt2d_sharded_fused`` (``csrc/dwt2d.cu``) and K26b
  ``idwt2d_sharded_fused`` (``csrc/idwt2d.cu``), K1/K2's levels of one row
  shard whose edge rows come from exchanged halo tensors
  (``::build_dwt2d_sharded``, ``::build_idwt2d_sharded``); K27a
  ``swt2d_sharded_fused`` and K27b ``iswt2d_sharded_fused``
  (``csrc/swt2d.cu``), K8/K9's (``::build_swt2d_sharded``,
  ``::build_iswt2d_sharded``); float32 and float64;
* the one-axis passes of the grid and sequence layouts of
  ``parallel.spatial``, each on one shard with its exchanged halos: K29a
  ``ana_lanes_fused`` (``csrc/dwt1d.cu``) and K29b ``syn_lanes_fused``
  (``csrc/idwt1d.cu``), K3/K4's levels along the last axis
  (``::build_ana_padded_lanes``, ``::build_syn_padded_lanes``); K29c
  ``ana_rows_fused`` and K29d ``syn_rows_fused`` (``csrc/axis_rows.cu``),
  the same along axis -2 (``::build_ana_padded_rows``,
  ``::build_syn_padded_rows``); float32 and float64.

The non-separable stationary kernels K18a/K18b are in ``ops.nonsep``;
``ops.KERNELS`` lists all of them.  The 1D kernels take rows ``(R, n)`` or
one signal ``(n,)``, which they view as ``(1, n)``: that also covers the
TPU's folded long-signal kernels (``::dwt1d_long_fused`` and its kin),
whose folding only fixed the TPU's lane layout.  Beside each kernel:

* its plain PyTorch version (``*_plain``): the ``core.conv`` primitives
  composed for one level, exactly as the JAX package's ``core/dwt.py`` and
  ``core/swt.py`` fallbacks compose them;
* ``*_unsupported``, which says before launch, from dtype, rank, shape and
  bank, why the kernel cannot take a call (None if it can) -- the port's
  form of the JAX wrappers returning None.  Every kernel takes every
  float32 or float64 level its plain version takes: odd sizes (the
  reference's virtual extension, in the kernels' index), odd filter
  lengths, odd synthesis outputs, and any batch or row count (levels past
  a grid's limits go in several launches); only another dtype or rank,
  inputs of mixed dtypes, an empty or over-long (2^30 samples) axis and an
  over-long filter refuse;
* ``launches`` on the wrapper, its count of kernel launches (of either
  instance).

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor it
launches the kernel or raises.  A float32 level runs the float32 instance
with taps rounded once from the bank's float64 filters (as
``pallas_dwt._taps`` / ``conv._as_taps``); a float64 level runs the
float64 instance (the C entry points ``*_f64``) with the bank's float64
values as they are, as the reference's -DDOUBLEPRECISION build and the
plain versions do.  Taps go to the kernel by value, so a call copies
nothing to the device.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import conv
from ..core.shapes import div2
from ..filters import MAX_FILTER_WIDTH
from . import _build

_MAX_SAMPLES = 1 << 30  # samples per axis: int indices in the kernels
F32 = (torch.float32,)                  # the tensor-core forms, K19/K20
F32_F64 = (torch.float32, torch.float64)  # the tap-loop kernels


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


def _bank_unsupported(fb, lowest=1):
    """Why a decimating kernel cannot take bank ``fb``: analysis takes
    1..40 taps, synthesis (``lowest`` 2) 2..40; the plain synthesis has no
    polyphase tap below 2."""
    if not lowest <= fb.hlen <= MAX_FILTER_WIDTH:
        return f"filter length {fb.hlen} ({lowest}..{MAX_FILTER_WIDTH})"
    return None


def _sizes_unsupported(sizes, what):
    if min(sizes) < 1:
        return f"empty {what}"
    if max(sizes) >= _MAX_SAMPLES:
        return f"{what} sizes {tuple(sizes)} (each below {_MAX_SAMPLES})"
    return None


def _dtype_unsupported(t, what, dtypes):
    if t.dtype not in dtypes:
        names = " or ".join(str(d).split(".")[-1] for d in dtypes)
        return f"{what} dtype {t.dtype} ({names} only)"
    return None


def _plane_unsupported(t, what, dtypes=F32):
    why = _dtype_unsupported(t, what, dtypes)
    if why:
        return why
    if t.ndim not in (2, 3):
        return f"{what} rank {t.ndim} (2 or 3)"
    if t.numel() == 0:
        return f"empty {what}"
    return _sizes_unsupported(t.shape[-2:], what)


def _batch(t):
    return t.shape[0] if t.ndim == 3 else 1


def dwt2d_unsupported(x, fb):
    """Why K1 cannot take ``x`` with bank ``fb``, or None if it can."""
    return _plane_unsupported(x, "input", F32_F64) or _bank_unsupported(fb)


def subbands_unsupported(a, h, v, d, out_shape, dtypes=F32):
    """Why four subbands and an output shape cannot go to a 2D synthesis
    kernel (K2, K17, K20, K6) of ``dtypes``, or None."""
    why = _plane_unsupported(a, "coefficient", dtypes)
    if why:
        return why
    if not (a.shape == h.shape == v.shape == d.shape):
        return "subbands of different shapes"
    if not (a.dtype == h.dtype == v.dtype == d.dtype):
        return "subbands of different dtypes"
    if not (a.device == h.device == v.device == d.device):
        return "subbands on different devices"
    return _sizes_unsupported(tuple(out_shape[-2:]), "output")


def idwt2d_unsupported(a, h, v, d, fb, out_shape):
    """Why K2 cannot take these coefficients, or None if it can."""
    return (subbands_unsupported(a, h, v, d, out_shape, F32_F64)
            or _bank_unsupported(fb, 2))


_HOST_TAPS: dict = {}


def _host_taps(f, dtype=np.float32):
    """The taps of one float64 filter in ``dtype`` (float32: rounded once;
    float64: its values as they are), cached by value so that the pointer
    handed to the kernel stays alive."""
    f = np.asarray(f, dtype=np.float64)
    key = (f.tobytes(), np.dtype(dtype).str)
    t = _HOST_TAPS.get(key)
    if t is None:
        t = _HOST_TAPS[key] = np.ascontiguousarray(f.astype(dtype))
    return t


def _taps(f, like):
    """``_host_taps`` in the dtype of tensor ``like``."""
    return _host_taps(f, np.float64 if like.dtype == torch.float64
                      else np.float32)


def _entry(lib, name, like):
    """The C entry point of kernel ``name`` for ``like``'s dtype: the
    float64 instance is ``name + "_f64"``."""
    return getattr(lib, name + "_f64" if like.dtype == torch.float64
                   else name)


def _check_launch(lib, err, name):
    if err != 0:
        msg = lib.pypwt_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: cudaError {err} ({msg})")


def _require(cond, name, why):
    if not cond:
        raise ValueError(f"{name} does not take this input: {why}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_inputs(name, why, *ts):
    """Raise unless kernel ``name`` can take ``ts`` (CUDA, contiguous);
    ``why`` is its ``*_unsupported`` answer."""
    _require(ts[0].is_cuda, name, f"device {ts[0].device}")
    _require(why is None, name, why)
    _require(all(t.is_contiguous() for t in ts), name, "non-contiguous input")


def dwt2d_fused(x, fb):
    """K1: one separable analysis level -> (a, h, v, d), each
    (B?, div2(Nr), div2(Nc)).  CPU tensor: the plain version."""
    if x.device.type == "cpu":
        return dwt2d_plain(x, fb)
    _check_inputs("K1 (dwt2d)", dwt2d_unsupported(x, fb), x)
    lib = _build.load_library()
    nr, nc = x.shape[-2], x.shape[-1]
    shape = (*x.shape[:-2], div2(nr), div2(nc))
    a, h, v, d = (torch.empty(shape, dtype=x.dtype, device=x.device)
                  for _ in range(4))
    lo, hi = _taps(fb.dec_lo, x), _taps(fb.dec_hi, x)
    err = _entry(lib, "pypwt_dwt2d", x)(
        x.data_ptr(), a.data_ptr(), h.data_ptr(), v.data_ptr(), d.data_ptr(),
        _batch(x), nr, nc, lo.ctypes.data, hi.ctypes.data, fb.hlen,
        x.device.index, _stream(x))
    _check_launch(lib, err, "K1 (dwt2d)")
    dwt2d_fused.launches += 1
    return a, h, v, d


def idwt2d_fused(a, h, v, d, fb, out_shape):
    """K2: one separable synthesis level -> (B?, *out_shape[-2:]).  CPU
    tensors: the plain version."""
    if a.device.type == "cpu":
        return idwt2d_plain(a, h, v, d, fb, out_shape)
    _check_inputs("K2 (idwt2d)", idwt2d_unsupported(a, h, v, d, fb, out_shape),
                  a, h, v, d)
    lib = _build.load_library()
    nr, nc = out_shape[-2], out_shape[-1]
    out = torch.empty((*a.shape[:-2], nr, nc), dtype=a.dtype, device=a.device)
    lo, hi = _taps(fb.rec_lo, a), _taps(fb.rec_hi, a)
    err = _entry(lib, "pypwt_idwt2d", a)(
        a.data_ptr(), h.data_ptr(), v.data_ptr(), d.data_ptr(),
        out.data_ptr(), _batch(a), a.shape[-2], a.shape[-1], nr, nc,
        lo.ctypes.data, hi.ctypes.data, fb.hlen, a.device.index,
        _stream(a))
    _check_launch(lib, err, "K2 (idwt2d)")
    idwt2d_fused.launches += 1
    return out


# -- batched-1D levels: K3, K4, K10a, K10b --------------------------------


def dwt1d_plain(x, fb):
    """One analysis level along the last axis in torch ops -> (a, d)."""
    return conv.analysis_last(x, fb.dec_lo, fb.dec_hi)


def idwt1d_plain(a, d, fb, n_out):
    """One synthesis level along the last axis in torch ops -> n_out
    samples per row."""
    return conv.synthesis_last(a, d, fb.rec_lo, fb.rec_hi, n_out)


def swt1d_plain(x, fb, level):
    """One stationary analysis level along the last axis -> (a, d)."""
    return conv.swt_analysis_last(x, fb.dec_lo, fb.dec_hi, level)


def iswt1d_plain(a, d, fb, level):
    """One stationary synthesis level along the last axis."""
    return conv.swt_synthesis_last(a, d, fb.rec_lo, fb.rec_hi, level)


def _rows(t):
    return t.shape[0] if t.ndim == 2 else 1


def _rows_unsupported(t, what, dtypes=F32):
    """Why rows ``t`` (``(R, n)`` or ``(n,)``) cannot go to a 1D kernel of
    ``dtypes``, or None.  Rows past a grid's limit go in several
    launches."""
    why = _dtype_unsupported(t, what, dtypes)
    if why:
        return why
    if t.ndim not in (1, 2):
        return f"{what} rank {t.ndim} (1 or 2)"
    n = t.shape[-1]
    if n < 1 or _rows(t) < 1:
        return f"empty {what}"
    if n >= _MAX_SAMPLES:
        return f"{n} samples per row (below {_MAX_SAMPLES})"
    return None


def _pair_unsupported(a, d):
    if a.shape != d.shape:
        return "coefficients of different shapes"
    if a.dtype != d.dtype:
        return "coefficients of different dtypes"
    if a.device != d.device:
        return "coefficients on different devices"
    return None


def _level_unsupported(level):
    if level < 1:
        return f"level {level} (1 or more)"
    return None


def dwt1d_unsupported(x, fb):
    """Why K3 cannot take ``x`` with bank ``fb``, or None if it can."""
    return _rows_unsupported(x, "input", F32_F64) or _bank_unsupported(fb)


def idwt1d_unsupported(a, d, fb, n_out):
    """Why K4 cannot take these coefficients, or None if it can."""
    return (_rows_unsupported(a, "coefficient", F32_F64)
            or _pair_unsupported(a, d)
            or _bank_unsupported(fb, 2)
            or _sizes_unsupported((n_out,), "output"))


def swt1d_unsupported(x, fb, level):
    """Why K10a cannot take ``x`` at ``level``, or None if it can."""
    return (_rows_unsupported(x, "input", F32_F64) or _bank_unsupported(fb)
            or _level_unsupported(level))


def iswt1d_unsupported(a, d, fb, level):
    """Why K10b cannot take these coefficients, or None if it can."""
    return (_rows_unsupported(a, "coefficient", F32_F64)
            or _pair_unsupported(a, d) or _bank_unsupported(fb)
            or _level_unsupported(level))


def dwt1d_fused(x, fb):
    """K3: one batched-1D analysis level -> (a, d), each
    ``(R?, div2(n))``.
    CPU tensor: the plain version."""
    if x.device.type == "cpu":
        return dwt1d_plain(x, fb)
    _check_inputs("K3 (dwt1d)", dwt1d_unsupported(x, fb), x)
    lib = _build.load_library()
    n = x.shape[-1]
    shape = (*x.shape[:-1], div2(n))
    a, d = (torch.empty(shape, dtype=x.dtype, device=x.device)
            for _ in range(2))
    lo, hi = _taps(fb.dec_lo, x), _taps(fb.dec_hi, x)
    err = _entry(lib, "pypwt_dwt1d", x)(x.data_ptr(), a.data_ptr(), d.data_ptr(), _rows(x),
                          n, lo.ctypes.data, hi.ctypes.data, fb.hlen,
                          x.device.index, _stream(x))
    _check_launch(lib, err, "K3 (dwt1d)")
    dwt1d_fused.launches += 1
    return a, d


def idwt1d_fused(a, d, fb, n_out):
    """K4: one batched-1D synthesis level -> ``(R?, n_out)``.  CPU
    tensors: the plain version."""
    if a.device.type == "cpu":
        return idwt1d_plain(a, d, fb, n_out)
    _check_inputs("K4 (idwt1d)", idwt1d_unsupported(a, d, fb, n_out), a, d)
    lib = _build.load_library()
    out = torch.empty((*a.shape[:-1], n_out), dtype=a.dtype, device=a.device)
    lo, hi = _taps(fb.rec_lo, a), _taps(fb.rec_hi, a)
    err = _entry(lib, "pypwt_idwt1d", a)(a.data_ptr(), d.data_ptr(), out.data_ptr(),
                           _rows(a), a.shape[-1], n_out, lo.ctypes.data,
                           hi.ctypes.data, fb.hlen, a.device.index,
                           _stream(a))
    _check_launch(lib, err, "K4 (idwt1d)")
    idwt1d_fused.launches += 1
    return out


def swt1d_fused(x, fb, level):
    """K10a: one batched-1D stationary analysis level -> (a, d), each of
    the input's shape.  CPU tensor: the plain version."""
    if x.device.type == "cpu":
        return swt1d_plain(x, fb, level)
    _check_inputs("K10a (swt1d)", swt1d_unsupported(x, fb, level), x)
    lib = _build.load_library()
    a, d = torch.empty_like(x), torch.empty_like(x)
    lo, hi = _taps(fb.dec_lo, x), _taps(fb.dec_hi, x)
    err = _entry(lib, "pypwt_swt1d", x)(x.data_ptr(), a.data_ptr(), d.data_ptr(), _rows(x),
                          x.shape[-1], level, lo.ctypes.data, hi.ctypes.data,
                          fb.hlen, x.device.index, _stream(x))
    _check_launch(lib, err, "K10a (swt1d)")
    swt1d_fused.launches += 1
    return a, d


def iswt1d_fused(a, d, fb, level):
    """K10b: one batched-1D stationary synthesis level -> the
    coefficients' shape.  CPU tensors: the plain version."""
    if a.device.type == "cpu":
        return iswt1d_plain(a, d, fb, level)
    _check_inputs("K10b (iswt1d)", iswt1d_unsupported(a, d, fb, level), a, d)
    lib = _build.load_library()
    out = torch.empty_like(a)
    lo, hi = _taps(fb.rec_lo, a), _taps(fb.rec_hi, a)
    err = _entry(lib, "pypwt_iswt1d", a)(a.data_ptr(), d.data_ptr(), out.data_ptr(),
                           _rows(a), a.shape[-1], level, lo.ctypes.data,
                           hi.ctypes.data, fb.hlen, a.device.index,
                           _stream(a))
    _check_launch(lib, err, "K10b (iswt1d)")
    iswt1d_fused.launches += 1
    return out


# -- 2D stationary levels: K8, K9 ------------------------------------------


def swt2d_plain(x, fb, level):
    """One stationary 2D analysis level in torch ops -> (a, h, v, d), each
    of the input's shape: the last axis first, then axis -2, as the JAX
    fallback (h: high-pass along axis -2)."""
    t1, t2 = conv.swt_analysis_last(x, fb.dec_lo, fb.dec_hi, level)
    t1 = t1.transpose(-1, -2)
    t2 = t2.transpose(-1, -2)
    a, h = conv.swt_analysis_last(t1, fb.dec_lo, fb.dec_hi, level)
    v, d = conv.swt_analysis_last(t2, fb.dec_lo, fb.dec_hi, level)
    return tuple(s.transpose(-1, -2).contiguous() for s in (a, h, v, d))


def iswt2d_plain(a, h, v, d, fb, level):
    """One stationary 2D synthesis level in torch ops (axis -2 first, then
    the last axis; 1/2 per axis pass)."""
    at, ht, vt, dt = (s.transpose(-1, -2) for s in (a, h, v, d))
    t1 = conv.swt_synthesis_last(at, ht, fb.rec_lo, fb.rec_hi, level)
    t2 = conv.swt_synthesis_last(vt, dt, fb.rec_lo, fb.rec_hi, level)
    t1 = t1.transpose(-1, -2)
    t2 = t2.transpose(-1, -2)
    return conv.swt_synthesis_last(t1, t2, fb.rec_lo, fb.rec_hi,
                                   level).contiguous()


def swt2d_plane_unsupported(t, what, level):
    """Why a plane or stack ``t`` cannot go to a 2D stationary kernel (K8,
    K9, K18a, K18b) at ``level``, or None.  A level with more row blocks or
    planes than a grid holds is launched in chunks, so no batch, plane size
    or level meets a grid limit: only dtype (float32 or float64), rank, an
    empty input and the 32-bit sizes refuse."""
    return (_plane_unsupported(t, what, F32_F64)
            or _level_unsupported(level))


def swt2d_unsupported(x, fb, level):
    """Why K8 cannot take ``x`` at ``level``, or None if it can."""
    return (swt2d_plane_unsupported(x, "input", level)
            or _bank_unsupported(fb))


def iswt2d_unsupported(a, h, v, d, fb, level):
    """Why K9 cannot take these coefficients, or None if it can."""
    return (swt2d_plane_unsupported(a, "coefficient", level)
            or _pair_unsupported(a, h) or _pair_unsupported(a, v)
            or _pair_unsupported(a, d) or _bank_unsupported(fb))


def swt2d_fused(x, fb, level):
    """K8: one stationary 2D analysis level -> (a, h, v, d), each of the
    input's shape ``(B?, Nr, Nc)``.  CPU tensor: the plain version."""
    if x.device.type == "cpu":
        return swt2d_plain(x, fb, level)
    _check_inputs("K8 (swt2d)", swt2d_unsupported(x, fb, level), x)
    lib = _build.load_library()
    a, h, v, d = (torch.empty_like(x) for _ in range(4))
    lo, hi = _taps(fb.dec_lo, x), _taps(fb.dec_hi, x)
    err = _entry(lib, "pypwt_swt2d", x)(
        x.data_ptr(), a.data_ptr(), h.data_ptr(), v.data_ptr(), d.data_ptr(),
        _batch(x), x.shape[-2], x.shape[-1], level,
        conv.swt_centre(fb.hlen, False), lo.ctypes.data, hi.ctypes.data,
        fb.hlen, x.device.index, _stream(x))
    _check_launch(lib, err, "K8 (swt2d)")
    swt2d_fused.launches += 1
    return a, h, v, d


def iswt2d_fused(a, h, v, d, fb, level):
    """K9: one stationary 2D synthesis level -> the coefficients' shape.
    CPU tensors: the plain version."""
    if a.device.type == "cpu":
        return iswt2d_plain(a, h, v, d, fb, level)
    _check_inputs("K9 (iswt2d)", iswt2d_unsupported(a, h, v, d, fb, level),
                  a, h, v, d)
    lib = _build.load_library()
    out = torch.empty_like(a)
    lo, hi = _taps(fb.rec_lo, a), _taps(fb.rec_hi, a)
    err = _entry(lib, "pypwt_iswt2d", a)(
        a.data_ptr(), h.data_ptr(), v.data_ptr(), d.data_ptr(),
        out.data_ptr(), _batch(a), a.shape[-2], a.shape[-1], level,
        conv.swt_centre(fb.hlen, True), lo.ctypes.data, hi.ctypes.data,
        fb.hlen, a.device.index, _stream(a))
    _check_launch(lib, err, "K9 (iswt2d)")
    iswt2d_fused.launches += 1
    return out


# -- row-sharded levels: K26a/K26b, K27a/K27b ------------------------------
#
# One row shard (B?, nr, nc) of a larger plane whose rows are split over a
# ring of shards (``parallel.spatial``): the rows above and below the shard
# come as halo tensors that its neighbours sent, of the exact heights of the
# level's pads (``conv.analysis_pads``, ``conv.synthesis_pads`` with n_out =
# 2L, ``conv.swt_pads``), where JAX's kernels took bands rounded up to 8
# rows (``pallas_dwt._pick_bands``).  The row axis is not wrapped; the
# column axis stays periodic.  A synthesis level takes JAX's 8-tuple of
# halos ``(a_t, a_b, h_t, h_b, v_t, v_b, d_t, d_b)``.


def _extend_rows(top, x, bot):
    """The shard's rows with its halos above and below, on axis -2."""
    return torch.cat([top, x, bot], dim=-2)


def _rows_last(x):
    return x.transpose(-1, -2)


def dwt2d_sharded_plain(x, top, bot, fb):
    """K26a's map in torch ops: the last axis periodically
    (``conv.analysis_last``) on the shard and its halo rows, then axis -2
    unwrapped on the halo-extended rows (``conv.analysis_core``) -> (a, h,
    v, d), each (B?, nr/2, div2(nc))."""
    t1, t2 = conv.analysis_last(_extend_rows(top, x, bot), fb.dec_lo,
                                fb.dec_hi)
    L = x.shape[-2] // 2
    a, h = conv.analysis_core(_rows_last(t1), fb.dec_lo, fb.dec_hi, L)
    v, d = conv.analysis_core(_rows_last(t2), fb.dec_lo, fb.dec_hi, L)
    return tuple(_rows_last(s).contiguous() for s in (a, h, v, d))


def idwt2d_sharded_plain(a, h, v, d, halos, fb):
    """K26b's map in torch ops: along axis -2 on each plane's
    halo-extended rows (``conv.synthesis_core``) t1 = syn(a, h), t2 =
    syn(v, d), then the last axis periodically -> (B?, 2Lr, 2Lc)."""
    L = a.shape[-2]
    lp = conv.synthesis_pads(fb.hlen, L, 2 * L)[0]
    ext = [_rows_last(_extend_rows(halos[2 * i], p, halos[2 * i + 1]))
           for i, p in enumerate((a, h, v, d))]
    t1, t2 = (_rows_last(conv.synthesis_core(lo, hi, fb.rec_lo, fb.rec_hi,
                                             2 * L, L, lp))
              for lo, hi in ((ext[0], ext[1]), (ext[2], ext[3])))
    return conv.synthesis_last(t1, t2, fb.rec_lo, fb.rec_hi,
                               2 * a.shape[-1]).contiguous()


def swt2d_sharded_plain(x, top, bot, fb, level):
    """K27a's map in torch ops: the last axis periodically
    (``conv.swt_analysis_last``) on the shard and its halo rows, then axis
    -2 on the halo-extended rows (``conv.swt_analysis_core``) -> (a, h, v,
    d), each of the shard's shape."""
    t1, t2 = conv.swt_analysis_last(_extend_rows(top, x, bot), fb.dec_lo,
                                    fb.dec_hi, level)
    n = x.shape[-2]
    a, h = conv.swt_analysis_core(_rows_last(t1), fb.dec_lo, fb.dec_hi,
                                  level, n)
    v, d = conv.swt_analysis_core(_rows_last(t2), fb.dec_lo, fb.dec_hi,
                                  level, n)
    return tuple(_rows_last(s).contiguous() for s in (a, h, v, d))


def iswt2d_sharded_plain(a, h, v, d, halos, fb, level):
    """K27b's map in torch ops: along axis -2 on the halo-extended rows
    (``conv.swt_synthesis_core``) t1 = syn(a, h), t2 = syn(v, d), then the
    last axis periodically, 1/2 per pass."""
    n = a.shape[-2]
    ext = [_rows_last(_extend_rows(halos[2 * i], p, halos[2 * i + 1]))
           for i, p in enumerate((a, h, v, d))]
    t1, t2 = (_rows_last(conv.swt_synthesis_core(lo, hi, fb.rec_lo,
                                                 fb.rec_hi, level, n))
              for lo, hi in ((ext[0], ext[1]), (ext[2], ext[3])))
    return conv.swt_synthesis_last(t1, t2, fb.rec_lo, fb.rec_hi,
                                   level).contiguous()


def halo_heights(kind, fb, rows, level=1):
    """(top, bottom) halo rows of a row-sharded level of ``kind`` ("dwt",
    "idwt", "swt", "iswt") on shards of ``rows`` rows (coefficient rows for
    "idwt")."""
    if kind == "dwt":
        return conv.analysis_pads(fb.hlen)
    if kind == "idwt":
        return conv.synthesis_pads(fb.hlen, rows, 2 * rows)
    return conv.swt_pads(fb.hlen, level, kind == "iswt")


def halos_unsupported(x, tops_bots, heights):
    """Why halo tensors ``tops_bots`` (top, bottom, top, bottom, ... one
    pair per plane) cannot go with shard ``x``: each of (B?, height, nc) of
    x's dtype and device, ``heights`` = (top, bottom); or None."""
    for i, t in enumerate(tops_bots):
        want = (*x.shape[:-2], heights[i % 2], x.shape[-1])
        side = "bottom" if i % 2 else "top"
        if tuple(t.shape) != want:
            return f"{side} halo of shape {tuple(t.shape)} (want {want})"
        if t.dtype != x.dtype or t.device != x.device:
            return f"{side} halo of {t.dtype} on {t.device}"
    return None


def _even_rows_unsupported(x):
    if x.shape[-2] % 2:
        return f"{x.shape[-2]} shard rows (an even count only)"
    return None


def dwt2d_sharded_unsupported(x, top, bot, fb):
    """Why K26a cannot take shard ``x`` and its halos, or None if it
    can."""
    return (dwt2d_unsupported(x, fb) or _even_rows_unsupported(x)
            or halos_unsupported(x, (top, bot), halo_heights("dwt", fb, 0)))


def idwt2d_sharded_unsupported(a, h, v, d, halos, fb):
    """Why K26b cannot take these coefficient planes and halos, or None."""
    out = (2 * a.shape[-2], 2 * a.shape[-1])
    return (idwt2d_unsupported(a, h, v, d, fb, out)
            or (len(halos) != 8 and f"{len(halos)} halos (8)")
            or halos_unsupported(a, halos,
                                 halo_heights("idwt", fb, a.shape[-2])))


def swt2d_sharded_unsupported(x, top, bot, fb, level):
    """Why K27a cannot take shard ``x`` and its halos at ``level``."""
    return (swt2d_unsupported(x, fb, level)
            or halos_unsupported(x, (top, bot),
                                 halo_heights("swt", fb, 0, level)))


def iswt2d_sharded_unsupported(a, h, v, d, halos, fb, level):
    """Why K27b cannot take these coefficient planes and halos."""
    return (iswt2d_unsupported(a, h, v, d, fb, level)
            or (len(halos) != 8 and f"{len(halos)} halos (8)")
            or halos_unsupported(a, halos,
                                 halo_heights("iswt", fb, 0, level)))


def halo_array(halos):
    """The halo pointers (eight of a 2D synthesis, four of a one-axis one)
    as a C array (kept alive by the caller during the call)."""
    return (ctypes.c_void_p * len(halos))(*(t.data_ptr() for t in halos))


def dwt2d_sharded_fused(x, top, bot, fb):
    """K26a: one analysis level of a row shard -> (a, h, v, d), each
    (B?, nr/2, div2(nc)).  CPU tensors: the plain version."""
    if x.device.type == "cpu":
        return dwt2d_sharded_plain(x, top, bot, fb)
    name = "K26a (dwt2d_sharded)"
    _check_inputs(name, dwt2d_sharded_unsupported(x, top, bot, fb), x, top,
                  bot)
    lib = _build.load_library()
    nr, nc = x.shape[-2], x.shape[-1]
    a, h, v, d = (torch.empty((*x.shape[:-2], nr // 2, div2(nc)),
                              dtype=x.dtype, device=x.device)
                  for _ in range(4))
    lo, hi = _taps(fb.dec_lo, x), _taps(fb.dec_hi, x)
    err = _entry(lib, "pypwt_dwt2d_sharded", x)(
        x.data_ptr(), top.data_ptr(), bot.data_ptr(), a.data_ptr(),
        h.data_ptr(), v.data_ptr(), d.data_ptr(), _batch(x), nr, nc,
        top.shape[-2], bot.shape[-2], lo.ctypes.data, hi.ctypes.data,
        fb.hlen, x.device.index, _stream(x))
    _check_launch(lib, err, name)
    dwt2d_sharded_fused.launches += 1
    return a, h, v, d


def idwt2d_sharded_fused(a, h, v, d, halos, fb):
    """K26b: one synthesis level of a row shard's coefficient planes and
    their eight halos -> (B?, 2Lr, 2Lc).  CPU tensors: the plain version."""
    if a.device.type == "cpu":
        return idwt2d_sharded_plain(a, h, v, d, halos, fb)
    name = "K26b (idwt2d_sharded)"
    _check_inputs(name, idwt2d_sharded_unsupported(a, h, v, d, halos, fb),
                  a, h, v, d, *halos)
    lib = _build.load_library()
    lr, lc = a.shape[-2], a.shape[-1]
    out = torch.empty((*a.shape[:-2], 2 * lr, 2 * lc), dtype=a.dtype,
                      device=a.device)
    lo, hi = _taps(fb.rec_lo, a), _taps(fb.rec_hi, a)
    ptrs = halo_array(halos)
    err = _entry(lib, "pypwt_idwt2d_sharded", a)(
        a.data_ptr(), h.data_ptr(), v.data_ptr(), d.data_ptr(),
        ctypes.addressof(ptrs), out.data_ptr(), _batch(a), lr, lc,
        halos[0].shape[-2], halos[1].shape[-2], lo.ctypes.data,
        hi.ctypes.data, fb.hlen, a.device.index, _stream(a))
    _check_launch(lib, err, name)
    idwt2d_sharded_fused.launches += 1
    return out


def swt2d_sharded_fused(x, top, bot, fb, level):
    """K27a: one stationary analysis level of a row shard -> (a, h, v, d),
    each of the shard's shape.  CPU tensors: the plain version."""
    if x.device.type == "cpu":
        return swt2d_sharded_plain(x, top, bot, fb, level)
    name = "K27a (swt2d_sharded)"
    _check_inputs(name, swt2d_sharded_unsupported(x, top, bot, fb, level),
                  x, top, bot)
    lib = _build.load_library()
    a, h, v, d = (torch.empty_like(x) for _ in range(4))
    lo, hi = _taps(fb.dec_lo, x), _taps(fb.dec_hi, x)
    err = _entry(lib, "pypwt_swt2d_sharded", x)(
        x.data_ptr(), top.data_ptr(), bot.data_ptr(), a.data_ptr(),
        h.data_ptr(), v.data_ptr(), d.data_ptr(), _batch(x), x.shape[-2],
        x.shape[-1], level, conv.swt_centre(fb.hlen, False), top.shape[-2],
        bot.shape[-2], lo.ctypes.data, hi.ctypes.data, fb.hlen,
        x.device.index, _stream(x))
    _check_launch(lib, err, name)
    swt2d_sharded_fused.launches += 1
    return a, h, v, d


def iswt2d_sharded_fused(a, h, v, d, halos, fb, level):
    """K27b: one stationary synthesis level of a row shard's planes and
    their eight halos -> the planes' shape.  CPU tensors: the plain
    version."""
    if a.device.type == "cpu":
        return iswt2d_sharded_plain(a, h, v, d, halos, fb, level)
    name = "K27b (iswt2d_sharded)"
    _check_inputs(name,
                  iswt2d_sharded_unsupported(a, h, v, d, halos, fb, level),
                  a, h, v, d, *halos)
    lib = _build.load_library()
    out = torch.empty_like(a)
    lo, hi = _taps(fb.rec_lo, a), _taps(fb.rec_hi, a)
    ptrs = halo_array(halos)
    err = _entry(lib, "pypwt_iswt2d_sharded", a)(
        a.data_ptr(), h.data_ptr(), v.data_ptr(), d.data_ptr(),
        ctypes.addressof(ptrs), out.data_ptr(), _batch(a), a.shape[-2],
        a.shape[-1], level, conv.swt_centre(fb.hlen, True),
        halos[0].shape[-2], halos[1].shape[-2], lo.ctypes.data,
        hi.ctypes.data, fb.hlen, a.device.index, _stream(a))
    _check_launch(lib, err, name)
    iswt2d_sharded_fused.launches += 1
    return out

# -- one-axis passes of a grid or signal shard: K29a-K29d -------------------
#
# One shard of a plane split over both axes (the grid layout) or of rows
# split along their samples (the sequence layout: a signal ``(n,)``, or
# JAX's leading batch ``(B, n)``), and one decimating pass along its last
# axis (the lanes: K29a/K29b) or along axis -2 (the rows: K29c/K29d).  The
# samples a filter reaches past the shard's edges come as halo tensors that
# its ring neighbours sent, of exactly the pass's pads
# (``conv.analysis_pads``; ``conv.synthesis_pads`` with n_out = 2L), where
# JAX folded a long signal into per-row windows (``_fold_padded``) and
# padded the shard; both were TPU layout choices.  An analysis takes the
# halos (before, after); a synthesis JAX's 4-tuple (lo_before, lo_after,
# hi_before, hi_after).  The ring itself stays periodic: a halo wraps.


def _extend(before, x, after, axis):
    """The shard with its halos before and after it along ``axis``."""
    return torch.cat([before, x, after], dim=axis)


def ana_lanes_plain(x, left, right, fb):
    """K29a's map: ``conv.analysis_core`` on the halo-extended rows ->
    (lo, hi), each (R?, n/2)."""
    return conv.analysis_core(_extend(left, x, right, -1), fb.dec_lo,
                              fb.dec_hi, x.shape[-1] // 2)


def syn_lanes_plain(a, d, halos, fb):
    """K29b's map: ``conv.synthesis_core`` on the halo-extended coefficient
    rows -> (R?, 2L)."""
    L = a.shape[-1]
    lp = conv.synthesis_pads(fb.hlen, L, 2 * L)[0]
    return conv.synthesis_core(_extend(halos[0], a, halos[1], -1),
                               _extend(halos[2], d, halos[3], -1), fb.rec_lo,
                               fb.rec_hi, 2 * L, L, lp)


def ana_rows_plain(x, top, bot, fb):
    """K29c's map: ``conv.analysis_core`` along axis -2 on the
    halo-extended rows -> (lo, hi), each (nr/2, nc)."""
    lo, hi = conv.analysis_core(_rows_last(_extend(top, x, bot, -2)),
                                fb.dec_lo, fb.dec_hi, x.shape[-2] // 2)
    return _rows_last(lo).contiguous(), _rows_last(hi).contiguous()


def syn_rows_plain(a, d, halos, fb):
    """K29d's map: ``conv.synthesis_core`` along axis -2 on the
    halo-extended coefficient rows -> (2L, nc)."""
    L = a.shape[-2]
    lp = conv.synthesis_pads(fb.hlen, L, 2 * L)[0]
    out = conv.synthesis_core(_rows_last(_extend(halos[0], a, halos[1], -2)),
                              _rows_last(_extend(halos[2], d, halos[3], -2)),
                              fb.rec_lo, fb.rec_hi, 2 * L, L, lp)
    return _rows_last(out).contiguous()


def one_axis_pads(kind, fb, n):
    """(before, after) halo widths of a one-axis pass of ``kind`` ("ana",
    "syn") on shards of ``n`` samples (coefficients for "syn") along the
    pass's axis."""
    if kind == "ana":
        return conv.analysis_pads(fb.hlen)
    return conv.synthesis_pads(fb.hlen, n, 2 * n)


def lane_halos_unsupported(x, halos, widths):
    """Why halo tensors ``halos`` (before, after, before, after, ... one
    pair per plane) cannot go with the rows ``x``: each of (R?, width) of
    x's dtype and device, ``widths`` = (before, after); or None."""
    for i, t in enumerate(halos):
        want = (*x.shape[:-1], widths[i % 2])
        side = "after" if i % 2 else "before"
        if tuple(t.shape) != want:
            return f"halo {side} of shape {tuple(t.shape)} (want {want})"
        if t.dtype != x.dtype or t.device != x.device:
            return f"halo {side} of {t.dtype} on {t.device}"
    return None


def _even_samples_unsupported(x):
    if x.shape[-1] % 2:
        return f"{x.shape[-1]} samples per row (an even count only)"
    return None


def _halo_count_unsupported(halos, count):
    if len(halos) != count:
        return f"{len(halos)} halos ({count})"
    return None


def shard_plane_unsupported(t, what, dtypes=F32_F64):
    """Why ``t`` cannot go to a row pass of a grid shard: a plane (nr, nc)
    of ``dtypes``; or None."""
    if t.ndim != 2:
        return f"{what} rank {t.ndim} (2)"
    return _plane_unsupported(t, what, dtypes)


def ana_lanes_unsupported(x, left, right, fb):
    """Why K29a cannot take the rows ``x`` and their halos, or None."""
    return (dwt1d_unsupported(x, fb) or _even_samples_unsupported(x)
            or lane_halos_unsupported(x, (left, right),
                                      one_axis_pads("ana", fb, 0)))


def syn_lanes_unsupported(a, d, halos, fb):
    """Why K29b cannot take the coefficient rows and their four halos."""
    L = a.shape[-1]
    return (idwt1d_unsupported(a, d, fb, 2 * L)
            or _halo_count_unsupported(halos, 4)
            or lane_halos_unsupported(a, halos, one_axis_pads("syn", fb, L)))


def ana_rows_unsupported(x, top, bot, fb):
    """Why K29c cannot take the shard ``x`` and its halo rows, or None."""
    return (shard_plane_unsupported(x, "input") or _bank_unsupported(fb)
            or _even_rows_unsupported(x)
            or halos_unsupported(x, (top, bot), one_axis_pads("ana", fb, 0)))


def syn_rows_unsupported(a, d, halos, fb):
    """Why K29d cannot take the coefficient planes and their four halos."""
    L = a.shape[-2]
    return (shard_plane_unsupported(a, "coefficient")
            or _pair_unsupported(a, d) or _bank_unsupported(fb, 2)
            or _sizes_unsupported((2 * L,), "output")
            or _halo_count_unsupported(halos, 4)
            or halos_unsupported(a, halos, one_axis_pads("syn", fb, L)))


def ana_lanes_fused(x, left, right, fb):
    """K29a: one analysis level along the last axis of rows ``(R?, n)``
    whose samples before and after come from ``left`` and ``right`` -> (lo,
    hi), each ``(R?, n/2)``.  CPU tensors: the plain version."""
    if x.device.type == "cpu":
        return ana_lanes_plain(x, left, right, fb)
    name = "K29a (ana_lanes)"
    _check_inputs(name, ana_lanes_unsupported(x, left, right, fb), x, left,
                  right)
    lib = _build.load_library()
    n = x.shape[-1]
    lo, hi = (torch.empty((*x.shape[:-1], n // 2), dtype=x.dtype,
                          device=x.device) for _ in range(2))
    flo, fhi = _taps(fb.dec_lo, x), _taps(fb.dec_hi, x)
    err = _entry(lib, "pypwt_ana_lanes", x)(
        x.data_ptr(), left.data_ptr(), right.data_ptr(), lo.data_ptr(),
        hi.data_ptr(), _rows(x), n, left.shape[-1], right.shape[-1],
        flo.ctypes.data, fhi.ctypes.data, fb.hlen, x.device.index,
        _stream(x))
    _check_launch(lib, err, name)
    ana_lanes_fused.launches += 1
    return lo, hi


def syn_lanes_fused(a, d, halos, fb):
    """K29b: one synthesis level along the last axis of coefficient rows
    ``(R?, L)`` and their four halos -> ``(R?, 2L)``.  CPU tensors: the
    plain version."""
    if a.device.type == "cpu":
        return syn_lanes_plain(a, d, halos, fb)
    name = "K29b (syn_lanes)"
    _check_inputs(name, syn_lanes_unsupported(a, d, halos, fb), a, d, *halos)
    lib = _build.load_library()
    L = a.shape[-1]
    out = torch.empty((*a.shape[:-1], 2 * L), dtype=a.dtype, device=a.device)
    flo, fhi = _taps(fb.rec_lo, a), _taps(fb.rec_hi, a)
    ptrs = halo_array(halos)
    err = _entry(lib, "pypwt_syn_lanes", a)(
        a.data_ptr(), d.data_ptr(), ctypes.addressof(ptrs), out.data_ptr(),
        _rows(a), L, halos[0].shape[-1], halos[1].shape[-1],
        flo.ctypes.data, fhi.ctypes.data, fb.hlen, a.device.index,
        _stream(a))
    _check_launch(lib, err, name)
    syn_lanes_fused.launches += 1
    return out


def ana_rows_fused(x, top, bot, fb):
    """K29c: one analysis level along axis -2 of a grid shard ``(nr, nc)``
    and its halo rows -> (lo, hi), each ``(nr/2, nc)``.  CPU tensors: the
    plain version."""
    if x.device.type == "cpu":
        return ana_rows_plain(x, top, bot, fb)
    name = "K29c (ana_rows)"
    _check_inputs(name, ana_rows_unsupported(x, top, bot, fb), x, top, bot)
    lib = _build.load_library()
    nr, nc = x.shape
    lo, hi = (torch.empty((nr // 2, nc), dtype=x.dtype, device=x.device)
              for _ in range(2))
    flo, fhi = _taps(fb.dec_lo, x), _taps(fb.dec_hi, x)
    err = _entry(lib, "pypwt_ana_rows", x)(
        x.data_ptr(), top.data_ptr(), bot.data_ptr(), lo.data_ptr(),
        hi.data_ptr(), nr, nc, top.shape[-2], bot.shape[-2],
        flo.ctypes.data, fhi.ctypes.data, fb.hlen, x.device.index,
        _stream(x))
    _check_launch(lib, err, name)
    ana_rows_fused.launches += 1
    return lo, hi


def syn_rows_fused(a, d, halos, fb):
    """K29d: one synthesis level along axis -2 of a grid shard's coefficient
    planes ``(L, nc)`` and their four halos -> ``(2L, nc)``.  CPU tensors:
    the plain version."""
    if a.device.type == "cpu":
        return syn_rows_plain(a, d, halos, fb)
    name = "K29d (syn_rows)"
    _check_inputs(name, syn_rows_unsupported(a, d, halos, fb), a, d, *halos)
    lib = _build.load_library()
    L, nc = a.shape
    out = torch.empty((2 * L, nc), dtype=a.dtype, device=a.device)
    flo, fhi = _taps(fb.rec_lo, a), _taps(fb.rec_hi, a)
    ptrs = halo_array(halos)
    err = _entry(lib, "pypwt_syn_rows", a)(
        a.data_ptr(), d.data_ptr(), ctypes.addressof(ptrs), out.data_ptr(),
        L, nc, halos[0].shape[-2], halos[1].shape[-2], flo.ctypes.data,
        fhi.ctypes.data, fb.hlen, a.device.index, _stream(a))
    _check_launch(lib, err, name)
    syn_rows_fused.launches += 1
    return out


KERNELS = (dwt2d_fused, idwt2d_fused, dwt1d_fused, idwt1d_fused,
           swt1d_fused, iswt1d_fused, swt2d_fused, iswt2d_fused,
           dwt2d_sharded_fused, idwt2d_sharded_fused, swt2d_sharded_fused,
           iswt2d_sharded_fused, ana_lanes_fused, syn_lanes_fused,
           ana_rows_fused, syn_rows_fused)

# counts start at 0; ``ops.reset_counts`` zeroes them with the others
for _k in KERNELS:
    _k.launches = 0
