"""The whole-pyramid 2D DWT kernels: every level of an analysis or a
synthesis pyramid in one launch (the port of
``pypwt_tpu/ops/fused_pyramid.py``).

* K24 ``wavedec2_pyramid_fused`` (``csrc/pyramid2d.cu``): all L analysis
  levels of a float32 plane ``(Nr, Nc)`` or stack ``(B, Nr, Nc)`` ->
  ``[a_L, (h, v, d) of level 1 (finest), ..., of level L (deepest)]``, K1's
  map applied L times.  It replaces ``::wavedec2_pyramid``
  (``_build_wavedec2``).
* K25 ``waverec2_pyramid_fused``: all L synthesis levels, K2's map applied
  L times, deepest first.  It replaces ``::waverec2_pyramid``
  (``_build_waverec2``).

The coverage is JAX's and nothing narrower: float32, one plane or a stack,
an even bank, L >= 2 and 2^L dividing both sizes (``fused_pyramid.py:136-
139``, ``:190-195``, ``:332-345``); a synthesis also needs every subband
of the shape its level gives.  JAX's band picks (``_pick_band``, the
``ib >> levels >= 8`` rule, the per-level halo blocks) lay out its TPU
bands and are not carried over: within the coverage the kernels take
every bank of up to 40 taps and every depth, and decline nothing.

``wavedec2_pyramid`` and ``waverec2_pyramid`` are the public entries: None
where the coverage functions give a reason (the caller then runs level by
level, as JAX's callers do), else their wrapper's result.  Beside each
kernel: its plain version (the level loop over ``fused_dwt.dwt2d_plain``
or ``idwt2d_plain``), its ``*_unsupported`` coverage function and the
``launches`` count on its wrapper.  A wrapper given a CPU tensor runs the
plain version; given a CUDA tensor it launches its kernel once or raises.
It allocates the outputs and one scratch for the intermediate
approximations, a region per level.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.shapes import div2
from ..filters import MAX_FILTER_WIDTH
from . import _build
from .fused_dwt import (_batch, _check_inputs, _check_launch, _host_taps,
                        _plane_unsupported, _stream, dwt2d_plain,
                        idwt2d_plain)

# csrc/pyramid2d.cu's kMaxLevels: a 17th level needs planes of 2^34
# samples
MAX_LEVELS = 16


def wavedec2_pyramid_plain(x, fb, levels):
    """K24's map in torch ops: the analysis level, ``levels`` times."""
    a = x
    details = []
    for _ in range(levels):
        a, h, v, d = dwt2d_plain(a, fb)
        details.append((h, v, d))
    return [a] + details


def waverec2_pyramid_plain(coeffs, fb, out_shape):
    """K25's map in torch ops: the synthesis level, deepest first, each to
    the size of the level above (``out_shape`` at the top)."""
    levels = len(coeffs) - 1
    sizes = [tuple(out_shape[-2:])]
    for _ in range(levels):
        sizes.append((div2(sizes[-1][0]), div2(sizes[-1][1])))
    a = coeffs[0]
    for lev in range(levels, 0, -1):
        a = idwt2d_plain(a, *coeffs[lev], fb, sizes[lev - 1])
    return a


def _pyramid_unsupported(t, fb, levels, what):
    why = _plane_unsupported(t, what)
    if why:
        return why
    if fb.hlen % 2 or not 2 <= fb.hlen <= MAX_FILTER_WIDTH:
        return f"filter length {fb.hlen} (even, 2..{MAX_FILTER_WIDTH})"
    if not 2 <= levels <= MAX_LEVELS:
        return f"{levels} levels (2..{MAX_LEVELS})"
    return None


def _indivisible(sizes, levels):
    if any(n % (1 << levels) for n in sizes):
        return f"sizes {tuple(sizes)} not divisible by 2^{levels}"
    return None


def wavedec2_pyramid_unsupported(x, fb, levels):
    """Why K24 cannot take the ``levels``-level pyramid of ``x``, or None
    if it can."""
    return (_pyramid_unsupported(x, fb, levels, "input")
            or _indivisible(x.shape[-2:], levels))


def waverec2_pyramid_unsupported(coeffs, fb, out_shape):
    """Why K25 cannot take pyramid ``coeffs`` to ``out_shape``, or None if
    it can."""
    levels = len(coeffs) - 1
    a = coeffs[0]
    nr, nc = out_shape[-2], out_shape[-1]
    why = (_pyramid_unsupported(a, fb, levels, "coefficient")
           or _indivisible((nr, nc), levels))
    if why:
        return why
    top = (nr >> levels, nc >> levels)
    if tuple(a.shape[-2:]) != top:
        return (f"approximation {tuple(a.shape[-2:])} (the output "
                f"{(nr, nc)} needs {top})")
    for lev, trip in enumerate(coeffs[1:], 1):
        want = (*a.shape[:-2], nr >> lev, nc >> lev)
        if len(trip) != 3:
            return f"level {lev} holds {len(trip)} subbands, not 3"
        for s in trip:
            if tuple(s.shape) != want:
                return (f"level {lev} subband {tuple(s.shape)} (the output "
                        f"{(nr, nc)} needs {want})")
            if s.dtype != a.dtype or s.device != a.device:
                return "subbands of different dtypes or devices"
    return None


def contiguous(coeffs):
    """A pyramid ``[a, (h, v, d), ...]`` with every tensor contiguous."""
    return [coeffs[0].contiguous()] + [tuple(s.contiguous() for s in c)
                                       for c in coeffs[1:]]


def wavedec2_pyramid(x, fb, levels):
    """Every analysis level of ``x`` in one launch -> ``[a_L, (h, v, d) of
    level 1, ..., of level L]``; None if K24 does not cover the call (the
    caller runs level by level)."""
    if wavedec2_pyramid_unsupported(x, fb, levels):
        return None
    return wavedec2_pyramid_fused(x.contiguous(), fb, levels)


def waverec2_pyramid(coeffs, fb, out_shape):
    """Every synthesis level of pyramid ``coeffs`` in one launch -> the
    image of ``out_shape`` (its last two sizes); None if K25 does not cover
    the call."""
    if waverec2_pyramid_unsupported(coeffs, fb, out_shape):
        return None
    return waverec2_pyramid_fused(contiguous(coeffs), fb, out_shape)


def _levels_of(batch, nr, nc, levels, like):
    """Planes of (*batch, nr >> l, nc >> l) for l = 1 .. levels - 1, views
    of one scratch tensor."""
    shapes = [(*batch, nr >> lev, nc >> lev) for lev in range(1, levels)]
    sizes = [torch.Size(s).numel() for s in shapes]
    scratch = torch.empty(sum(sizes), dtype=like.dtype, device=like.device)
    return [p.view(s) for p, s in zip(scratch.split(sizes), shapes)]


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def wavedec2_pyramid_fused(x, fb, levels):
    """K24: every analysis level of ``x`` -> ``[a_L, (h, v, d) of level 1,
    ..., of level L]``, level l of ``(B?, Nr >> l, Nc >> l)``.  CPU tensor:
    the plain version."""
    if x.device.type == "cpu":
        return wavedec2_pyramid_plain(x, fb, levels)
    _check_inputs("K24 (wavedec2_pyramid)",
                  wavedec2_pyramid_unsupported(x, fb, levels), x)
    lib = _build.load_library()
    batch, (nr, nc) = x.shape[:-2], x.shape[-2:]
    approx = _levels_of(batch, nr, nc, levels, x) + [
        torch.empty((*batch, nr >> levels, nc >> levels), dtype=x.dtype,
                    device=x.device)]
    details = [tuple(torch.empty((*batch, nr >> lev, nc >> lev),
                                 dtype=x.dtype, device=x.device)
                     for _ in range(3)) for lev in range(1, levels + 1)]
    lo, hi = _host_taps(fb.dec_lo), _host_taps(fb.dec_hi)
    a_ptrs = _pointers(approx)
    d_ptrs = _pointers([s for trip in details for s in trip])
    err = lib.pypwt_wavedec2_pyramid(
        x.data_ptr(), ctypes.addressof(a_ptrs), ctypes.addressof(d_ptrs),
        _batch(x), nr, nc, levels, lo.ctypes.data, hi.ctypes.data, fb.hlen,
        x.device.index, _stream(x))
    _check_launch(lib, err, "K24 (wavedec2_pyramid)")
    wavedec2_pyramid_fused.launches += 1
    return [approx[-1]] + details


def waverec2_pyramid_fused(coeffs, fb, out_shape):
    """K25: every synthesis level of pyramid ``coeffs`` -> the image
    ``(B?, *out_shape[-2:])``.  CPU tensors: the plain version."""
    a = coeffs[0]
    if a.device.type == "cpu":
        return waverec2_pyramid_plain(coeffs, fb, out_shape)
    details = [s for trip in coeffs[1:] for s in trip]
    _check_inputs("K25 (waverec2_pyramid)",
                  waverec2_pyramid_unsupported(coeffs, fb, out_shape), a,
                  *details)
    lib = _build.load_library()
    levels = len(coeffs) - 1
    batch, (nr, nc) = a.shape[:-2], (out_shape[-2], out_shape[-1])
    out = torch.empty((*batch, nr, nc), dtype=a.dtype, device=a.device)
    lo, hi = _host_taps(fb.rec_lo), _host_taps(fb.rec_hi)
    approx = _levels_of(batch, nr, nc, levels, a) + [a]
    a_ptrs = _pointers(approx)
    d_ptrs = _pointers(details)
    err = lib.pypwt_waverec2_pyramid(
        out.data_ptr(), ctypes.addressof(a_ptrs), ctypes.addressof(d_ptrs),
        _batch(a), nr, nc, levels, lo.ctypes.data, hi.ctypes.data, fb.hlen,
        a.device.index, _stream(a))
    _check_launch(lib, err, "K25 (waverec2_pyramid)")
    waverec2_pyramid_fused.launches += 1
    return out


KERNELS = (wavedec2_pyramid_fused, waverec2_pyramid_fused)

for _k in KERNELS:
    _k.launches = 0
