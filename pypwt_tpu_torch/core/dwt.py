"""Multi-level separable DWT (1D, batched-1D, 2D), forward and inverse
(the port of ``pypwt_tpu.core.dwt``).

The coefficient pyramid is a plain list of tensors on the input's device,
the same layout as the JAX package: 2D ``[A, (H1, V1, D1), ..., (Hn, Vn,
Dn)]``, 1D ``[A, D1, ..., Dn]``.  Axis convention (matches the
reference): the last axis is filtered by pass 1, the second-to-last by
pass 2.  2D inputs may be one plane ``(Nr, Nc)`` or a stack ``(B, Nr,
Nc)``; 1D inputs one signal ``(n,)`` or rows ``(R, n)`` filtered one by
one (the reference's batched-1D mode, pypwt.pyx:146-151).

Kernel routing (``set_kernels``), decided per level before launch from
dtype, device and shape, never by catching an error:

* ``"auto"`` (default): a CUDA tensor launches the level's kernel (K1/K2
  in 2D, K3/K4 in 1D, K19/K20 for the shifted levels of cycle spinning;
  K10 and K8/K9 for ``core.swt``, K16/K17 and K18a/K18b for
  ``core.nonsep``); a CPU tensor runs the plain version.  Every kernel
  takes every float32 level its plain version takes (odd sizes and filter
  lengths included), and the tap-loop kernels (all but K19/K20) every
  float64 level too, on their float64 instances, so none declines: a level
  it does not cover on a CUDA tensor (float16, ...) raises ``ValueError``.
* ``"cuda"``: the kernel, or an error (CPU tensor, uncovered level).
* ``"torch"``: always the plain version, on the tensor's device.
* ``"mxu"``: the tensor-core forms where they cover a level, JAX's
  ``set_kernels("mxu")``: a 2D DWT level of float32 planes of even sizes
  and an even bank of 4 or more taps goes to K5/K6 (``ops.mxu_dwt``), a 2D
  SWT level whose dilated support fits in the plane to K11a/K11b
  (``ops.mxu_swt``, through ``core.swt``); in 1D a float32 level of even
  length and such a bank to K7a, its synthesis of twice the coefficients'
  length to K7b, and a stationary level whose support fits in the row to
  K12a/K12b; every other level (float64 included) goes where ``"auto"``
  sends it (K1/K2, K3/K4, K8/K9, K10, ...), as JAX sends it to its VPU
  kernels.  On a CPU tensor the tensor-core forms' banded plain versions
  run, as JAX runs its MXU kernels in interpret mode there.
  ``set_mxu_precision("highest"|"bf16")`` picks their precision.

``"auto"`` never takes the tensor-core forms: JAX's crossovers
(``_MXU_MIN_HLEN``, ``_LONG1D_MXU_MIN_HLEN``, the SWT support cliffs) were
measured on a TPU, and a tensor-core form becomes a default route only
once the H100 has shown it (ROADMAP.md).

Tail-level fusion (``set_tail_fuse(True)``), off by default as in JAX
(``pypwt_tpu/core/dwt.py:226-298``): ``wavedec2`` of 3 or more levels runs
level 0 through ``dwt2d`` (so on K1, or K5 in mode "mxu") and levels 2..L
in one launch of K24 (``ops.fused_pyramid``), and ``waverec2`` levels L..2
in one launch of K25, then level 0 through ``idwt2d``, wherever the
pyramid kernels cover the tail (float32, an even bank, both sizes of the
level-0 approximation divisible by 2^(L-1)); elsewhere, and in mode
"torch" (JAX's "jnp"), the levels run one by one, as JAX decides, before
any launch.  On a CPU tensor the tail runs the pyramid's plain version.

The environment sets all three at import, as in JAX
(``pypwt_tpu/core/dwt.py``): ``PYPWT_KERNELS`` (default ``"auto"``),
``PYPWT_MXU_PRECISION`` (default ``"highest"``), where a value the setter
refuses raises ``ValueError`` at import, naming the variable, and
``PYPWT_TAIL_FUSE`` (on if exactly ``"1"``, off for anything else).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops import fused_dwt, fused_pyramid, mxu_dwt, shifted
from .shapes import div2

_MODES = ("auto", "torch", "cuda", "mxu")
_KERNEL_MODE = "auto"
_MXU_PRECISION = "highest"


def set_kernels(mode: str):
    """Select the compute path: 'auto', 'torch' (plain ops), 'cuda' (the
    CUDA kernels only) or 'mxu' (the tensor-core forms where they cover a
    level)."""
    global _KERNEL_MODE
    if mode not in _MODES:
        raise ValueError("kernel mode must be auto|torch|cuda|mxu")
    _KERNEL_MODE = mode


def set_mxu_precision(prec: str):
    """Select the tensor-core forms' precision: 'highest' (3xTF32, about
    float32, the default) or 'bf16' (one bf16 product, about 1 % RMS
    error)."""
    global _MXU_PRECISION
    mxu_dwt.check_precision(prec)
    _MXU_PRECISION = prec


def mxu_precision() -> str:
    return _MXU_PRECISION


def _from_env(var, setter, default):
    """Apply environment variable ``var`` (or ``default``) through
    ``setter``; a refused value raises ValueError naming ``var``."""
    value = os.environ.get(var, default)
    try:
        setter(value)
    except ValueError as e:
        raise ValueError(f"{var}={value!r}: {e}") from None


_TAIL_FUSE = False


def set_tail_fuse(on: bool):
    """Turn tail-level fusion on or off (see the module docstring)."""
    global _TAIL_FUSE
    _TAIL_FUSE = bool(on)


_from_env("PYPWT_KERNELS", set_kernels, "auto")
_from_env("PYPWT_MXU_PRECISION", set_mxu_precision, "highest")
set_tail_fuse(os.environ.get("PYPWT_TAIL_FUSE", "0") == "1")


def _route(kernel, tensor, why):
    """True if ``kernel`` takes this level.  ``why`` is the kernel's
    reason to refuse the call (None if it covers it).  No kernel declines:
    an uncovered level on a CUDA tensor raises, unless kernel mode
    ``"torch"`` asks for the plain version ("mxu" routes as "auto" for
    the levels the tensor-core forms do not take)."""
    if _KERNEL_MODE == "torch":
        return False
    if not tensor.is_cuda:
        if _KERNEL_MODE == "cuda":
            raise ValueError(
                f"kernel mode 'cuda': tensor on {tensor.device}; the CUDA "
                "kernels take CUDA tensors only")
        return False
    if why is None:
        return True
    raise ValueError(
        f"{kernel.__name__}: the CUDA kernel does not cover {why}; "
        "set_kernels('torch') runs the plain version on the device")


def use_mxu(why) -> bool:
    """True if a level goes to a tensor-core form (K5, K6, K7, K11, K12):
    kernel mode "mxu" and a level the form covers (``why`` None), decided
    from shape and dtype before launch.  Its wrapper launches the kernel on
    a CUDA tensor and runs its banded plain version on the CPU."""
    return _KERNEL_MODE == "mxu" and why is None


def use_k5(x, fb) -> bool:
    """Routing decision for one analysis level in mode "mxu"."""
    return use_mxu(mxu_dwt.dwt2d_mxu_unsupported(x, fb))


def use_k6(a, h, v, d, fb, out_shape) -> bool:
    """Routing decision for one synthesis level in mode "mxu"."""
    return use_mxu(mxu_dwt.idwt2d_mxu_unsupported(a, h, v, d, fb, out_shape))


def use_k7a(x, fb) -> bool:
    """Routing decision for one 1D analysis level in mode "mxu"."""
    return use_mxu(mxu_dwt.dwt1d_mxu_unsupported(x, fb))


def use_k7b(a, d, fb, n_out) -> bool:
    """Routing decision for one 1D synthesis level in mode "mxu"."""
    return use_mxu(mxu_dwt.idwt1d_mxu_unsupported(a, d, fb, n_out))


def use_k1(x, fb) -> bool:
    """Routing decision for one analysis level (see module docstring)."""
    return _route(fused_dwt.dwt2d_fused, x,
                  fused_dwt.dwt2d_unsupported(x, fb))


def use_k2(a, h, v, d, fb, out_shape) -> bool:
    """Routing decision for one synthesis level (see module docstring)."""
    return _route(fused_dwt.idwt2d_fused, a,
                  fused_dwt.idwt2d_unsupported(a, h, v, d, fb, out_shape))


def _pyramid_route(kernel, tensor, why):
    """True if a pyramid's levels go to K24/K25 (``kernel``) as one launch:
    mode is not "torch" and the kernel covers them (``why`` None; else
    JAX's None, and the levels run one by one).  On a CPU tensor the
    wrapper runs its plain version (mode "cuda" raises there)."""
    if why is not None or _KERNEL_MODE == "torch":
        return False
    return _route(kernel, tensor, None) or not tensor.is_cuda


def use_k24(image, fb, levels) -> bool:
    """Routing decision for the tail of tail fusion's analysis: levels
    2..L of ``image``'s pyramid go to K24 where it covers their input, the
    level-0 approximation, decided from its shape and dtype before level 0
    runs."""
    a0 = torch.empty((*image.shape[:-2], div2(image.shape[-2]),
                      div2(image.shape[-1])), dtype=image.dtype,
                     device="meta")
    return _pyramid_route(
        fused_pyramid.wavedec2_pyramid_fused, image,
        fused_pyramid.wavedec2_pyramid_unsupported(a0, fb, levels - 1))


def use_k25(coeffs, fb) -> bool:
    """Routing decision for the tail of tail fusion's synthesis: levels
    L..2 of pyramid ``coeffs`` go to K25 where it covers them, up to the
    level-0 approximation (of level 1's subband shape)."""
    return _pyramid_route(
        fused_pyramid.waverec2_pyramid_fused, coeffs[0],
        fused_pyramid.waverec2_pyramid_unsupported(_tail(coeffs), fb,
                                                   coeffs[1][0].shape))


def _tail(coeffs):
    """The pyramid of levels 2..L: ``[a_L, (h, v, d) of level 2, ...]``."""
    return [coeffs[0]] + list(coeffs[2:])


def use_k3(x, fb) -> bool:
    """Routing decision for one 1D analysis level."""
    return _route(fused_dwt.dwt1d_fused, x,
                  fused_dwt.dwt1d_unsupported(x, fb))


def use_k4(a, d, fb, n_out) -> bool:
    """Routing decision for one 1D synthesis level."""
    return _route(fused_dwt.idwt1d_fused, a,
                  fused_dwt.idwt1d_unsupported(a, d, fb, n_out))


def use_k19(x, fb, mode=None) -> bool:
    """Routing decision for one shifted analysis level."""
    return _route(shifted.dwt2d_shifted_fused, x,
                  shifted.dwt2d_shifted_unsupported(x, fb, mode))


def use_k20(a, h, v, d, fb, out_shape, acc=None) -> bool:
    """Routing decision for one unshifting synthesis level."""
    return _route(shifted.idwt2d_unshift_fused, a,
                  shifted.idwt2d_unshift_unsupported(a, h, v, d, fb,
                                                     out_shape, acc))


def dwt1d(x, fb):
    """One analysis level along the last axis -> (a, d), for one signal
    ``(n,)`` (a ``(1, n)`` batch to K3 or K7a, at any length) or rows
    ``(R, n)``."""
    if use_k7a(x, fb):
        return mxu_dwt.dwt1d_mxu_fused(x.contiguous(), fb, _MXU_PRECISION)
    if use_k3(x, fb):
        return fused_dwt.dwt1d_fused(x.contiguous(), fb)
    return fused_dwt.dwt1d_plain(x, fb)


def idwt1d(a, d, fb, n_out):
    """One synthesis level along the last axis -> ``n_out`` samples."""
    if use_k7b(a, d, fb, n_out):
        return mxu_dwt.idwt1d_mxu_fused(a.contiguous(), d.contiguous(), fb,
                                        n_out, _MXU_PRECISION)
    if use_k4(a, d, fb, n_out):
        return fused_dwt.idwt1d_fused(a.contiguous(), d.contiguous(), fb,
                                      n_out)
    return fused_dwt.idwt1d_plain(a, d, fb, n_out)


def dwt2d(x, fb):
    """One separable 2D analysis level -> (a, h, v, d)."""
    if use_k5(x, fb):
        return mxu_dwt.dwt2d_mxu_fused(x.contiguous(), fb, _MXU_PRECISION)
    if use_k1(x, fb):
        return fused_dwt.dwt2d_fused(x.contiguous(), fb)
    return fused_dwt.dwt2d_plain(x, fb)


def idwt2d(a, h, v, d, fb, out_shape):
    """One separable 2D synthesis level -> image of ``out_shape``."""
    if use_k6(a, h, v, d, fb, out_shape):
        return mxu_dwt.idwt2d_mxu_fused(
            *(s.contiguous() for s in (a, h, v, d)), fb, out_shape,
            _MXU_PRECISION)
    if use_k2(a, h, v, d, fb, out_shape):
        return fused_dwt.idwt2d_fused(a.contiguous(), h.contiguous(),
                                      v.contiguous(), d.contiguous(), fb,
                                      out_shape)
    return fused_dwt.idwt2d_plain(a, h, v, d, fb, out_shape)


def dwt2d_shifted(x, fb, sr, sc, mode=None, beta=0.0):
    """One analysis level of ``roll(x, (sr, sc), (-2, -1))`` -> (a, h, v,
    d); ``mode`` "soft" or "hard" thresholds h, v and d by ``beta``."""
    if use_k19(x, fb, mode):
        return shifted.dwt2d_shifted_fused(x.contiguous(), fb, sr, sc, mode,
                                           beta)
    return shifted.dwt2d_shifted_plain(x, fb, sr, sc, mode, beta)


def idwt2d_unshift(a, h, v, d, fb, out_shape, sr, sc, acc=None, scale=1.0):
    """One synthesis level of ``out_shape``, rolled back by (sr, sc), added
    to ``acc`` (if given) and scaled: ``scale * (roll(y, (-sr, -sc))
    [+ acc])``."""
    if use_k20(a, h, v, d, fb, out_shape, acc):
        return shifted.idwt2d_unshift_fused(
            *(t.contiguous() for t in (a, h, v, d)), fb, out_shape, sr, sc,
            None if acc is None else acc.contiguous(), scale)
    return shifted.idwt2d_unshift_plain(a, h, v, d, fb, out_shape, sr, sc,
                                        acc, scale)


def wavedec2_tailfused(image, fb, levels: int):
    """Level 0 on its own kernel (``dwt2d``), levels 2..L in one K24
    launch; None where the tail is not covered, L < 3 or in mode "torch"
    (JAX's None)."""
    if levels < 3 or not use_k24(image, fb, levels):
        return None
    a0, h0, v0, d0 = dwt2d(image, fb)
    tail = fused_pyramid.wavedec2_pyramid_fused(a0.contiguous(), fb,
                                                levels - 1)
    return [tail[0], (h0, v0, d0)] + tail[1:]


def waverec2_tailfused(coeffs, fb, shape):
    """Inverse of ``wavedec2_tailfused``: levels L..2 in one K25 launch,
    level 0 on its own kernel (``idwt2d``); None where the tail is not
    covered, L < 3 or in mode "torch"."""
    if len(coeffs) - 1 < 3 or not use_k25(coeffs, fb):
        return None
    h0, v0, d0 = coeffs[1]
    a1 = fused_pyramid.waverec2_pyramid_fused(
        fused_pyramid.contiguous(_tail(coeffs)), fb, h0.shape)
    return idwt2d(a1, h0, v0, d0, fb, shape)


def wavedec2(image, fb, levels: int):
    """Multi-level separable 2D forward transform -> pyramid list."""
    if _TAIL_FUSE:
        r = wavedec2_tailfused(image, fb, levels)
        if r is not None:
            return r
    a = image
    details = []
    for _ in range(levels):
        a, h, v, d = dwt2d(a, fb)
        details.append((h, v, d))
    return [a] + details


def waverec2(coeffs, fb, shape):
    """Multi-level separable 2D inverse.  ``shape`` is the original image
    shape; per-level output sizes follow the div2 chain (wt.cu:332-342)."""
    if _TAIL_FUSE:
        r = waverec2_tailfused(coeffs, fb, shape)
        if r is not None:
            return r
    levels = len(coeffs) - 1
    sizes = [tuple(shape[-2:])]
    for _ in range(levels):
        sizes.append((div2(sizes[-1][0]), div2(sizes[-1][1])))
    a = coeffs[0]
    for lev in range(levels, 0, -1):
        h, v, d = coeffs[lev]
        a = idwt2d(a, h, v, d, fb, sizes[lev - 1])
    return a


def wavedec1(x, fb, levels: int):
    """Multi-level (batched) 1D forward transform along the last axis."""
    a = x
    details = []
    for _ in range(levels):
        a, d = dwt1d(a, fb)
        details.append(d)
    return [a] + details


def waverec1(coeffs, fb, n: int):
    """Multi-level (batched) 1D inverse along the last axis; ``n`` is the
    signal length, per-level lengths follow the div2 chain."""
    levels = len(coeffs) - 1
    sizes = [n]
    for _ in range(levels):
        sizes.append(div2(sizes[-1]))
    a = coeffs[0]
    for lev in range(levels, 0, -1):
        a = idwt1d(a, coeffs[lev], fb, sizes[lev - 1])
    return a


def pyramid_from_numpy(coeffs, device):
    """A pyramid of numpy arrays (for instance the JAX package's output,
    passed through ``np.asarray``) as tensors on ``device``; dtypes kept."""
    def t(c):
        return torch.tensor(np.asarray(c), device=device)  # copies
    out = [t(coeffs[0])]
    for c in coeffs[1:]:
        out.append(tuple(t(s) for s in c) if isinstance(c, (tuple, list))
                   else t(c))
    return out


def pyramid_to_numpy(coeffs):
    """A pyramid of tensors as numpy arrays on the host, same structure."""
    def n(c):
        return c.detach().cpu().numpy()
    out = [n(coeffs[0])]
    for c in coeffs[1:]:
        out.append(tuple(n(s) for s in c) if isinstance(c, (tuple, list))
                   else n(c))
    return out
