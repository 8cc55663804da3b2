"""Multi-level separable 2D DWT, forward and inverse (the 2D part of
``pypwt_tpu.core.dwt``).

The coefficient pyramid is a plain list -- ``[A, (H1, V1, D1), ...,
(Hn, Vn, Dn)]`` -- of tensors on the input's device, the same layout as
the JAX package.  Axis convention (matches the reference): the last axis
is filtered by pass 1, the second-to-last by pass 2.  Inputs may be one
plane ``(Nr, Nc)`` or a stack ``(B, Nr, Nc)``.

Kernel routing (``set_kernels``), decided per level before launch from
dtype, device and shape, never by catching an error:

* ``"auto"`` (default): a CUDA tensor that K1/K2 cover launches the
  kernel; an uncovered level on a CUDA tensor (odd size, float64, ...)
  runs the plain torch version on the same device and adds one to the
  kernel's ``declined`` count; a CPU tensor runs the plain version.
* ``"cuda"``: the kernel, or an error (CPU tensor, uncovered level).
* ``"torch"``: always the plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import fused_dwt
from .shapes import div2

_MODES = ("auto", "torch", "cuda")
_KERNEL_MODE = "auto"


def set_kernels(mode: str):
    """Select the compute path: 'auto', 'torch' (plain ops) or 'cuda'
    (K1/K2 only)."""
    global _KERNEL_MODE
    if mode not in _MODES:
        raise ValueError("kernel mode must be auto|torch|cuda")
    _KERNEL_MODE = mode


def _route(kernel, tensor, why):
    """True if ``kernel`` takes this level.  ``why`` is the kernel's
    reason to refuse the call (None if it covers it)."""
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
    if _KERNEL_MODE == "cuda":
        raise ValueError(f"kernel mode 'cuda': kernel does not cover {why}")
    kernel.declined += 1
    return False


def use_k1(x, fb) -> bool:
    """Routing decision for one analysis level (see module docstring)."""
    return _route(fused_dwt.dwt2d_fused, x,
                  fused_dwt.dwt2d_unsupported(x, fb))


def use_k2(a, h, v, d, fb, out_shape) -> bool:
    """Routing decision for one synthesis level (see module docstring)."""
    return _route(fused_dwt.idwt2d_fused, a,
                  fused_dwt.idwt2d_unsupported(a, h, v, d, fb, out_shape))


def dwt2d(x, fb):
    """One separable 2D analysis level -> (a, h, v, d)."""
    if use_k1(x, fb):
        return fused_dwt.dwt2d_fused(x.contiguous(), fb)
    return fused_dwt.dwt2d_plain(x, fb)


def idwt2d(a, h, v, d, fb, out_shape):
    """One separable 2D synthesis level -> image of ``out_shape``."""
    if use_k2(a, h, v, d, fb, out_shape):
        return fused_dwt.idwt2d_fused(a.contiguous(), h.contiguous(),
                                      v.contiguous(), d.contiguous(), fb,
                                      out_shape)
    return fused_dwt.idwt2d_plain(a, h, v, d, fb, out_shape)


def wavedec2(image, fb, levels: int):
    """Multi-level separable 2D forward transform -> pyramid list."""
    a = image
    details = []
    for _ in range(levels):
        a, h, v, d = dwt2d(a, fb)
        details.append((h, v, d))
    return [a] + details


def waverec2(coeffs, fb, shape):
    """Multi-level separable 2D inverse.  ``shape`` is the original image
    shape; per-level output sizes follow the div2 chain (wt.cu:332-342)."""
    levels = len(coeffs) - 1
    sizes = [tuple(shape[-2:])]
    for _ in range(levels):
        sizes.append((div2(sizes[-1][0]), div2(sizes[-1][1])))
    a = coeffs[0]
    for lev in range(levels, 0, -1):
        h, v, d = coeffs[lev]
        a = idwt2d(a, h, v, d, fb, sizes[lev - 1])
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
