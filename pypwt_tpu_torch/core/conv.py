"""Periodized filtering primitives in plain torch ops (the 2D-DWT part of
``pypwt_tpu.core.conv``).

These restate the reference CUDA kernels' index algebra with tensor
slicing and elementwise multiply-adds, in the same tap order as the JAX
package:

* analysis (convolve + decimate), separable pass
  (separable.cu:91-131 "w_kern_forward_pass1"):
      out[i] = sum_j f[hlen-1-j] * x_ext[(2 i + j - lpad) mod M]
  where for odd N the signal is virtually extended by repeating its last
  element (M = N + 1), matching pywt's "periodization" mode.

* synthesis (upsample + convolve), polyphase form
  (separable.cu:246-328 "w_kern_inverse_pass1/2"): each output parity p
  reads the coefficients once with the phase-p polyphase component of the
  filter, with the reference's even/odd half-length centering rules.

All functions operate on the last axis; callers transpose for other axes.
``F.conv1d`` is deliberately not used: on a GPU it runs through cuDNN in
TF32 by default, which is outside the accuracy envelope.
"""

from __future__ import annotations

import numpy as np
import torch


def _as_taps(f, dtype):
    """Filter taps as Python floats holding the value rounded to ``dtype``
    (float64 filters rounded once, as ``pypwt_tpu.core.conv._as_taps``)."""
    f = np.asarray(f, dtype=np.float64)
    if f.ndim != 1:
        raise ValueError("filter must be 1D")
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    return [float(v) for v in f.astype(np_dtype)]


def periodic_pad_last(x, lpad: int, rpad: int):
    """Periodic padding along the last axis, robust to pads >= N."""
    if lpad == 0 and rpad == 0:
        return x
    n = x.shape[-1]
    if lpad < n and rpad < n:
        parts = []
        if lpad:
            parts.append(x[..., n - lpad:])
        parts.append(x)
        if rpad:
            parts.append(x[..., :rpad])
        return torch.cat(parts, dim=-1)
    idx = torch.from_numpy(np.arange(-lpad, n + rpad) % n).to(x.device)
    return torch.index_select(x, -1, idx)


def _odd_extend_last(x):
    """Repeat the last element so the length is even (reference's virtual
    extension for odd sizes, separable.cu:116-121)."""
    if x.shape[-1] % 2 == 1:
        x = torch.cat([x, x[..., -1:]], dim=-1)
    return x


def analysis_pads(hlen: int):
    """(lpad, rpad) of the periodic padding used by ``analysis_last``."""
    s = hlen // 2
    return hlen - 1 - s, max(s - 1, 0)


def analysis_core(xp, dec_lo, dec_hi, L: int):
    """Decimating analysis on an already-padded signal:
    out[i] = sum_j f_rev[j] * xp[2i + j] for i < L."""
    hlen = len(dec_lo)
    even = xp[..., 0::2]
    odd = xp[..., 1::2]
    flo = _as_taps(dec_lo, xp.dtype)
    fhi = _as_taps(dec_hi, xp.dtype)
    lo = None
    hi = None
    for j in range(hlen):
        src = even if j % 2 == 0 else odd
        seg = src[..., j // 2: j // 2 + L]
        glo, ghi = flo[hlen - 1 - j], fhi[hlen - 1 - j]
        lo = seg * glo if lo is None else lo + seg * glo
        hi = seg * ghi if hi is None else hi + seg * ghi
    return lo, hi


def analysis_last(x, dec_lo, dec_hi):
    """Single-level decimating analysis along the last axis.

    Returns (lo, hi), each of length div2(N).
    """
    hlen = len(dec_lo)
    xe = _odd_extend_last(x)
    L = xe.shape[-1] // 2
    lpad, rpad = analysis_pads(hlen)
    xp = periodic_pad_last(xe, lpad, rpad)
    return analysis_core(xp, dec_lo, dec_hi, L)


def synthesis_pads(hlen: int, L: int, n_out: int):
    """(lpad, rpad) of the periodic padding used by ``synthesis_core``."""
    hlen2 = hlen // 2
    sigma = 1 if hlen2 % 2 == 0 else 0
    c = hlen2 // 2
    Lout = (n_out + 1) // 2
    lpad = c
    rpad = max(((p + sigma) >> 1) - c + Lout + hlen2 - 1 - L
               for p in (0, 1))
    return lpad, max(rpad, 0)


def synthesis_core(lop, hip, rec_lo, rec_hi, n_out: int, L: int,
                   lpad: int):
    """Upsampling synthesis on already-padded coefficient signals.

    lop/hip carry ``lpad`` extra samples on the left (>= c) and enough on
    the right (see ``synthesis_pads``); L is the unpadded coefficient
    length, n_out the output length.  Implements the reference's polyphase
    inverse including its even half-length right-shift rule
    (separable.cu:252-264).
    """
    hlen = len(rec_lo)
    hlen2 = hlen // 2
    sigma = 1 if hlen2 % 2 == 0 else 0
    c = hlen2 // 2
    flo = _as_taps(rec_lo, lop.dtype)
    fhi = _as_taps(rec_hi, lop.dtype)

    Lout = (n_out + 1) // 2  # compute both parities at this length
    phases = []
    for p in (0, 1):
        pp = (p + sigma) & 1
        delta = (p + sigma) >> 1
        off = 1 - pp
        base = lpad + delta - c
        acc = None
        for j in range(hlen2):
            tap = hlen - 1 - 2 * j - off
            gl, gh = flo[tap], fhi[tap]
            seg_l = lop[..., base + j: base + j + Lout]
            seg_h = hip[..., base + j: base + j + Lout]
            term = seg_l * gl + seg_h * gh
            acc = term if acc is None else acc + term
        phases.append(acc)
    out = torch.stack(phases, dim=-1).reshape(*lop.shape[:-1], 2 * Lout)
    return out[..., :n_out]


def synthesis_last(lo, hi, rec_lo, rec_hi, n_out: int):
    """Single-level upsampling synthesis along the last axis.

    lo/hi have length L = div2(n_out); returns length n_out.
    """
    L = lo.shape[-1]
    hlen = len(rec_lo)
    lpad, rpad = synthesis_pads(hlen, L, n_out)
    lop = periodic_pad_last(lo, lpad, rpad)
    hip = periodic_pad_last(hi, lpad, rpad)
    return synthesis_core(lop, hip, rec_lo, rec_hi, n_out, L, lpad)
