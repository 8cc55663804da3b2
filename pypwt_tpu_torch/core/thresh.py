"""Pointwise proximal operators, norms and shifts over coefficient pyramids
(the port of ``pypwt_tpu.core.thresh``, which is plain jnp there too).

* soft / hard thresholding with the optional per-scale beta/sqrt(2)
  normalization rule (w_call_soft_thresh, common.cu:219-248)
* group (joint H/V/D[,A at the coarsest scale]) soft thresholding
  (common.cu:311-341)
* projection onto the L-inf ball (common.cu:285-308)
* L2 shrinkage x/(1+beta) (w_shrink, common.cu:347-371)
* circular shift (common.cu:202-211) -- the cycle-spinning primitive
* L1 / squared-L2 norms over the pyramid (wt.cu:368-416)
* coefficient axpy (w_add_coeffs, common.cu:499-526)

A pyramid is ``[A, (H1,V1,D1), ...]`` (2D) or ``[A, D1, ...]`` (1D); every
function returns new tensors and leaves its inputs as they were.
"""

from __future__ import annotations

import math

import torch

SQRT_2 = math.sqrt(2.0)


def _is_2d(coeffs):
    return isinstance(coeffs[1], (tuple, list))


def _soft(x, t):
    return torch.sign(x) * torch.clamp(torch.abs(x) - t, min=0)


def _hard(x, t):
    # reference: max(sign(|x|-t), 0) * x -- |x| == t is zeroed since
    # W_SIGN(0) = -1 (common.cu:7)
    return torch.where(torch.abs(x) > t, x, 0.0)


def _proj_linf(x, t):
    return torch.sign(x) * torch.clamp(torch.abs(x), max=t)


def _app_beta(beta, nlevels, normalize):
    """beta / sqrt(2)^nlevels via the reference's exact integer/float split
    (common.cu:231-235)."""
    if not normalize:
        return beta
    b = beta / (1 << (nlevels // 2))
    if nlevels % 2:
        b = b / SQRT_2
    return b


def _map_details(coeffs, fn_per_level):
    """Apply fn(level_index, subband) to every detail subband."""
    out = [coeffs[0]]
    for i, c in enumerate(coeffs[1:]):
        if isinstance(c, (tuple, list)):
            out.append(tuple(fn_per_level(i, s) for s in c))
        else:
            out.append(fn_per_level(i, c))
    return out


def soft_threshold(coeffs, beta, do_thresh_appcoeffs=False, normalize=False):
    nlevels = len(coeffs) - 1
    out0 = coeffs[0]
    if do_thresh_appcoeffs:
        out0 = _soft(coeffs[0], _app_beta(beta, nlevels, normalize))

    def f(i, s):
        b = beta / (SQRT_2 ** (i + 1)) if normalize else beta
        return _soft(s, b)

    res = _map_details(coeffs, f)
    res[0] = out0
    return res


def hard_threshold(coeffs, beta, do_thresh_appcoeffs=False, normalize=False):
    out0 = coeffs[0]
    if do_thresh_appcoeffs:
        # reference behavior: the appcoeff threshold ignores `normalize`
        # (w_call_hard_thresh computes beta2 but passes beta,
        # common.cu:262-270)
        out0 = _hard(coeffs[0], beta)

    def f(i, s):
        b = beta / (SQRT_2 ** (i + 1)) if normalize else beta
        return _hard(s, b)

    res = _map_details(coeffs, f)
    res[0] = out0
    return res


def proj_linf(coeffs, beta, do_thresh_appcoeffs=False):
    out0 = coeffs[0]
    if do_thresh_appcoeffs:
        out0 = _proj_linf(coeffs[0], beta)
    res = _map_details(coeffs, lambda i, s: _proj_linf(s, beta))
    res[0] = out0
    return res


def _group_factor(norm2, b):
    norm = torch.sqrt(norm2)
    return torch.where(norm > 0, torch.clamp(1 - b / norm, min=0), 0.0)


def group_soft_threshold(coeffs, beta, do_thresh_appcoeffs=False,
                         normalize=False):
    """Joint soft thresholding: each pixel's (H,V,D) vector (plus A at the
    coarsest scale if requested) is shrunk by its L2 norm
    (common.cu:145-198, 311-341)."""
    nlevels = len(coeffs) - 1
    out = [coeffs[0]]
    two_d = _is_2d(coeffs)
    for i in range(nlevels):
        b = beta / (SQRT_2 ** (i + 1)) if normalize else beta
        include_app = do_thresh_appcoeffs and (i == nlevels - 1)
        subs = coeffs[i + 1] if two_d else (coeffs[i + 1],)
        norm2 = sum(s * s for s in subs)
        if include_app:
            norm2 = norm2 + coeffs[0] * coeffs[0]
        fac = _group_factor(norm2, b)
        scaled = tuple(s * fac for s in subs)
        out.append(scaled if two_d else scaled[0])
        if include_app:
            out[0] = coeffs[0] * fac
    return out


def shrink(coeffs, beta, do_thresh_appcoeffs=True):
    """L2 proximal: every coefficient scaled by 1/(1+beta)
    (w_shrink, common.cu:347-371)."""
    fac = 1.0 / (1.0 + beta)
    res = _map_details(coeffs, lambda i, s: s * fac)
    res[0] = coeffs[0] * fac if do_thresh_appcoeffs else coeffs[0]
    return res


def _subbands(coeffs):
    yield coeffs[0]
    for c in coeffs[1:]:
        yield from (c if isinstance(c, (tuple, list)) else (c,))


def norm1(coeffs):
    """Sum of |w| over all subbands including A (wt.cu:396-416)."""
    return sum(torch.sum(torch.abs(s)) for s in _subbands(coeffs))


def norm2sq(coeffs):
    """Sum of w^2 over all subbands including A.

    The reference's 1D branch accumulates an L1 sum for the detail
    coefficients (wt.cu:386-388, an upstream bug); like the JAX package
    this implements the documented semantics (pypwt.pyx:439-448).
    """
    return sum(torch.sum(s * s) for s in _subbands(coeffs))


def circshift(img, sr: int, sc: int):
    """Circular shift: out[y, x] = in[y - sr, x - sc] (common.cu:202-211).
    For 1D inputs only the last axis is shifted."""
    if img.ndim == 1:
        return torch.roll(img, sc, dims=-1)
    return torch.roll(img, (sr, sc), dims=(-2, -1))


def add_coeffs(dst, src, alpha=1.0):
    """dst + alpha * src over the whole pyramid (common.cu:499-526)."""
    out = [dst[0] + alpha * src[0]]
    for c_d, c_s in zip(dst[1:], src[1:]):
        if isinstance(c_d, (tuple, list)):
            out.append(tuple(d + alpha * s for d, s in zip(c_d, c_s)))
        else:
            out.append(c_d + alpha * c_s)
    return out
