"""Non-separable 2D transforms: one true 2D filtering per level (the port
of ``pypwt_tpu.core.nonsep``).

Equivalent of the reference's non-separable kernels (nonseparable.cu:
114-225 for the DWT, :304-401 for the SWT).  The four 2D filters (LL, LH,
HL, HH) are outer products of the 1D bank for built-in wavelets
(``Filters2D.from_bank``) or arbitrary user-supplied squares (custom
banks).  Public functions keep the JAX layout ``(..., H, W)``.

Routing:

* the drivers (``ns_wavedec2``, ``ns_waverec2``, ``ns_swt2d``,
  ``ins_swt2d``) send a bank that factors into one isotropic 1D bank to
  the separable path (``core.dwt``: K1/K2; ``core.swt``: K8/K9), as the
  JAX package does;
* ``ns_swt2d_level``/``ins_swt2d_level`` route through
  ``core.dwt.set_kernels`` to K18a/K18b (``ops.nonsep``) on a CUDA tensor,
  which take every float32 level and never decline (float64 raises there,
  unless kernel mode ``"torch"`` asks for the plain version);
* ``nsdwt2d``/``insdwt2d`` are the plain slice formulation.  Their TPU
  kernels K16/K17 are not ported yet: on a CUDA tensor a bank that factors
  runs its level on K1/K2, and one that does not raises
  ``NotImplementedError`` (ROADMAP.md queue 1, item 6), unless kernel mode
  ``"torch"`` asks for the plain version.

The plain versions use the slice formulation at every filter size (the JAX
package switches to ``lax.conv_general_dilated`` above 12 taps; a torch
convolution would run through cuDNN in TF32 on a GPU).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import nonsep as kernels
from . import conv, dwt, swt
from .shapes import div2


class Filters2D:
    """The four 2D analysis + four 2D synthesis filters.

    For built-in banks these are outer products f1[i] * f2[j]; the first
    index filters the row axis (axis -2).

    The H subband is hi(rows) x lo(cols), the separable path's and pywt's
    convention (the reference's non-separable kernels swap H and V,
    nonseparable.cu:71-74; PARITY.md keeps the JAX package's choice).
    """

    def __init__(self, dec, rec, name="custom2d"):
        self.name = name
        self.dec = [np.asarray(f, dtype=np.float64) for f in dec]
        self.rec = [np.asarray(f, dtype=np.float64) for f in rec]
        n = self.dec[0].shape[0]
        for f in self.dec + self.rec:
            if f.shape != (n, n):
                raise ValueError("2D filters must all be square, same size")
        self.hlen = n

    @staticmethod
    def from_bank(fb):
        def outer(a, b):
            return np.outer(np.asarray(a), np.asarray(b))

        dec = [outer(fb.dec_lo, fb.dec_lo), outer(fb.dec_hi, fb.dec_lo),
               outer(fb.dec_lo, fb.dec_hi), outer(fb.dec_hi, fb.dec_hi)]
        rec = [outer(fb.rec_lo, fb.rec_lo), outer(fb.rec_hi, fb.rec_lo),
               outer(fb.rec_lo, fb.rec_hi), outer(fb.rec_hi, fb.rec_hi)]
        return Filters2D(dec, rec, name=fb.name)

    def separable_bank(self):
        """If the four 2D filter pairs factor into one isotropic 1D bank
        (outer products with identical row/col factors, the from_bank
        construction), return that bank; else None.

        Used to route the non-separable mode through the separable
        kernels: with harmonized H/V conventions the results coincide.
        The same float64 SVD as the JAX package, so the factored taps are
        bit-identical to its own.
        """
        if getattr(self, "_sep_bank", "?") != "?":
            return self._sep_bank
        self._sep_bank = None
        try:
            u, s, vt = np.linalg.svd(self.dec[0])
            if s[0] <= 0 or (len(s) > 1 and s[1] > 1e-10 * s[0]):
                return None
            lo_r = u[:, 0] * np.sqrt(s[0])
            lo_c = vt[0] * np.sqrt(s[0])
            if lo_r.sum() < 0:
                lo_r, lo_c = -lo_r, -lo_c
            nlc = float(lo_c @ lo_c)
            nlr = float(lo_r @ lo_r)
            hi_r = self.dec[1] @ lo_c / nlc
            hi_c = self.dec[2].T @ lo_r / nlr

            ur, sr, vr = np.linalg.svd(self.rec[0])
            if sr[0] <= 0 or (len(sr) > 1 and sr[1] > 1e-10 * sr[0]):
                return None
            rlo_r = ur[:, 0] * np.sqrt(sr[0])
            rlo_c = vr[0] * np.sqrt(sr[0])
            if rlo_r.sum() < 0:
                rlo_r, rlo_c = -rlo_r, -rlo_c
            rhi_r = self.rec[1] @ rlo_c / float(rlo_c @ rlo_c)
            rhi_c = self.rec[2].T @ rlo_r / float(rlo_r @ rlo_r)

            tol = 1e-9 * max(np.abs(f).max() for f in self.dec + self.rec)
            checks = [
                (self.dec[0], np.outer(lo_r, lo_c)),
                (self.dec[1], np.outer(hi_r, lo_c)),
                (self.dec[2], np.outer(lo_r, hi_c)),
                (self.dec[3], np.outer(hi_r, hi_c)),
                (self.rec[0], np.outer(rlo_r, rlo_c)),
                (self.rec[1], np.outer(rhi_r, rlo_c)),
                (self.rec[2], np.outer(rlo_r, rhi_c)),
                (self.rec[3], np.outer(rhi_r, rhi_c)),
                # isotropy: the separable core uses one bank on both axes
                (np.outer(lo_r, 1.0), np.outer(lo_c, 1.0)),
                (np.outer(hi_r, 1.0), np.outer(hi_c, 1.0)),
                (np.outer(rlo_r, 1.0), np.outer(rlo_c, 1.0)),
                (np.outer(rhi_r, 1.0), np.outer(rhi_c, 1.0)),
            ]
            for got, want in checks:
                if np.abs(got - want).max() > max(tol, 1e-12):
                    return None
            from ..filters import FilterBank
            self._sep_bank = FilterBank.custom(
                self.name + "-factored", lo_r, hi_r, rlo_r, rhi_r)
        except (np.linalg.LinAlgError, ValueError):
            # no SVD, or a factor the separable kernels do not take (odd
            # or over-long): the true 2D path
            self._sep_bank = None
        return self._sep_bank


def filters2d_from_numpy(name, dec, rec):
    """Carry a 2D bank across from its arrays (for instance the ``name``,
    ``dec`` and ``rec`` fields of a ``pypwt_tpu.core.nonsep.Filters2D``).
    The 2D counterpart of ``filters.bank_from_numpy``: a name of its own
    because it takes the bank's name first, as that helper does, where
    ``Filters2D`` takes it last."""
    return Filters2D(dec, rec, name=name)


def _separable_on_cuda(t, f2d):
    """The factored bank for a DWT level on a CUDA tensor (its level runs
    on K1/K2); None where the plain version runs (CPU tensor, or kernel
    mode "torch").  K16/K17 are not ported: a bank that does not factor
    raises on a CUDA tensor."""
    if not t.is_cuda or dwt._KERNEL_MODE == "torch":
        return None
    fb = f2d.separable_bank()
    if fb is None:
        raise NotImplementedError(
            f"the non-separable DWT level of the non-factorable bank "
            f"{f2d.name!r} has no CUDA kernel yet (K16/K17, ROADMAP.md "
            "queue 1 item 6); set_kernels('torch') runs the plain version "
            "on the device")
    return fb


def _weights(F, dtype):
    return [conv._as_taps(row, dtype) for row in np.asarray(F)]


def nsdwt2d(x, f2d: Filters2D):
    """One non-separable 2D analysis level -> (a, h, v, d), each of size
    div2 of the input's, in the slice formulation."""
    fb = _separable_on_cuda(x, f2d)
    if fb is not None:
        return dwt.dwt2d(x, fb)
    hlen = f2d.hlen
    s = hlen // 2
    xe = conv._odd_extend_2d(x)
    xp = conv._pad2_periodic(xe, hlen - 1 - s, max(s - 1, 0))
    L_r = xe.shape[-2] // 2
    L_c = xe.shape[-1] // 2
    frev = [_weights(np.asarray(f)[::-1, ::-1], x.dtype) for f in f2d.dec]
    outs = [None] * 4
    for k in range(hlen):
        slab = xp[..., k: k + 2 * L_r: 2, :]
        for l in range(hlen):
            seg = slab[..., :, l: l + 2 * L_c: 2]
            for si in range(4):
                w = frev[si][k][l]
                if w == 0.0:
                    continue
                t = seg * w
                outs[si] = t if outs[si] is None else outs[si] + t
    return tuple(outs)


def insdwt2d(a, h, v, d, f2d: Filters2D, out_shape):
    """One non-separable 2D synthesis level (4-phase polyphase inverse,
    nonseparable.cu:176-225) -> image of ``out_shape``."""
    fb = _separable_on_cuda(a, f2d)
    if fb is not None:
        return dwt.idwt2d(a, h, v, d, fb, out_shape)
    nr, nc = out_shape[-2], out_shape[-1]
    L_r = a.shape[-2]
    hlen = f2d.hlen
    hlen2 = hlen // 2
    sigma = 1 if hlen2 % 2 == 0 else 0
    c = hlen2 // 2
    Lout_r, Lout_c = (nr + 1) // 2, (nc + 1) // 2

    coeffs = torch.stack([a, h, v, d], dim=-3)  # (..., 4, L_r, L_c)

    # phase-dependent pads (same recipe as the 1D synthesis)
    def pad_for(p, L, Lout):
        pp = (p + sigma) & 1
        delta = (p + sigma) >> 1
        start = delta - c
        lpad = max(-start, 0)
        rpad = max(start + Lout + hlen2 - 1 - L, 0)
        return pp, start + lpad, lpad, rpad

    # all four phases share delta/lpad per parity; pad once with the max
    pads = {p: pad_for(p, L_r, Lout_r) for p in (0, 1)}
    lpad = max(pads[0][2], pads[1][2])
    rpad = max(pads[0][3], pads[1][3])
    xp = conv._pad2_periodic(coeffs, lpad, rpad)

    # rhs[(py*2+px), b, jy, jx] = F_b[hlen-1-2jy-offy, hlen-1-2jx-offx]
    rhs = np.zeros((4, 4, hlen2, hlen2))
    offs = {p: 1 - ((p + sigma) & 1) for p in (0, 1)}
    js = np.arange(hlen2)
    for py in (0, 1):
        for px in (0, 1):
            ty = hlen - 1 - 2 * js - offs[py]
            tx = hlen - 1 - 2 * js - offs[px]
            for b, F in enumerate(f2d.rec):
                rhs[py * 2 + px, b] = F[np.ix_(ty, tx)]

    outs = {}
    for py in (0, 1):
        by = pads[py][1] + lpad - pads[py][2]
        for px in (0, 1):
            bx = pads[px][1] + lpad - pads[px][2]
            win = xp[..., by: by + Lout_r + hlen2 - 1,
                     bx: bx + Lout_c + hlen2 - 1]
            acc = None
            for b in range(4):
                wb = win[..., b, :, :]
                taps = _weights(rhs[py * 2 + px, b], a.dtype)
                for jy in range(hlen2):
                    for jx in range(hlen2):
                        w = taps[jy][jx]
                        if w == 0.0:
                            continue
                        t = wb[..., jy: jy + Lout_r, jx: jx + Lout_c] * w
                        acc = t if acc is None else acc + t
            outs[(py, px)] = acc

    top = torch.stack([outs[(0, 0)], outs[(0, 1)]], dim=-1)
    bot = torch.stack([outs[(1, 0)], outs[(1, 1)]], dim=-1)
    top = top.reshape(*top.shape[:-2], 2 * Lout_c)
    bot = bot.reshape(*bot.shape[:-2], 2 * Lout_c)
    out = torch.stack([top, bot], dim=-2).reshape(
        *top.shape[:-2], 2 * Lout_r, 2 * Lout_c)
    return out[..., :nr, :nc].contiguous()


def use_k18a(x, f2d, level) -> bool:
    """Routing decision for one non-separable stationary analysis level."""
    return dwt._route(kernels.ns_swt2d_fused, x,
                      kernels.ns_swt2d_unsupported(x, f2d, level), strict=True)


def use_k18b(a, h, v, d, f2d, level) -> bool:
    """Routing decision for one non-separable stationary synthesis level."""
    return dwt._route(kernels.ins_swt2d_fused, a,
                      kernels.ins_swt2d_unsupported(a, h, v, d, f2d, level),
                      strict=True)


def ns_swt2d_level(x, f2d: Filters2D, level: int):
    """One non-separable stationary analysis level (nonseparable.cu:
    304-354) -> (a, h, v, d), each of the input's shape."""
    if use_k18a(x, f2d, level):
        return kernels.ns_swt2d_fused(x.contiguous(), f2d, level)
    return kernels.ns_swt2d_plain(x, f2d, level)


def ins_swt2d_level(a, h, v, d, f2d: Filters2D, level: int):
    """One non-separable stationary synthesis level, scaled by 1/4
    (nonseparable.cu:360-401)."""
    if use_k18b(a, h, v, d, f2d, level):
        return kernels.ins_swt2d_fused(*(s.contiguous() for s in (a, h, v, d)),
                                       f2d, level)
    return kernels.ins_swt2d_plain(a, h, v, d, f2d, level)


def ns_wavedec2(image, f2d, levels):
    fb = f2d.separable_bank()
    if fb is not None:
        return dwt.wavedec2(image, fb, levels)
    a = image
    details = []
    for _ in range(levels):
        a, h, v, d = nsdwt2d(a, f2d)
        details.append((h, v, d))
    return [a] + details


def ns_waverec2(coeffs, f2d, shape):
    fb = f2d.separable_bank()
    if fb is not None:
        return dwt.waverec2(coeffs, fb, shape)
    levels = len(coeffs) - 1
    sizes = [tuple(shape[-2:])]
    for _ in range(levels):
        sizes.append((div2(sizes[-1][0]), div2(sizes[-1][1])))
    a = coeffs[0]
    for lev in range(levels, 0, -1):
        h, v, d = coeffs[lev]
        a = insdwt2d(a, h, v, d, f2d, sizes[lev - 1])
    return a


def ns_swt2d(image, f2d, levels):
    fb = f2d.separable_bank()
    if fb is not None:
        return swt.swt2d(image, fb, levels)
    a = image
    details = []
    for lev in range(1, levels + 1):
        a, h, v, d = ns_swt2d_level(a, f2d, lev)
        details.append((h, v, d))
    return [a] + details


def ins_swt2d(coeffs, f2d):
    fb = f2d.separable_bank()
    if fb is not None:
        return swt.iswt2d(coeffs, fb)
    levels = len(coeffs) - 1
    a = coeffs[0]
    for lev in range(levels, 0, -1):
        h, v, d = coeffs[lev]
        a = ins_swt2d_level(a, h, v, d, f2d, lev)
    return a
