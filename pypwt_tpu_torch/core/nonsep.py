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
* the level functions ``nsdwt2d``/``insdwt2d`` and
  ``ns_swt2d_level``/``ins_swt2d_level`` route through
  ``core.dwt.set_kernels`` to K16/K17 and K18a/K18b (``ops.nonsep``) on a
  CUDA tensor, which take every float32 level of every bank and never
  decline (float64 raises there, unless kernel mode ``"torch"`` asks for
  the plain version).

The plain versions (in ``ops.nonsep``) use the slice formulation at every
filter size (the JAX package switches to ``lax.conv_general_dilated``
above 12 taps; a torch convolution would run through cuDNN in TF32 on a
GPU).
"""

from __future__ import annotations

import numpy as np

from ..ops import nonsep as kernels
from . import dwt, swt
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


def use_k16(x, f2d) -> bool:
    """Routing decision for one non-separable analysis level."""
    return dwt._route(kernels.nsdwt2d_fused, x,
                      kernels.nsdwt2d_unsupported(x, f2d))


def use_k17(a, h, v, d, f2d, out_shape) -> bool:
    """Routing decision for one non-separable synthesis level."""
    return dwt._route(kernels.insdwt2d_fused, a,
                      kernels.insdwt2d_unsupported(a, h, v, d, f2d,
                                                   out_shape))


def nsdwt2d(x, f2d: Filters2D):
    """One non-separable 2D analysis level -> (a, h, v, d), each of size
    div2 of the input's."""
    if use_k16(x, f2d):
        return kernels.nsdwt2d_fused(x.contiguous(), f2d)
    return kernels.nsdwt2d_plain(x, f2d)


def insdwt2d(a, h, v, d, f2d: Filters2D, out_shape):
    """One non-separable 2D synthesis level (4-phase polyphase inverse,
    nonseparable.cu:176-225) -> image of ``out_shape``."""
    if use_k17(a, h, v, d, f2d, out_shape):
        return kernels.insdwt2d_fused(*(s.contiguous() for s in (a, h, v, d)),
                                      f2d, out_shape)
    return kernels.insdwt2d_plain(a, h, v, d, f2d, out_shape)


def use_k18a(x, f2d, level) -> bool:
    """Routing decision for one non-separable stationary analysis level."""
    return dwt._route(kernels.ns_swt2d_fused, x,
                      kernels.ns_swt2d_unsupported(x, f2d, level))


def use_k18b(a, h, v, d, f2d, level) -> bool:
    """Routing decision for one non-separable stationary synthesis level."""
    return dwt._route(kernels.ins_swt2d_fused, a,
                      kernels.ins_swt2d_unsupported(a, h, v, d, f2d, level))


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
