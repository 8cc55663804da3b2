"""End-to-end denoising pipelines (the port of ``pypwt_tpu.pipeline``):
forward transform -> threshold -> inverse, and its translation-invariant
form, cycle spinning (the reference's wt.cu:242-246 and :303).

The JAX package compiles each pipeline into one executable; here they run
eagerly, level by level, on the level kernels.  Random shifts come from a
``torch.Generator`` on the CPU (``generator=``, in place of JAX's
``key=``), so that drawing a shift needs no device sync.  ``img`` is a
tensor, whose device the pipeline runs on, or an array, which goes to
``device`` (the card unless the caller asks for the CPU).

Cycle spinning on one float32 plane with a bank longer than haar runs the
shift-aware kernels, as the JAX package's fused path does
(``pipeline.py:88-131``, ``:192-242``):

* a static spin runs level 0 on K19 (the shifted analysis, the level-0
  detail threshold in its epilogue), levels 2..L on K1/K2 through
  ``core.dwt``, and its synthesis back to the image on K20, which unshifts
  and adds the spin into the accumulator, with the 1/n of the average in
  the last spin's store;
* a random spin runs every level on K19/K20, level l shifted by that
  level's phase bits ``((s >> l) & 1)``: a periodized level satisfies
  A(roll(x, s)) = roll(A(roll(x, s % 2)), s // 2), so the shift factors
  through the pyramid, with the detail planes in rolled coordinates
  (thresholding is pointwise, so the image is the same).

``denoise2d`` (and the roll path below) runs its transforms through
``core.dwt.wavedec2``/``waverec2``, so tail fusion, where it is on, runs
their levels 2..L on K24/K25, as in JAX; the fused spins keep their own
level loop, which tail fusion does not touch (``pipeline.py:92-112``).

Both reduce a shift mod 2^L, which is exact only where 2^L divides both
plane sizes (an L-level pyramid then commutes with translations by
2^L); elsewhere a spin keeps its whole shift, which K19/K20 take as they
take any shift, and a random spin runs as a static one.  The JAX package
reduces wherever its kernels cover a level; the two agree wherever the
reduction is exact.  A stack, float64 or the haar bank take the roll
path: ``torch.roll`` around the multi-level transforms.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .filters import get_filter_bank
from .core import dwt, haar, swt, thresh
from .core.shapes import clamp_levels, div2

_SQRT2 = math.sqrt(2.0)


def _tensor(img, device):
    if isinstance(img, torch.Tensor):
        return img if device is None else img.to(device)
    return torch.from_numpy(np.ascontiguousarray(img)).to(device or "cuda")


def _fwd_inv(fb, levels, shape, do_swt):
    if fb.hlen == 2 and not do_swt:
        return (lambda x: haar.haar_wavedec2(x, levels),
                lambda c: haar.haar_waverec2(c, shape))
    if do_swt:
        return (lambda x: swt.swt2d(x, fb, levels),
                lambda c: swt.iswt2d(c, fb))
    return (lambda x: dwt.wavedec2(x, fb, levels),
            lambda c: dwt.waverec2(c, fb, shape))


def _threshold(hard):
    return thresh.hard_threshold if hard else thresh.soft_threshold


def denoise2d(img, wname, levels, beta, do_swt=False, hard=False,
              normalize=False, threshold_appcoeffs=False, device=None):
    """forward -> threshold -> inverse on a single (Nr, Nc) image or a
    (B, Nr, Nc) stack."""
    img = _tensor(img, device)
    fb = get_filter_bank(wname)
    levels = clamp_levels(levels, img.shape[-2:], fb.hlen, 2)
    fwd, inv = _fwd_inv(fb, levels, img.shape, do_swt)
    pyr = _threshold(hard)(fwd(img), beta, bool(threshold_appcoeffs),
                           bool(normalize))
    return inv(pyr)


class _Spins:
    """One cycle-spinning call: the bank, the level count and the
    threshold schedule shared by its spins."""

    def __init__(self, img, wname, levels, beta, hard, normalize,
                 threshold_appcoeffs):
        self.img = img
        self.fb = get_filter_bank(wname)
        self.levels = clamp_levels(levels, img.shape[-2:], self.fb.hlen, 2)
        self.beta = beta
        self.th = _threshold(hard)
        self.mode = "hard" if hard else "soft"
        self.app = bool(threshold_appcoeffs)
        self.normalize = bool(normalize)
        # the level-0 detail threshold, and the sub-pyramid's: beta/sqrt2
        # keeps the global normalize schedule (pipeline.py:85-86, :102-104)
        self.b1 = beta / _SQRT2 if normalize else beta
        self.sizes = [tuple(img.shape[-2:])]
        for _ in range(self.levels):
            self.sizes.append(tuple(div2(n) for n in self.sizes[-1]))
        nr, nc = self.sizes[0]
        period = 1 << self.levels
        self.fused = (img.ndim == 2 and img.dtype == torch.float32
                      and self.fb.hlen != 2)
        self.exact = nr % period == 0 and nc % period == 0

    def reduce(self, sr, sc):
        """The shift a spin runs: mod 2^L where that is exact, else mod
        the plane."""
        m = (1 << self.levels) if self.exact else None
        nr, nc = self.sizes[0]
        return int(sr) % (m or nr), int(sc) % (m or nc)

    def roll_spin(self, sr, sc):
        """One spin of the roll path: the whole denoise of the shifted
        image, shifted back."""
        fwd, inv = _fwd_inv(self.fb, self.levels, self.img.shape, False)
        pyr = self.th(fwd(torch.roll(self.img, (sr, sc), (-2, -1))),
                      self.beta, self.app, self.normalize)
        return torch.roll(inv(pyr), (-sr, -sc), (-2, -1))

    def _sub_threshold(self, pyr):
        return self.th(pyr, self.b1, self.app, self.normalize)

    def static_spin(self, sr, sc, acc, scale):
        """One spin with its shift in K19/K20 at level 0 and levels 2..L
        on K1/K2 (pipeline.py:92-131)."""
        fb = self.fb
        a, h0, v0, d0 = dwt.dwt2d_shifted(self.img, fb, sr, sc, self.mode,
                                          self.b1)
        details = []
        for _ in range(self.levels - 1):
            a, h, v, d = dwt.dwt2d(a, fb)
            details.append((h, v, d))
        sub = self._sub_threshold([a] + details)
        a = sub[0]
        for lev in range(self.levels - 1, 0, -1):
            a = dwt.idwt2d(a, *sub[lev], fb, self.sizes[lev])
        return dwt.idwt2d_unshift(a, h0, v0, d0, fb, self.sizes[0], sr, sc,
                                  acc, scale)

    def phase_spin(self, sr, sc, acc, scale):
        """One spin with a shift below 2^L, every level on K19/K20 shifted
        by its phase bits (pipeline.py:192-242)."""
        fb = self.fb
        bits = [((sr >> l) & 1, (sc >> l) & 1) for l in range(self.levels)]
        planes = []
        a = self.img
        for l, (br, bc) in enumerate(bits):
            a, h, v, d = (dwt.dwt2d_shifted(a, fb, br, bc, self.mode, self.b1)
                          if l == 0 else dwt.dwt2d_shifted(a, fb, br, bc))
            planes.append((h, v, d))
        sub = self._sub_threshold([a] + planes[1:])
        a = sub[0]
        for l in range(self.levels - 1, 0, -1):
            a = dwt.idwt2d_unshift(a, *sub[l], fb, self.sizes[l], *bits[l])
        return dwt.idwt2d_unshift(a, *planes[0], fb, self.sizes[0], *bits[0],
                                  acc, scale)

    def average(self, shifts, spin):
        """The mean of the spins over ``shifts``: the roll path's sum over
        n, or the fused spins' accumulator with 1/n in the last store."""
        n = len(shifts)
        acc = None
        if not self.fused:
            for sr, sc in shifts:
                rec = self.roll_spin(int(sr), int(sc))
                acc = rec if acc is None else acc + rec
            return acc / n if n > 1 else acc
        for k, (sr, sc) in enumerate(shifts):
            scale = 1.0 / n if k == n - 1 and n > 1 else 1.0
            acc = spin(*self.reduce(sr, sc), acc, scale)
        return acc


def random_spins(img, wname, levels, beta, shifts, hard=False,
                 normalize=False, threshold_appcoeffs=False, device=None):
    """Random-mode cycle spinning over given shifts ``((sr, sc), ...)``,
    each drawn from [0, Nr) x [0, Nc): the body of
    ``denoise2d_cycle_spinning(..., generator=...)``, which draws them."""
    img = _tensor(img, device)
    run = _Spins(img, wname, levels, beta, hard, normalize,
                 threshold_appcoeffs)
    return run.average(shifts, run.phase_spin if run.exact
                       else run.static_spin)


def denoise2d_cycle_spinning(img, wname, levels, beta, generator=None,
                             n_spins=8, hard=False, normalize=False,
                             threshold_appcoeffs=False, shifts=None,
                             device=None):
    """Translation-invariant denoising by averaging over circular shifts
    (the reference's cycle spinning, wt.cu:242-246 and :303).

    Two modes:

    * ``shifts=((r0, c0), ...)``: the given shifts, one spin each.  Where
      2^levels divides both plane sizes, only shifts mod 2^levels are
      distinct, and the default diagonal schedule ``((0,0), (1,1), ..)``
      already covers distinct cosets.
    * ``generator=<torch.Generator on the CPU>``: ``n_spins`` random shifts,
      each ``sr = randint(0, Nr)`` then ``sc = randint(0, Nc)`` from the
      generator (reproducible), as the reference's rand()-based mode.
    """
    img = _tensor(img, device)
    if shifts is not None:
        run = _Spins(img, wname, levels, beta, hard, normalize,
                     threshold_appcoeffs)
        return run.average(shifts, run.static_spin)
    if generator is None:
        raise ValueError("pass either a random key or static shifts")
    nr, nc = img.shape[-2], img.shape[-1]
    drawn = []
    for _ in range(n_spins):
        sr = int(torch.randint(0, nr, (), generator=generator))
        sc = int(torch.randint(0, nc, (), generator=generator))
        drawn.append((sr, sc))
    return random_spins(img, wname, levels, beta, drawn, hard, normalize,
                        threshold_appcoeffs)
