"""ShardedWavelets: the ``Wavelets`` plan for ONE image or signal too large
(or too latency-critical) for a single device (the port of
``pypwt_tpu.parallel.sharded``): the image's rows are split over the
mesh's rows axis (row layout), or both its axes over a ``make_mesh2d``
mesh (grid layout), or a 1D signal's samples over the rows axis (sequence
layout), and every transform runs per shard with halo exchanges
(``parallel.spatial``).

The surface keeps the reference's member names (pypwt.pyx:64-615):
thresholds, norms, coefficient access, cycle spinning and a fused denoise
step, while the image and pyramid stay on the devices, one shard each.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import thresh
from ..core.shapes import clamp_levels
from ..filters import get_filter_bank
from . import mesh as pmesh
from . import ring as _ring
from . import spatial


class ShardedWavelets:
    """Spatially-sharded wavelet plan for a single (Nr, Nc) image or a
    single long 1D signal.

    Parameters mirror ``Wavelets`` (wname, levels, do_swt,
    do_cycle_spinning, seed); ``mesh`` defaults to every visible CUDA
    device on the rows axis (row layout).  A (rows, cols) mesh from
    ``mesh.make_mesh2d`` selects the grid layout: both image axes sharded,
    halos on both rings (``ring.GridRings``).  A 1D input selects the
    sequence layout: the signal's samples sharded over the rows axis (DWT
    and a-trous SWT).  Any size is accepted: the input is padded to the
    mesh-aligned size (multiples of n_rows << L and n_cols << L) by
    PERIODIC extension, transformed sharded and cropped on readback, so
    ``coeffs`` are the single-device transform OF THE PERIODIC EXTENSION to
    the aligned size, and the unprocessed roundtrip is exact at every size
    (the JAX plan's contract, ``pypwt_tpu/parallel/sharded.py:41-53``).
    Cycle-spinning shifts come from ``np.random.default_rng(seed)`` in the
    JAX plan's order (the sequence layout draws no column shift), so one
    seed draws the same shifts in both packages; the global roll of the
    sharded image is a ring exchange (``spatial.roll_shards``,
    ``roll_grid``, ``roll_last``).
    """

    def __init__(self, img, wname, levels, do_swt=0, do_cycle_spinning=0,
                 mesh=None, seed=None):
        img = np.ascontiguousarray(img, dtype=np.float32)
        if img.ndim not in (1, 2):
            raise ValueError(
                "ShardedWavelets expects a single 1D signal or 2D image")
        if mesh is None:
            devices = pmesh._cuda_devices()
            mesh = pmesh.make_mesh(1, len(devices), devices)
        self.mesh = mesh
        self.ndim = img.ndim
        self.grid = self.ndim == 2 and pmesh.COL_AXIS in mesh.axis_names
        self.n_rows = mesh.shape[pmesh.ROW_AXIS]
        self.n_cols = mesh.shape[pmesh.COL_AXIS] if self.grid else 1
        if self.ndim == 1:
            self.Nr, self.Nc = img.shape[0], None
        else:
            self.Nr, self.Nc = img.shape
        self.shape = tuple(img.shape)
        self.wname = wname
        self.do_swt = int(bool(do_swt))
        self.do_cycle_spinning = int(bool(do_cycle_spinning))
        self._fb = get_filter_bank(wname)
        self.hlen = self._fb.hlen
        self.levels = clamp_levels(int(levels), img.shape, self.hlen,
                                   self.ndim)

        # mesh-aligned geometry: shards of equal size, divisible by
        # 2^levels so that every level halves evenly
        rmult = self.n_rows << self.levels
        cmult = self.n_cols << self.levels
        self._Nrp = -(-self.Nr // rmult) * rmult
        if self.ndim == 1:
            self._Ncp = None
            self._padded = (self._Nrp,)
        else:
            self._Ncp = -(-self.Nc // cmult) * cmult
            self._padded = (self._Nrp, self._Ncp)
        self._layout()
        self._image = self._put(img)
        self._coeffs = None
        self._rng = np.random.default_rng(seed)
        self.current_shift = (0, 0)

    def _layout(self):
        """The ring(s), the split and gather of whole tensors and the level
        loops of this plan's layout."""
        fb, lv, sw = self._fb, self.levels, self.do_swt
        if self.ndim == 1:
            self.ring = _ring.rows_ring(self.mesh)
            self._split, self._gather = _ring.shard_last, _ring.gather_last
            fwd, inv = ((spatial._local_swt1_seq, spatial._local_iswt1_seq)
                        if sw else (spatial._local_wavedec1_seq,
                                    spatial._local_waverec1_seq))
            self._roll = lambda p, sr, sc: spatial.roll_last(p, sr, self.ring)
        elif self.grid:
            self.ring = _ring.GridRings.for_mesh(self.mesh)
            self._split = _ring.shard_grid
            self._gather = lambda p, dev: _ring.gather_grid(p, self.n_cols,
                                                            dev)
            fwd, inv = ((spatial._local_swt2_grid, spatial._local_iswt2_grid)
                        if sw else (spatial._local_wavedec2_grid,
                                    spatial._local_waverec2_grid))
            self._roll = lambda p, sr, sc: spatial.roll_grid(p, sr, sc,
                                                             self.ring)
        else:
            self.ring = _ring.LocalRing.for_mesh(self.mesh, batched=False)
            self._split = _ring.shard_rows
            self._gather = lambda p, dev: _ring.gather_rows(p, device=dev)
            fwd, inv = ((spatial._local_swt2, spatial._local_iswt2) if sw
                        else (spatial._local_wavedec2,
                              spatial._local_waverec2))
            self._roll = lambda p, sr, sc: spatial.roll_shards(p, sr, sc,
                                                               self.ring)
        self._fwd = lambda parts: fwd(parts, fb, lv, self.ring)
        self._inv = lambda coeffs: inv(coeffs, fb, self.ring)

    def _put(self, img):
        """Pad (PERIODIC extension: the transform's own boundary rule) to
        the mesh-aligned size and shard."""
        pads = [(0, p - n) for p, n in zip(self._padded, img.shape)]
        if any(p for _, p in pads):
            img = np.pad(img, pads, mode="wrap")
        return self._split(torch.from_numpy(np.ascontiguousarray(img)),
                           self.mesh)

    def forward(self, img=None):
        if img is not None:
            img = np.ascontiguousarray(img, dtype=np.float32)
            if img.shape != self.shape:
                raise ValueError(
                    "The image does not have the correct shape")
            self._image = self._put(img)
        if self.do_cycle_spinning:
            sr = int(self._rng.integers(0, self._Nrp))
            sc = (0 if self.ndim == 1
                  else int(self._rng.integers(0, self._Ncp)))
            self.current_shift = (sr, sc)
            self._image = self._roll(self._image, sr, sc)
        self._coeffs = self._fwd(self._image)
        return self

    def inverse(self):
        self._guard()
        self._image = self._inv(self._coeffs)
        if self.do_cycle_spinning:
            sr, sc = self.current_shift
            self._image = self._roll(self._image, -sr, -sc)
        return self

    def _guard(self):
        if self._coeffs is None:
            raise RuntimeError("forward() has not been run")

    # ------------------------------------------------------------------

    def _map(self, fn):
        """Apply a pointwise pyramid operator to every shard's pyramid."""
        self._coeffs = _ring.from_per_shard(
            [fn(p) for p in _ring.per_shard(self._coeffs)])

    def soft_threshold(self, beta, do_threshold_appcoeffs=0, normalize=0):
        self._guard()
        self._map(lambda p: thresh.soft_threshold(
            p, float(beta), bool(do_threshold_appcoeffs), bool(normalize)))

    def hard_threshold(self, beta, do_threshold_appcoeffs=0, normalize=0):
        self._guard()
        self._map(lambda p: thresh.hard_threshold(
            p, float(beta), bool(do_threshold_appcoeffs), bool(normalize)))

    def group_soft_threshold(self, beta, do_threshold_appcoeffs=0,
                             normalize=0):
        self._guard()
        self._map(lambda p: thresh.group_soft_threshold(
            p, float(beta), bool(do_threshold_appcoeffs), bool(normalize)))

    def proj_linf(self, beta, do_threshold_appcoeffs=0):
        self._guard()
        self._map(lambda p: thresh.proj_linf(
            p, float(beta), bool(do_threshold_appcoeffs)))

    def shrink(self, beta, do_threshold_appcoeffs=1):
        self._guard()
        self._map(lambda p: thresh.shrink(p, float(beta),
                                          bool(do_threshold_appcoeffs)))

    def _norm(self, fn):
        self._guard()
        return float(self.ring.all_reduce_sum(
            [fn(p) for p in _ring.per_shard(self._coeffs)]))

    def norm1(self):
        return self._norm(thresh.norm1)

    def norm2sq(self):
        return self._norm(thresh.norm2sq)

    def _step(self, x, beta, normalize, hard):
        th = thresh.hard_threshold if hard else thresh.soft_threshold
        pyr = [th(p, beta, False, bool(normalize))
               for p in _ring.per_shard(self._fwd(x))]
        return self._inv(_ring.from_per_shard(pyr))

    def denoise(self, beta, normalize=0, hard=False, spins=1):
        """Forward -> threshold -> inverse; with ``spins > 1`` averages
        over random circular shifts (translation-invariant cycle spinning,
        wt.cu:242-246 generalized to an explicit spin count)."""
        beta = float(np.float32(beta))
        acc = None
        for _ in range(max(1, int(spins))):
            if spins > 1 or self.do_cycle_spinning:
                sr = int(self._rng.integers(0, self.Nr))
                sc = (0 if self.ndim == 1
                      else int(self._rng.integers(0, self.Nc)))
            else:
                sr = sc = 0
            x = self._roll(self._image, sr, sc) if (sr or sc) \
                else self._image
            y = self._step(x, beta, normalize, hard)
            if sr or sc:
                y = self._roll(y, -sr, -sc)
            acc = y if acc is None else [s + t for s, t in zip(acc, y)]
        self._image = [s / spins for s in acc] if spins > 1 else acc
        self._coeffs = None
        return self

    # ------------------------------------------------------------------

    @property
    def image(self):
        # crop the internal mesh-aligned padding back to the user's size
        out = self._gather(self._image, "cpu").numpy()
        return out[: self.Nr] if self.ndim == 1 else out[: self.Nr, : self.Nc]

    def set_image(self, img):
        img = np.ascontiguousarray(img, dtype=np.float32)
        if img.shape != self.shape:
            raise ValueError("The image does not have the correct shape")
        self._image = self._put(img)
        self._coeffs = None

    def image_device_array(self):
        """The image's shards (the padded, mesh-aligned image)."""
        return self._image

    def _coeff_index(self, num):
        self._guard()
        if num == 0:
            return 0, None
        if self.ndim == 1:
            if num > self.levels:
                raise ValueError(f"coefficient {num} out of range")
            return num, None
        level, sub = (num - 1) // 3 + 1, (num - 1) % 3
        if level > self.levels:
            raise ValueError(f"coefficient {num} out of range")
        return level, sub

    def _coeff_ref(self, num):
        level, sub = self._coeff_index(num)
        c = self._coeffs[level]
        return c if sub is None else c[sub]

    def coeff_only(self, num):
        return self._gather(self._coeff_ref(num), "cpu").numpy()

    @property
    def coeffs(self):
        self._guard()
        full = _ring.pyramid_from_shards(
            self._coeffs, gather=lambda p: self._gather(p, "cpu"))
        if self.ndim == 1:
            return [c.numpy() for c in full]
        return [full[0].numpy()] + [[s.numpy() for s in lev]
                                    for lev in full[1:]]

    def set_coeff(self, coeff, num, check=False):
        ref = self._coeff_ref(num)
        part = ref[0].shape
        shape = ((self.n_rows * part[-1],) if self.ndim == 1 else
                 (self.n_rows * part[-2], self.n_cols * part[-1]))
        coeff = np.ascontiguousarray(coeff, dtype=np.float32)
        if check and tuple(coeff.shape) != shape:
            raise ValueError(
                "set_coeff: Invalid coefficient shape : expected %s, "
                "got %s" % (str(shape), str(tuple(coeff.shape))))
        new = self._split(torch.from_numpy(coeff.reshape(shape)), self.mesh)
        level, sub = self._coeff_index(num)
        c = list(self._coeffs)
        if sub is None:
            c[level] = new
        else:
            planes = list(c[level])
            planes[sub] = new
            c[level] = tuple(planes)
        self._coeffs = c

    def coeffs_device(self):
        """The live sharded pyramid (a list of shards at each leaf)."""
        self._guard()
        return self._coeffs

    def add_wavelet(self, W, alpha=1.0):
        """In-place coefficient axpy with another ShardedWavelets holding
        the same transform (wt.cu:622-655; shard-local, no exchange)."""
        self._guard()
        W._guard()
        if (self.levels != W.levels
                or self.wname.lower() != W.wname.lower()):
            raise ValueError(
                "add_wavelet(): right operand is not the same transform "
                "(wname, level)")
        if (self.shape, bool(self.do_swt)) != (W.shape, bool(W.do_swt)):
            raise ValueError(
                "add_wavelet(): operands do not have the same geometry")
        if (self.do_cycle_spinning and W.do_cycle_spinning
                and self.current_shift != W.current_shift):
            raise ValueError(
                "add_wavelet(): operands do not have the same current shift")
        mine, theirs = _ring.per_shard(self._coeffs), _ring.per_shard(
            W._coeffs)
        self._coeffs = _ring.from_per_shard(
            [thresh.add_coeffs(p, q, float(alpha))
             for p, q in zip(mine, theirs)])
        return 0

    def info(self):
        if self.ndim == 1:
            layout = f"{self.n_rows} seq-shards"
        elif self.grid:
            layout = f"{self.n_rows}x{self.n_cols} grid-shards"
        else:
            layout = f"{self.n_rows} row-shards"
        pad = ("" if self._padded == self.shape
               else f" (padded to {'x'.join(map(str, self._padded))})")
        print(f"ShardedWavelets: {self.shape} {self.wname} "
              f"L{self.levels} swt={self.do_swt} over {layout}{pad}")
