"""BatchedWavelets: the ``Wavelets`` plan scaled out over a device mesh
(the port of ``pypwt_tpu.parallel.api``).

A stack of frames (tomography projections, video) stays on the devices,
split over the mesh's data axis, one shard per data index, through
forward / threshold / inverse / coefficient access / norms.  Each shard
runs the single-device core (K1/K2, K8/K9, K3/K4, K10, the haar
butterfly); only the norms combine shards, one all-reduce each.

HYBRID layout: a mesh whose rows axis is > 1 (``make_mesh(n_data,
n_rows)``) splits the frames over ``data`` AND each frame's rows over
``rows`` (the stacks-of-large-frames configuration): the per-frame compute
runs the row-sharded kernels K26-K28 with halo exchanges on each rows ring
(``parallel.spatial``), the batch riding through them; frame rows are
padded to the mesh-aligned size (PERIODIC extension, so the padded
coefficients are exactly the transform of the periodized extension) and
cropped on readback, as in ``ShardedWavelets``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import dwt, haar, swt, thresh
from ..core.shapes import clamp_levels
from ..filters import FilterBank, get_filter_bank
from . import mesh as pmesh
from . import ring as _ring
from . import spatial
from .batch import data_devices, shard_stack


class BatchedWavelets:
    """Wavelet plan for a (B, Nr, Nc) frame stack sharded across devices.

    Parameters mirror ``Wavelets`` (wname, levels, do_swt,
    do_cycle_spinning, ndim, seed); ``mesh`` defaults to every visible
    CUDA device on the data axis.  The batch must be divisible by the
    mesh's data-axis size.  ``ndim=1`` transforms each frame row as an
    independent 1D signal (the reference's batched-1D mode,
    pypwt.pyx:146-151, scaled over the mesh).  Cycle-spinning shifts come
    from ``np.random.default_rng(seed)`` in the JAX plan's order.
    """

    def __init__(self, stack, wname, levels, do_swt=0, mesh=None,
                 ndim=2, do_cycle_spinning=0, seed=None):
        stack = np.asarray(stack, dtype=np.float32)
        if stack.ndim != 3:
            raise ValueError("BatchedWavelets expects a (B, Nr, Nc) stack")
        self.mesh = mesh if mesh is not None else pmesh.make_mesh()
        n_data = self.mesh.shape[pmesh.BATCH_AXIS]
        if stack.shape[0] % n_data:
            raise ValueError(
                f"batch {stack.shape[0]} not divisible by data axis "
                f"{n_data}")
        self.B, self.Nr, self.Nc = stack.shape
        self.shape = stack.shape
        self.wname = wname
        self.do_swt = int(bool(do_swt))
        self.ndim = 1 if int(ndim) == 1 else 2
        self.do_cycle_spinning = int(bool(do_cycle_spinning))
        self._rng = np.random.default_rng(seed)
        self.current_shift = (0, 0)
        self._fb = get_filter_bank(wname)
        self.hlen = self._fb.hlen
        self.levels = clamp_levels(int(levels), (self.Nr, self.Nc),
                                   self.hlen, self.ndim)

        self.n_rows = (self.mesh.shape[pmesh.ROW_AXIS]
                       if pmesh.ROW_AXIS in self.mesh.axis_names else 1)
        self.hybrid = self.n_rows > 1 and self.ndim == 2
        if self.hybrid:
            rmult = self.n_rows << self.levels
            self._Nrp = -(-self.Nr // rmult) * rmult
            self.ring = _ring.LocalRing.for_mesh(self.mesh, batched=True)
        else:
            self._Nrp = self.Nr
            self.ring = _ring.LocalRing(data_devices(self.mesh), 1)
        self._stack = self._put_stack(stack)
        self._coeffs = None

    def _put_stack(self, stack):
        if not self.hybrid:
            return shard_stack(torch.from_numpy(np.ascontiguousarray(stack)),
                               self.mesh)
        pr = self._Nrp - stack.shape[1]
        if pr:
            stack = np.pad(stack, ((0, 0), (0, pr), (0, 0)), mode="wrap")
        return _ring.shard_rows(torch.from_numpy(np.ascontiguousarray(stack)),
                                self.mesh)

    def set_wavelets_filters(self, filter_name, lowpass, highpass,
                             i_lowpass, i_highpass):
        """Install a custom separable filter bank (pypwt.pyx:487-576)."""
        self._fb = FilterBank.custom(filter_name, lowpass, highpass,
                                     i_lowpass, i_highpass)
        self.wname = filter_name
        self.hlen = self._fb.hlen
        self._coeffs = None

    # ------------------------------------------------------------------

    def _use_haar(self):
        return self._fb.hlen == 2 and not self.do_swt

    def _fwd_shard(self, x):
        fb, lv = self._fb, self.levels
        if self.ndim == 1:
            if self._use_haar():
                return haar.haar_wavedec1(x, lv)
            if self.do_swt:
                return swt.swt1d(x, fb, lv)
            return dwt.wavedec1(x, fb, lv)
        if self._use_haar():
            return haar.haar_wavedec2(x, lv)
        if self.do_swt:
            return swt.swt2d(x, fb, lv)
        return dwt.wavedec2(x, fb, lv)

    def _inv_shard(self, c):
        fb = self._fb
        shape = (*c[0].shape[:-2], self.Nr, self.Nc)
        if self.ndim == 1:
            if self._use_haar():
                return haar.haar_waverec1(c, self.Nc)
            if self.do_swt:
                return swt.iswt1d(c, fb)
            return dwt.waverec1(c, fb, self.Nc)
        if self._use_haar():
            return haar.haar_waverec2(c, shape)
        if self.do_swt:
            return swt.iswt2d(c, fb)
        return dwt.waverec2(c, fb, shape)

    def _fwd(self, parts):
        if self.hybrid:
            if self.do_swt:
                return spatial._local_swt2(parts, self._fb, self.levels,
                                           self.ring)
            return spatial._local_wavedec2(parts, self._fb, self.levels,
                                           self.ring)
        return _ring.from_per_shard([self._fwd_shard(x) for x in parts])

    def _inv(self, coeffs):
        if self.hybrid:
            if self.do_swt:
                return spatial._local_iswt2(coeffs, self._fb, self.ring)
            return spatial._local_waverec2(coeffs, self._fb, self.ring,
                                           (self._Nrp, self.Nc))
        return [self._inv_shard(p) for p in _ring.per_shard(coeffs)]

    def _shift(self, parts, sr, sc):
        if self.hybrid:
            return spatial.roll_shards(parts, sr, sc, self.ring)
        if self.ndim == 1:
            return [torch.roll(x, sc, -1) for x in parts]  # common.cu:386
        return [torch.roll(x, (sr, sc), (-2, -1)) for x in parts]

    def forward(self, stack=None):
        if stack is not None:
            stack = np.asarray(stack, dtype=np.float32)
            if stack.shape != self.shape:
                raise ValueError("stack shape changed")
            self._stack = self._put_stack(stack)
        if self.do_cycle_spinning:
            sr = int(self._rng.integers(0, self.Nr))
            sc = int(self._rng.integers(0, self.Nc))
            self.current_shift = (sr, sc)
            self._stack = self._shift(self._stack, sr, sc)
        self._coeffs = self._fwd(self._stack)
        return self

    def inverse(self):
        self._guard()
        self._stack = self._inv(self._coeffs)
        if self.do_cycle_spinning:
            sr, sc = self.current_shift
            self._stack = self._shift(self._stack, -sr, -sc)
        return self

    def _guard(self):
        if self._coeffs is None:
            raise RuntimeError("forward() has not been run")

    def _map(self, fn):
        self._guard()
        self._coeffs = _ring.from_per_shard(
            [fn(p) for p in _ring.per_shard(self._coeffs)])

    def soft_threshold(self, beta, do_threshold_appcoeffs=0, normalize=0):
        self._map(lambda p: thresh.soft_threshold(
            p, float(beta), bool(do_threshold_appcoeffs), bool(normalize)))

    def hard_threshold(self, beta, do_threshold_appcoeffs=0, normalize=0):
        self._map(lambda p: thresh.hard_threshold(
            p, float(beta), bool(do_threshold_appcoeffs), bool(normalize)))

    def group_soft_threshold(self, beta, do_threshold_appcoeffs=0,
                             normalize=0):
        self._map(lambda p: thresh.group_soft_threshold(
            p, float(beta), bool(do_threshold_appcoeffs), bool(normalize)))

    def shrink(self, beta, do_threshold_appcoeffs=1):
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

    def denoise(self, beta, normalize=0, hard=False):
        """Forward -> threshold -> inverse on every shard; returns self."""
        th = thresh.hard_threshold if hard else thresh.soft_threshold
        beta = float(np.float32(beta))
        pyr = _ring.from_per_shard(
            [th(p, beta, False, bool(normalize))
             for p in _ring.per_shard(self._fwd(self._stack))])
        self._stack = self._inv(pyr)
        self._coeffs = None
        return self

    # ------------------------------------------------------------------

    def _gather(self, parts):
        if self.hybrid:
            return _ring.gather_rows(parts, self.n_rows, device="cpu")
        return _ring.gather_batch(parts, device="cpu")

    @property
    def image(self):
        """The stack, gathered to the host (B, Nr, Nc); hybrid row padding
        is cropped back to the user's geometry."""
        out = self._gather(self._stack).numpy()
        return out[:, : self.Nr] if self.hybrid else out

    def stack_device_array(self):
        """The stack's shards."""
        return self._stack

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
        """One coefficient plane for the whole batch, gathered to the host.

        Indexing: 2D: 0=A, 1=H1, 2=V1, 3=D1, ...; 1D: 0=A, i=Di
        (wt.cu:478-502)."""
        return self._gather(self._coeff_ref(num)).numpy()

    def coeffs_device(self):
        """The live sharded pyramid (a list of shards at each leaf)."""
        self._guard()
        return self._coeffs

    def set_coeff(self, coeff, num, check=False):
        """Overwrite one coefficient plane for the whole batch
        (pypwt.pyx:463-484 batched: the leading axis is B), split like the
        plane it replaces."""
        ref = self._coeff_ref(num)
        shape = tuple(self._gather(ref).shape)
        coeff = np.asarray(coeff, dtype=np.float32)
        if check and tuple(coeff.shape) != shape:
            raise ValueError(
                "set_coeff: Invalid coefficient shape : expected %s, got %s"
                % (str(shape), str(tuple(coeff.shape))))
        new = torch.from_numpy(np.ascontiguousarray(coeff.reshape(shape)))
        new = (_ring.shard_rows(new, self.mesh) if self.hybrid
               else shard_stack(new, self.mesh))
        level, sub = self._coeff_index(num)
        c = list(self._coeffs)
        if sub is None:
            c[level] = new
        else:
            planes = list(c[level])
            planes[sub] = new
            c[level] = tuple(planes)
        self._coeffs = c

    def add_wavelet(self, W, alpha=1.0):
        """In-place coefficient axpy with another BatchedWavelets holding
        the same transform (wt.cu:622-655, batched)."""
        self._guard()
        W._guard()
        if (self.levels != W.levels
                or self.wname.lower() != W.wname.lower()):
            raise ValueError(
                "add_wavelet(): right operand is not the same transform "
                "(wname, level)")
        if (self.shape, self.ndim, bool(self.do_swt)) != (
                W.shape, W.ndim, bool(W.do_swt)):
            raise ValueError(
                "add_wavelet(): operands do not have the same geometry")
        if (self.do_cycle_spinning and W.do_cycle_spinning
                and self.current_shift != W.current_shift):
            raise ValueError(
                "add_wavelet(): operands do not have the same current shift")
        self._coeffs = _ring.from_per_shard(
            [thresh.add_coeffs(p, q, float(alpha))
             for p, q in zip(_ring.per_shard(self._coeffs),
                             _ring.per_shard(W._coeffs))])
        return 0
