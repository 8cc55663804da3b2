"""Batch data parallelism over frame stacks (the port of
``pypwt_tpu.parallel.batch``).

A stack of images (tomography frames, video, ...) is split over the mesh's
data axis, one shard per data index; every transform of the core is
batch-polymorphic, so each shard runs the single-device path (K1/K2, K8/K9,
the haar butterfly) on its own device and no exchange takes place.  Only
the norms combine the shards, with one all-reduce each (the distributed
form of the reference's cuBLAS reductions, wt.cu:368-416).  A sharded
pyramid holds a list of shards at each leaf (``parallel.ring``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import dwt, haar, swt, thresh
from . import ring as _ring


def data_devices(mesh):
    """One device per data index: the mesh's first rows column."""
    return list(np.asarray(mesh.devices)[:, 0])


def shard_stack(stack, mesh):
    """A (B, ...) stack split over the data axis -> the list of its
    shards, each contiguous on its device."""
    t = stack if isinstance(stack, torch.Tensor) else torch.tensor(
        np.asarray(stack))
    devs = data_devices(mesh)
    return [p.to(d).contiguous()
            for p, d in zip(torch.tensor_split(t, len(devs), 0), devs)]


def _shards(stack, mesh):
    return list(stack) if isinstance(stack, (list, tuple)) else shard_stack(
        stack, mesh)


def wavedec2_batched(stack, fb, levels, mesh):
    """Multi-level 2D forward transform of a (B, Nr, Nc) stack sharded
    over the data axis; the batch axis stays sharded through every level."""
    return _ring.from_per_shard([dwt.wavedec2(x, fb, levels)
                                 for x in _shards(stack, mesh)])


def waverec2_batched(coeffs, fb, shape, mesh):
    """Inverse of ``wavedec2_batched`` -> the list of shards."""
    del mesh  # the shards are where the pyramid's shards are
    return [dwt.waverec2(p, fb, p[0].shape[:-2] + tuple(shape[-2:]))
            for p in _ring.per_shard(coeffs)]


def swt2d_batched(stack, fb, levels, mesh):
    return _ring.from_per_shard([swt.swt2d(x, fb, levels)
                                 for x in _shards(stack, mesh)])


def denoise_batched(stack, fb, levels, beta, mesh, normalize=False,
                    hard=False):
    """Forward -> threshold -> inverse on each data shard (the reference's
    doc/denoising.rst pipeline, scaled out) -> the list of shards."""
    th = thresh.hard_threshold if hard else thresh.soft_threshold

    def step(x):
        if fb.hlen == 2:
            pyr = haar.haar_wavedec2(x, levels)
        else:
            pyr = dwt.wavedec2(x, fb, levels)
        pyr = th(pyr, beta, do_thresh_appcoeffs=False, normalize=normalize)
        if fb.hlen == 2:
            return haar.haar_waverec2(pyr, x.shape)
        return dwt.waverec2(pyr, fb, x.shape)

    return [step(x) for x in _shards(stack, mesh)]


def norms_batched(coeffs, ring=None):
    """Global L1 and squared-L2 norms of a sharded pyramid: the shards'
    partial sums, then one all-reduce per norm (``ring``: a
    ``LocalRing`` over the shards' devices if None)."""
    shards = _ring.per_shard(coeffs)
    if ring is None:
        ring = _ring.LocalRing([p[0].device for p in shards], 1)
    n1 = ring.all_reduce_sum([thresh.norm1(p) for p in shards])
    n2 = ring.all_reduce_sum([thresh.norm2sq(p) for p in shards])
    return n1, n2
