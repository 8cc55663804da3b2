"""Row-sharded transforms of single large images (the port of the
row-sharded half of ``pypwt_tpu.parallel.spatial``): an image's rows are
split over a ring of shards, and the rows a level's filters reach across a
shard's edge come from its neighbours as halos.

This is the distributed form of the reference kernels' in-thread periodic
indexing (separable.cu:112-121): the periodic wrap lands on the ring's
first <-> last link, so a halo exchange on the ring *is* periodization.
The column passes stay local (each shard holds whole rows).

JAX runs one SPMD program per shard that calls ``ppermute`` itself.  The
port's local functions take the list of shards and a ring
(``parallel.ring``) and run level-synchronously: per level they exchange
the halos of every shard first, then launch one kernel per shard, on its
shard's device and current stream.

Halo heights are the exact pads of the level (``ops.fused_dwt.
halo_heights``): DWT analysis ``conv.analysis_pads``, synthesis
``conv.synthesis_pads``, and the SWT's dilated by 2^(level-1) — JAX's
kernels took bands rounded up to 8 rows, which the port does not carry
(``parallel.audit`` records the difference).  Halos wider than one shard
(deep SWT levels, long filters on thin shards) are gathered
farthest-first with one ``ppermute`` per ring hop.

Per shard and level, routed before launch from mode, dtype, device and
shape (``core.dwt.set_kernels``): in mode "mxu" the tensor-core form K28
where it covers the level (``ops.mxu_dwt``, ``ops.mxu_swt``), else on a
CUDA tensor K26a/K26b (DWT) or K27a/K27b (SWT) (``ops.fused_dwt``, float32
and float64), which take every level; on a CPU tensor, or in mode
"torch", their plain versions.  A ring of one shard runs the unsharded
``core.dwt.dwt2d``/``core.swt.swt2d_level`` (and their inverses), as JAX
does.  The grid and sequence layouts (``pypwt_tpu/parallel/spatial.py``
:454-801, kernel family K29) are a later slice of the port (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import conv
from ..core import dwt as _dwt
from ..core import swt as _swt
from ..ops import fused_dwt, mxu_dwt, mxu_swt
from . import ring as _ring
from .mesh import ROW_AXIS


# -- halo primitives ---------------------------------------------------------


def _collect(parts, pad, ring, axis, before):
    """The ``pad`` samples along ``axis`` (-1 or -2) preceding (``before``)
    or following each shard's block in the global periodic array: the
    neighbours' blocks gathered farthest-first (before) or nearest-first
    (after), one ppermute per ring hop.  Hops past the ring wrap (the perm
    is mod its size), so pads wider than the whole array keep periodic
    semantics.  Returns one list of segments per hop."""
    n = parts[0].shape[axis]
    size = ring.axis_size
    hops = -(-pad // n) if pad > 0 else 0
    order = range(hops, 0, -1) if before else range(1, hops + 1)
    segs = []
    for j in order:
        perm = [(p, (p + j) % size if before else (p - j) % size)
                for p in range(size)]
        width = pad - (j - 1) * n
        if width >= n:
            seg = list(parts)
        elif before:
            seg = [x.narrow(axis, n - width, width) for x in parts]
        else:
            seg = [x.narrow(axis, 0, width) for x in parts]
        segs.append(ring.ppermute(seg, perm))
    return segs


def _collect_left(parts, pad, ring):
    """Segments (one list per hop) of the ``pad`` samples preceding each
    shard's block along the last axis."""
    return _collect(parts, pad, ring, -1, True)


def _collect_right(parts, pad, ring):
    """Segments of the ``pad`` samples following each shard's block along
    the last axis."""
    return _collect(parts, pad, ring, -1, False)


def _joined(parts, segs, axis):
    if not segs:
        return [x.narrow(axis, 0, 0) for x in parts]
    return [torch.cat([s[i] for s in segs], axis) if len(segs) > 1
            else segs[0][i].contiguous() for i in range(len(parts))]


def halo_exchange_last(parts, lpad, rpad, ring):
    """Periodic halo exchange along the last axis of shards split along
    it: prepend the ``lpad`` samples preceding each block and append the
    ``rpad`` following it, multi-hop where a pad is wider than a shard;
    with a ring of one this is plain periodic padding."""
    if ring.axis_size == 1:
        return [conv.periodic_pad_last(x, lpad, rpad) for x in parts]
    left = _collect_left(parts, lpad, ring) if lpad else []
    right = _collect_right(parts, rpad, ring) if rpad else []
    return [torch.cat([s[i] for s in left] + [x] + [s[i] for s in right], -1)
            for i, x in enumerate(parts)]


def _rows_before(parts, pad, ring):
    """The ``pad`` rows (axis -2) preceding each shard's block, gathered
    farthest-first with one ppermute per ring hop (none for pad 0)."""
    return _joined(parts, _collect(parts, pad, ring, -2, True), -2)


def _rows_after(parts, pad, ring):
    """The ``pad`` rows (axis -2) following each shard's block."""
    return _joined(parts, _collect(parts, pad, ring, -2, False), -2)


def _exchange(planes, kind, fb, ring, level=1):
    """The halos of every shard of each plane list in ``planes``: per
    shard the tuple (top, bottom) of each plane in order."""
    top, bot = fused_dwt.halo_heights(kind, fb, planes[0][0].shape[-2],
                                      level)
    per_plane = [(_rows_before(p, top, ring), _rows_after(p, bot, ring))
                 for p in planes]
    return [tuple(h for tb in per_plane for h in (tb[0][i], tb[1][i]))
            for i in range(len(planes[0]))]


def _by_subband(results):
    """Per-shard (a, h, v, d) -> four lists of shards."""
    return tuple(list(s) for s in zip(*results))


# -- one level of every shard ------------------------------------------------


def _dwt2d_shard(x, top, bot, fb):
    x = x.contiguous()
    if _dwt.use_mxu(mxu_dwt.dwt2d_sharded_mxu_unsupported(x, top, bot, fb)):
        return mxu_dwt.dwt2d_sharded_mxu_fused(x, top, bot, fb,
                                               _dwt.mxu_precision())
    if _dwt._route(fused_dwt.dwt2d_sharded_fused, x,
                   fused_dwt.dwt2d_sharded_unsupported(x, top, bot, fb)):
        return fused_dwt.dwt2d_sharded_fused(x, top, bot, fb)
    return fused_dwt.dwt2d_sharded_plain(x, top, bot, fb)


def _idwt2d_shard(a, h, v, d, halos, fb):
    a, h, v, d = (s.contiguous() for s in (a, h, v, d))
    if _dwt.use_mxu(mxu_dwt.idwt2d_sharded_mxu_unsupported(a, h, v, d, halos,
                                                      fb)):
        return mxu_dwt.idwt2d_sharded_mxu_fused(a, h, v, d, halos, fb,
                                                _dwt.mxu_precision())
    if _dwt._route(fused_dwt.idwt2d_sharded_fused, a,
                   fused_dwt.idwt2d_sharded_unsupported(a, h, v, d, halos,
                                                        fb)):
        return fused_dwt.idwt2d_sharded_fused(a, h, v, d, halos, fb)
    return fused_dwt.idwt2d_sharded_plain(a, h, v, d, halos, fb)


def _swt2d_shard(x, top, bot, fb, lev):
    x = x.contiguous()
    if _dwt.use_mxu(mxu_swt.swt2d_sharded_mxu_unsupported(x, top, bot, fb, lev)):
        return mxu_swt.swt2d_sharded_mxu_fused(x, top, bot, fb, lev,
                                               _dwt.mxu_precision())
    if _dwt._route(fused_dwt.swt2d_sharded_fused, x,
                   fused_dwt.swt2d_sharded_unsupported(x, top, bot, fb,
                                                       lev)):
        return fused_dwt.swt2d_sharded_fused(x, top, bot, fb, lev)
    return fused_dwt.swt2d_sharded_plain(x, top, bot, fb, lev)


def _iswt2d_shard(a, h, v, d, halos, fb, lev):
    a, h, v, d = (s.contiguous() for s in (a, h, v, d))
    if _dwt.use_mxu(mxu_swt.iswt2d_sharded_mxu_unsupported(a, h, v, d, halos, fb,
                                                      lev)):
        return mxu_swt.iswt2d_sharded_mxu_fused(a, h, v, d, halos, fb, lev,
                                                _dwt.mxu_precision())
    if _dwt._route(fused_dwt.iswt2d_sharded_fused, a,
                   fused_dwt.iswt2d_sharded_unsupported(a, h, v, d, halos,
                                                        fb, lev)):
        return fused_dwt.iswt2d_sharded_fused(a, h, v, d, halos, fb, lev)
    return fused_dwt.iswt2d_sharded_plain(a, h, v, d, halos, fb, lev)


def _dwt2d_level_sharded(parts, fb, ring):
    """One sharded separable analysis level -> (a, h, v, d), each a list
    of shards."""
    if ring.axis_size == 1:  # locally periodic: the unsharded kernels
        return _by_subband([_dwt.dwt2d(x, fb) for x in parts])
    halos = _exchange([parts], "dwt", fb, ring)
    return _by_subband([_dwt2d_shard(x, *hs, fb)
                        for x, hs in zip(parts, halos)])


def _idwt2d_level_sharded(a, h, v, d, fb, ring):
    """One sharded separable synthesis level -> list of shards."""
    if ring.axis_size == 1:
        return [_dwt.idwt2d(*s, fb, (2 * s[0].shape[-2], 2 * s[0].shape[-1]))
                for s in zip(a, h, v, d)]
    halos = _exchange([a, h, v, d], "idwt", fb, ring)
    return [_idwt2d_shard(*s, hs, fb) for *s, hs in zip(a, h, v, d, halos)]


def _swt2d_level_sharded(parts, fb, lev, ring):
    """One sharded stationary analysis level -> (a, h, v, d) lists."""
    if ring.axis_size == 1:
        return _by_subband([_swt.swt2d_level(x, fb, lev) for x in parts])
    halos = _exchange([parts], "swt", fb, ring, lev)
    return _by_subband([_swt2d_shard(x, *hs, fb, lev)
                        for x, hs in zip(parts, halos)])


def _iswt2d_level_sharded(a, h, v, d, fb, lev, ring):
    """One sharded stationary synthesis level -> list of shards."""
    if ring.axis_size == 1:
        return [_swt.iswt2d_level(*s, fb, lev) for s in zip(a, h, v, d)]
    halos = _exchange([a, h, v, d], "iswt", fb, ring, lev)
    return [_iswt2d_shard(*s, hs, fb, lev)
            for *s, hs in zip(a, h, v, d, halos)]


# -- level loops -------------------------------------------------------------


def _local_wavedec2(parts, fb, levels, ring):
    """The sharded pyramid [A, (H1, V1, D1), ...], each leaf a list of
    shards."""
    a = parts
    details = []
    for _ in range(levels):
        a, h, v, d = _dwt2d_level_sharded(a, fb, ring)
        details.append((h, v, d))
    return [a] + details


def _local_waverec2(coeffs, fb, ring):
    a = coeffs[0]
    for lev in range(len(coeffs) - 1, 0, -1):
        a = _idwt2d_level_sharded(a, *coeffs[lev], fb, ring)
    return a


def _local_swt2(parts, fb, levels, ring):
    a = parts
    details = []
    for lev in range(1, levels + 1):
        a, h, v, d = _swt2d_level_sharded(a, fb, lev, ring)
        details.append((h, v, d))
    return [a] + details


def _local_iswt2(coeffs, fb, ring):
    a = coeffs[0]
    for lev in range(len(coeffs) - 1, 0, -1):
        a = _iswt2d_level_sharded(a, *coeffs[lev], fb, lev, ring)
    return a


def _check_divisible(nr, nc, levels, n_rows):
    if nc % (1 << levels):
        raise ValueError(
            f"row length {nc} must be divisible by 2^levels for the "
            "row-sharded path")
    if nr % (n_rows << levels):
        raise ValueError(
            f"{nr} rows cannot be sharded over {n_rows} devices for "
            f"{levels} levels (need divisibility by {n_rows << levels})")


def _shards(image, mesh, ring):
    """(shards, ring) of an image or stack: a list of shards as it is, a
    whole tensor or numpy array split over ``mesh``."""
    if isinstance(image, (list, tuple)):
        parts = list(image)
    else:
        parts = _ring.shard_rows(image if isinstance(image, torch.Tensor)
                                 else torch.tensor(np.asarray(image)), mesh)
    if ring is None:
        ring = _ring.LocalRing.for_mesh(mesh, batched=parts[0].ndim == 3)
    return parts, ring


def _coeff_shards(coeffs, mesh, ring, batched):
    if not isinstance(coeffs[0], (list, tuple)):
        coeffs = _ring.pyramid_to_shards(coeffs, mesh)
    if ring is None:
        ring = _ring.LocalRing.for_mesh(mesh, batched)
    return coeffs, ring


def wavedec2_rowsharded(image, fb, levels, mesh, ring=None):
    """Multi-level separable 2D forward transform of an image whose rows
    are sharded over the mesh's row axis.  ``image`` (a whole tensor or
    array, or its list of shards) may have a leading batch axis, sharded
    over the data axis.  Returns the sharded pyramid (each leaf a list of
    shards); ``ring`` defaults to ``LocalRing.for_mesh(mesh)``."""
    if not isinstance(image, (list, tuple)):
        nr, nc = image.shape[-2], image.shape[-1]
        _check_divisible(nr, nc, levels, mesh.shape[ROW_AXIS])
    parts, ring = _shards(image, mesh, ring)
    _check_divisible(parts[0].shape[-2] * ring.axis_size,
                     parts[0].shape[-1], levels, ring.axis_size)
    return _local_wavedec2(parts, fb, levels, ring)


def waverec2_rowsharded(coeffs, fb, mesh, batched=False, ring=None):
    """Inverse of ``wavedec2_rowsharded`` -> the list of shards."""
    coeffs, ring = _coeff_shards(coeffs, mesh, ring, batched)
    return _local_waverec2(coeffs, fb, ring)


def swt2d_rowsharded(image, fb, levels, mesh, ring=None):
    """Multi-level stationary 2D transform of a row-sharded image."""
    parts, ring = _shards(image, mesh, ring)
    return _local_swt2(parts, fb, levels, ring)


def iswt2d_rowsharded(coeffs, fb, mesh, batched=False, ring=None):
    """Inverse of ``swt2d_rowsharded`` -> the list of shards."""
    coeffs, ring = _coeff_shards(coeffs, mesh, ring, batched)
    return _local_iswt2(coeffs, fb, ring)


def roll_shards(parts, sr, sc, ring):
    """``roll(x, (sr, sc), (-2, -1))`` of the row-sharded plane (or stack)
    whose shards are ``parts``: each shard's rows come from at most two
    source shards of its ring (one or two exchanges, no gather), the
    columns roll locally."""
    size = ring.axis_size
    n = parts[0].shape[-2]
    k, r = divmod(sr % (size * n), n)

    def shifted(seg, hop):
        if hop % size == 0:
            return seg
        return ring.ppermute(seg, [(p, (p + hop) % size)
                                   for p in range(size)])

    if r == 0:
        out = shifted(list(parts), k)
    else:
        tail = shifted([x[..., n - r:, :] for x in parts], k + 1)
        head = shifted([x[..., :n - r, :] for x in parts], k)
        out = [torch.cat([t, h], -2) for t, h in zip(tail, head)]
    if sc:
        out = [torch.roll(x, sc, -1) for x in out]
    return out
