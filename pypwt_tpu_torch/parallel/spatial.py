"""Sharded transforms of single large images and long signals (the port of
``pypwt_tpu.parallel.spatial``): an image's rows are split over a ring of
shards (the row layout), or both its axes over a (rows, cols) grid (the
grid layout), or a signal's samples over a ring (the sequence layout); the
samples a level's filters reach across a shard's edge come from its
neighbours as halos.

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
does.

The grid layout runs each level as JAX does, one axis at a time: the
column pass along the last axis with halos from the ``cols`` ring, then the
row pass along axis -2 on both of its outputs with halos from the ``rows``
ring (``parallel.ring.GridRings``), and the synthesis the other way round;
the sequence layout runs the column pass alone on the signal's shards (a
``(n,)`` shard, or JAX's leading batch ``(B, n)``).  Each pass routes per
shard: in mode "mxu" the tensor-core forms K29e/K29f (lanes) or K29g/K29h
(rows) where they cover it (``ops.mxu_dwt``; float32, an even bank of 4 or
more taps), else on a CUDA tensor K29a/K29b or K29c/K29d
(``ops.fused_dwt``, float32 and float64, any bank), which take every pass
these layouts make; on a CPU tensor, or in mode "torch", the plain
versions.  A ring of one shard wraps its own halos (periodic slices of the
shard, no exchange).  The stationary passes of both layouts run no kernel in
JAX either: the a-trous map in torch ops on each shard's halo-extended
tensor (``conv.swt_analysis_core``/``swt_synthesis_core``, the row pass
along axis -2 itself, no transpose).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import conv
from ..core import dwt as _dwt
from ..core import swt as _swt
from ..core.shapes import div2
from ..ops import fused_dwt, mxu_dwt, mxu_swt
from . import ring as _ring
from .mesh import COL_AXIS, ROW_AXIS


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


def _local_waverec2(coeffs, fb, ring, shape=None):
    """The sharded inverse -> list of shards.  ``shape`` is the whole
    frame's (rows, cols): each level's output is cropped to its div2 chain
    of widths (``core.dwt.waverec2``), so a width that 2^levels does not
    divide comes back; rows split evenly at every level and need no crop.
    Without it every level doubles the width."""
    a = coeffs[0]
    levels = len(coeffs) - 1
    widths = [None] * (levels + 1)
    if shape is not None:
        widths[0] = shape[-1]
        for lev in range(1, levels + 1):
            widths[lev] = div2(widths[lev - 1])
    for lev in range(levels, 0, -1):
        a = _idwt2d_level_sharded(a, *coeffs[lev], fb, ring)
        w = widths[lev - 1]
        if w is not None and a[0].shape[-1] != w:  # local: columns unsplit
            a = [x[..., :w].contiguous() for x in a]
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


def _roll_axis(parts, s, ring, axis):
    """``roll(x, s, axis)`` of the array split along ``axis`` over ``ring``
    whose shards are ``parts``: each shard's samples come from at most two
    source shards of its ring (one or two exchanges, no gather)."""
    size = ring.axis_size
    n = parts[0].shape[axis]
    k, r = divmod(s % (size * n), n)

    def shifted(seg, hop):
        if hop % size == 0:
            return seg
        return ring.ppermute(seg, [(p, (p + hop) % size)
                                   for p in range(size)])

    if r == 0:
        return shifted(list(parts), k)
    tail = shifted([x.narrow(axis, n - r, r) for x in parts], k + 1)
    head = shifted([x.narrow(axis, 0, n - r) for x in parts], k)
    return [torch.cat([t, h], axis) for t, h in zip(tail, head)]


def roll_shards(parts, sr, sc, ring):
    """``roll(x, (sr, sc), (-2, -1))`` of the row-sharded plane (or stack)
    whose shards are ``parts``: the rows through the ring, the columns
    locally."""
    out = _roll_axis(parts, sr, ring, -2)
    if sc:
        out = [torch.roll(x, sc, -1) for x in out]
    return out


def roll_grid(parts, sr, sc, rings):
    """``roll(x, (sr, sc), (-2, -1))`` of the grid-sharded image whose
    shards are ``parts``: the rows through the ``rows`` rings, the columns
    through the ``cols`` rings (``parallel.ring.GridRings``)."""
    return _roll_axis(_roll_axis(parts, sr, rings.rows, -2), sc, rings.cols,
                      -1)


def roll_last(parts, s, ring):
    """``roll(x, s, -1)`` of the sequence-sharded signal (or rows) whose
    shards are ``parts``."""
    return _roll_axis(parts, s, ring, -1)


# -- the grid and sequence layouts -------------------------------------------


def _wrapped(x, start, stop, axis):
    """Samples [start, stop) of ``x`` along ``axis``, periodically (a ring
    of one shard's halos), as a contiguous tensor."""
    n = x.shape[axis]
    if 0 <= start and stop <= n:
        return x.narrow(axis, start, stop - start).contiguous()
    idx = torch.arange(start, stop, device=x.device) % n
    return x.index_select(axis, idx)


def _halos(parts, lpad, rpad, ring, axis):
    """Per shard (before, after): the ``lpad`` samples along ``axis``
    (-1 or -2) preceding its block in the global periodic array and the
    ``rpad`` following it, gathered over ``ring`` (multi-hop where a pad is
    wider than a shard); a ring of one wraps its shard (no exchange)."""
    if ring.axis_size == 1:
        return [(_wrapped(x, -lpad, 0, axis),
                 _wrapped(x, x.shape[axis], x.shape[axis] + rpad, axis))
                for x in parts]
    before = _joined(parts, _collect(parts, lpad, ring, axis, True), axis)
    after = _joined(parts, _collect(parts, rpad, ring, axis, False), axis)
    return list(zip(before, after))


def halo_exchange_rows(parts, lpad, rpad, ring):
    """Periodic halo exchange along axis -2 without any transpose: each
    shard with the ``lpad`` rows before it and the ``rpad`` after it
    (multi-hop as needed; a local periodic wrap on a ring of one)."""
    return [torch.cat([b, x, a], -2)
            for x, (b, a) in zip(parts, _halos(parts, lpad, rpad, ring, -2))]


# (tensor-core form, its coverage, tap-loop kernel, its coverage, plain
# version) of each one-axis pass of a shard
_PASSES = {
    "ana_lanes": (mxu_dwt.ana_lanes_mxu_fused,
                  mxu_dwt.ana_lanes_mxu_unsupported,
                  fused_dwt.ana_lanes_fused, fused_dwt.ana_lanes_unsupported,
                  fused_dwt.ana_lanes_plain),
    "syn_lanes": (mxu_dwt.syn_lanes_mxu_fused,
                  mxu_dwt.syn_lanes_mxu_unsupported,
                  fused_dwt.syn_lanes_fused, fused_dwt.syn_lanes_unsupported,
                  fused_dwt.syn_lanes_plain),
    "ana_rows": (mxu_dwt.ana_rows_mxu_fused, mxu_dwt.ana_rows_mxu_unsupported,
                 fused_dwt.ana_rows_fused, fused_dwt.ana_rows_unsupported,
                 fused_dwt.ana_rows_plain),
    "syn_rows": (mxu_dwt.syn_rows_mxu_fused, mxu_dwt.syn_rows_mxu_unsupported,
                 fused_dwt.syn_rows_fused, fused_dwt.syn_rows_unsupported,
                 fused_dwt.syn_rows_plain),
}


def _one_axis_shard(kind, *args):
    """One shard's pass ``kind`` of ``_PASSES``, routed before launch."""
    mxu, mxu_why, kernel, why, plain = _PASSES[kind]
    if _dwt.use_mxu(mxu_why(*args)):
        return mxu(*args, _dwt.mxu_precision())
    if _dwt._route(kernel, args[0], why(*args)):
        return kernel(*args)
    return plain(*args)


def _kind(pass_, axis):
    return f"{pass_}_{'lanes' if axis in (-1, 1) else 'rows'}"


def _analysis_axis_sharded(parts, fb, axis, ring):
    """Decimating analysis along ``axis`` (-1: the lanes of a grid shard or
    a signal shard; -2: the rows of a grid shard) of every shard, halos
    exchanged on ``ring`` -> (lo, hi), each a list of shards."""
    lp, rp = conv.analysis_pads(fb.hlen)
    halos = _halos(parts, lp, rp, ring, axis)
    return _by_subband([_one_axis_shard(_kind("ana", axis), x.contiguous(),
                                        b, a, fb)
                        for x, (b, a) in zip(parts, halos)])


def _synthesis_axis_sharded(lo, hi, fb, axis, ring):
    """Upsampling synthesis along ``axis`` of every shard's coefficient
    pair, halos of both exchanged on ``ring`` -> list of shards."""
    L = lo[0].shape[axis]
    lp, rp = conv.synthesis_pads(fb.hlen, L, 2 * L)
    hl, hh = (_halos(p, lp, rp, ring, axis) for p in (lo, hi))
    return [_one_axis_shard(_kind("syn", axis), a.contiguous(),
                            d.contiguous(), (*ha, *hd), fb)
            for a, d, ha, hd in zip(lo, hi, hl, hh)]


def _swt_axis_sharded(parts, fb, level, axis, ring):
    """A-trous analysis along ``axis`` of every shard with dilated halos
    (torch ops, as JAX's ``_swt_last_sharded``) -> (lo, hi) lists."""
    lp, rp = conv.swt_pads(fb.hlen, level, False)
    n = parts[0].shape[axis]
    return _by_subband([conv.swt_analysis_core(
        torch.cat([b, x, a], axis), fb.dec_lo, fb.dec_hi, level, n, axis)
        for x, (b, a) in zip(parts, _halos(parts, lp, rp, ring, axis))])


def _iswt_axis_sharded(lo, hi, fb, level, axis, ring):
    """A-trous synthesis (with the 1/2) along ``axis`` of every shard's
    pair (JAX's ``_iswt_last_sharded``) -> list of shards."""
    lp, rp = conv.swt_pads(fb.hlen, level, True)
    n = lo[0].shape[axis]
    hl, hh = (_halos(p, lp, rp, ring, axis) for p in (lo, hi))
    return [conv.swt_synthesis_core(torch.cat([ha[0], a, ha[1]], axis),
                                    torch.cat([hd[0], d, hd[1]], axis),
                                    fb.rec_lo, fb.rec_hi, level, n, axis)
            for a, d, ha, hd in zip(lo, hi, hl, hh)]


def _local_wavedec2_grid(parts, fb, levels, rings):
    """The grid-sharded pyramid: per level the columns over ``rings.cols``,
    then the rows of both outputs over ``rings.rows``."""
    a = parts
    details = []
    for _ in range(levels):
        t1, t2 = _analysis_axis_sharded(a, fb, -1, rings.cols)
        a, h = _analysis_axis_sharded(t1, fb, -2, rings.rows)
        v, d = _analysis_axis_sharded(t2, fb, -2, rings.rows)
        details.append((h, v, d))
    return [a] + details


def _local_waverec2_grid(coeffs, fb, rings):
    a = coeffs[0]
    for lev in range(len(coeffs) - 1, 0, -1):
        h, v, d = coeffs[lev]
        t1 = _synthesis_axis_sharded(a, h, fb, -2, rings.rows)
        t2 = _synthesis_axis_sharded(v, d, fb, -2, rings.rows)
        a = _synthesis_axis_sharded(t1, t2, fb, -1, rings.cols)
    return a


def _local_swt2_grid(parts, fb, levels, rings):
    """Stationary 2D transform with both axes sharded: a-trous columns over
    the cols rings, then rows over the rows rings (dilated halos on
    each)."""
    a = parts
    details = []
    for lev in range(1, levels + 1):
        t1, t2 = _swt_axis_sharded(a, fb, lev, -1, rings.cols)
        a, h = _swt_axis_sharded(t1, fb, lev, -2, rings.rows)
        v, d = _swt_axis_sharded(t2, fb, lev, -2, rings.rows)
        details.append((h, v, d))
    return [a] + details


def _local_iswt2_grid(coeffs, fb, rings):
    a = coeffs[0]
    for lev in range(len(coeffs) - 1, 0, -1):
        h, v, d = coeffs[lev]
        t1 = _iswt_axis_sharded(a, h, fb, lev, -2, rings.rows)
        t2 = _iswt_axis_sharded(v, d, fb, lev, -2, rings.rows)
        a = _iswt_axis_sharded(t1, t2, fb, lev, -1, rings.cols)
    return a


def _check_grid(nr, nc, levels, n_rows, n_cols):
    if nr % (n_rows << levels) or nc % (n_cols << levels):
        raise ValueError(
            f"({nr}, {nc}) cannot be grid-sharded over ({n_rows}, "
            f"{n_cols}) devices for {levels} levels")


def _grid_shards(image, mesh, rings):
    """(shards, rings) of a grid image: a list of shards as it is (rings
    required without a mesh), a whole tensor or array split over
    ``mesh``."""
    if isinstance(image, (list, tuple)):
        parts = list(image)
    else:
        parts = _ring.shard_grid(image if isinstance(image, torch.Tensor)
                                 else torch.tensor(np.asarray(image)), mesh)
    if rings is None:
        rings = _ring.GridRings.for_mesh(mesh)
    return parts, rings


def wavedec2_gridsharded(image, fb, levels, mesh, rings=None):
    """Multi-level separable 2D forward transform of an image sharded over
    a (rows, cols) mesh in both axes (a whole tensor or array, or its
    row-major list of shards); halos ride each ring.  Returns the sharded
    pyramid; ``rings`` defaults to ``GridRings.for_mesh(mesh)``."""
    if not isinstance(image, (list, tuple)):
        _check_grid(*image.shape[-2:], levels, mesh.shape[ROW_AXIS],
                    mesh.shape[COL_AXIS])
    parts, rings = _grid_shards(image, mesh, rings)
    n_rows, n_cols = rings.rows.axis_size, rings.cols.axis_size
    _check_grid(parts[0].shape[-2] * n_rows, parts[0].shape[-1] * n_cols,
                levels, n_rows, n_cols)
    return _local_wavedec2_grid(parts, fb, levels, rings)


def _grid_coeffs(coeffs, mesh, rings):
    if not isinstance(coeffs[0], (list, tuple)):
        coeffs = _ring.pyramid_to_shards(coeffs, mesh, _ring.shard_grid)
    if rings is None:
        rings = _ring.GridRings.for_mesh(mesh)
    return coeffs, rings


def waverec2_gridsharded(coeffs, fb, mesh, rings=None):
    """Inverse of ``wavedec2_gridsharded`` -> the list of shards."""
    coeffs, rings = _grid_coeffs(coeffs, mesh, rings)
    return _local_waverec2_grid(coeffs, fb, rings)


def swt2d_gridsharded(image, fb, levels, mesh, rings=None):
    """Multi-level stationary 2D transform of a grid-sharded image."""
    parts, rings = _grid_shards(image, mesh, rings)
    return _local_swt2_grid(parts, fb, levels, rings)


def iswt2d_gridsharded(coeffs, fb, mesh, rings=None):
    """Inverse of ``swt2d_gridsharded`` -> the list of shards."""
    coeffs, rings = _grid_coeffs(coeffs, mesh, rings)
    return _local_iswt2_grid(coeffs, fb, rings)


def _local_wavedec1_seq(parts, fb, levels, ring):
    """Shard-local multi-level 1D analysis along the sharded last axis."""
    a, details = parts, []
    for _ in range(levels):
        a, d = _analysis_axis_sharded(a, fb, -1, ring)
        details.append(d)
    return [a] + details


def _local_waverec1_seq(coeffs, fb, ring):
    a = coeffs[0]
    for lev in range(len(coeffs) - 1, 0, -1):
        a = _synthesis_axis_sharded(a, coeffs[lev], fb, -1, ring)
    return a


def _local_swt1_seq(parts, fb, levels, ring):
    """Multi-level a-trous 1D analysis along the sharded last axis (dilated
    halos over the ring, multi-hop for deep levels)."""
    a, details = parts, []
    for lev in range(1, levels + 1):
        a, d = _swt_axis_sharded(a, fb, lev, -1, ring)
        details.append(d)
    return [a] + details


def _local_iswt1_seq(coeffs, fb, ring):
    a = coeffs[0]
    for lev in range(len(coeffs) - 1, 0, -1):
        a = _iswt_axis_sharded(a, coeffs[lev], fb, lev, -1, ring)
    return a


def _seq_shards(x, mesh, ring):
    if isinstance(x, (list, tuple)):
        parts = list(x)
    else:
        parts = _ring.shard_last(x if isinstance(x, torch.Tensor)
                                 else torch.tensor(np.asarray(x)), mesh)
    if ring is None:
        ring = _ring.rows_ring(mesh)
    return parts, ring


def _seq_coeffs(coeffs, mesh, ring):
    if not isinstance(coeffs[0], (list, tuple)):
        coeffs = _ring.pyramid_to_shards(coeffs, mesh, _ring.shard_last)
    return coeffs, (_ring.rows_ring(mesh) if ring is None else ring)


def wavedec1_seqsharded(x, fb, levels, mesh, ring=None):
    """Multi-level 1D transform of a signal (or rows, a leading batch
    axis) whose last axis is sharded over ``mesh``'s rows axis: the
    long-signal (sequence-parallel) configuration.  Returns the sharded
    pyramid [A, D1, ..., DL], each leaf a list of shards."""
    n_shards = mesh.shape[ROW_AXIS] if ring is None else ring.axis_size
    n = (x[0].shape[-1] * n_shards if isinstance(x, (list, tuple))
         else x.shape[-1])
    if n % (n_shards << levels):
        raise ValueError(
            f"signal length {n} cannot be sharded over {n_shards} devices "
            f"for {levels} levels")
    parts, ring = _seq_shards(x, mesh, ring)
    return _local_wavedec1_seq(parts, fb, levels, ring)


def waverec1_seqsharded(coeffs, fb, mesh, ring=None):
    """Inverse of ``wavedec1_seqsharded`` -> the list of shards."""
    coeffs, ring = _seq_coeffs(coeffs, mesh, ring)
    return _local_waverec1_seq(coeffs, fb, ring)


def swt1d_seqsharded(x, fb, levels, mesh, ring=None):
    """Multi-level stationary 1D transform of a signal whose last axis is
    sharded."""
    parts, ring = _seq_shards(x, mesh, ring)
    return _local_swt1_seq(parts, fb, levels, ring)


def iswt1d_seqsharded(coeffs, fb, mesh, ring=None):
    """Inverse of ``swt1d_seqsharded`` -> the list of shards."""
    coeffs, ring = _seq_coeffs(coeffs, mesh, ring)
    return _local_iswt1_seq(coeffs, fb, ring)
