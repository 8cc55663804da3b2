"""Exchange-schedule audit: the structural scaling claim of the sharded
paths (row, grid and sequence layouts), counted on the port's own exchange
layer (the port of ``pypwt_tpu.parallel.audit``, which read the same
schedule from compiled HLO).

The sharded transforms (``parallel.spatial``) promise a communication
pattern: per level a fixed number of ring-neighbour ``ppermute`` exchanges
of halo-sized operands (a few rows), and no all-gather, all-to-all or
all-reduce anywhere in a transform; the only all-reduce is one per norm.
Halo bytes per shard do not depend on the number of shards, so per-device
work stays constant as the ring grows.  ``predict_rowsharded`` states the
exact schedule from the halo geometry (the hop arithmetic of
``spatial._collect``), and ``schedule_of(ring)`` reads what a ring counted
(``parallel.ring``); the tests and ``chip_smoke.py`` hold one to the
other.

The port's halos are the exact pads of each level; JAX's kernels took
bands rounded up to 8 rows (``pallas_dwt._pick_bands``), so its
``predict_rowsharded`` under ``set_kernels("pallas")`` counts the same
exchanges only where both heights need the same hops (and the haar bank,
whose pads are 0, exchanges nothing here).  JAX's interconnect cost model
(``ICI_BW``, ``ICI_LATENCY``, ``predict_efficiency``) holds a TPU's link
figures and is not carried over; no link figure of the port's hardware
replaces it until one is measured.  The grid and sequence layouts
exchange exactly the pads of each one-axis pass, as JAX's do, so their
predictions are JAX's; a ring of one shard wraps locally and exchanges
nothing (JAX's ``axis_size == 1``).
"""

from __future__ import annotations

from ..core import conv
from . import ring as _ring
from . import spatial


def schedule_of(ring) -> dict:
    """The collective counts a ring made since its last ``reset()``, and
    the elements one shard sent in each ppermute (sorted)."""
    out = dict(ring.counts)
    out["ppermute_elems"] = sorted(ring.ppermute_elems)
    return out


def rowsharded_fns(fb, levels, mesh, swt=False):
    """(forward, inverse) of the row-sharded path on ``mesh`` (one image
    over its rows axis), sharing one ``LocalRing`` (``forward.ring``):
    forward takes the whole image or its shards and returns the sharded
    pyramid, inverse takes that and returns the shards."""
    ring = _ring.LocalRing.for_mesh(mesh, batched=False)

    def forward(x):
        parts, _ = spatial._shards(x, mesh, ring)
        if swt:
            return spatial._local_swt2(parts, fb, levels, ring)
        return spatial._local_wavedec2(parts, fb, levels, ring)

    def inverse(coeffs):
        if swt:
            return spatial._local_iswt2(coeffs, fb, ring)
        return spatial._local_waverec2(coeffs, fb, ring)

    forward.ring = inverse.ring = ring
    return forward, inverse


def gridsharded_fns(fb, levels, mesh, swt=False):
    """(forward, inverse) of the grid-sharded path on a ``make_mesh2d``
    mesh, sharing one ``GridRings`` (``forward.ring``)."""
    rings = _ring.GridRings.for_mesh(mesh)

    def forward(x):
        parts, _ = spatial._grid_shards(x, mesh, rings)
        if swt:
            return spatial._local_swt2_grid(parts, fb, levels, rings)
        return spatial._local_wavedec2_grid(parts, fb, levels, rings)

    def inverse(coeffs):
        if swt:
            return spatial._local_iswt2_grid(coeffs, fb, rings)
        return spatial._local_waverec2_grid(coeffs, fb, rings)

    forward.ring = inverse.ring = rings
    return forward, inverse


def seqsharded_fns(fb, levels, mesh):
    """(forward, inverse) of the sequence-sharded 1D path over ``mesh``'s
    rows axis, sharing one ``LocalRing`` (``forward.ring``)."""
    ring = _ring.rows_ring(mesh)

    def forward(x):
        parts, _ = spatial._seq_shards(x, mesh, ring)
        return spatial._local_wavedec1_seq(parts, fb, levels, ring)

    def inverse(coeffs):
        return spatial._local_waverec1_seq(coeffs, fb, ring)

    forward.ring = inverse.ring = ring
    return forward, inverse


def seqsharded_swt_fns(fb, levels, mesh):
    """(forward, inverse) of the sequence-sharded stationary 1D path."""
    ring = _ring.rows_ring(mesh)

    def forward(x):
        parts, _ = spatial._seq_shards(x, mesh, ring)
        return spatial._local_swt1_seq(parts, fb, levels, ring)

    def inverse(coeffs):
        return spatial._local_iswt1_seq(coeffs, fb, ring)

    forward.ring = inverse.ring = ring
    return forward, inverse


def _hops(pad: int, n: int) -> int:
    return 0 if pad <= 0 else -(-pad // n)


def _both(pads, n, shards):
    """Hops of one exchange of (before, after) ``pads`` on shards of ``n``
    samples, none on a ring of one."""
    return 0 if shards == 1 else _hops(pads[0], n) + _hops(pads[1], n)


def predict_rowsharded(fb, levels, Nr, Nc, n_shards, swt=False):
    """Exact ppermute counts (forward, inverse) of the row-sharded path on
    ``n_shards`` row shards of an (Nr, Nc) image, and the halo bytes one
    shard receives in the forward transform of float32 data (top and
    bottom).  Per level
    the forward exchanges the input plane once each way; the inverse each
    of the four coefficient planes.  One shard exchanges nothing (the
    unsharded kernels)."""
    fwd = inv = halo_bytes = 0
    if n_shards == 1:
        return {"fwd_ppermute": 0, "inv_ppermute": 0, "fwd_halo_bytes": 0}
    for i in range(levels):
        lev = i + 1
        if swt:
            n, c = Nr // n_shards, Nc
            lp, rp = conv.swt_pads(fb.hlen, lev, False)
            lpi, rpi = conv.swt_pads(fb.hlen, lev, True)
            ni = n
        else:
            n, c = (Nr // n_shards) >> i, Nc >> i
            lp, rp = conv.analysis_pads(fb.hlen)
            ni = n // 2  # the inverse exchanges the next-coarser level's
            lpi, rpi = conv.synthesis_pads(fb.hlen, ni, n)
        fwd += _hops(lp, n) + _hops(rp, n)
        halo_bytes += (lp + rp) * c * 4
        inv += 4 * (_hops(lpi, ni) + _hops(rpi, ni))
    return {"fwd_ppermute": fwd, "inv_ppermute": inv,
            "fwd_halo_bytes": halo_bytes}


def predict_gridsharded(fb, levels, Nr, Nc, n_rows, n_cols):
    """Exact ppermute counts of the grid-sharded path: per level one column
    exchange on the image plus two row exchanges on the column outputs
    (forward); four row and two column coefficient exchanges (inverse)."""
    fwd = inv = 0
    pads = conv.analysis_pads(fb.hlen)
    for i in range(levels):
        nr = (Nr // n_rows) >> i
        nc = (Nc // n_cols) >> i
        fwd += _both(pads, nc, n_cols) + 2 * _both(pads, nr, n_rows)
        inv += 4 * _both(conv.synthesis_pads(fb.hlen, nr // 2, nr), nr // 2,
                         n_rows)
        inv += 2 * _both(conv.synthesis_pads(fb.hlen, nc // 2, nc), nc // 2,
                         n_cols)
    return {"fwd_ppermute": fwd, "inv_ppermute": inv}


def predict_gridsharded_swt(fb, levels, Nr, Nc, n_rows, n_cols):
    """Exact ppermute counts of the grid-sharded stationary path: the
    a-trous halos dilate by 2^(level-1); per level one column exchange on
    the undecimated image plus two row exchanges (forward), four row and two
    column plane exchanges (inverse)."""
    fwd = inv = 0
    nr, nc = Nr // n_rows, Nc // n_cols  # undecimated: constant
    for lev in range(1, levels + 1):
        pads = conv.swt_pads(fb.hlen, lev, False)
        fwd += _both(pads, nc, n_cols) + 2 * _both(pads, nr, n_rows)
        pads = conv.swt_pads(fb.hlen, lev, True)
        inv += 4 * _both(pads, nr, n_rows) + 2 * _both(pads, nc, n_cols)
    return {"fwd_ppermute": fwd, "inv_ppermute": inv}


def predict_seqsharded(fb, levels, N, n_shards):
    """Exact ppermute counts of the sequence-sharded 1D path (a signal's
    last axis split over the ring): one exchange of the input per level
    forward, of both coefficient planes inverse."""
    fwd = inv = 0
    for i in range(levels):
        n = (N // n_shards) >> i
        fwd += _both(conv.analysis_pads(fb.hlen), n, n_shards)
        inv += 2 * _both(conv.synthesis_pads(fb.hlen, n // 2, n), n // 2,
                         n_shards)
    return {"fwd_ppermute": fwd, "inv_ppermute": inv}


def predict_seqsharded_swt(fb, levels, N, n_shards):
    """Exact ppermute counts of the sequence-sharded stationary 1D path:
    one dilated exchange per level forward, two plane exchanges per level
    on the synthesis."""
    fwd = inv = 0
    n = N // n_shards  # undecimated: constant per level
    for lev in range(1, levels + 1):
        fwd += _both(conv.swt_pads(fb.hlen, lev, False), n, n_shards)
        inv += 2 * _both(conv.swt_pads(fb.hlen, lev, True), n, n_shards)
    return {"fwd_ppermute": fwd, "inv_ppermute": inv}
