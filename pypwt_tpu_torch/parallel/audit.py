"""Exchange-schedule audit: the structural scaling claim of the row-sharded
path, counted on the port's own exchange layer (the port of the row-sharded
part of ``pypwt_tpu.parallel.audit``, which read the same schedule from
compiled HLO).

The row-sharded transforms (``parallel.spatial``) promise a communication
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
replaces it until one is measured.  The grid and sequence predictions come
with their layouts, a later slice (ROADMAP.md).
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


def _hops(pad: int, n: int) -> int:
    return 0 if pad <= 0 else -(-pad // n)


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
