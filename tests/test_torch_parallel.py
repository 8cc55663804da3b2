"""The port's row-sharded layer (``pypwt_tpu_torch.parallel.spatial``)
held against the JAX package on the CPU.

JAX runs on the conftest's 8 simulated CPU devices, the port on meshes of
repeated CPU devices (``make_mesh(..., devices=[cpu] * n)``), where its
kernel wrappers run their plain versions.  Cases are JAX's own
(``tests/test_parallel.py``, ``tests/test_spatial_fused.py``): the path as
a whole against JAX's jnp route (float64, which the conftest enables:
1e-12 forward, 1e-10 roundtrip, as test_parallel.py), and each module that
holds a kernel (K26a/K26b, K27a/K27b, K28) against JAX's Pallas and MXU
sharded kernels in interpret mode under ``set_kernels("pallas")`` /
``("mxu")`` (float32: 3e-5, as test_spatial_fused.py; the banded MXU
forms 5e-5, as there).  Modes are reset in ``finally`` in both packages.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pypwt_tpu.core import dwt as jdwt
from pypwt_tpu.core import swt as jswt
from pypwt_tpu.filters import get_filter_bank as jbank
from pypwt_tpu.ops import mxu_dwt as jmx
from pypwt_tpu.ops import mxu_swt as jmxs
from pypwt_tpu.ops import pallas_dwt as jpk
from pypwt_tpu.parallel import mesh as jmesh
from pypwt_tpu.parallel import spatial as jspatial

from pypwt_tpu_torch import get_filter_bank
from pypwt_tpu_torch.core import dwt as tdwt
from pypwt_tpu_torch.ops import fused_dwt as fd
from pypwt_tpu_torch.ops import mxu_dwt as km
from pypwt_tpu_torch.ops import mxu_swt as kms
from pypwt_tpu_torch.parallel import mesh as pmesh
from pypwt_tpu_torch.parallel import ring as pring
from pypwt_tpu_torch.parallel import spatial

CPU = torch.device("cpu")
RNG = np.random.default_rng(11)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 simulated devices")


def _mesh(n_data, n_rows):
    return pmesh.make_mesh(n_data, n_rows, [CPU] * (n_data * n_rows))


def _leaves(pyr):
    return [pyr[0]] + [s for lev in pyr[1:] for s in lev]


def _close(got_pyr, jax_pyr, atol):
    got = _leaves(pring.pyramid_from_shards(got_pyr))
    ref = _leaves(jax_pyr)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=atol)


def _taps(f):
    return tuple(float(v) for v in np.asarray(f, dtype=np.float64))


# -- the path as a whole against JAX's jnp route (float64) -----------------


@pytest.mark.parametrize("wname", ["db2", "sym4"])
@pytest.mark.parametrize("n_rows", [4, 8])
def test_rowsharded_dwt_matches_jax(wname, n_rows):
    img = RNG.standard_normal((256, 128))
    jm = jmesh.make_mesh(n_data=8 // n_rows, n_rows=n_rows)
    ref = jspatial.wavedec2_rowsharded(jnp.asarray(img), jbank(wname), 2, jm)
    fb = get_filter_bank(wname)
    m = _mesh(1, n_rows)
    pyr = spatial.wavedec2_rowsharded(torch.from_numpy(img), fb, 2, m)
    _close(pyr, ref, 1e-12)
    y = pring.gather_rows(spatial.waverec2_rowsharded(pyr, fb, m))
    np.testing.assert_allclose(y.numpy(), img, atol=1e-10)


@pytest.mark.parametrize("wname, levels", [("db2", 2), ("sym4", 2),
                                           ("db20", 1)])
def test_rowsharded_dwt_8_shards_and_multihop(wname, levels):
    """(128, 64) on 8 shards of 16 rows; db20's 19-row halos take two
    hops."""
    img = RNG.standard_normal((128, 64))
    jm = jmesh.make_mesh(n_data=1, n_rows=8)
    ref = jspatial.wavedec2_rowsharded(jnp.asarray(img), jbank(wname),
                                       levels, jm)
    fb = get_filter_bank(wname)
    m = _mesh(1, 8)
    pyr = spatial.wavedec2_rowsharded(img, fb, levels, m)
    _close(pyr, ref, 1e-12)
    # the coefficients JAX made, sharded for the port's inverse
    back = spatial.waverec2_rowsharded(
        [np.asarray(ref[0])] + [tuple(np.asarray(s) for s in lev)
                                for lev in ref[1:]], fb, m)
    np.testing.assert_allclose(pring.gather_rows(back).numpy(), img,
                               atol=1e-10)


@pytest.mark.parametrize("levels, n_rows", [(2, 4), (4, 8)])
def test_rowsharded_swt_matches_jax(levels, n_rows):
    """db3 SWT of (128, 128): L2 on 4 shards, and L4 on 8 shards of 16
    rows, whose dilated halos need (16, 24) rows: multi-hop."""
    img = RNG.standard_normal((128, 128))
    jm = jmesh.make_mesh(n_data=1, n_rows=n_rows)
    ref = jspatial.swt2d_rowsharded(jnp.asarray(img), jbank("db3"), levels,
                                    jm)
    fb = get_filter_bank("db3")
    m = _mesh(1, n_rows)
    pyr = spatial.swt2d_rowsharded(img, fb, levels, m)
    _close(pyr, ref, 1e-11)
    y = pring.gather_rows(spatial.iswt2d_rowsharded(pyr, fb, m))
    np.testing.assert_allclose(y.numpy(), img, atol=1e-9)


def test_rowsharded_batched_combined():
    """(4, 128, 128) on a 4 data x 2 rows mesh: the batch over data, the
    rows over rows."""
    x = RNG.standard_normal((4, 128, 128))
    jm = jmesh.make_mesh(n_data=4, n_rows=2)
    ref = jspatial.wavedec2_rowsharded(jnp.asarray(x), jbank("db2"), 2, jm)
    fb = get_filter_bank("db2")
    m = _mesh(4, 2)
    pyr = spatial.wavedec2_rowsharded(x, fb, 2, m)
    got = _leaves(pring.pyramid_from_shards(pyr, n_rows=2))
    for g, r in zip(got, _leaves(ref)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-12)
    y = spatial.waverec2_rowsharded(pyr, fb, m, batched=True)
    np.testing.assert_allclose(pring.gather_rows(y, n_rows=2).numpy(), x,
                               atol=1e-10)


def test_check_divisible_errors_match_jax():
    fb = get_filter_bank("db2")
    for shape, n_rows in (((100, 64), 8), ((128, 66), 8)):
        with pytest.raises(ValueError) as jerr:
            jspatial.wavedec2_rowsharded(jnp.zeros(shape), jbank("db2"), 2,
                                         jmesh.make_mesh(1, n_rows))
        with pytest.raises(ValueError) as terr:
            spatial.wavedec2_rowsharded(torch.zeros(shape), fb, 2,
                                        _mesh(1, n_rows))
        assert str(terr.value) == str(jerr.value)


# -- the halo primitives against numpy periodic slices ---------------------


@pytest.mark.parametrize("pad", [0, 1, 5, 16, 17, 40, 70])
def test_halo_rows_are_periodic_slices(pad):
    """Rows before and after each shard, including pads wider than a shard
    (multi-hop) and than the whole plane (hops wrap the ring)."""
    S, n = 4, 16
    x = np.arange(S * n * 3, dtype=np.float64).reshape(S * n, 3)
    parts = pring.shard_rows(torch.from_numpy(x), _mesh(1, S))
    ring = pring.LocalRing([CPU] * S, S)
    before = spatial._rows_before(parts, pad, ring)
    after = spatial._rows_after(parts, pad, ring)
    for i in range(S):
        rows = np.arange(i * n - pad, i * n) % (S * n)
        np.testing.assert_array_equal(before[i].numpy(), x[rows])
        rows = np.arange((i + 1) * n, (i + 1) * n + pad) % (S * n)
        np.testing.assert_array_equal(after[i].numpy(), x[rows])
    hops = -(-pad // n) if pad else 0
    assert ring.counts["ppermute"] == 2 * hops


@pytest.mark.parametrize("lpad, rpad", [(0, 0), (3, 2), (9, 20), (50, 1)])
def test_halo_exchange_last_is_periodic_padding(lpad, rpad):
    S, n = 4, 8
    x = np.arange(2 * S * n, dtype=np.float64).reshape(2, S * n)
    parts = list(torch.from_numpy(x).tensor_split(S, -1))
    out = spatial.halo_exchange_last(parts, lpad, rpad,
                                     pring.LocalRing([CPU] * S, S))
    for i in range(S):
        cols = np.arange(i * n - lpad, (i + 1) * n + rpad) % (S * n)
        np.testing.assert_array_equal(out[i].numpy(), x[:, cols])
    one = spatial.halo_exchange_last([torch.from_numpy(x)], lpad, rpad,
                                     pring.LocalRing([CPU], 1))
    np.testing.assert_array_equal(
        one[0].numpy(), x[:, np.arange(-lpad, S * n + rpad) % (S * n)])


# -- each kernel module against JAX's sharded kernels (interpret mode) -----


def _shard(x, S, i, top, bot):
    n = x.shape[-2] // S
    rows = np.arange(i * n - top, i * n + n + bot) % x.shape[-2]
    ext = x[..., rows, :]
    return ext[..., top:top + n, :], ext[..., :top, :], ext[..., top + n:, :]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("wname", ["db2", "sym4", "db10"])
def test_k26_plain_matches_jax_sharded_kernels(wname):
    """K26a/K26b's plain versions on exact halos against JAX's sharded
    Pallas kernels on their 8-row-rounded bands, shard by shard."""
    S, n, nc = 4, 32, 64
    x = RNG.standard_normal((S * n, nc)).astype(np.float32)
    fb, jfb = get_filter_bank(wname), jbank(wname)
    fj, hh = jpk.build_dwt2d_sharded(n, nc, _taps(jfb.dec_lo),
                                     _taps(jfb.dec_hi), True)
    lp, rp = fd.halo_heights("dwt", fb, n)
    coeffs = []
    for i in range(S):
        b, t, o = _shard(x, S, i, hh, hh)
        ref = fj(jnp.asarray(b), jnp.asarray(t), jnp.asarray(o))
        b, t, o = _shard(x, S, i, lp, rp)
        got = fd.dwt2d_sharded_plain(_t(b), _t(t), _t(o), fb)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=3e-5)
        coeffs.append([np.asarray(r) for r in ref])
    planes = [np.concatenate([c[k] for c in coeffs], 0) for k in range(4)]
    gj, hj = jpk.build_idwt2d_sharded(n, nc, _taps(jfb.rec_lo),
                                      _taps(jfb.rec_hi), True)
    L = n // 2
    lpi, rpi = fd.halo_heights("idwt", fb, L)
    for i in range(S):
        parts = [_shard(p, S, i, hj, hj) for p in planes]
        ref = gj(*(jnp.asarray(p[0]) for p in parts),
                 tuple(jnp.asarray(h) for p in parts for h in p[1:]))
        parts = [_shard(p, S, i, lpi, rpi) for p in planes]
        got = fd.idwt2d_sharded_plain(*(_t(p[0]) for p in parts),
                                      tuple(_t(h) for p in parts
                                            for h in p[1:]), fb)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-5)


@pytest.mark.parametrize("level", [1, 2])
def test_k27_plain_matches_jax_sharded_kernels(level):
    S, n, nc = 4, 32, 128
    wname = "db3"
    x = RNG.standard_normal((S * n, nc)).astype(np.float32)
    fb, jfb = get_filter_bank(wname), jbank(wname)
    fj, hh = jpk.build_swt2d_sharded(n, nc, _taps(jfb.dec_lo),
                                     _taps(jfb.dec_hi), level, True)
    gj, hj = jpk.build_iswt2d_sharded(n, nc, _taps(jfb.rec_lo),
                                      _taps(jfb.rec_hi), level, True)
    coeffs = []
    for i in range(S):
        b, t, o = _shard(x, S, i, hh, hh)
        ref = fj(jnp.asarray(b), jnp.asarray(t), jnp.asarray(o))
        b, t, o = _shard(x, S, i, *fd.halo_heights("swt", fb, n, level))
        got = fd.swt2d_sharded_plain(_t(b), _t(t), _t(o), fb, level)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=3e-5)
        coeffs.append([np.asarray(r) for r in ref])
    planes = [np.concatenate([c[k] for c in coeffs], 0) for k in range(4)]
    for i in range(S):
        parts = [_shard(p, S, i, hj, hj) for p in planes]
        ref = gj(*(jnp.asarray(p[0]) for p in parts),
                 tuple(jnp.asarray(h) for p in parts for h in p[1:]))
        parts = [_shard(p, S, i, *fd.halo_heights("iswt", fb, n, level))
                 for p in planes]
        got = fd.iswt2d_sharded_plain(*(_t(p[0]) for p in parts),
                                      tuple(_t(h) for p in parts
                                            for h in p[1:]), fb, level)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-5)


@pytest.mark.parametrize("wname", ["sym8", "db10"])
def test_k28_dwt_plain_matches_jax_sharded_mxu_kernels(wname):
    S, n, nc = 4, 64, 128
    x = RNG.standard_normal((S * n, nc)).astype(np.float32)
    fb, jfb = get_filter_bank(wname), jbank(wname)
    fj, hh = jmx.build_dwt2d_sharded_mxu(n, nc, _taps(jfb.dec_lo),
                                         _taps(jfb.dec_hi), True)
    gj, hj = jmx.build_idwt2d_sharded_mxu(n, nc, _taps(jfb.rec_lo),
                                          _taps(jfb.rec_hi), True)
    coeffs = []
    for i in range(S):
        b, t, o = _shard(x, S, i, hh, hh)
        ref = fj(jnp.asarray(b), jnp.asarray(t), jnp.asarray(o))
        b, t, o = _shard(x, S, i, *fd.halo_heights("dwt", fb, n))
        got = km.dwt2d_sharded_mxu_plain(_t(b), _t(t), _t(o), fb)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=5e-5)
        coeffs.append([np.asarray(r) for r in ref])
    planes = [np.concatenate([c[k] for c in coeffs], 0) for k in range(4)]
    L = n // 2
    for i in range(S):
        parts = [_shard(p, S, i, hj, hj) for p in planes]
        ref = gj(*(jnp.asarray(p[0]) for p in parts),
                 tuple(jnp.asarray(h) for p in parts for h in p[1:]))
        parts = [_shard(p, S, i, *fd.halo_heights("idwt", fb, L))
                 for p in planes]
        got = km.idwt2d_sharded_mxu_plain(*(_t(p[0]) for p in parts),
                                          tuple(_t(h) for p in parts
                                                for h in p[1:]), fb)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-5)


# wname, shards, shard rows, columns, level, batch
K28_SWT_CASES = [
    ("sym8", 4, 32, 128, 1, ()),
    ("sym8", 4, 16, 96, 2, ()),   # 16-row shards: halos from two neighbours
    ("db2", 4, 32, 64, 4, ()),    # level 4
    ("sym8", 3, 20, 24, 1, ()),   # a shard under one 32 x 32 tile
    ("db4", 2, 32, 64, 1, (3,)),  # a batch of 3 planes
]


def _jax_jnp(fn, *args):
    jdwt.set_kernels("jnp")
    try:
        return fn(*args)
    finally:
        jdwt.set_kernels("auto")


@pytest.mark.parametrize("k", range(len(K28_SWT_CASES)))
def test_k28_swt_plain_matches_jax_sharded_mxu_kernels(k):
    """K28's stationary plain versions, shard by shard, against JAX's
    sharded MXU kernels on their own halo bands, plane by plane; where JAX
    builds no kernel (a shard under its band), against its jnp level of
    the whole plane, cut into shards."""
    wname, S, n, nc, level, batch = K28_SWT_CASES[k]
    # the first case draws from the module's RNG, as it always has
    rng = RNG if k == 0 else np.random.default_rng(100 + k)
    x = rng.standard_normal((*batch, S * n, nc)).astype(np.float32)
    fb, jfb = get_filter_bank(wname), jbank(wname)
    ana = jmxs.build_swt2d_sharded_mxu(n, nc, _taps(jfb.dec_lo),
                                       _taps(jfb.dec_hi), level, True)
    syn = jmxs.build_iswt2d_sharded_mxu(n, nc, _taps(jfb.rec_lo),
                                        _taps(jfb.rec_hi), level, True)

    def per_plane(fn, planes):
        """fn on each plane of the batch, stacked back to its shape."""
        flat = [p.reshape(-1, S * n, nc) for p in planes]
        outs = [fn(*(p[j] for p in flat)) for j in range(len(flat[0]))]
        if isinstance(outs[0], list):
            return [np.stack([o[q] for o in outs]).reshape(
                *batch, S * n, nc) for q in range(len(outs[0]))]
        return np.stack(outs).reshape(*batch, S * n, nc)

    def jax_ana(xp):
        if ana is None:
            return [np.asarray(r) for r in _jax_jnp(
                jswt.swt2d_level, jnp.asarray(xp), jfb, level)]
        fj, hh = ana
        outs = [fj(*(jnp.asarray(t) for t in _shard(xp, S, i, hh, hh)))
                for i in range(S)]
        return [np.concatenate([np.asarray(o[q]) for o in outs], 0)
                for q in range(4)]

    def jax_syn(*c):
        if syn is None:
            return np.asarray(_jax_jnp(jswt.iswt2d_level,
                                       *(jnp.asarray(p) for p in c), jfb,
                                       level))
        gj, hj = syn
        outs = []
        for i in range(S):
            parts = [_shard(p, S, i, hj, hj) for p in c]
            outs.append(np.asarray(gj(
                *(jnp.asarray(p[0]) for p in parts),
                tuple(jnp.asarray(h) for p in parts for h in p[1:]))))
        return np.concatenate(outs, 0)

    coeffs = per_plane(jax_ana, [x])
    for i in range(S):
        b, t, o = _shard(x, S, i, *fd.halo_heights("swt", fb, n, level))
        got = kms.swt2d_sharded_mxu_plain(_t(b), _t(t), _t(o), fb, level)
        for g, r in zip(got, coeffs):
            np.testing.assert_allclose(g.numpy(), r[..., i * n:(i + 1) * n, :],
                                       atol=5e-5)
    ref = per_plane(jax_syn, coeffs)
    for i in range(S):
        parts = [_shard(p, S, i, *fd.halo_heights("iswt", fb, n, level))
                 for p in coeffs]
        got = kms.iswt2d_sharded_mxu_plain(*(_t(p[0]) for p in parts),
                                           tuple(_t(h) for p in parts
                                                 for h in p[1:]), fb, level)
        np.testing.assert_allclose(got.numpy(), ref[..., i * n:(i + 1) * n, :],
                                   atol=5e-5)


# -- the path in kernel modes, against JAX in the same modes ---------------


@pytest.fixture
def both_modes():
    def set_both(jmode, tmode):
        jdwt.set_kernels(jmode)
        tdwt.set_kernels(tmode)
    try:
        yield set_both
    finally:
        jdwt.set_kernels("auto")
        tdwt.set_kernels("auto")


@pytest.mark.parametrize("wname", ["db2", "sym8"])
def test_rowsharded_path_in_kernel_modes_matches_jax(both_modes, wname):
    """(256, 128) float32 L2 on 4 shards: JAX's sharded Pallas kernels
    (set_kernels("pallas"), or "mxu" for sym8) against the port in the
    matching mode (K26's plain version, K28's banded one)."""
    mode = "mxu" if wname == "sym8" else "pallas"
    img = RNG.standard_normal((256, 128)).astype(np.float32)
    both_modes(mode, "mxu" if mode == "mxu" else "auto")
    ref = jspatial.wavedec2_rowsharded(jnp.asarray(img), jbank(wname), 2,
                                       jmesh.make_mesh(2, 4))
    yj = jspatial.waverec2_rowsharded(ref, jbank(wname),
                                      jmesh.make_mesh(2, 4))
    fb = get_filter_bank(wname)
    m = _mesh(1, 4)
    pyr = spatial.wavedec2_rowsharded(img, fb, 2, m)
    tol = 5e-5 if mode == "mxu" else 3e-5
    _close(pyr, ref, tol)
    y = pring.gather_rows(spatial.waverec2_rowsharded(pyr, fb, m))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=tol)
    np.testing.assert_allclose(y.numpy(), img, atol=tol)


def test_rowsharded_swt_pallas_and_batched_fused(both_modes):
    """JAX's sharded Pallas SWT (db3 L2) and the batched (4, 128, 128) DWT
    on a 4 x 2 mesh against the port."""
    both_modes("pallas", "auto")
    img = RNG.standard_normal((128, 128)).astype(np.float32)
    ref = jspatial.swt2d_rowsharded(jnp.asarray(img), jbank("db3"), 2,
                                    jmesh.make_mesh(2, 4))
    pyr = spatial.swt2d_rowsharded(img, get_filter_bank("db3"), 2,
                                   _mesh(1, 4))
    _close(pyr, ref, 3e-5)
    x = RNG.standard_normal((4, 128, 128)).astype(np.float32)
    ref = jspatial.wavedec2_rowsharded(jnp.asarray(x), jbank("db2"), 2,
                                       jmesh.make_mesh(4, 2))
    pyr = spatial.wavedec2_rowsharded(x, get_filter_bank("db2"), 2,
                                      _mesh(4, 2))
    got = _leaves(pring.pyramid_from_shards(pyr, n_rows=2))
    for g, r in zip(got, _leaves(ref)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=3e-5)


def test_routes_decided_before_launch(both_modes):
    """A ring of one shard takes the unsharded level (as JAX); mode "mxu"
    sends a level K28 does not cover (haar) to K26, and mode "cuda" on a
    CPU tensor raises."""
    x = torch.from_numpy(RNG.standard_normal((64, 32)).astype(np.float32))
    fb = get_filter_bank("db2")
    one = spatial.wavedec2_rowsharded(x, fb, 2, _mesh(1, 1))
    ref = tdwt.wavedec2(x, fb, 2)
    for g, r in zip(_leaves(pring.pyramid_from_shards(one)), _leaves(ref)):
        assert torch.equal(g, r)
    parts = pring.shard_rows(x, _mesh(1, 4))
    t, b = (torch.zeros((0, 32)),) * 2
    assert km.dwt2d_sharded_mxu_unsupported(parts[0], t, b,
                                            get_filter_bank("haar"))
    assert fd.dwt2d_sharded_unsupported(parts[0], t, b,
                                        get_filter_bank("haar")) is None
    both_modes("auto", "cuda")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        spatial.wavedec2_rowsharded(x, fb, 2, _mesh(1, 4))


def test_meshes_never_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.make_mesh2d(2, 2)
    m = pmesh.make_mesh(2, 2, [CPU] * 4)
    assert m.shape == {"data": 2, "rows": 2}
    assert pmesh.make_mesh(devices=[CPU] * 8).shape["data"] == 8
