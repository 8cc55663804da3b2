"""The port's grid and sequence layouts (``pypwt_tpu_torch.parallel.
spatial``: both image axes sharded; one long signal sharded along its
samples) held against the JAX package on the CPU.

JAX runs on the conftest's 8 simulated CPU devices, the port on meshes of
repeated CPU devices, where its kernel wrappers run their plain versions.
Cases are JAX's own (``tests/test_spatial_grid.py``): the layouts against
the unsharded core and against JAX's ``*_gridsharded`` / ``*_seqsharded``
(float32 at 1e-5, JAX's tolerance; float64 against JAX's jnp route at
1e-12 forward, 1e-10 roundtrip), and each K29 plain version against JAX's
``build_*_padded_*`` kernels in interpret mode (3e-5) and their ``_mxu``
twins (5e-5), as ``tests/test_torch_parallel.py`` holds K26-K28.  The
halo primitives and the global rolls are held against numpy periodic
slices.  Modes are reset in ``finally`` in both packages.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pypwt_tpu.core import dwt as jdwt
from pypwt_tpu.filters import get_filter_bank as jbank
from pypwt_tpu.ops import mxu_dwt as jmx
from pypwt_tpu.ops import pallas_dwt as jpk
from pypwt_tpu.parallel import mesh as jmesh
from pypwt_tpu.parallel import spatial as jspatial

from pypwt_tpu_torch import get_filter_bank
from pypwt_tpu_torch.core import conv
from pypwt_tpu_torch.core import dwt as tdwt
from pypwt_tpu_torch.core import swt as tswt
from pypwt_tpu_torch.ops import fused_dwt as fd
from pypwt_tpu_torch.ops import mxu_dwt as km
from pypwt_tpu_torch.parallel import mesh as pmesh
from pypwt_tpu_torch.parallel import ring as pring
from pypwt_tpu_torch.parallel import spatial

CPU = torch.device("cpu")
RNG = np.random.default_rng(29)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 simulated devices")


def _grid(n_rows, n_cols):
    return pmesh.make_mesh2d(n_rows, n_cols, [CPU] * (n_rows * n_cols))


def _rows(n):
    return pmesh.make_mesh(1, n, [CPU] * n)


def _leaves(pyr):
    return [pyr[0]] + [s for lev in pyr[1:]
                       for s in (lev if isinstance(lev, (tuple, list))
                                 else (lev,))]


def _whole_grid(pyr, n_cols):
    return _leaves(pring.pyramid_from_shards(
        pyr, gather=lambda p: pring.gather_grid(p, n_cols)))


def _whole_seq(pyr):
    return _leaves(pring.pyramid_from_shards(pyr, gather=pring.gather_last))


def _close(got, ref, atol):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r), atol=atol)


def _taps(f):
    return tuple(float(v) for v in np.asarray(f, dtype=np.float64))


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


# -- the layouts against the unsharded core and JAX (test_spatial_grid.py) --


def test_gridsharded_matches_local():
    fb = get_filter_bank("db3")
    x = np.random.default_rng(0).random((64, 128)).astype(np.float32)
    pyr = spatial.wavedec2_gridsharded(torch.from_numpy(x), fb, 2,
                                       _grid(2, 2))
    want = tdwt.wavedec2(torch.from_numpy(x), fb, 2)
    _close(_whole_grid(pyr, 2), _leaves(want), 1e-5)
    ref = jspatial.wavedec2_gridsharded(
        jnp.asarray(x), jbank("db3"), 2, jmesh.make_mesh2d(
            2, 2, devices=jax.devices()[:4]))
    _close(_whole_grid(pyr, 2), jax.tree_util.tree_leaves(ref), 1e-5)
    y = pring.gather_grid(spatial.waverec2_gridsharded(pyr, fb, _grid(2, 2)),
                          2)
    np.testing.assert_allclose(y.numpy(), x, atol=1e-5)


def test_gridsharded_batched_leading_axis():
    fb = get_filter_bank("haar")
    x = np.random.default_rng(1).random((32, 64)).astype(np.float32)
    m = _grid(2, 4)
    c = spatial.wavedec2_gridsharded(x, fb, 2, m)
    y = pring.gather_grid(spatial.waverec2_gridsharded(c, fb, m), 4)
    np.testing.assert_allclose(y.numpy(), x, atol=1e-5)


def test_grid_divisibility_error():
    x = np.zeros((30, 64), np.float32)
    with pytest.raises(ValueError):
        jspatial.wavedec2_gridsharded(
            jnp.asarray(x), jbank("db2"), 2,
            jmesh.make_mesh2d(2, 2, devices=jax.devices()[:4]))
    with pytest.raises(ValueError, match="grid-sharded"):
        spatial.wavedec2_gridsharded(x, get_filter_bank("db2"), 2,
                                     _grid(2, 2))
    with pytest.raises(ValueError, match="signal length"):
        spatial.wavedec1_seqsharded(np.zeros(100, np.float32),
                                    get_filter_bank("db2"), 2, _rows(8))


def test_seqsharded_1d_matches_local():
    fb = get_filter_bank("db4")
    x = np.random.default_rng(2).random(1024).astype(np.float32)
    pyr = spatial.wavedec1_seqsharded(x, fb, 3, _rows(8))
    _close(_whole_seq(pyr), tdwt.wavedec1(torch.from_numpy(x), fb, 3), 1e-5)
    ref = jspatial.wavedec1_seqsharded(jnp.asarray(x), jbank("db4"), 3,
                                       jmesh.make_mesh(n_data=1, n_rows=8))
    _close(_whole_seq(pyr), ref, 1e-5)
    y = pring.gather_last(spatial.waverec1_seqsharded(pyr, fb, _rows(8)))
    np.testing.assert_allclose(y.numpy(), x, atol=1e-5)


def test_seqsharded_batched_rows():
    """JAX's leading batch axis: (6, 256) signals over 4 shards."""
    fb = get_filter_bank("db2")
    x = np.random.default_rng(3).random((6, 256)).astype(np.float32)
    pyr = spatial.wavedec1_seqsharded(x, fb, 2, _rows(4))
    ref = jspatial.wavedec1_seqsharded(jnp.asarray(x), jbank("db2"), 2,
                                       jmesh.make_mesh(n_data=1, n_rows=4))
    _close(_whole_seq(pyr), ref, 1e-5)
    y = pring.gather_last(spatial.waverec1_seqsharded(pyr, fb, _rows(4)))
    np.testing.assert_allclose(y.numpy(), x, atol=1e-5)


def test_gridsharded_mxu_wide_filter(both_modes):
    """sym8 on the grid in mode "mxu" in both packages: the banded forms
    (JAX's padded-core MXU kernels, the port's K29e-K29h plain versions)
    against the core, and against each other."""
    fb = get_filter_bank("sym8")
    x = np.random.default_rng(3).random((128, 256)).astype(np.float32)
    both_modes("mxu", "mxu")
    jm = jmesh.make_mesh2d(2, 2, devices=jax.devices()[:4])
    ref = jspatial.wavedec2_gridsharded(jnp.asarray(x), jbank("sym8"), 2, jm)
    yj = jspatial.waverec2_gridsharded(ref, jbank("sym8"), jm)
    pyr = spatial.wavedec2_gridsharded(x, fb, 2, _grid(2, 2))
    y = pring.gather_grid(spatial.waverec2_gridsharded(pyr, fb, _grid(2, 2)),
                          2)
    both_modes("auto", "auto")
    want = tdwt.wavedec2(torch.from_numpy(x), fb, 2)
    _close(_whole_grid(pyr, 2), _leaves(want), 5e-5)
    _close(_whole_grid(pyr, 2), jax.tree_util.tree_leaves(ref), 5e-5)
    np.testing.assert_allclose(y.numpy(), x, atol=5e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=5e-5)


def test_padded_core_mxu_coverage():
    """The tensor-core forms cover the exact pads the layouts produce, at
    JAX's coverage (an even bank of 4+ taps), and refuse anything else."""
    fb = get_filter_bank("sym8")
    x = torch.zeros((64, 128))
    lp, rp = conv.analysis_pads(fb.hlen)
    left, right = torch.zeros((64, lp)), torch.zeros((64, rp))
    assert km.ana_lanes_mxu_unsupported(x, left, right, fb) is None
    assert km.ana_lanes_mxu_unsupported(x, left, torch.zeros((64, rp + 2)),
                                        fb)
    assert km.ana_lanes_mxu_unsupported(x, left[:, :0], right[:, :0],
                                        get_filter_bank("haar"))
    assert fd.ana_lanes_unsupported(x, left[:, :0], right[:, :0],
                                    get_filter_bank("haar")) is None
    L = 64
    lpi, rpi = conv.synthesis_pads(fb.hlen, L, 2 * L)
    c = torch.zeros((L, 128))
    halos = (torch.zeros((lpi, 128)), torch.zeros((rpi, 128))) * 2
    assert km.syn_rows_mxu_unsupported(c, c, halos, fb) is None
    assert km.syn_rows_mxu_unsupported(c.double(), c.double(),
                                       tuple(h.double() for h in halos), fb)
    assert fd.syn_rows_unsupported(c.double(), c.double(),
                                   tuple(h.double() for h in halos),
                                   fb) is None


# -- each K29 plain version against JAX's padded-core kernels --------------


def _lane_parts(xp, lp, rp):
    n = xp.shape[-1] - lp - rp
    return (torch.from_numpy(np.ascontiguousarray(xp[..., lp:lp + n])),
            torch.from_numpy(np.ascontiguousarray(xp[..., :lp])),
            torch.from_numpy(np.ascontiguousarray(xp[..., lp + n:])))


def _row_parts(xp, lp, rp):
    parts = _lane_parts(np.swapaxes(xp, -1, -2), lp, rp)
    return tuple(p.transpose(-1, -2).contiguous() for p in parts)


@pytest.mark.parametrize("wname", ["db2", "sym4", "db10"])
def test_k29_lanes_plain_match_jax_padded_kernels(wname):
    """K29a/K29b against ``build_ana_padded_lanes`` /
    ``build_syn_padded_lanes`` (interpret mode) on arrays padded by the
    exact pads, and K29e/K29f against their MXU twins."""
    fb, jfb = get_filter_bank(wname), jbank(wname)
    nr, L = 8, 64
    lp, rp = conv.analysis_pads(fb.hlen)
    xp = RNG.standard_normal((nr, 2 * L + lp + rp)).astype(np.float32)
    body, left, right = _lane_parts(xp, lp, rp)
    fj = jpk.build_ana_padded_lanes(nr, xp.shape[1], L, _taps(jfb.dec_lo),
                                    _taps(jfb.dec_hi), True)
    ref = fj(jnp.asarray(xp))
    _close(fd.ana_lanes_plain(body, left, right, fb), ref, 3e-5)
    fm = jmx.build_ana_padded_lanes_mxu(nr, xp.shape[1], L,
                                        _taps(jfb.dec_lo), _taps(jfb.dec_hi),
                                        True)
    _close(km.ana_lanes_mxu_plain(body, left, right, fb), fm(jnp.asarray(xp)),
           5e-5)
    lpi, rpi = conv.synthesis_pads(fb.hlen, L, 2 * L)
    ap, dp = (RNG.standard_normal((nr, L + lpi + rpi)).astype(np.float32)
              for _ in range(2))
    (a, al, ar), (d, dl, dr) = (_lane_parts(p, lpi, rpi) for p in (ap, dp))
    gj = jpk.build_syn_padded_lanes(nr, ap.shape[1], 2 * L, lpi,
                                    _taps(jfb.rec_lo), _taps(jfb.rec_hi),
                                    True)
    ref = gj(jnp.asarray(ap), jnp.asarray(dp))
    np.testing.assert_allclose(
        fd.syn_lanes_plain(a, d, (al, ar, dl, dr), fb).numpy(),
        np.asarray(ref), atol=3e-5)
    gm = jmx.build_syn_padded_lanes_mxu(nr, ap.shape[1], 2 * L, lpi,
                                        _taps(jfb.rec_lo), _taps(jfb.rec_hi),
                                        True)
    np.testing.assert_allclose(
        km.syn_lanes_mxu_plain(a, d, (al, ar, dl, dr), fb).numpy(),
        np.asarray(gm(jnp.asarray(ap), jnp.asarray(dp))), atol=5e-5)


# (bank, coefficient rows L, columns nc): haar to sym20 (h2 1 to 20), L not
# a multiple of 32 (K29d's tile rows) and one 8-row shard whose sym20
# halos (10 rows) are wider than it, nc % 4 of 1, 2 and 3. JAX's
# padded-core kernels take nc in whole 128-lane blocks; the other widths
# are held against their bodies (``_analysis_sub`` / ``_synthesis_sub``,
# jnp), which the kernels run per block.
@pytest.mark.parametrize("wname, L, nc", [
    pytest.param("db2", 32, 128, id="db2"),
    pytest.param("sym4", 32, 128, id="sym4"),
    pytest.param("db10", 32, 128, id="db10"),
    pytest.param("haar", 37, 128, id="haar-37x128"),
    pytest.param("sym20", 45, 256, id="sym20-45x256"),
    pytest.param("sym20", 8, 129, id="sym20-8x129"),
    pytest.param("db2", 37, 130, id="db2-37x130"),
    pytest.param("sym8", 33, 131, id="sym8-33x131")])
def test_k29_rows_plain_match_jax_padded_kernels(wname, L, nc):
    """K29c/K29d against ``build_ana_padded_rows`` /
    ``build_syn_padded_rows`` (interpret mode), K29g/K29h against their
    MXU twins where those take the bank and width."""
    fb, jfb = get_filter_bank(wname), jbank(wname)
    flo, fhi = _taps(jfb.dec_lo), _taps(jfb.dec_hi)
    glo, ghi = _taps(jfb.rec_lo), _taps(jfb.rec_hi)
    lp, rp = conv.analysis_pads(fb.hlen)
    xp = RNG.standard_normal((2 * L + lp + rp, nc)).astype(np.float32)
    body, top, bot = _row_parts(xp, lp, rp)
    if nc % 128 == 0:
        ref = jpk.build_ana_padded_rows(xp.shape[0], nc, L, flo, fhi,
                                        True)(jnp.asarray(xp))
    else:
        ref = jpk._analysis_sub(jnp.asarray(xp), flo, fhi, L)
    _close(fd.ana_rows_plain(body, top, bot, fb), ref, 3e-5)
    fm = jmx.build_ana_padded_rows_mxu(xp.shape[0], nc, L, flo, fhi, True)
    if fm is not None:
        _close(km.ana_rows_mxu_plain(body, top, bot, fb),
               fm(jnp.asarray(xp)), 5e-5)
    lpi, rpi = conv.synthesis_pads(fb.hlen, L, 2 * L)
    ap, dp = (RNG.standard_normal((L + lpi + rpi, nc)).astype(np.float32)
              for _ in range(2))
    (a, at, ab), (d, dt, db) = (_row_parts(p, lpi, rpi) for p in (ap, dp))
    if nc % 128 == 0:
        ref = jpk.build_syn_padded_rows(ap.shape[0], nc, 2 * L, lpi, glo,
                                        ghi, True)(jnp.asarray(ap),
                                                   jnp.asarray(dp))
    else:
        ref = jpk._synthesis_sub(jnp.asarray(ap), jnp.asarray(dp), glo,
                                 ghi, L, lpi)
    np.testing.assert_allclose(
        fd.syn_rows_plain(a, d, (at, ab, dt, db), fb).numpy(),
        np.asarray(ref), atol=3e-5)
    gm = jmx.build_syn_padded_rows_mxu(ap.shape[0], nc, 2 * L, lpi, glo,
                                       ghi, True)
    if gm is not None:
        np.testing.assert_allclose(
            km.syn_rows_mxu_plain(a, d, (at, ab, dt, db), fb).numpy(),
            np.asarray(gm(jnp.asarray(ap), jnp.asarray(dp))), atol=5e-5)


def test_k29_plain_versions_take_odd_banks():
    """JAX's padded-core kernels decline an odd bank; K29a-K29d's plain
    versions take it (the port's kernels do too), holding the unsharded
    core on one shard whose halos wrap it."""
    fb = get_filter_bank("bior3.5")
    x = torch.from_numpy(RNG.standard_normal((4, 64)))
    pyr = spatial.wavedec1_seqsharded(x, fb, 2, _rows(1))
    _close(_whole_seq(pyr), tdwt.wavedec1(x, fb, 2), 1e-12)
    img = torch.from_numpy(RNG.standard_normal((32, 48)))
    pyr = spatial.wavedec2_gridsharded(img, fb, 2, _grid(1, 1))
    _close(_whole_grid(pyr, 1), _leaves(tdwt.wavedec2(img, fb, 2)), 1e-12)


# -- the pyramids against JAX's sharded ones -------------------------------


@pytest.mark.parametrize("wname, levels, mesh", [
    ("db2", 2, (2, 2)), ("sym4", 3, (4, 2)), ("db20", 1, (2, 4)),
    ("haar", 3, (2, 2))], ids=str)
def test_grid_dwt_matches_jax_float32(wname, levels, mesh):
    """(128, 256) float32 grids on 2 x 2, 4 x 2 and 2 x 4 meshes against
    JAX's grid-sharded pyramid, and the port's inverse of JAX's
    coefficients; haar's pads are 0 (no exchange)."""
    img = RNG.random((128, 256)).astype(np.float32)
    jm = jmesh.make_mesh2d(*mesh, devices=jax.devices()[:mesh[0] * mesh[1]])
    ref = jspatial.wavedec2_gridsharded(jnp.asarray(img), jbank(wname),
                                        levels, jm)
    fb = get_filter_bank(wname)
    m = _grid(*mesh)
    pyr = spatial.wavedec2_gridsharded(img, fb, levels, m)
    _close(_whole_grid(pyr, mesh[1]), jax.tree_util.tree_leaves(ref), 1e-5)
    back = spatial.waverec2_gridsharded(
        [np.asarray(ref[0])] + [tuple(np.asarray(s) for s in lev)
                                for lev in ref[1:]], fb, m)
    np.testing.assert_allclose(pring.gather_grid(back, mesh[1]).numpy(), img,
                               atol=1e-5)


@pytest.mark.parametrize("levels, mesh", [(2, (2, 2)), (4, (4, 2))],
                         ids=str)
def test_grid_swt_matches_jax_float64(levels, mesh):
    """db3 SWT of a (64, 64) float64 grid against JAX's (jnp) route; at L4
    on (4, 2) the dilated halos (16, 24) take several hops on 16-row
    shards."""
    img = RNG.standard_normal((64, 64))
    jm = jmesh.make_mesh2d(*mesh, devices=jax.devices()[:mesh[0] * mesh[1]])
    ref = jspatial.swt2d_gridsharded(jnp.asarray(img), jbank("db3"), levels,
                                     jm)
    fb = get_filter_bank("db3")
    m = _grid(*mesh)
    pyr = spatial.swt2d_gridsharded(img, fb, levels, m)
    _close(_whole_grid(pyr, mesh[1]), jax.tree_util.tree_leaves(ref), 1e-12)
    y = pring.gather_grid(spatial.iswt2d_gridsharded(pyr, fb, m), mesh[1])
    np.testing.assert_allclose(y.numpy(), img, atol=1e-10)
    # and the unsharded stationary core
    want = tswt.swt2d(torch.from_numpy(img), fb, levels)
    _close(_whole_grid(pyr, mesh[1]), _leaves(want), 1e-12)


def test_grid_dwt_float64_matches_jax_jnp_route():
    img = RNG.standard_normal((64, 128))
    jm = jmesh.make_mesh2d(2, 4, devices=jax.devices())
    ref = jspatial.wavedec2_gridsharded(jnp.asarray(img), jbank("sym4"), 3,
                                        jm)
    fb = get_filter_bank("sym4")
    m = _grid(2, 4)
    pyr = spatial.wavedec2_gridsharded(img, fb, 3, m)
    _close(_whole_grid(pyr, 4), jax.tree_util.tree_leaves(ref), 1e-12)
    y = pring.gather_grid(spatial.waverec2_gridsharded(pyr, fb, m), 4)
    np.testing.assert_allclose(y.numpy(), img, atol=1e-10)


@pytest.mark.parametrize("width", [20, 24, 28], ids=lambda w: f"nc{w // 4}")
def test_grid_sym20_multi_hop_float64_matches_jax_jnp_route(width):
    """sym20 on (64, width) float64 grids of 4 x 2 shards: the row passes
    see 8-row coefficient shards whose 10-row halos take two hops, on
    shard widths of 5, 6 and 7 columns (nc % 4 of 1, 2 and 3), against
    JAX's (jnp) route; the port's inverse of JAX's coefficients and its
    own roundtrip."""
    img = RNG.standard_normal((64, width))
    jm = jmesh.make_mesh2d(4, 2, devices=jax.devices())
    ref = jspatial.wavedec2_gridsharded(jnp.asarray(img), jbank("sym20"), 1,
                                        jm)
    fb = get_filter_bank("sym20")
    m = _grid(4, 2)
    pyr = spatial.wavedec2_gridsharded(img, fb, 1, m)
    _close(_whole_grid(pyr, 2), jax.tree_util.tree_leaves(ref), 1e-12)
    back = spatial.waverec2_gridsharded(
        [np.asarray(ref[0])] + [tuple(np.asarray(s) for s in lev)
                                for lev in ref[1:]], fb, m)
    np.testing.assert_allclose(pring.gather_grid(back, 2).numpy(), img,
                               atol=1e-10)
    y = pring.gather_grid(spatial.waverec2_gridsharded(pyr, fb, m), 2)
    np.testing.assert_allclose(y.numpy(), img, atol=1e-10)


@pytest.mark.parametrize("shape, wname, levels, n", [
    ((4096,), "db2", 5, 8), ((8, 1024), "sym8", 3, 4),
    ((512,), "db20", 3, 8)], ids=str)
def test_seq_dwt_matches_jax(shape, wname, levels, n):
    """A signal and JAX's (B, n) batch; db20's 19-sample halos take two
    hops at level 3, on shards of 16 samples."""
    x = RNG.random(shape).astype(np.float32)
    jm = jmesh.make_mesh(n_data=1, n_rows=n)
    ref = jspatial.wavedec1_seqsharded(jnp.asarray(x), jbank(wname), levels,
                                       jm)
    fb = get_filter_bank(wname)
    pyr = spatial.wavedec1_seqsharded(x, fb, levels, _rows(n))
    _close(_whole_seq(pyr), ref, 1e-5)
    y = pring.gather_last(spatial.waverec1_seqsharded(
        [np.asarray(c) for c in ref], fb, _rows(n)))
    np.testing.assert_allclose(y.numpy(), x, atol=1e-5)


@pytest.mark.parametrize("shape", [(2048,), (3, 512)], ids=str)
def test_seq_swt_and_float64_match_jax(shape):
    """The a-trous sequence path at L4 on 8 shards (float64: JAX's jnp
    route) and the float64 DWT."""
    x = RNG.standard_normal(shape)
    jm = jmesh.make_mesh(n_data=1, n_rows=8)
    fb = get_filter_bank("db3")
    ref = jspatial.swt1d_seqsharded(jnp.asarray(x), jbank("db3"), 4, jm)
    pyr = spatial.swt1d_seqsharded(x, fb, 4, _rows(8))
    _close(_whole_seq(pyr), ref, 1e-12)
    y = pring.gather_last(spatial.iswt1d_seqsharded(pyr, fb, _rows(8)))
    np.testing.assert_allclose(y.numpy(), x, atol=1e-10)
    ref = jspatial.wavedec1_seqsharded(jnp.asarray(x), jbank("db3"), 3, jm)
    pyr = spatial.wavedec1_seqsharded(x, fb, 3, _rows(8))
    _close(_whole_seq(pyr), ref, 1e-12)


def test_grid_and_seq_in_pallas_mode_match_jax(both_modes):
    """JAX's padded-core Pallas kernels (set_kernels("pallas"), interpret
    mode) on the grid and the (B, n) sequence against the port's K29a-K29d
    plain versions."""
    both_modes("pallas", "auto")
    img = RNG.random((64, 256)).astype(np.float32)
    jm = jmesh.make_mesh2d(2, 2, devices=jax.devices()[:4])
    ref = jspatial.wavedec2_gridsharded(jnp.asarray(img), jbank("db2"), 2,
                                        jm)
    pyr = spatial.wavedec2_gridsharded(img, get_filter_bank("db2"), 2,
                                       _grid(2, 2))
    _close(_whole_grid(pyr, 2), jax.tree_util.tree_leaves(ref), 3e-5)
    x = RNG.random((8, 1024)).astype(np.float32)
    ref = jspatial.wavedec1_seqsharded(jnp.asarray(x), jbank("db2"), 2,
                                       jmesh.make_mesh(n_data=1, n_rows=4))
    pyr = spatial.wavedec1_seqsharded(x, get_filter_bank("db2"), 2, _rows(4))
    _close(_whole_seq(pyr), ref, 3e-5)


# -- the halo primitives and rolls against numpy periodic slices ------------


@pytest.mark.parametrize("pad", [0, 1, 5, 16, 17, 40])
@pytest.mark.parametrize("axis", [-1, -2])
def test_halos_are_periodic_slices(pad, axis):
    """Samples before and after each shard along either axis, pads wider
    than a shard (multi-hop) and than the whole axis (hops wrap), and on a
    ring of one (local wrap, no exchange)."""
    S, n = 4, 16
    x = np.arange(2 * S * n * 3, dtype=np.float64).reshape(2, S * n, 3)
    x = np.moveaxis(x, 1, axis)
    for size in (S, 1):
        parts = list(torch.from_numpy(x).tensor_split(size, axis))
        ring = pring.LocalRing([CPU] * size, size)
        got = spatial._halos(parts, pad, pad + 3, ring, axis)
        m = x.shape[axis] // size
        for i, (b, a) in enumerate(got):
            idx = np.arange(i * m - pad, i * m) % x.shape[axis]
            np.testing.assert_array_equal(b.numpy(), np.take(x, idx, axis))
            idx = np.arange((i + 1) * m, (i + 1) * m + pad + 3) % x.shape[axis]
            np.testing.assert_array_equal(a.numpy(), np.take(x, idx, axis))
        hops = 0 if size == 1 else (-(-pad // m) if pad else 0) + -(-(pad + 3)
                                                                   // m)
        assert ring.counts["ppermute"] == hops


def test_halo_exchange_rows_and_strided_rings():
    """``halo_exchange_rows`` on the rows rings of a 2 x 2 grid (stride 2):
    each shard with the rows of its column's neighbours, as numpy's
    periodic slices of the whole image."""
    x = np.arange(8 * 6, dtype=np.float64).reshape(8, 6)
    m = _grid(2, 2)
    parts = pring.shard_grid(torch.from_numpy(x), m)
    rings = pring.GridRings.for_mesh(m)
    ext = spatial.halo_exchange_rows(parts, 3, 5, rings.rows)
    for k, e in enumerate(ext):
        i, j = divmod(k, 2)
        rows = np.arange(4 * i - 3, 4 * i + 4 + 5) % 8
        np.testing.assert_array_equal(e.numpy(), x[rows][:, 3 * j:3 * j + 3])
    assert rings.counts["ppermute"] == 1 + 2
    np.testing.assert_array_equal(pring.gather_grid(parts, 2).numpy(), x)


@pytest.mark.parametrize("sr, sc", [(0, 0), (3, 5), (17, -9), (64, 130)])
def test_global_rolls_of_grid_and_signal(sr, sc):
    x = np.arange(32 * 48, dtype=np.float64).reshape(32, 48)
    m = _grid(2, 4)
    rings = pring.GridRings.for_mesh(m)
    out = spatial.roll_grid(pring.shard_grid(torch.from_numpy(x), m), sr, sc,
                            rings)
    np.testing.assert_array_equal(pring.gather_grid(out, 4).numpy(),
                                  np.roll(x, (sr, sc), (0, 1)))
    assert rings.counts["all_gather"] == 0
    sig = np.arange(3 * 64, dtype=np.float64).reshape(3, 64)
    ring = pring.LocalRing([CPU] * 8, 8)
    out = spatial.roll_last(pring.shard_last(torch.from_numpy(sig), _rows(8)),
                            sr + sc, ring)
    np.testing.assert_array_equal(pring.gather_last(out).numpy(),
                                  np.roll(sig, sr + sc, -1))
