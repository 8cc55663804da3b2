"""The port's plans ``ShardedWavelets`` (row, grid and sequence layouts)
and ``BatchedWavelets`` held against the JAX package's on the CPU: the
cases of tests/test_sharded_api.py and tests/test_batched_api.py, run through
both packages on the same numpy inputs (JAX on the conftest's 8 simulated
devices, the port on meshes of repeated CPU devices).  Both run float32
plans, JAX's on its jnp route: coefficients and images within 1e-5 (the
JAX tests' own tolerance), norms within 1e-5 relative.  The same seed
draws the same cycle-spinning shifts in both.
"""

import numpy as np
import pytest
import torch

import jax

from pypwt_tpu import get_filter_bank as jbank
from pypwt_tpu.parallel import BatchedWavelets as JBatched
from pypwt_tpu.parallel import ShardedWavelets as JSharded
from pypwt_tpu.parallel import mesh as jmesh

from pypwt_tpu_torch import Wavelets, get_filter_bank
from pypwt_tpu_torch.parallel import BatchedWavelets, ShardedWavelets
from pypwt_tpu_torch.parallel import mesh as pmesh

CPU = torch.device("cpu")
TOL = 1e-5

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 simulated devices")


def _img(nr=128, nc=64, seed=0):
    return np.random.default_rng(seed).random((nr, nc)).astype(np.float32)


def _mesh(n_data, n_rows):
    return pmesh.make_mesh(n_data, n_rows, [CPU] * (n_data * n_rows))


def _pair_rows(n):
    return jmesh.make_mesh(n_data=1, n_rows=n), _mesh(1, n)


def _same_coeffs(a, b, nums, atol=TOL):
    for num in nums:
        np.testing.assert_allclose(a.coeff_only(num), b.coeff_only(num),
                                   atol=atol)


def test_sharded_matches_jax_plan():
    img = _img()
    jm, tm = _pair_rows(8)
    J = JSharded(img, "db3", 2, mesh=jm)
    T = ShardedWavelets(img, "db3", 2, mesh=tm)
    J.forward()
    T.forward()
    _same_coeffs(T, J, range(7))
    for a, b in zip(T.coeffs[1], J.coeffs[1]):
        np.testing.assert_allclose(a, b, atol=TOL)
    # and the port's single-device plan
    W = Wavelets(img, "db3", 2, device="cpu").forward()
    np.testing.assert_allclose(T.coeff_only(4), W.coeff_only(4), atol=TOL)
    J.soft_threshold(0.1)
    T.soft_threshold(0.1)
    assert abs(T.norm1() - J.norm1()) / J.norm1() < 1e-5
    assert abs(T.norm2sq() - J.norm2sq()) / J.norm2sq() < 1e-5
    J.inverse()
    T.inverse()
    np.testing.assert_allclose(T.image, J.image, atol=TOL)


def test_sharded_swt_matches_jax_and_roundtrips():
    img = _img(64, 64)
    jm, tm = _pair_rows(4)
    J = JSharded(img, "db2", 3, do_swt=1, mesh=jm).forward()
    T = ShardedWavelets(img, "db2", 3, do_swt=1, mesh=tm).forward()
    _same_coeffs(T, J, range(10))
    T.inverse()
    np.testing.assert_allclose(T.image, img, atol=TOL)


@pytest.mark.parametrize("spins", [1, 3])
def test_sharded_denoise_and_spins_match_jax(spins):
    img = _img()
    jm, tm = _pair_rows(8)
    J = JSharded(img, "db2", 2, mesh=jm, seed=7).denoise(0.05, spins=spins)
    T = ShardedWavelets(img, "db2", 2, mesh=tm, seed=7).denoise(
        0.05, spins=spins)
    np.testing.assert_allclose(T.image, J.image, atol=TOL)
    if spins > 1:
        plain = ShardedWavelets(img, "db2", 2, mesh=tm).denoise(0.05)
        assert np.abs(T.image - plain.image).max() > 0


def test_sharded_cycle_spinning_matches_jax():
    img = _img()
    jm, tm = _pair_rows(8)
    J = JSharded(img, "db2", 2, do_cycle_spinning=1, mesh=jm, seed=3)
    T = ShardedWavelets(img, "db2", 2, do_cycle_spinning=1, mesh=tm, seed=3)
    J.forward()
    T.forward()
    assert T.current_shift == J.current_shift != (0, 0)
    _same_coeffs(T, J, range(7))
    T.inverse()
    np.testing.assert_allclose(T.image, img, atol=TOL)


def test_sharded_set_coeff_and_guards():
    T = ShardedWavelets(_img(), "db2", 1, mesh=_mesh(1, 8))
    with pytest.raises(RuntimeError):
        T.norm1()
    T.forward()
    z = np.zeros_like(T.coeff_only(3))
    T.set_coeff(z, 3, check=True)
    assert np.abs(T.coeff_only(3)).max() == 0
    with pytest.raises(ValueError):
        T.set_coeff(np.zeros((3, 3), np.float32), 1, check=True)
    with pytest.raises(ValueError):
        T.coeff_only(99)
    with pytest.raises(ValueError):
        ShardedWavelets(np.zeros((4, 32, 32), np.float32), "db2", 1,
                        mesh=_mesh(1, 8))


@pytest.mark.parametrize("shape, wname, levels", [((100, 70), "db2", 2),
                                                  ((100, 90), "db3", 3)])
def test_sharded_nonaligned_sizes_match_jax(shape, wname, levels):
    """Padded periodically to the mesh-aligned size: the coefficients are
    those of the periodic extension, in both packages; roundtrip exact."""
    img = _img(*shape, seed=4)
    jm, tm = _pair_rows(8)
    J = JSharded(img, wname, levels, mesh=jm).forward()
    T = ShardedWavelets(img, wname, levels, mesh=tm).forward()
    assert T._padded == J._padded != img.shape
    _same_coeffs(T, J, range(3 * levels + 1))
    T.inverse()
    assert T.image.shape == img.shape
    np.testing.assert_allclose(T.image, img, atol=TOL)
    S = ShardedWavelets(img, wname, 2, do_swt=1, mesh=tm).forward()
    S.inverse()
    np.testing.assert_allclose(S.image, img, atol=TOL)


def test_sharded_add_wavelet():
    img = _img(64, 64, 7)
    m = _mesh(1, 8)
    T = ShardedWavelets(img, "db2", 2, mesh=m).forward()
    T2 = ShardedWavelets(img, "db2", 2, mesh=m).forward()
    h1 = T.coeff_only(1)
    T.add_wavelet(T2, alpha=1.0)
    np.testing.assert_allclose(T.coeff_only(1), 2.0 * h1, atol=1e-6)
    bad = ShardedWavelets(img, "db3", 2, mesh=m).forward()
    with pytest.raises(ValueError):
        T.add_wavelet(bad)


def test_grid_and_sequence_layouts_construct_and_roundtrip():
    """A 1D signal selects the sequence layout and a ``make_mesh2d`` mesh
    the grid layout; both construct and round-trip."""
    sig = np.random.default_rng(0).random(256).astype(np.float32)
    S = ShardedWavelets(sig, "db2", 2, mesh=_mesh(1, 4))
    assert (S.ndim, S.grid) == (1, False)
    S.forward()
    S.inverse()
    np.testing.assert_allclose(S.image, sig, atol=TOL)
    img = _img(64, 64)
    G = ShardedWavelets(img, "db2", 2, mesh=_grid(2, 2))
    assert (G.ndim, G.grid, G.n_rows, G.n_cols) == (2, True, 2, 2)
    G.forward()
    G.inverse()
    np.testing.assert_allclose(G.image, img, atol=TOL)


# -- grid and sequence layouts (tests/test_sharded_api.py:177-231, :331-377)


def _grid(nr, nc):
    return pmesh.make_mesh2d(nr, nc, [CPU] * (nr * nc))


def _jgrid(nr, nc):
    return jmesh.make_mesh2d(nr, nc, jax.devices()[:nr * nc])


def test_sharded_grid_matches_jax_and_single_plan():
    img = _img(128, 128, 8)
    J = JSharded(img, "db3", 2, mesh=_jgrid(4, 2))
    T = ShardedWavelets(img, "db3", 2, mesh=_grid(4, 2))
    assert T.grid and J.grid
    J.forward()
    T.forward()
    _same_coeffs(T, J, range(7))
    W = Wavelets(img, "db3", 2, device="cpu").forward()
    for num in range(7):
        np.testing.assert_allclose(T.coeff_only(num), W.coeff_only(num),
                                   atol=TOL)
    J.soft_threshold(0.1)
    T.soft_threshold(0.1)
    W.soft_threshold(0.1)
    assert abs(T.norm1() - J.norm1()) / J.norm1() < 1e-5
    assert abs(T.norm2sq() - W.norm2sq()) / W.norm2sq() < 1e-5
    J.inverse()
    T.inverse()
    np.testing.assert_allclose(T.image, J.image, atol=TOL)


def test_sharded_grid_swt_matches_jax_and_roundtrips():
    img = _img(64, 64, 9)
    J = JSharded(img, "db2", 2, do_swt=1, mesh=_jgrid(2, 4)).forward()
    T = ShardedWavelets(img, "db2", 2, do_swt=1, mesh=_grid(2, 4)).forward()
    _same_coeffs(T, J, range(7))
    T.inverse()
    np.testing.assert_allclose(T.image, img, atol=TOL)


@pytest.mark.parametrize("spins", [1, 2])
def test_sharded_grid_any_size_denoise_matches_jax(spins):
    img = _img(90, 110, 10)
    J = JSharded(img, "db2", 2, mesh=_jgrid(2, 4), seed=1)
    T = ShardedWavelets(img, "db2", 2, mesh=_grid(2, 4), seed=1)
    assert T._padded == J._padded == (96, 112)
    J.denoise(0.05, spins=spins)
    T.denoise(0.05, spins=spins)
    assert T.image.shape == img.shape
    np.testing.assert_allclose(T.image, J.image, atol=TOL)
    T.set_image(img)
    T.forward()
    T.inverse()
    np.testing.assert_allclose(T.image, img, atol=TOL)


def test_sharded_grid_cycle_spinning_set_coeff_and_add_wavelet():
    img = _img(64, 96, 11)
    J = JSharded(img, "db2", 2, do_cycle_spinning=1, mesh=_jgrid(2, 2),
                 seed=4).forward()
    T = ShardedWavelets(img, "db2", 2, do_cycle_spinning=1, mesh=_grid(2, 2),
                        seed=4).forward()
    assert T.current_shift == J.current_shift != (0, 0)
    _same_coeffs(T, J, range(7))
    T.inverse()
    np.testing.assert_allclose(T.image, img, atol=TOL)
    T.forward()
    h1 = T.coeff_only(1)
    T.set_coeff(np.zeros_like(h1), 1, check=True)
    assert np.abs(T.coeff_only(1)).max() == 0
    with pytest.raises(ValueError):
        T.set_coeff(np.zeros((3, 3), np.float32), 2, check=True)
    T.set_coeff(h1, 1)
    T2 = ShardedWavelets(img, "db2", 2, mesh=_grid(2, 2)).forward()
    T3 = ShardedWavelets(img, "db2", 2, mesh=_grid(2, 2)).forward()
    T2.add_wavelet(T3, alpha=1.0)
    np.testing.assert_allclose(T2.coeff_only(4), 2.0 * T3.coeff_only(4),
                               atol=1e-5)


def test_sharded_seq1d_matches_jax_and_single_plan():
    sig = np.random.default_rng(20).random(8 * 1024).astype(np.float32)
    J = JSharded(sig, "db3", 3, mesh=_pair_rows(8)[0])
    T = ShardedWavelets(sig, "db3", 3, mesh=_mesh(1, 8))
    assert T.ndim == J.ndim == 1
    J.forward()
    T.forward()
    _same_coeffs(T, J, range(4))
    W = Wavelets(sig, "db3", 3, device="cpu").forward()
    for num in range(4):
        np.testing.assert_allclose(T.coeff_only(num),
                                   np.ravel(W.coeff_only(num)), atol=TOL)
    J.soft_threshold(0.1)
    T.soft_threshold(0.1)
    assert abs(T.norm1() - J.norm1()) / J.norm1() < 1e-5
    assert abs(T.norm2sq() - J.norm2sq()) / J.norm2sq() < 1e-5
    J.inverse()
    T.inverse()
    np.testing.assert_allclose(T.image, J.image, atol=TOL)


def test_sharded_seq1d_any_size_and_swt_match_jax():
    sig = np.random.default_rng(21).random(5000).astype(np.float32)
    jm, tm = _pair_rows(8)
    J = JSharded(sig, "db2", 2, mesh=jm).forward()
    T = ShardedWavelets(sig, "db2", 2, mesh=tm).forward()
    assert T._padded == J._padded != sig.shape
    _same_coeffs(T, J, range(3))
    T.inverse()
    np.testing.assert_allclose(T.image, sig, atol=TOL)
    # stationary: dilated halos over the ring, multi-hop at depth
    JS = JSharded(sig, "db2", 3, do_swt=1, mesh=jm).forward()
    SS = ShardedWavelets(sig, "db2", 3, do_swt=1, mesh=tm).forward()
    _same_coeffs(SS, JS, range(4))
    SS.inverse()
    np.testing.assert_allclose(SS.image, sig, atol=TOL)


def test_sharded_seq1d_denoise_and_set_coeff_match_jax():
    sig = np.random.default_rng(22).random(4096).astype(np.float32)
    jm, tm = _pair_rows(8)
    J = JSharded(sig, "sym4", 2, mesh=jm, seed=5).denoise(0.05, spins=2)
    T = ShardedWavelets(sig, "sym4", 2, mesh=tm, seed=5).denoise(0.05,
                                                                 spins=2)
    assert T.image.shape == sig.shape
    np.testing.assert_allclose(T.image, J.image, atol=TOL)
    T.set_image(sig)
    T.forward()
    d1 = T.coeff_only(1)
    T.set_coeff(np.zeros_like(d1), 1, check=True)
    assert np.abs(T.coeff_only(1)).max() == 0
    with pytest.raises(ValueError):
        T.coeff_only(3)
    C = ShardedWavelets(sig, "db2", 2, do_cycle_spinning=1, mesh=tm,
                        seed=6).forward()
    JC = JSharded(sig, "db2", 2, do_cycle_spinning=1, mesh=jm,
                  seed=6).forward()
    assert C.current_shift == JC.current_shift and C.current_shift[1] == 0
    _same_coeffs(C, JC, range(3))


def test_sharded_info_names_the_layout(capsys):
    ShardedWavelets(np.zeros(4096, np.float32), "db2", 2,
                    mesh=_mesh(1, 8)).info()
    ShardedWavelets(_img(90, 110), "db2", 2, mesh=_grid(2, 4)).info()
    ShardedWavelets(_img(), "db2", 2, mesh=_mesh(1, 8)).info()
    out = capsys.readouterr().out.splitlines()
    assert out == [
        "ShardedWavelets: (4096,) db2 L2 swt=0 over 8 seq-shards",
        "ShardedWavelets: (90, 110) db2 L2 swt=0 over 2x4 grid-shards "
        "(padded to 96x112)",
        "ShardedWavelets: (128, 64) db2 L2 swt=0 over 8 row-shards"]


# -- BatchedWavelets ---------------------------------------------------------


def _stack(b=8, nr=32, nc=64, seed=0):
    return np.random.default_rng(seed).random((b, nr, nc)).astype(
        np.float32)


@pytest.mark.parametrize("n_data, n_rows, wname", [(4, 2, "db2"),
                                                   (8, 1, "db2"),
                                                   (4, 2, "db3"),
                                                   (2, 1, "haar")])
def test_batched_matches_jax_plan(n_data, n_rows, wname):
    stack = _stack(b=4 if n_rows == 2 else 8, nr=128 if n_rows == 2 else 32)
    J = JBatched(stack, wname, 2,
                 mesh=jmesh.make_mesh(n_data, n_rows,
                                      jax.devices()[:n_data * n_rows]))
    T = BatchedWavelets(stack, wname, 2, mesh=_mesh(n_data, n_rows))
    assert T.hybrid == J.hybrid == (n_rows > 1)
    J.forward()
    T.forward()
    _same_coeffs(T, J, range(7))
    J.soft_threshold(0.1)
    T.soft_threshold(0.1)
    assert abs(T.norm1() - J.norm1()) / J.norm1() < 1e-5
    assert abs(T.norm2sq() - J.norm2sq()) / J.norm2sq() < 1e-5
    J.inverse()
    T.inverse()
    np.testing.assert_allclose(T.image, J.image, atol=TOL)


def test_batched_swt_and_bad_divisibility():
    stack = _stack(b=4, nr=16, nc=16)
    T = BatchedWavelets(stack, "db2", 2, do_swt=1, mesh=_mesh(4, 1))
    J = JBatched(stack, "db2", 2, do_swt=1,
                 mesh=jmesh.make_mesh(4, 1, jax.devices()[:4]))
    T.forward()
    J.forward()
    _same_coeffs(T, J, range(7))
    T.inverse()
    np.testing.assert_allclose(T.image, stack, atol=TOL)
    with pytest.raises(ValueError, match="not divisible"):
        BatchedWavelets(_stack(b=6), "db2", 1, mesh=_mesh(4, 2))


def test_batched_hybrid_any_rows_swt_and_cycle_spin_match_jax():
    stack = np.random.default_rng(31).random((2, 100, 64)).astype(
        np.float32)
    jm, tm = jmesh.make_mesh(2, 4), _mesh(2, 4)
    for kw in ({}, {"do_swt": 1}, {"do_cycle_spinning": 1, "seed": 9}):
        J = JBatched(stack, "db2", 2, mesh=jm, **kw).forward()
        T = BatchedWavelets(stack, "db2", 2, mesh=tm, **kw).forward()
        assert T._Nrp == J._Nrp != 100
        assert T.current_shift == J.current_shift
        _same_coeffs(T, J, range(7))
        J.inverse()
        T.inverse()
        np.testing.assert_allclose(T.image, J.image, atol=TOL)
        np.testing.assert_allclose(T.image, stack, atol=TOL)


@pytest.mark.parametrize("shape, levels, jax_fault", [
    ((4, 48, 36), 3, TypeError),
    ((4, 40, 36), 3, TypeError),
    ((4, 48, 35), 1, 36),
    ((4, 48, 64), 3, None)])
def test_batched_hybrid_inverse_any_width(shape, levels, jax_fault):
    """The hybrid layout pads rows only: its inverse crops each level to
    the div2 chain of widths, so a width 2^levels does not divide comes
    back.  JAX's plan raises there, or at one level returns frames of the
    doubled width (``jax_fault``); width 64 is the case that worked."""
    stack = _stack(*shape, seed=41)
    J = JBatched(stack, "db2", levels, mesh=jmesh.make_mesh(2, 2)).forward()
    T = BatchedWavelets(stack, "db2", levels, mesh=_mesh(2, 2)).forward()
    assert T.hybrid and T._Nrp == J._Nrp
    _same_coeffs(T, J, range(3 * levels + 1))
    T.inverse()
    np.testing.assert_allclose(T.image, stack, atol=7e-4)
    if jax_fault is TypeError:
        with pytest.raises(TypeError):
            J.inverse()
    elif jax_fault is not None:
        assert J.inverse().image.shape[-1] == jax_fault != shape[-1]
    else:
        J.inverse()
        np.testing.assert_allclose(T.image, J.image, atol=TOL)
    # thresholded: the single-device plan on each row-padded frame, cropped
    T.forward()
    T.soft_threshold(0.1)
    T.inverse()
    padded = np.pad(stack, ((0, 0), (0, T._Nrp - shape[1]), (0, 0)),
                    mode="wrap")
    for b in range(shape[0]):
        W = Wavelets(padded[b], "db2", levels, device="cpu").forward()
        assert W.levels == levels
        W.soft_threshold(0.1)
        W.inverse()
        np.testing.assert_allclose(T.image[b], W.image[: shape[1]],
                                   atol=TOL)


def test_batched_denoise_matches_jax():
    stack = _stack(b=4, nr=64, nc=64, seed=32)
    for n_data, n_rows in ((4, 2), (4, 1)):
        J = JBatched(stack, "db2", 2,
                     mesh=jmesh.make_mesh(n_data, n_rows,
                                          jax.devices()[:n_data * n_rows]))
        T = BatchedWavelets(stack, "db2", 2, mesh=_mesh(n_data, n_rows))
        J.denoise(0.05)
        T.denoise(0.05)
        np.testing.assert_allclose(T.image, J.image, atol=TOL)


def test_batched_1d_mode_and_custom_bank_match_jax():
    stack = np.random.default_rng(1).random((8, 16, 64)).astype(np.float32)
    jm = jmesh.make_mesh(8, 1)
    J = JBatched(stack, "db2", 2, mesh=jm, ndim=1).forward()
    T = BatchedWavelets(stack, "db2", 2, mesh=_mesh(8, 1), ndim=1).forward()
    _same_coeffs(T, J, range(3))
    T.inverse()
    np.testing.assert_allclose(T.image, stack, atol=TOL)
    fb = get_filter_bank("db4")
    C = BatchedWavelets(stack, "db2", 2, mesh=_mesh(8, 1))
    C.set_wavelets_filters("custom-db4", fb.dec_lo, fb.dec_hi, fb.rec_lo,
                           fb.rec_hi)
    C.forward()
    jfb = jbank("db4")
    JC = JBatched(stack, "db2", 2, mesh=jm)
    JC.set_wavelets_filters("custom-db4", jfb.dec_lo, jfb.dec_hi,
                            jfb.rec_lo, jfb.rec_hi)
    JC.forward()
    _same_coeffs(C, JC, range(7), atol=1e-6)


def test_batched_set_coeff_and_add_wavelet():
    stack = _stack(seed=5)
    m = _mesh(8, 1)
    T = BatchedWavelets(stack, "db2", 2, mesh=m).forward()
    h1 = T.coeff_only(1)
    T.set_coeff(np.zeros_like(h1), 1, check=True)
    np.testing.assert_array_equal(T.coeff_only(1), np.zeros_like(h1))
    with pytest.raises(ValueError):
        T.set_coeff(np.zeros((8, 3, 3), np.float32), 1, check=True)
    with pytest.raises(ValueError):
        T.set_coeff(h1, 99)
    T.set_coeff(h1, 1)
    T2 = BatchedWavelets(stack, "db2", 2, mesh=m).forward()
    T.add_wavelet(T2, alpha=2.0)
    np.testing.assert_allclose(T.coeff_only(1), 3.0 * h1, atol=1e-5)
    bad = BatchedWavelets(stack, "db3", 2, mesh=m).forward()
    with pytest.raises(ValueError):
        T.add_wavelet(bad)
    H = BatchedWavelets(_stack(b=4, nr=64), "db2", 2, mesh=_mesh(2, 2))
    H.forward()
    d = H.coeff_only(3)
    H.set_coeff(np.zeros_like(d), 3, check=True)
    np.testing.assert_array_equal(H.coeff_only(3), np.zeros_like(d))
