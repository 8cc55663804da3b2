"""The port's Wavelets(..., device="cpu") against pypwt_tpu.Wavelets at
256^2, db2, 3 levels, 0..255 float32 data: transforms, thresholds, the
coeff_only indexing, the state machine, norms, set_coeff, add_wavelet and
cycle spinning with the same seed (hence the same shifts)."""

import numpy as np
import pytest
import torch

import pypwt_tpu
import pypwt_tpu_torch

torch.set_num_threads(1)

COEFF_TOL = 3e-4
IMAGE_TOL = 7e-4
SHAPE = (256, 256)


def _img(seed=0, shape=SHAPE):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.float32)


def _pair(img=None, wname="db2", levels=3, **kw):
    img = _img() if img is None else img
    return (pypwt_tpu.Wavelets(img, wname, levels, **kw),
            pypwt_tpu_torch.Wavelets(img, wname, levels, device="cpu", **kw))


def _assert_coeffs(t, j):
    tc, jc = t.coeffs, j.coeffs
    assert len(tc) == len(jc) == t.levels + 1
    assert np.abs(tc[0] - jc[0]).max() <= COEFF_TOL * 2 ** t.levels
    for lev in range(1, t.levels + 1):
        assert len(tc[lev]) == 3
        for a, b in zip(tc[lev], jc[lev]):
            assert a.shape == b.shape and a.dtype == np.float32
            assert np.abs(a - b).max() <= COEFF_TOL * 2 ** lev


@pytest.mark.parametrize("wname", ["db2", "haar", "sym8"])
def test_forward_threshold_inverse(wname):
    j, t = _pair(wname=wname)
    assert (t.levels, t.hlen, t.sizes) == (j.levels, j.hlen, j.sizes)
    j.forward()
    t.forward()
    _assert_coeffs(t, j)
    j.soft_threshold(10.0)
    t.soft_threshold(10.0)
    _assert_coeffs(t, j)
    j.inverse()
    t.inverse()
    assert t.image.shape == SHAPE
    assert np.abs(t.image - j.image).max() <= IMAGE_TOL


@pytest.mark.parametrize("op, args", [
    ("hard_threshold", (10.0, 1, 1)), ("group_soft_threshold", (10.0, 1, 0)),
    ("proj_linf", (5.0, 1)), ("shrink", (0.5,))])
def test_other_operators(op, args):
    j, t = _pair()
    j.forward()
    t.forward()
    getattr(j, op)(*args)
    getattr(t, op)(*args)
    _assert_coeffs(t, j)


def test_coeff_only_indexing():
    j, t = _pair()
    j.forward()
    t.forward()
    tc = t.coeffs
    for num in range(3 * t.levels + 1):
        got = t.coeff_only(num)
        ref = j.coeff_only(num)
        assert got.shape == ref.shape
        expect = tc[0] if num == 0 else tc[(num - 1) // 3 + 1][(num - 1) % 3]
        np.testing.assert_array_equal(got, expect)
        assert np.abs(got - ref).max() <= COEFF_TOL * 8
    for w in (j, t):
        with pytest.raises(ValueError, match="out of range"):
            w.coeff_only(3 * t.levels + 1)


def test_state_machine(capsys):
    j, t = _pair()
    for w in (j, t):
        w.forward()
        w.inverse()
        first = w.image.copy()
        capsys.readouterr()
        assert w.inverse() is w
        assert "already been run" in capsys.readouterr().out
        np.testing.assert_array_equal(w.image, first)
        with pytest.raises(RuntimeError, match="inverse"):
            w.coeffs
        with pytest.raises(RuntimeError, match="inverse"):
            w.coeff_only(0)
        with pytest.raises(RuntimeError):
            w.soft_threshold(1.0)
        w.forward()
        assert len(w.coeffs) == w.levels + 1


def test_norms():
    j, t = _pair()
    j.forward()
    t.forward()
    assert t.norm1() == pytest.approx(j.norm1(), rel=1e-5)
    assert t.norm2sq() == pytest.approx(j.norm2sq(), rel=1e-5)


def test_set_coeff_then_inverse():
    j, t = _pair()
    for w in (j, t):
        w.forward()
        h1 = w.coeff_only(1)
        w.set_coeff(np.zeros_like(h1), 1, check=True)
        w.set_coeff(w.coeff_only(0) * 0.5, 0)
        with pytest.raises(ValueError, match="Invalid coefficient shape"):
            w.set_coeff(np.zeros((3, 3), np.float32), 2, check=True)
        w.inverse()
    assert np.abs(t.image - j.image).max() <= IMAGE_TOL


def test_add_wavelet():
    j1, t1 = _pair(_img(1))
    j2, t2 = _pair(_img(2))
    for a, b in ((j1, j2), (t1, t2)):
        a.forward()
        b.forward()
        assert a.add_wavelet(b, 0.5) == 0
    _assert_coeffs(t1, j1)
    _, t3 = _pair(wname="db3")
    with pytest.raises(ValueError, match="same transform"):
        t1.add_wavelet(t3)


@pytest.mark.parametrize("seed", [7, 11])
def test_cycle_spinning_same_shifts(seed):
    j, t = _pair(do_cycle_spinning=1, seed=seed)
    for _ in range(2):
        j.forward()
        t.forward()
        assert t.current_shift == j.current_shift
        _assert_coeffs(t, j)
        j.soft_threshold(5.0)
        t.soft_threshold(5.0)
        j.inverse()
        t.inverse()
        assert np.abs(t.image - j.image).max() <= IMAGE_TOL


def test_circshift_and_set_image():
    j, t = _pair()
    for w in (j, t):
        w.circshift(3, -5)
    np.testing.assert_array_equal(t.image, j.image)
    img = _img(9)
    t.set_image(img)
    np.testing.assert_array_equal(t.image, img)
    assert torch.equal(t.image_device_array(), torch.from_numpy(img))
    with pytest.raises(ValueError, match="correct shape"):
        t.set_image(np.zeros((4, 4), np.float32))


def test_odd_size_matches():
    img = _img(3, (100, 90))
    j, t = _pair(img, "db4", 3)
    j.forward()
    t.forward()
    _assert_coeffs(t, j)
    j.inverse()
    t.inverse()
    assert np.abs(t.image - img).max() <= IMAGE_TOL


@pytest.mark.parametrize("kw, match", [
    (dict(do_swt=1), "swt"), (dict(ndim=1), "1D"),
    (dict(do_separable=0), "nonsep")])
def test_unported_modes_raise(kw, match):
    with pytest.raises(NotImplementedError, match=match):
        pypwt_tpu_torch.Wavelets(_img(), "db2", 3, device="cpu", **kw)


def test_1d_image_raises():
    with pytest.raises(NotImplementedError, match="1D"):
        pypwt_tpu_torch.Wavelets(np.zeros(64, np.float32), "db2", 3,
                                 device="cpu")


def test_info_and_version():
    _, t = _pair()
    s = repr(t)
    assert "Running on device : cpu" in s
    assert "Number of levels : 3" in s
    assert t.version() == pypwt_tpu.Wavelets.version()
    assert t.image_device_array().device.type == "cpu"


def test_custom_filters():
    fb = pypwt_tpu.get_filter_bank("db3")
    j, t = _pair()
    for w in (j, t):
        w.set_wavelets_filters("mine", fb.dec_lo, fb.dec_hi, fb.rec_lo,
                               fb.rec_hi)
        w.forward()
    _assert_coeffs(t, j)
    with pytest.raises(ValueError, match="same length"):
        t.set_wavelets_filters("bad", np.ones(4), np.ones(6), np.ones(4),
                               np.ones(4))
