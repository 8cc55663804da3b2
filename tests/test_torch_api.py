"""The port's Wavelets(..., device="cpu") against pypwt_tpu.Wavelets on
0..255 float32 data: the 2D plan at 256^2, db2, 3 levels; the 1D plans --
one signal and the rows of a 2D image (ndim=1), DWT and SWT -- over haar,
db2, sym8, sym20 and bior3.5; and the other 2D plans -- SWT, and the
non-separable mode with a built-in name or a custom 2D bank, DWT and SWT:
transforms, thresholds, the coeff_only indexing, the state machine, norms,
set_coeff, add_wavelet, cycle spinning with the same seed (hence the same
shifts), circshift, info() and the refusals of set_wavelets_filters."""

import numpy as np
import pytest
import torch

import pypwt_tpu
import pypwt_tpu_torch
from pypwt_tpu_torch.core import swt

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


# Once the 2D modes that raised; now each is held against the JAX package
# (name and ids kept from then).
@pytest.mark.parametrize("kw", [
    pytest.param(dict(do_swt=1), id="kw0-swt"),
    pytest.param(dict(do_separable=0), id="kw2-nonsep")])
def test_unported_modes_raise(kw):
    j, t = _pair(**kw)
    assert (t.do_swt, t.do_separable) == (j.do_swt, j.do_separable)
    assert (t.levels, t.sizes) == (j.levels, j.sizes)
    j.forward()
    t.forward()
    _assert_coeffs(t, j)
    j.soft_threshold(10.0)
    t.soft_threshold(10.0)
    j.inverse()
    t.inverse()
    assert np.abs(t.image - j.image).max() <= IMAGE_TOL


def test_batched_1d_plan_matches_jax():
    j, t = _pair(ndim=1)
    assert (t.ndim, t.batched1d, t.levels, t.sizes) == (
        j.ndim, j.batched1d, j.levels, j.sizes)
    j.forward()
    t.forward()
    _assert_coeffs_1d(t, j)
    j.inverse()
    t.inverse()
    assert np.abs(t.image - j.image).max() <= IMAGE_TOL


def test_1d_image_raises():
    """A 1D image builds the single-signal plan; cycle spinning on it is
    refused in both packages, as in the reference."""
    sig = _img(4, (64,))
    for cls, kw in ((pypwt_tpu.Wavelets, {}),
                    (pypwt_tpu_torch.Wavelets, dict(device="cpu"))):
        with pytest.raises(ValueError, match="not implemented for 1D"):
            cls(sig, "db2", 3, do_cycle_spinning=1, **kw)
    j, t = _pair(sig)
    assert (t.ndim, t.batched1d, t.shape, t.sizes) == (j.ndim, j.batched1d,
                                                       j.shape, j.sizes)
    j.forward()
    t.forward()
    _assert_coeffs_1d(t, j)


# ---------------------------------------------------------------------------
# 1D plans: one signal (n,) and batched rows (Nr, n), DWT and SWT
# ---------------------------------------------------------------------------

SIG = (2048,)
ROWS = (16, 512)
BANKS_1D = ["haar", "db2", "sym8", "sym20", "bior3.5"]


def _assert_coeffs_1d(t, j):
    tc, jc = t.coeffs, j.coeffs
    assert len(tc) == len(jc) == t.levels + 1
    levs = [t.levels] + list(range(1, t.levels + 1))
    for a, b, lev in zip(tc, jc, levs):
        assert isinstance(a, np.ndarray)
        assert a.shape == b.shape and a.dtype == np.float32
        assert np.abs(a - b).max() <= COEFF_TOL * 2 ** lev


def _pair_1d(shape, wname="db2", levels=3, img_seed=0, **kw):
    kw = dict(kw, ndim=1) if len(shape) == 2 else kw
    return _pair(_img(img_seed, shape), wname, levels, **kw)


@pytest.mark.parametrize("wname", BANKS_1D)
@pytest.mark.parametrize("shape", [SIG, ROWS], ids=["single", "batched"])
@pytest.mark.parametrize("do_swt", [0, 1], ids=["dwt", "swt"])
def test_1d_forward_threshold_inverse(wname, shape, do_swt):
    j, t = _pair_1d(shape, wname, do_swt=do_swt)
    assert (t.levels, t.hlen, t.sizes, t.ndim, t.do_swt) == (
        j.levels, j.hlen, j.sizes, j.ndim, j.do_swt)
    j.forward()
    t.forward()
    _assert_coeffs_1d(t, j)
    j.soft_threshold(10.0)
    t.soft_threshold(10.0)
    _assert_coeffs_1d(t, j)
    j.inverse()
    t.inverse()
    assert t.image.shape == j.image.shape == (shape[0] if len(shape) == 2
                                              else 1, shape[-1])
    assert np.abs(t.image - j.image).max() <= IMAGE_TOL


@pytest.mark.parametrize("shape", [SIG, ROWS], ids=["single", "batched"])
@pytest.mark.parametrize("do_swt", [0, 1], ids=["dwt", "swt"])
def test_1d_coeff_only_set_coeff_and_norms(shape, do_swt):
    j, t = _pair_1d(shape, "sym8", 4, do_swt=do_swt)
    for w in (j, t):
        w.forward()
    tc = t.coeffs
    for num in range(t.levels + 1):
        got, ref = t.coeff_only(num), j.coeff_only(num)
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got, tc[num])
        assert np.abs(got - ref).max() <= COEFF_TOL * 2 ** t.levels
    for w in (j, t):
        with pytest.raises(ValueError, match="out of range"):
            w.coeff_only(t.levels + 1)
    assert t.norm1() == pytest.approx(j.norm1(), rel=1e-5)
    assert t.norm2sq() == pytest.approx(j.norm2sq(), rel=1e-5)
    for w in (j, t):
        d1 = w.coeff_only(1)
        w.set_coeff(np.zeros_like(d1), 1, check=True)
        w.set_coeff(w.coeff_only(0) * 0.5, 0)
        with pytest.raises(ValueError, match="Invalid coefficient shape"):
            w.set_coeff(np.zeros((3, 3), np.float32), 2, check=True)
    _assert_coeffs_1d(t, j)
    for w in (j, t):
        w.group_soft_threshold(5.0, 1, 1)
    _assert_coeffs_1d(t, j)
    for w in (j, t):
        w.inverse()
    assert np.abs(t.image - j.image).max() <= IMAGE_TOL


@pytest.mark.parametrize("seed", [7, 11])
def test_1d_cycle_spinning_shifts_columns_only(seed):
    j, t = _pair_1d(ROWS, "db2", do_cycle_spinning=1, seed=seed)
    img = t.image.copy()
    for _ in range(2):
        j.forward()
        t.forward()
        assert t.current_shift == j.current_shift
        sr, sc = t.current_shift
        # the image moved along its rows only, by sc
        np.testing.assert_array_equal(t.image, np.roll(img, sc, axis=-1))
        _assert_coeffs_1d(t, j)
        j.soft_threshold(5.0)
        t.soft_threshold(5.0)
        j.inverse()
        t.inverse()
        assert np.abs(t.image - j.image).max() <= IMAGE_TOL
        img = t.image.copy()


def test_1d_circshift_ignores_sr():
    j, t = _pair_1d(ROWS)
    img = t.image.copy()
    for w in (j, t):
        w.circshift(3, -5)
    np.testing.assert_array_equal(t.image, j.image)
    np.testing.assert_array_equal(t.image, np.roll(img, -5, axis=-1))


@pytest.mark.parametrize("shape", [SIG, ROWS], ids=["single", "batched"])
def test_1d_non_separable_is_forced_separable(shape):
    j, t = _pair_1d(shape, do_separable=0)
    assert t.do_separable == j.do_separable == 1
    j.forward()
    t.forward()
    _assert_coeffs_1d(t, j)


def test_1d_haar_swt_runs_the_a_trous_levels():
    j, t = _pair_1d(ROWS, "haar", do_swt=1)
    j.forward()
    t.forward()
    assert all(c.shape == ROWS for c in t.coeffs)
    _assert_coeffs_1d(t, j)
    fb = pypwt_tpu_torch.get_filter_bank("haar")
    ref = swt.swt1d(torch.from_numpy(_img(0, ROWS)), fb, t.levels)
    for got, r in zip(t.coeffs, ref):
        np.testing.assert_array_equal(got, r.numpy())


def test_add_wavelet_refuses_swt_with_dwt():
    pairs = [_pair_1d(ROWS, img_seed=s, do_swt=w)
             for s, w in ((1, 0), (2, 1))]
    for (a, b) in zip(*pairs):
        a.forward()
        b.forward()
        with pytest.raises(ValueError, match="both use SWT or DWT"):
            a.add_wavelet(b)
    j1, t1 = _pair_1d(ROWS, img_seed=1, do_swt=1)
    j2, t2 = _pair_1d(ROWS, img_seed=2, do_swt=1)
    for a, b in ((j1, j2), (t1, t2)):
        a.forward()
        b.forward()
        assert a.add_wavelet(b, 0.5) == 0
    _assert_coeffs_1d(t1, j1)


@pytest.mark.parametrize("shape, kw", [
    (SIG, {}), (ROWS, {}), (SIG, dict(do_swt=1)), (ROWS, dict(do_swt=1))],
    ids=["single-dwt", "batched-dwt", "single-swt", "batched-swt"])
def test_1d_info_matches_jax(shape, kw):
    j, t = _pair_1d(shape, **kw)
    device_line = "Running on device"
    tl = [x for x in t._info_str().splitlines() if device_line not in x]
    jl = [x for x in j._info_str().splitlines() if device_line not in x]
    assert tl == jl
    assert "Running on device : cpu" in repr(t)


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


# ---------------------------------------------------------------------------
# 2D stationary and non-separable plans, built-in and custom 2D banks
# ---------------------------------------------------------------------------

SHAPE_2D = (96, 128)
PARTS = (("lo", "lo"), ("hi", "lo"), ("lo", "hi"), ("hi", "hi"))


def _cross_bank():
    """db3(rows) x coif1(cols): a 2D bank that does not factor into one
    isotropic 1D bank, as (LL, HH, iLL, iHH, LH, HL, iLH, iHL)."""
    fr, fc = pypwt_tpu.get_filter_bank("db3"), pypwt_tpu.get_filter_bank(
        "coif1")
    dec = [np.outer(getattr(fr, "dec_" + p), getattr(fc, "dec_" + q))
           for p, q in PARTS]
    rec = [np.outer(getattr(fr, "rec_" + p), getattr(fc, "rec_" + q))
           for p, q in PARTS]
    return (dec[0], dec[3], rec[0], rec[3]), dict(
        LH=dec[1], HL=dec[2], i_LH=rec[1], i_HL=rec[2])


MODES_2D = {
    "swt": (dict(do_swt=1), False),
    "nonsep": (dict(do_separable=0), False),
    "nonsep-swt": (dict(do_separable=0, do_swt=1), False),
    "custom2d": (dict(do_separable=0), True),
    "custom2d-swt": (dict(do_separable=0, do_swt=1), True),
}


def _pair_2d(mode, img=None, **kw):
    flags, custom = MODES_2D[mode]
    j, t = _pair(_img(0, SHAPE_2D) if img is None else img,
                 **dict(flags, **kw))
    if custom:
        args, kw2d = _cross_bank()
        for w in (j, t):
            w.set_wavelets_filters("db3xcoif1", *args, **kw2d)
    return j, t


@pytest.mark.parametrize("mode", MODES_2D)
def test_2d_modes_forward_threshold_inverse(mode):
    j, t = _pair_2d(mode)
    assert (t.levels, t.hlen, t.sizes, t.do_swt, t.do_separable) == (
        j.levels, j.hlen, j.sizes, j.do_swt, j.do_separable)
    j.forward()
    t.forward()
    _assert_coeffs(t, j)
    if t.do_swt:
        assert all(s.shape == SHAPE_2D for c in t.coeffs[1:] for s in c)
    j.soft_threshold(10.0)
    t.soft_threshold(10.0)
    _assert_coeffs(t, j)
    j.inverse()
    t.inverse()
    assert t.image.shape == SHAPE_2D
    assert np.abs(t.image - j.image).max() <= IMAGE_TOL


@pytest.mark.parametrize("mode", MODES_2D)
def test_2d_modes_thresholds_and_norms(mode):
    j, t = _pair_2d(mode)
    for op, args in (("hard_threshold", (10.0, 1, 1)),
                     ("group_soft_threshold", (10.0, 1, 0)),
                     ("proj_linf", (5.0, 1)), ("shrink", (0.5,)),
                     ("soft_threshold", (3.0, 0, 1))):
        for w in (j, t):
            w.forward()
            getattr(w, op)(*args)
        _assert_coeffs(t, j)
    assert t.norm1() == pytest.approx(j.norm1(), rel=1e-5)
    assert t.norm2sq() == pytest.approx(j.norm2sq(), rel=1e-5)


@pytest.mark.parametrize("mode", MODES_2D)
def test_2d_modes_coeff_only_and_set_coeff(mode):
    j, t = _pair_2d(mode)
    for w in (j, t):
        w.forward()
    tc = t.coeffs
    for num in range(3 * t.levels + 1):
        got, ref = t.coeff_only(num), j.coeff_only(num)
        assert got.shape == ref.shape
        expect = tc[0] if num == 0 else tc[(num - 1) // 3 + 1][(num - 1) % 3]
        np.testing.assert_array_equal(got, expect)
    for w in (j, t):
        w.set_coeff(np.zeros_like(w.coeff_only(1)), 1, check=True)
        w.set_coeff(w.coeff_only(0) * 0.5, 0)
        with pytest.raises(ValueError, match="Invalid coefficient shape"):
            w.set_coeff(np.zeros((3, 3), np.float32), 2, check=True)
    _assert_coeffs(t, j)
    for w in (j, t):
        w.inverse()
    assert np.abs(t.image - j.image).max() <= IMAGE_TOL


@pytest.mark.parametrize("mode", MODES_2D)
def test_2d_modes_add_wavelet(mode):
    j1, t1 = _pair_2d(mode, _img(1, SHAPE_2D))
    j2, t2 = _pair_2d(mode, _img(2, SHAPE_2D))
    for a, b in ((j1, j2), (t1, t2)):
        a.forward()
        b.forward()
        assert a.add_wavelet(b, 0.5) == 0
    _assert_coeffs(t1, j1)
    if t1.do_swt:  # against the decimated plan of the same bank
        base = mode[:-len("-swt")] if mode.endswith("-swt") else None
        _, t3 = (_pair_2d(base) if base else _pair(_img(1, SHAPE_2D)))
        t3.forward()
        with pytest.raises(ValueError, match="both use SWT or DWT"):
            t1.add_wavelet(t3)


@pytest.mark.parametrize("mode", MODES_2D)
def test_2d_modes_cycle_spinning(mode, capsys):
    j, t = _pair_2d(mode, do_cycle_spinning=1, seed=5)
    warned = "makes little sense" in capsys.readouterr().out
    assert warned == bool(t.do_swt)
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


@pytest.mark.parametrize("mode", MODES_2D)
def test_2d_modes_info_matches_jax(mode):
    j, t = _pair_2d(mode)
    device_line = "Running on device"
    tl = [x for x in t._info_str().splitlines() if device_line not in x]
    jl = [x for x in j._info_str().splitlines() if device_line not in x]
    assert tl == jl
    sep = "no" if mode.startswith(("nonsep", "custom")) else "yes"
    assert f"Separable transform : {sep}" in tl
    assert ("Stationary WT : yes" in tl) == mode.endswith("swt")


def test_custom_2d_bank_replaces_the_1d_bank():
    j, t = _pair_2d("custom2d")
    for w in (j, t):
        assert w._fb is None and w.hlen == 6 and w.wname == "db3xcoif1"
        assert w._f2d.separable_bank() is None
    np.testing.assert_array_equal(t._f2d.dec[1], j._f2d.dec[1])
    # a built-in name in non-separable mode factors back to its 1D bank
    _, t = _pair(do_separable=0, do_swt=1)
    assert t._f2d.separable_bank() is not None


def test_set_wavelets_filters_refusals():
    (ll, hh, ill, ihh), kw2d = _cross_bank()
    fb = pypwt_tpu.get_filter_bank("db3")
    _, sep = _pair()
    _, t = _pair(do_separable=0)
    for w in (t, pypwt_tpu.Wavelets(_img(), "db2", 3, do_separable=0)):
        with pytest.raises(ValueError, match="2D square arrays"):
            w.set_wavelets_filters("bad", fb.dec_lo, fb.dec_hi, fb.rec_lo,
                                   fb.rec_hi)
        with pytest.raises(ValueError, match="Expected LH and HL"):
            w.set_wavelets_filters("bad", ll, hh, ill, ihh)
        with pytest.raises(ValueError, match="same length"):
            w.set_wavelets_filters("bad", ll, hh, ill, ihh,
                                   **dict(kw2d, LH=np.ones((4, 4))))
        with pytest.raises(ValueError, match="too long"):
            w.set_wavelets_filters("bad", *(np.ones((42, 42)),) * 4,
                                   **{k: np.ones((42, 42)) for k in kw2d})
        with pytest.raises(ValueError, match="square"):
            w.set_wavelets_filters("bad", ll, hh, ill, ihh[:, :5],
                                   **kw2d)
    with pytest.raises(ValueError, match="same length"):
        sep.set_wavelets_filters("bad", fb.dec_lo, fb.dec_hi, fb.rec_lo,
                                 fb.rec_hi, LH=np.ones(3))
    assert t._fb is not None  # untouched by the refused calls
