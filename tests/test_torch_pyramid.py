"""The whole-pyramid kernels' plain versions (K24/K25, ``ops.fused_pyramid``)
and tail-level fusion (``core.dwt.set_tail_fuse``) against the JAX package
on the CPU: JAX's pyramid kernels run in interpret mode, as
tests/test_pyramid.py runs them, and its tail-fused path under
``set_kernels("pallas")``.  Max-abs 1e-5 on [0, 1) float32 data (JAX's own
tolerance there), roundtrips below 1e-5.  Both packages' modes are reset
in ``finally``.  The kernels themselves run only on a GPU
(tests/test_torch_kernels_cuda.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pypwt_tpu import Wavelets as JWavelets
from pypwt_tpu.core import dwt as jdwt
from pypwt_tpu.filters import FilterBank as JFilterBank
from pypwt_tpu.filters import get_filter_bank as jbank
from pypwt_tpu.ops import fused_pyramid as jfp
from pypwt_tpu_torch import Wavelets, ops, pipeline
from pypwt_tpu_torch.core import dwt
from pypwt_tpu_torch.filters import FilterBank, get_filter_bank
from pypwt_tpu_torch.ops import fused_pyramid as fp

torch.set_num_threads(1)

TOL = 1e-5
WAVELETS = ["haar", "db2", "db4", "sym8", "bior4.4"]
CASES = [((128, 128), 2), ((256, 128), 3), ((128, 256), 3)]
ODD = ([0.1, -0.3, 0.7, 0.25, -0.05], [0.2, 0.5, -0.6, 0.1, 0.3],
       [-0.15, 0.35, 0.6, 0.2, 0.05], [0.4, -0.2, 0.1, 0.55, -0.3])


def _rand(shape, seed=5):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _flat(pyr):
    return [np.asarray(pyr[0])] + [np.asarray(s) for t in pyr[1:] for s in t]


def _close(got, ref, tol=TOL):
    got, ref = _flat(got), _flat(ref)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert np.abs(g - r).max() < tol


@pytest.fixture
def modes():
    """Tail fusion and kernel modes of both packages, reset afterwards."""
    try:
        yield
    finally:
        dwt.set_kernels("auto")
        dwt.set_tail_fuse(False)
        jdwt.set_kernels("auto")
        jdwt.set_tail_fuse(False)


@pytest.mark.parametrize("wname", WAVELETS)
@pytest.mark.parametrize("shape, levels", CASES, ids=str)
def test_wavedec2_pyramid_matches_jax(wname, shape, levels):
    x = _rand(shape)
    ref = jfp.wavedec2_pyramid(jnp.asarray(x), jbank(wname), levels)
    assert ref is not None
    got = fp.wavedec2_pyramid(torch.from_numpy(x), get_filter_bank(wname),
                              levels)
    _close(dwt.pyramid_to_numpy(got), ref)


@pytest.mark.parametrize("wname", ["haar", "db2", "sym8", "bior4.4"])
@pytest.mark.parametrize("source", ["jax", "port"])
def test_waverec2_pyramid_matches_jax(wname, source):
    """The port's synthesis of JAX's pyramid and of its own, against JAX's
    synthesis of JAX's pyramid."""
    shape, levels = (128, 256), 3
    x = _rand(shape)
    jpyr = jfp.wavedec2_pyramid(jnp.asarray(x), jbank(wname), levels)
    ref = np.asarray(jfp.waverec2_pyramid(jpyr, jbank(wname), shape))
    fb = get_filter_bank(wname)
    pyr = (dwt.pyramid_from_numpy([np.asarray(jpyr[0])] + [
        tuple(np.asarray(s) for s in t) for t in jpyr[1:]], "cpu")
        if source == "jax" else fp.wavedec2_pyramid(torch.from_numpy(x), fb,
                                                    levels))
    got = fp.waverec2_pyramid(pyr, fb, shape).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < TOL
    assert np.abs(got - x).max() < TOL


def test_stack_matches_jax():
    x = _rand((2, 128, 128))
    fb, jfb = get_filter_bank("db2"), jbank("db2")
    ref = jfp.wavedec2_pyramid(jnp.asarray(x), jfb, 2)
    got = fp.wavedec2_pyramid(torch.from_numpy(x), fb, 2)
    _close(dwt.pyramid_to_numpy(got), ref)
    back = fp.waverec2_pyramid(got, fb, x.shape).numpy()
    jback = np.asarray(jfp.waverec2_pyramid(ref, jfb, x.shape))
    assert np.abs(back - jback).max() < TOL
    assert np.abs(back - x).max() < TOL


def _odd_banks():
    taps = [np.asarray(t, np.float64) for t in ODD]
    return FilterBank("odd5", *taps), JFilterBank("odd5", *taps)


@pytest.mark.parametrize("case", ["indivisible", "one-level", "odd-bank",
                                  "float64"])
def test_pyramid_none_where_jax_gives_none(case):
    """None in the same places as JAX (test_pyramid_fallbacks): 2^L not
    dividing a size, L < 2, an odd bank, float64."""
    shape, levels = {"indivisible": ((100, 128), 3),
                     "one-level": ((128, 128), 1)}.get(case, ((64, 64), 2))
    x = _rand(shape)
    fb, jfb = get_filter_bank("db2"), jbank("db2")
    if case == "odd-bank":
        fb, jfb = _odd_banks()
    if case == "float64":
        x = x.astype(np.float64)
    assert jfp.wavedec2_pyramid(jnp.asarray(x), jfb, levels) is None
    xt = torch.from_numpy(x)
    assert fp.wavedec2_pyramid(xt, fb, levels) is None
    assert fp.wavedec2_pyramid_unsupported(xt, fb, levels)
    pyr = dwt.wavedec2(xt, fb, levels)
    assert fp.waverec2_pyramid(pyr, fb, shape) is None
    assert fp.waverec2_pyramid_unsupported(pyr, fb, shape)


def test_pyramid_covers_what_only_jax_band_pick_declines():
    """(100, 128) at L2: 2^2 divides both sizes, so the port covers it;
    JAX's None there comes from its TPU band pick (no row band divides 100),
    which the port does not carry over.  The port's pyramid equals JAX's
    per-level path."""
    x = _rand((100, 128))
    assert jfp.wavedec2_pyramid(jnp.asarray(x), jbank("db2"), 2) is None
    jdwt.set_kernels("jnp")
    try:
        ref = jdwt.wavedec2(jnp.asarray(x), jbank("db2"), 2)
    finally:
        jdwt.set_kernels("auto")
    fb = get_filter_bank("db2")
    got = fp.wavedec2_pyramid(torch.from_numpy(x), fb, 2)
    _close(dwt.pyramid_to_numpy(got), ref)
    assert np.abs(fp.waverec2_pyramid(got, fb, x.shape).numpy() - x).max() \
        < TOL


@pytest.mark.parametrize("shape, levels", [((128, 128), 2), ((2, 64, 32), 5),
                                           ((33, 47), 3)], ids=str)
@pytest.mark.parametrize("wname", ["db2", "sym20"])
def test_plain_versions_are_the_per_level_loop(wname, shape, levels):
    fb = get_filter_bank(wname)
    x = torch.from_numpy(_rand(shape))
    dwt.set_kernels("torch")
    try:
        want = dwt.wavedec2(x, fb, levels)
        back = dwt.waverec2(want, fb, x.shape)
    finally:
        dwt.set_kernels("auto")
    got = fp.wavedec2_pyramid_plain(x, fb, levels)
    for g, w in zip(_flat(got), _flat(want)):
        assert np.array_equal(g, w)
    assert torch.equal(fp.waverec2_pyramid_plain(want, fb, x.shape), back)


@pytest.mark.parametrize("wname", ["db2", "sym8"])
def test_tailfused_matches_jax(wname, modes):
    shape, levels = (256, 256), 3
    x = _rand(shape)
    jdwt.set_kernels("pallas")
    ref = jdwt.wavedec2_tailfused(jnp.asarray(x), jbank(wname), levels)
    assert ref is not None
    jback = np.asarray(jdwt.waverec2_tailfused(ref, jbank(wname), shape))
    fb = get_filter_bank(wname)
    got = dwt.wavedec2_tailfused(torch.from_numpy(x), fb, levels)
    _close(dwt.pyramid_to_numpy(got), ref)
    back = dwt.waverec2_tailfused(got, fb, shape).numpy()
    assert np.abs(back - jback).max() < TOL
    assert np.abs(back - x).max() < TOL


@pytest.mark.parametrize("shape, fused", [((255, 255), True),
                                          ((254, 254), False)], ids=str)
def test_tailfused_takes_odd_frames_as_jax_does(shape, fused, modes):
    """The tail's input is the level-0 approximation: a 255^2 frame's
    128^2 is covered at L3 (JAX tail-fuses it), a 254^2 frame's 127^2 is
    not (both return None)."""
    x = _rand(shape)
    jdwt.set_kernels("pallas")
    ref = jdwt.wavedec2_tailfused(jnp.asarray(x), jbank("db2"), 3)
    fb = get_filter_bank("db2")
    got = dwt.wavedec2_tailfused(torch.from_numpy(x), fb, 3)
    assert (ref is not None) == fused and (got is not None) == fused
    if fused:
        _close(dwt.pyramid_to_numpy(got), ref)
        back = dwt.waverec2_tailfused(got, fb, shape).numpy()
        jback = np.asarray(jdwt.waverec2_tailfused(ref, jbank("db2"), shape))
        assert np.abs(back - jback).max() < TOL


def test_wavelets_with_tail_fusion_matches_jax(modes):
    x = _rand((256, 256), seed=7) * 255
    jdwt.set_kernels("pallas")
    jdwt.set_tail_fuse(True)
    JW = JWavelets(x, "db2", 3)
    JW.forward()
    jcoeffs = JW.coeffs
    JW.soft_threshold(10.0)
    JW.inverse()
    dwt.set_tail_fuse(True)
    W = Wavelets(x, "db2", 3, device="cpu")
    calls = fp.wavedec2_pyramid_fused, fp.waverec2_pyramid_fused
    W.forward()
    _close(W.coeffs, jcoeffs, 3e-4 * 8)
    W.soft_threshold(10.0)
    W.inverse()
    assert np.abs(W.image - JW.image).max() < 7e-4
    assert all(k.launches == 0 for k in calls)  # the CPU runs plain


@pytest.mark.parametrize("case", ["covered", "float64", "odd-a0", "two-levels",
                                  "odd-bank", "torch-mode"])
def test_tail_routes_decided_before_launch(case):
    fb = get_filter_bank("db2")
    shape, levels, dtype = (64, 64), 3, torch.float32
    if case == "float64":
        dtype = torch.float64
    if case == "odd-a0":
        shape = (62, 64)
    if case == "two-levels":
        levels = 2
    if case == "odd-bank":
        fb = _odd_banks()[0]
    x = torch.from_numpy(_rand(shape)).to(dtype)
    pyr = dwt.wavedec2(x, fb, levels)
    want = case == "covered"
    if case == "torch-mode":
        dwt.set_kernels("torch")
    try:
        assert dwt.use_k24(x, fb, levels) == want
        assert (dwt.wavedec2_tailfused(x, fb, levels) is not None) == want
        if levels >= 3:
            assert dwt.use_k25(pyr, fb) == want
        assert (dwt.waverec2_tailfused(pyr, fb, shape) is not None) == want
    finally:
        dwt.set_kernels("auto")


def test_cuda_mode_raises_on_cpu_tensor():
    fb = get_filter_bank("db2")
    x = torch.from_numpy(_rand((64, 64)))
    pyr = dwt.wavedec2(x, fb, 3)
    dwt.set_kernels("cuda")
    try:
        with pytest.raises(ValueError, match="CUDA tensors only"):
            dwt.wavedec2_tailfused(x, fb, 3)
        with pytest.raises(ValueError, match="CUDA tensors only"):
            dwt.waverec2_tailfused(pyr, fb, x.shape)
    finally:
        dwt.set_kernels("auto")


def test_set_tail_fuse_toggles_the_branch(monkeypatch, modes):
    """wavedec2/waverec2 enter the tail-fused path only when it is on, and
    produce the per-level result either way (on the CPU both are plain)."""
    seen = []
    for name in ("wavedec2_tailfused", "waverec2_tailfused"):
        real = getattr(dwt, name)
        monkeypatch.setattr(dwt, name, lambda *a, _r=real, _n=name: (
            seen.append(_n), _r(*a))[1])
    fb = get_filter_bank("sym8")
    x = torch.from_numpy(_rand((128, 128)))
    off = dwt.wavedec2(x, fb, 3)
    off_back = dwt.waverec2(off, fb, x.shape)
    assert seen == []
    dwt.set_tail_fuse(True)
    on = dwt.wavedec2(x, fb, 3)
    on_back = dwt.waverec2(on, fb, x.shape)
    assert seen == ["wavedec2_tailfused", "waverec2_tailfused"]
    for g, w in zip(_flat(on), _flat(off)):
        assert np.array_equal(g, w)
    assert torch.equal(on_back, off_back)


def test_denoise2d_with_tail_fusion_matches_per_level(modes):
    x = torch.from_numpy(_rand((128, 128), seed=3) * 255)
    want = pipeline.denoise2d(x, "db2", 3, 10.0)
    dwt.set_tail_fuse(True)
    got = pipeline.denoise2d(x, "db2", 3, 10.0)
    assert torch.equal(got, want)
    assert all(k.launches == 0 for k in ops.KERNELS)
