"""K1/K2, K3/K4 and K10a/K10b against their plain versions on the GPU, at
small sizes (the kernel phase of chip_smoke.py), plus the auto/cuda routing
on CUDA tensors and the Wavelets plans on the card.

Needs an NVIDIA GPU and nvcc; skips without a GPU.  Imports no JAX, and
needs none of the conftest's JAX set-up, so on the GPU run it without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from pypwt_tpu_torch import Wavelets
from pypwt_tpu_torch.core import dwt
from pypwt_tpu_torch.filters import FilterBank, get_filter_bank
from pypwt_tpu_torch.ops import fused_dwt as fd

pytestmark = pytest.mark.cuda

TOL = 2e-5  # kernel vs plain on [0, 1): summation order and FMA only
BANKS = ["haar", "db2", "db8", "sym20", "bior3.5"]
SHAPES = [(8, 8), (64, 128), (2, 96, 64), (130, 258)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


def _rand(shape, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand(shape, generator=g, device=dev)


@pytest.mark.parametrize("wname", BANKS)
@pytest.mark.parametrize("shape", SHAPES)
def test_k1_matches_plain(dev, wname, shape):
    fb = get_filter_bank(wname)
    x = _rand(shape, dev)
    n = fd.dwt2d_fused.launches
    got = fd.dwt2d_fused(x, fb)
    assert fd.dwt2d_fused.launches == n + 1
    for g, r in zip(got, fd.dwt2d_plain(x, fb)):
        assert g.shape == r.shape
        assert float((g - r).abs().max()) <= TOL


@pytest.mark.parametrize("wname", BANKS)
@pytest.mark.parametrize("shape", SHAPES)
def test_k2_matches_plain(dev, wname, shape):
    fb = get_filter_bank(wname)
    cshape = (*shape[:-2], shape[-2] // 2, shape[-1] // 2)
    c = [_rand(cshape, dev, s) for s in range(4)]
    n = fd.idwt2d_fused.launches
    out = fd.idwt2d_fused(*c, fb, shape)
    assert fd.idwt2d_fused.launches == n + 1
    assert float((out - fd.idwt2d_plain(*c, fb, shape)).abs().max()) <= TOL


@pytest.mark.parametrize("shape, dtype", [((31, 22), torch.float32),
                                          ((64, 64), torch.float64)])
def test_auto_declines_uncovered_levels(dev, shape, dtype):
    fb = get_filter_bank("db2")
    x = _rand(shape, dev).to(dtype)
    fd.reset_counts()
    got = dwt.dwt2d(x, fb)
    assert (fd.dwt2d_fused.launches, fd.dwt2d_fused.declined) == (0, 1)
    for g, r in zip(got, fd.dwt2d_plain(x, fb)):
        assert torch.equal(g, r)
    dwt.set_kernels("cuda")
    try:
        with pytest.raises(ValueError, match="does not cover"):
            dwt.dwt2d(x, fb)
    finally:
        dwt.set_kernels("auto")


def test_wavelets_cuda_matches_cpu(dev):
    img = (np.random.default_rng(0).random((256, 256)) * 255).astype(
        np.float32)
    ref = Wavelets(img, "db2", 3, device="cpu").forward()
    fd.reset_counts()
    W = Wavelets(img, "db2", 3, device=dev).forward()
    for lev in range(1, 4):
        for a, b in zip(W.coeffs[lev], ref.coeffs[lev]):
            assert np.abs(a - b).max() <= 3e-4 * 2 ** lev
    W.inverse()
    assert np.abs(W.image - img).max() < 7e-4
    assert (fd.dwt2d_fused.launches, fd.idwt2d_fused.launches) == (3, 3)
    assert "Running on device : NVIDIA" in repr(W)


SHAPES_1D = [(8,), (3, 64), (2, 2100), (1, 4098)]
ODD = FilterBank("odd5", *(np.asarray(v) for v in (
    [0.1, -0.3, 0.7, 0.25, -0.05], [0.2, 0.5, -0.6, 0.1, 0.3],
    [-0.15, 0.35, 0.6, 0.2, 0.05], [0.4, -0.2, 0.1, 0.55, -0.3])))


def _close(got, ref):
    if isinstance(got, torch.Tensor):
        got, ref = (got,), (ref,)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert float((g - r).abs().max()) <= TOL


@pytest.mark.parametrize("wname", BANKS)
@pytest.mark.parametrize("shape", SHAPES_1D)
def test_k3_k4_match_plain(dev, wname, shape):
    fb = get_filter_bank(wname)
    x = _rand(shape, dev)
    n3, n4 = fd.dwt1d_fused.launches, fd.idwt1d_fused.launches
    _close(fd.dwt1d_fused(x, fb), fd.dwt1d_plain(x, fb))
    cshape = (*shape[:-1], shape[-1] // 2)
    a, d = _rand(cshape, dev, 1), _rand(cshape, dev, 2)
    _close(fd.idwt1d_fused(a, d, fb, shape[-1]),
           fd.idwt1d_plain(a, d, fb, shape[-1]))
    assert (fd.dwt1d_fused.launches, fd.idwt1d_fused.launches) == (n3 + 1,
                                                                   n4 + 1)


@pytest.mark.parametrize("wname", BANKS + ["odd5"])
@pytest.mark.parametrize("shape, level", [((8,), 3), ((4, 16), 3),
                                          ((3, 64), 1), ((2, 3000), 6),
                                          ((2, 3000), 9), ((1, 4100), 12)])
def test_k10_match_plain(dev, wname, shape, level):
    fb = ODD if wname == "odd5" else get_filter_bank(wname)
    x = _rand(shape, dev)
    n = fd.swt1d_fused.launches + fd.iswt1d_fused.launches
    _close(fd.swt1d_fused(x, fb, level), fd.swt1d_plain(x, fb, level))
    a, d = _rand(shape, dev, 1), _rand(shape, dev, 2)
    _close(fd.iswt1d_fused(a, d, fb, level),
           fd.iswt1d_plain(a, d, fb, level))
    assert fd.swt1d_fused.launches + fd.iswt1d_fused.launches == n + 2


@pytest.mark.parametrize("shape, dtype", [((4, 31), torch.float32),
                                          ((4, 64), torch.float64)])
def test_auto_declines_uncovered_1d_levels(dev, shape, dtype):
    fb = get_filter_bank("db2")
    x = _rand(shape, dev).to(dtype)
    fd.reset_counts()
    got = dwt.dwt1d(x, fb)
    assert (fd.dwt1d_fused.launches, fd.dwt1d_fused.declined) == (0, 1)
    for g, r in zip(got, fd.dwt1d_plain(x, fb)):
        assert torch.equal(g, r)
    dwt.set_kernels("cuda")
    try:
        with pytest.raises(ValueError, match="does not cover"):
            dwt.dwt1d(x, fb)
    finally:
        dwt.set_kernels("auto")


@pytest.mark.parametrize("shape", [(2048,), (16, 512)],
                         ids=["single", "batched"])
@pytest.mark.parametrize("do_swt", [0, 1], ids=["dwt", "swt"])
def test_wavelets_1d_cuda_matches_cpu(dev, shape, do_swt):
    img = (np.random.default_rng(0).random(shape) * 255).astype(np.float32)
    kw = dict(do_swt=do_swt, ndim=1 if len(shape) == 2 else 2)
    ref = Wavelets(img, "db2", 3, device="cpu", **kw).forward()
    fd.reset_counts()
    W = Wavelets(img, "db2", 3, device=dev, **kw).forward()
    levs = [3, 1, 2, 3]
    for a, b, lev in zip(W.coeffs, ref.coeffs, levs):
        assert np.abs(a - b).max() <= 3e-4 * 2 ** lev
    W.inverse()
    assert np.abs(W.image.reshape(shape) - img).max() < 7e-4
    fwd, inv = ((fd.swt1d_fused, fd.iswt1d_fused) if do_swt
                else (fd.dwt1d_fused, fd.idwt1d_fused))
    assert (fwd.launches, inv.launches) == (3, 3)
    assert sum(k.declined for k in fd.KERNELS) == 0
