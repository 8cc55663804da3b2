"""K1/K2 against their plain versions on the GPU, at small sizes (the
kernel phase of chip_smoke.py), plus the auto/cuda routing on CUDA tensors.

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
from pypwt_tpu_torch.filters import get_filter_bank
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
