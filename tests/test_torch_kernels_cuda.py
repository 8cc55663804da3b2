"""K1/K2, K3/K4, K10a/K10b, K8/K9 and K18a/K18b against their plain
versions on the GPU, at small sizes (the kernel phase of chip_smoke.py),
plus the auto/cuda routing on CUDA tensors and the Wavelets plans on the
card.

Needs an NVIDIA GPU and nvcc; skips without a GPU.  Imports no JAX, and
needs none of the conftest's JAX set-up, so on the GPU run it without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from pypwt_tpu_torch import Wavelets, ops
from pypwt_tpu_torch.core import dwt, nonsep, swt
from pypwt_tpu_torch.core.nonsep import Filters2D
from pypwt_tpu_torch.filters import FilterBank, get_filter_bank
from pypwt_tpu_torch.ops import fused_dwt as fd
from pypwt_tpu_torch.ops import nonsep as kn

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
    ops.reset_counts()
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
    ops.reset_counts()
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
    ops.reset_counts()
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
    ops.reset_counts()
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


# -- 2D stationary (K8/K9) and non-separable stationary (K18a/K18b) -------

SHAPES_2D = [(8, 8), (33, 47), (2, 64, 96), (130, 258)]


@pytest.mark.parametrize("wname", BANKS + ["odd5"])
@pytest.mark.parametrize("shape", SHAPES_2D, ids=str)
@pytest.mark.parametrize("level", [1, 2, 4])
def test_k8_k9_match_plain(dev, wname, shape, level):
    fb = ODD if wname == "odd5" else get_filter_bank(wname)
    x = _rand(shape, dev)
    n = fd.swt2d_fused.launches + fd.iswt2d_fused.launches
    _close(fd.swt2d_fused(x, fb, level), fd.swt2d_plain(x, fb, level))
    c = [_rand(shape, dev, s) for s in range(1, 5)]
    _close(fd.iswt2d_fused(*c, fb, level), fd.iswt2d_plain(*c, fb, level))
    assert fd.swt2d_fused.launches + fd.iswt2d_fused.launches == n + 2


PARTS = (("lo", "lo"), ("hi", "lo"), ("lo", "hi"), ("hi", "hi"))


def _f2d(name):
    if name == "dense8":
        g = np.random.default_rng(8)
        return Filters2D(list(g.random((4, 8, 8)) / 8),
                         list(g.random((4, 8, 8)) / 8), name)
    fr, fc = get_filter_bank("db3"), get_filter_bank("coif1")
    return Filters2D(
        [np.outer(getattr(fr, "dec_" + p), getattr(fc, "dec_" + q))
         for p, q in PARTS],
        [np.outer(getattr(fr, "rec_" + p), getattr(fc, "rec_" + q))
         for p, q in PARTS], name)


@pytest.mark.parametrize("name", ["db3xcoif1", "dense8"])
@pytest.mark.parametrize("shape", [(8, 8), (64, 128), (2, 33, 47)], ids=str)
@pytest.mark.parametrize("level", [1, 2, 3])
def test_k18_match_plain(dev, name, shape, level):
    f2d = _f2d(name)
    x = _rand(shape, dev)
    n = fd.swt2d_fused.launches
    m = kn.ns_swt2d_fused.launches + kn.ins_swt2d_fused.launches
    _close(kn.ns_swt2d_fused(x, f2d, level), kn.ns_swt2d_plain(x, f2d, level))
    c = [_rand(shape, dev, s) for s in range(1, 5)]
    _close(kn.ins_swt2d_fused(*c, f2d, level),
           kn.ins_swt2d_plain(*c, f2d, level))
    assert kn.ns_swt2d_fused.launches + kn.ins_swt2d_fused.launches == m + 2
    assert fd.swt2d_fused.launches == n


@pytest.mark.parametrize("mode", ["swt", "nonsep", "nonsep-swt",
                                  "custom2d-swt"])
def test_wavelets_2d_modes_cuda_match_cpu(dev, mode):
    img = (np.random.default_rng(0).random((128, 96)) * 255).astype(
        np.float32)
    kw = dict(do_swt=int(mode.endswith("swt")),
              do_separable=int(mode == "swt"))
    plans = []
    for device in ("cpu", dev):
        W = Wavelets(img, "db2", 3, device=device, **kw)
        if mode.startswith("custom"):
            f = _f2d("db3xcoif1")
            W.set_wavelets_filters("db3xcoif1", f.dec[0], f.dec[3], f.rec[0],
                                   f.rec[3], LH=f.dec[1], HL=f.dec[2],
                                   i_LH=f.rec[1], i_HL=f.rec[2])
        plans.append(W)
    ref, W = plans
    ref.forward()
    ops.reset_counts()
    W.forward()
    for lev in range(1, 4):
        for a, b in zip(W.coeffs[lev], ref.coeffs[lev]):
            assert np.abs(a - b).max() <= 3e-4 * 2 ** lev
    W.inverse()
    assert np.abs(W.image - img).max() < 7e-4
    want = {"swt": ("swt2d_fused", "iswt2d_fused"),
            "nonsep": ("dwt2d_fused", "idwt2d_fused"),
            "nonsep-swt": ("swt2d_fused", "iswt2d_fused"),
            "custom2d-swt": ("ns_swt2d_fused", "ins_swt2d_fused")}[mode]
    got = {k.__name__: k.launches for k in ops.KERNELS if k.launches}
    assert got == {want[0]: 3, want[1]: 3}
    assert sum(k.declined for k in ops.KERNELS) == 0


ROUTES_2D_SWT = {
    "K8": lambda x, fb, f2d: swt.swt2d_level(x, fb, 2),
    "K9": lambda x, fb, f2d: swt.iswt2d_level(x, x, x, x, fb, 2),
    "K18a": lambda x, fb, f2d: nonsep.ns_swt2d_level(x, f2d, 2),
    "K18b": lambda x, fb, f2d: nonsep.ins_swt2d_level(x, x, x, x, f2d, 2),
}


@pytest.mark.parametrize("route", sorted(ROUTES_2D_SWT))
def test_2d_swt_routes_raise_on_float64(dev, route):
    """K8/K9/K18a/K18b never decline: float64 on the card raises in mode
    "auto", and mode "torch" runs the plain version on the device."""
    call = ROUTES_2D_SWT[route]
    fb, f2d = get_filter_bank("db2"), _f2d("db3xcoif1")
    x = _rand((16, 24), dev).double()
    ops.reset_counts()
    with pytest.raises(ValueError, match="float64"):
        call(x, fb, f2d)
    dwt.set_kernels("torch")
    try:
        got = call(x, fb, f2d)
    finally:
        dwt.set_kernels("auto")
    want = call(x.cpu(), fb, f2d)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.is_cuda and float((g.cpu() - w).abs().max()) <= 1e-12
    assert sum(k.launches + k.declined for k in ops.KERNELS) == 0


@pytest.mark.parametrize("shape, level", [((70000, 2, 3), 2),
                                          ((2200000, 1), 1),
                                          ((600000, 1), 3)], ids=str)
def test_2d_swt_kernels_past_the_grid_axis_limits(dev, shape, level):
    """More than 65535 planes or row tiles: the level goes in chunks of
    launches, so every such level runs on its kernel."""
    fb, f2d = get_filter_bank("db2"), _f2d("dense8")
    x = _rand(shape, dev)
    c = [_rand(shape, dev, s) for s in range(1, 5)]
    ops.reset_counts()
    _close(fd.swt2d_fused(x, fb, level), fd.swt2d_plain(x, fb, level))
    _close(fd.iswt2d_fused(*c, fb, level), fd.iswt2d_plain(*c, fb, level))
    _close(kn.ns_swt2d_fused(x, f2d, level), kn.ns_swt2d_plain(x, f2d, level))
    _close(kn.ins_swt2d_fused(*c, f2d, level),
           kn.ins_swt2d_plain(*c, f2d, level))
    assert {k.__name__: k.launches for k in ops.KERNELS if k.launches} == {
        "swt2d_fused": 1, "iswt2d_fused": 1, "ns_swt2d_fused": 1,
        "ins_swt2d_fused": 1}


def test_non_factorable_dwt_level_raises_on_cuda(dev):
    f2d = _f2d("db3xcoif1")
    x = _rand((32, 48), dev)
    with pytest.raises(NotImplementedError, match="item 6"):
        nonsep.nsdwt2d(x, f2d)
    c = [_rand((16, 24), dev, s) for s in range(4)]
    with pytest.raises(NotImplementedError, match="K16/K17"):
        nonsep.insdwt2d(*c, f2d, (32, 48))
    W = Wavelets(np.zeros((32, 48), np.float32), "db2", 2, device=dev,
                 do_separable=0)
    W.set_wavelets_filters(f2d.name, f2d.dec[0], f2d.dec[3], f2d.rec[0],
                           f2d.rec[3], LH=f2d.dec[1], HL=f2d.dec[2],
                           i_LH=f2d.rec[1], i_HL=f2d.rec[2])
    with pytest.raises(NotImplementedError, match="K16/K17"):
        W.forward()
    dwt.set_kernels("torch")
    try:
        got = nonsep.nsdwt2d(x, f2d)
    finally:
        dwt.set_kernels("auto")
    for g, r in zip(got, nonsep.nsdwt2d(x.cpu(), f2d)):
        assert float((g.cpu() - r).abs().max()) <= TOL
