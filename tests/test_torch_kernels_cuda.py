"""K1/K2, K3/K4, K10a/K10b, K8/K9, K16/K17, K18a/K18b, K19/K20, the
tensor-core forms K5/K6, K7a/K7b, K11a/K11b and K12a/K12b (both
precisions), the whole-pyramid kernels K24/K25, the row-sharded K26-K28
and the grid and sequence passes K29a-K29h against their plain
versions on the GPU, at small sizes (the kernel phase of chip_smoke.py),
odd sizes and odd filter lengths included; the float64 instances of the
tap-loop kernels against their float64 plain versions; plus the
auto/cuda/mxu routing on CUDA tensors, tail fusion's routes, the Wavelets
plans (float64 ones included) and the denoising pipelines on the card.

Needs an NVIDIA GPU and nvcc; skips without a GPU.  Imports no JAX, and
needs none of the conftest's JAX set-up, so on the GPU run it without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py
"""

import ctypes
import hashlib

import numpy as np
import pytest
import torch

from pypwt_tpu_torch import Wavelets, ops, pipeline
from pypwt_tpu_torch.core import conv, dwt, nonsep, swt
from pypwt_tpu_torch.core.nonsep import Filters2D
from pypwt_tpu_torch.filters import FilterBank, get_filter_bank
from pypwt_tpu_torch.ops import _build
from pypwt_tpu_torch.ops import fused_dwt as fd
from pypwt_tpu_torch.ops import fused_pyramid as kp
from pypwt_tpu_torch.ops import mxu_dwt as km
from pypwt_tpu_torch.ops import mxu_swt as kms
from pypwt_tpu_torch.ops import nonsep as kn
from pypwt_tpu_torch.ops import shifted as ks

pytestmark = pytest.mark.cuda

TOL = 2e-5  # kernel vs plain on [0, 1): summation order and FMA only
BANKS = ["haar", "db2", "db8", "sym20", "bior3.5", "odd5"]
SHAPES = [(8, 8), (64, 128), (2, 96, 64), (130, 258), (33, 47),
          (2, 31, 22), (1, 1)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


def _rand(shape, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand(shape, generator=g, device=dev)


ODD = FilterBank("odd5", *(np.asarray(v) for v in (
    [0.1, -0.3, 0.7, 0.25, -0.05], [0.2, 0.5, -0.6, 0.1, 0.3],
    [-0.15, 0.35, 0.6, 0.2, 0.05], [0.4, -0.2, 0.1, 0.55, -0.3])))


def _bank(wname):
    return ODD if wname == "odd5" else get_filter_bank(wname)


def _half(shape):
    return (*shape[:-2], (shape[-2] + 1) // 2, (shape[-1] + 1) // 2)


@pytest.mark.parametrize("wname", BANKS)
@pytest.mark.parametrize("shape", SHAPES)
def test_k1_matches_plain(dev, wname, shape):
    fb = _bank(wname)
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
    fb = _bank(wname)
    c = [_rand(_half(shape), dev, s) for s in range(4)]
    n = fd.idwt2d_fused.launches
    out = fd.idwt2d_fused(*c, fb, shape)
    assert fd.idwt2d_fused.launches == n + 1
    assert float((out - fd.idwt2d_plain(*c, fb, shape)).abs().max()) <= TOL


@pytest.mark.parametrize("shape, dtype", [((31, 22), torch.float32),
                                          ((64, 64), torch.float64)])
def test_auto_declines_uncovered_levels(dev, shape, dtype):
    """No level is declined: an odd float32 plane launches K1, a float64
    one its float64 instance, float16 raises in modes "auto" and "cuda",
    and mode "torch" runs the plain version on the device."""
    fb = get_filter_bank("db2")
    x = _rand(shape, dev).to(dtype)
    ops.reset_counts()
    got = dwt.dwt2d(x, fb)
    for g, r in zip(got, fd.dwt2d_plain(x, fb)):
        assert g.dtype == dtype
        assert float((g - r).abs().max()) <= (
            TOL if dtype == torch.float32 else 1e-12)
    assert fd.dwt2d_fused.launches == 1
    if dtype == torch.float32:
        return
    x = x.half()
    ops.reset_counts()
    for mode in ("auto", "cuda"):
        dwt.set_kernels(mode)
        try:
            with pytest.raises(ValueError, match="does not cover"):
                dwt.dwt2d(x, fb)
        finally:
            dwt.set_kernels("auto")
    dwt.set_kernels("torch")
    try:
        got = dwt.dwt2d(x, fb)
    finally:
        dwt.set_kernels("auto")
    for g, r in zip(got, fd.dwt2d_plain(x, fb)):
        assert g.is_cuda and torch.equal(g, r)
    assert fd.dwt2d_fused.launches == 0


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


SHAPES_1D = [(8,), (3, 64), (2, 2100), (1, 4098), (7,), (3, 63),
             (2, 2101)]


def _close(got, ref):
    if isinstance(got, torch.Tensor):
        got, ref = (got,), (ref,)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert float((g - r).abs().max()) <= TOL


@pytest.mark.parametrize("wname", BANKS)
@pytest.mark.parametrize("shape", SHAPES_1D)
def test_k3_k4_match_plain(dev, wname, shape):
    fb = _bank(wname)
    x = _rand(shape, dev)
    n3, n4 = fd.dwt1d_fused.launches, fd.idwt1d_fused.launches
    _close(fd.dwt1d_fused(x, fb), fd.dwt1d_plain(x, fb))
    cshape = (*shape[:-1], (shape[-1] + 1) // 2)
    a, d = _rand(cshape, dev, 1), _rand(cshape, dev, 2)
    _close(fd.idwt1d_fused(a, d, fb, shape[-1]),
           fd.idwt1d_plain(a, d, fb, shape[-1]))
    assert (fd.dwt1d_fused.launches, fd.idwt1d_fused.launches) == (n3 + 1,
                                                                   n4 + 1)


@pytest.mark.parametrize("wname", BANKS)
@pytest.mark.parametrize("shape, level", [((8,), 3), ((4, 16), 3),
                                          ((3, 64), 1), ((2, 3000), 6),
                                          ((2, 3000), 9), ((1, 4100), 12)])
def test_k10_match_plain(dev, wname, shape, level):
    fb = _bank(wname)
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
    """An odd float32 row launches K3, a float64 one its float64 instance;
    float16 raises."""
    fb = get_filter_bank("db2")
    x = _rand(shape, dev).to(dtype)
    ops.reset_counts()
    got = dwt.dwt1d(x, fb)
    for g, r in zip(got, fd.dwt1d_plain(x, fb)):
        assert g.dtype == dtype
        assert float((g - r).abs().max()) <= (
            TOL if dtype == torch.float32 else 1e-12)
    assert fd.dwt1d_fused.launches == 1
    if dtype == torch.float32:
        return
    ops.reset_counts()
    with pytest.raises(ValueError, match="does not cover"):
        dwt.dwt1d(x.half(), fb)
    assert fd.dwt1d_fused.launches == 0


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


# -- 2D stationary (K8/K9) and non-separable stationary (K18a/K18b) -------

SHAPES_2D = [(8, 8), (33, 47), (2, 64, 96), (130, 258)]


@pytest.mark.parametrize("wname", BANKS)
@pytest.mark.parametrize("shape", SHAPES_2D, ids=str)
@pytest.mark.parametrize("level", [1, 2, 4])
def test_k8_k9_match_plain(dev, wname, shape, level):
    fb = _bank(wname)
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


ROUTES_2D_SWT = {
    "K1": lambda x, fb, f2d: dwt.dwt2d(x, fb),
    "K2": lambda x, fb, f2d: dwt.idwt2d(x, x, x, x, fb, (31, 47)),
    "K3": lambda x, fb, f2d: dwt.dwt1d(x, fb),
    "K4": lambda x, fb, f2d: dwt.idwt1d(x, x, fb, 47),
    "K16": lambda x, fb, f2d: nonsep.nsdwt2d(x, f2d),
    "K17": lambda x, fb, f2d: nonsep.insdwt2d(x, x, x, x, f2d, (32, 48)),
    "K19": lambda x, fb, f2d: dwt.dwt2d_shifted(x, fb, 3, 1, "soft", 0.1),
    "K20": lambda x, fb, f2d: dwt.idwt2d_unshift(x, x, x, x, fb, (32, 48), 1,
                                                  5, x.new_zeros(32, 48)),
    "K8": lambda x, fb, f2d: swt.swt2d_level(x, fb, 2),
    "K9": lambda x, fb, f2d: swt.iswt2d_level(x, x, x, x, fb, 2),
    "K18a": lambda x, fb, f2d: nonsep.ns_swt2d_level(x, f2d, 2),
    "K18b": lambda x, fb, f2d: nonsep.ins_swt2d_level(x, x, x, x, f2d, 2),
}


@pytest.mark.parametrize("route", sorted(ROUTES_2D_SWT))
def test_2d_swt_routes_raise_on_float64(dev, route):
    """No kernel declines: float64 on the card runs on the kernel's float64
    instance in mode "auto" (K19/K20, float32 only, raise), float16 raises,
    and mode "torch" runs the plain version on the device."""
    call = ROUTES_2D_SWT[route]
    fb, f2d = get_filter_bank("db2"), _f2d("db3xcoif1")
    x = _rand((16, 24), dev).double()
    ops.reset_counts()
    if route in ("K19", "K20"):
        with pytest.raises(ValueError, match="float64"):
            call(x, fb, f2d)
    else:
        got = call(x, fb, f2d)
        want = call(x.cpu(), fb, f2d)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert g.dtype == torch.float64
            assert float((g.cpu() - w).abs().max()) <= 1e-12
        assert sum(k.launches for k in ops.KERNELS) == 1
        ops.reset_counts()
        with pytest.raises(ValueError, match="float16"):
            call(x.half(), fb, f2d)
    dwt.set_kernels("torch")
    try:
        got = call(x, fb, f2d)
    finally:
        dwt.set_kernels("auto")
    want = call(x.cpu(), fb, f2d)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.is_cuda and float((g.cpu() - w).abs().max()) <= 1e-12
    assert sum(k.launches for k in ops.KERNELS) == 0


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
    """The DWT of a bank that does not factor runs on K16/K17 (it raised
    before they were ported); float64 raises."""
    f2d = _f2d("db3xcoif1")
    x = _rand((32, 48), dev)
    ops.reset_counts()
    _close(nonsep.nsdwt2d(x, f2d), kn.nsdwt2d_plain(x, f2d))
    c = [_rand((16, 24), dev, s) for s in range(4)]
    _close(nonsep.insdwt2d(*c, f2d, (32, 48)),
           kn.insdwt2d_plain(*c, f2d, (32, 48)))
    W = Wavelets(x.cpu().numpy(), "db2", 2, device=dev, do_separable=0)
    W.set_wavelets_filters(f2d.name, f2d.dec[0], f2d.dec[3], f2d.rec[0],
                           f2d.rec[3], LH=f2d.dec[1], HL=f2d.dec[2],
                           i_LH=f2d.rec[1], i_HL=f2d.rec[2])
    W.forward()
    W.inverse()
    assert np.abs(W.image - x.cpu().numpy()).max() < 7e-4
    assert (kn.nsdwt2d_fused.launches, kn.insdwt2d_fused.launches) == (3, 3)
    xd = x.double()
    _close(nonsep.nsdwt2d(xd, f2d), kn.nsdwt2d_plain(xd, f2d))
    assert kn.nsdwt2d_fused.launches == 4
    with pytest.raises(ValueError, match="float16"):
        nonsep.nsdwt2d(x.half(), f2d)


@pytest.mark.parametrize("name", ["db3xcoif1", "dense8", "dense5"])
@pytest.mark.parametrize("shape", [(8, 8), (64, 128), (2, 33, 47), (7, 1)],
                         ids=str)
def test_k16_k17_match_plain(dev, name, shape):
    if name == "dense5":
        g = np.random.default_rng(5)
        f2d = Filters2D(list(g.random((4, 5, 5)) / 5),
                        list(g.random((4, 5, 5)) / 5), name)
    else:
        f2d = _f2d(name)
    x = _rand(shape, dev)
    n = kn.nsdwt2d_fused.launches + kn.insdwt2d_fused.launches
    _close(kn.nsdwt2d_fused(x, f2d), kn.nsdwt2d_plain(x, f2d))
    c = [_rand(_half(shape), dev, s) for s in range(1, 5)]
    _close(kn.insdwt2d_fused(*c, f2d, shape),
           kn.insdwt2d_plain(*c, f2d, shape))
    assert kn.nsdwt2d_fused.launches + kn.insdwt2d_fused.launches == n + 2


SHIFTS = [(0, 0), (1, 1), (2, 3), (7, 5), (8, 8), (1, 127), (6, 77),
          (127, 1), (300, 301)]


@pytest.mark.parametrize("wname", ["db2", "sym4", "haar", "odd5"])
@pytest.mark.parametrize("shape", [(128, 128), (65, 47), (2, 64, 96)],
                         ids=str)
@pytest.mark.parametrize("shift", SHIFTS, ids=str)
def test_k19_k20_match_plain(dev, wname, shape, shift):
    fb = _bank(wname)
    sr, sc = shift
    x = _rand(shape, dev)
    n = ks.dwt2d_shifted_fused.launches + ks.idwt2d_unshift_fused.launches
    for mode in (None, "soft", "hard"):
        _close(ks.dwt2d_shifted_fused(x, fb, sr, sc, mode, 0.3),
               ks.dwt2d_shifted_plain(x, fb, sr, sc, mode, 0.3))
    c = [_rand(_half(shape), dev, s) for s in range(1, 5)]
    acc = _rand(shape, dev, 9)
    _close(ks.idwt2d_unshift_fused(*c, fb, shape, sr, sc),
           ks.idwt2d_unshift_plain(*c, fb, shape, sr, sc))
    _close(ks.idwt2d_unshift_fused(*c, fb, shape, sr, sc, acc, 0.25),
           ks.idwt2d_unshift_plain(*c, fb, shape, sr, sc, acc, 0.25))
    assert (ks.dwt2d_shifted_fused.launches
            + ks.idwt2d_unshift_fused.launches) == n + 5


def test_k23_map_is_k19_per_spin_and_k20_accumulating(dev):
    """The multi-shift map: K19 once per spin, K20 accumulating, equals the
    mean of the spins' rolled plain syntheses."""
    fb = get_filter_bank("db2")
    x = _rand((128, 128), dev)
    shifts = ((0, 0), (2, 1), (4, 2), (6, 3))
    acc = ref = None
    for k, (sr, sc) in enumerate(shifts):
        c = ks.dwt2d_shifted_fused(x, fb, sr, sc)
        scale = 0.25 if k == len(shifts) - 1 else 1.0
        acc = ks.idwt2d_unshift_fused(*c, fb, x.shape, sr, sc, acc, scale)
        y = torch.roll(fd.idwt2d_plain(*c, fb, x.shape), (-sr, -sc), (-2, -1))
        ref = y if ref is None else ref + y
    _close(acc, ref * 0.25)
    _close(acc, x)


@pytest.mark.parametrize("mode", ["static", "random", "denoise", "odd"])
def test_pipeline_cuda_matches_cpu(dev, mode):
    img = (np.random.default_rng(0).random((128, 128)) * 255).astype(
        np.float32)
    if mode == "odd":
        img = img[:127, :101].copy()

    def run(device):
        x = torch.from_numpy(img).to(device)
        if mode == "denoise":
            return pipeline.denoise2d(x, "db2", 3, 10.0)
        if mode in ("static", "odd"):
            return pipeline.denoise2d_cycle_spinning(
                x, "db2", 3, 10.0, shifts=((0, 0), (1, 1), (2, 2), (3, 3)))
        return pipeline.denoise2d_cycle_spinning(
            x, "db2", 3, 10.0, generator=torch.Generator().manual_seed(7),
            n_spins=4)
    ref = run("cpu")
    ops.reset_counts()
    got = run(dev)
    assert got.is_cuda and float((got.cpu() - ref).abs().max()) < 7e-4
    counts = {k.__name__: k.launches for k in ops.KERNELS if k.launches}
    want = {"static": {"dwt2d_shifted_fused": 4, "idwt2d_unshift_fused": 4,
                       "dwt2d_fused": 8, "idwt2d_fused": 8},
            "odd": {"dwt2d_shifted_fused": 4, "idwt2d_unshift_fused": 4,
                    "dwt2d_fused": 8, "idwt2d_fused": 8},
            "random": {"dwt2d_shifted_fused": 12,
                       "idwt2d_unshift_fused": 12},
            "denoise": {"dwt2d_fused": 3, "idwt2d_fused": 3}}[mode]
    assert counts == want


# -- the tensor-core forms: K5/K6, K11a/K11b ------------------------------

# the banks and planes of chip_smoke.py's tensor-core phase, and small
# and odd ones
MXU_BANKS = ["db2", "db4", "sym8", "coif3", "bior4.4", "db10", "sym20"]
MXU_SHAPES = [(2048, 2048), (1024, 4096), (4096, 1024), (3, 256, 512),
              (64, 128)]


def _close_prec(got, ref, prec):
    """"highest" (3xTF32): TOL.  "bf16": both operands rounded to bf16 in
    each pass; kernel and plain sum the same exact products in another
    order, so an intermediate may round to the other neighbour, which moves
    an output by at most a tap times one bf16 ulp (2^-8 relative) of it:
    max-abs within 2^-6 of the largest output, RMS within 1e-3 of the
    output's RMS."""
    if isinstance(got, torch.Tensor):
        got, ref = (got,), (ref,)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        err = (g - r).abs()
        if prec == "highest":
            assert float(err.max()) <= TOL
        else:
            assert float(err.max()) <= 2 ** -6 * float(r.abs().max())
            assert float(err.pow(2).mean().sqrt()) <= 1e-3 * float(
                r.pow(2).mean().sqrt())


@pytest.mark.parametrize("prec", ["highest", "bf16"])
@pytest.mark.parametrize("wname", MXU_BANKS)
@pytest.mark.parametrize("shape", MXU_SHAPES + [(2, 96, 64), (130, 258),
                                                (6, 10), (2, 2)], ids=str)
def test_k5_k6_match_plain(dev, wname, shape, prec):
    fb = get_filter_bank(wname)
    x = _rand(shape, dev)
    n = km.dwt2d_mxu_fused.launches + km.idwt2d_mxu_fused.launches
    _close_prec(km.dwt2d_mxu_fused(x, fb, prec),
                km.dwt2d_mxu_plain(x, fb, prec), prec)
    c = [_rand(_half(shape), dev, s) for s in range(1, 5)]
    _close_prec(km.idwt2d_mxu_fused(*c, fb, shape, prec),
                km.idwt2d_mxu_plain(*c, fb, shape, prec), prec)
    assert km.dwt2d_mxu_fused.launches + km.idwt2d_mxu_fused.launches == n + 2


@pytest.mark.parametrize("prec", ["highest", "bf16"])
@pytest.mark.parametrize("wname", MXU_BANKS + ["haar", "odd5"])
@pytest.mark.parametrize("shape", MXU_SHAPES + [(2, 33, 47), (130, 258)],
                         ids=str)
@pytest.mark.parametrize("level", [1, 2, 3, 4])
def test_k11_match_plain(dev, wname, shape, level, prec):
    """Every level whose support fits in the plane runs on K11a/K11b; a
    wider one is refused before launch."""
    fb = _bank(wname)
    x = _rand(shape, dev)
    c = [_rand(shape, dev, s) for s in range(1, 5)]
    n = kms.swt2d_mxu_fused.launches + kms.iswt2d_mxu_fused.launches
    if kms.swt2d_mxu_unsupported(x, fb, level):
        with pytest.raises(ValueError, match="wider than the plane"):
            kms.swt2d_mxu_fused(x, fb, level, prec)
        return
    _close_prec(kms.swt2d_mxu_fused(x, fb, level, prec),
                kms.swt2d_mxu_plain(x, fb, level, prec), prec)
    _close_prec(kms.iswt2d_mxu_fused(*c, fb, level, prec),
                kms.iswt2d_mxu_plain(*c, fb, level, prec), prec)
    assert (kms.swt2d_mxu_fused.launches
            + kms.iswt2d_mxu_fused.launches) == n + 2


def _mxu(mode, prec="highest"):
    dwt.set_kernels(mode)
    dwt.set_mxu_precision(prec)


@pytest.mark.parametrize("mode", ["auto", "mxu"])
@pytest.mark.parametrize("do_swt", [0, 1], ids=["dwt", "swt"])
def test_sym8_paths_route_by_mode(dev, mode, do_swt):
    """"auto" launches no tensor-core kernel on the sym8 paths; "mxu"
    launches K5/K6 (K11a/K11b) once per level and nothing else."""
    img = (np.random.default_rng(0).random((256, 192)) * 255).astype(
        np.float32)  # sym8 keeps 3 levels (the clamp)
    ref = Wavelets(img, "sym8", 3, device="cpu", do_swt=do_swt).forward()
    try:
        _mxu(mode)
        ops.reset_counts()
        W = Wavelets(img, "sym8", 3, device=dev, do_swt=do_swt).forward()
        coeffs = W.coeffs
        W.inverse()
    finally:
        _mxu("auto")
    for lev in range(1, 4):
        for a, b in zip(coeffs[lev], ref.coeffs[lev]):
            assert np.abs(a - b).max() <= 3e-4 * 2 ** lev
    assert np.abs(W.image - img).max() < 7e-4
    names = {("auto", 0): ("dwt2d_fused", "idwt2d_fused"),
             ("auto", 1): ("swt2d_fused", "iswt2d_fused"),
             ("mxu", 0): ("dwt2d_mxu_fused", "idwt2d_mxu_fused"),
             ("mxu", 1): ("swt2d_mxu_fused", "iswt2d_mxu_fused")}[
                 (mode, do_swt)]
    got = {k.__name__: k.launches for k in ops.KERNELS if k.launches}
    assert got == {names[0]: 3, names[1]: 3}


@pytest.mark.parametrize("prec", ["highest", "bf16"])
def test_mxu_mode_stack_and_bf16_gate(dev, prec):
    """A stack through wavedec2/waverec2 and swt2d/iswt2d in mode "mxu":
    "highest" within the reference envelope of the plain path, "bf16"
    within JAX's loose gate (RMS error <= 1 % of the reference's RMS per
    subband at level 1, doubling per level as the reference's envelope
    does; the roundtrip at its depth)."""
    fb = get_filter_bank("sym8")
    x = torch.from_numpy((np.random.default_rng(1).random((3, 64, 96))
                          * 255).astype(np.float32))
    refs = (dwt.wavedec2(x, fb, 3), swt.swt2d(x, fb, 3))
    try:
        _mxu("mxu", prec)
        ops.reset_counts()
        xd = x.to(dev)
        pyrs = (dwt.wavedec2(xd, fb, 3), swt.swt2d(xd, fb, 3))
        backs = (dwt.waverec2(pyrs[0], fb, xd.shape), swt.iswt2d(pyrs[1], fb))
    finally:
        _mxu("auto")
    for pyr, ref, back in zip(pyrs, refs, backs):
        pairs = [(pyr[0], ref[0], 3)] + [
            (g, r, lev) for lev in range(1, 4)
            for g, r in zip(pyr[lev], ref[lev])]
        for g, r, lev in pairs:
            g = g.cpu()
            if prec == "highest":
                assert float((g - r).abs().max()) <= 3e-4 * 2 ** lev
            else:
                assert float((g - r).pow(2).mean().sqrt()) <= (
                    0.01 * 2 ** (lev - 1) * float(r.pow(2).mean().sqrt()))
        err = (back.cpu() - x)
        if prec == "highest":
            assert float(err.abs().max()) < 7e-4
        else:  # the roundtrip of 3 levels: the gate of level 3
            assert float(err.pow(2).mean().sqrt()) <= 0.04 * float(
                x.pow(2).mean().sqrt())
    got = {k.__name__: k.launches for k in ops.KERNELS if k.launches}
    assert got == {"dwt2d_mxu_fused": 3, "idwt2d_mxu_fused": 3,
                   "swt2d_mxu_fused": 3, "iswt2d_mxu_fused": 3}


@pytest.mark.parametrize("case", ["haar", "odd-plane", "wide-support",
                                  "float64"])
def test_mxu_mode_sends_uncovered_levels_to_jax_route(dev, case):
    """Mode "mxu" sends what K5/K6/K11 do not cover where JAX sends it:
    hlen 2 and odd planes to K1/K2, a dilated support wider than the plane
    to K8/K9; float64 to K1/K2's float64 instances."""
    fb = get_filter_bank("haar" if case == "haar" else "sym8")
    shape = (31, 22) if case == "odd-plane" else (32, 48)
    x = _rand(shape, dev)
    try:
        _mxu("mxu")
        ops.reset_counts()
        if case == "float64":
            xd = x.double()
            c = dwt.dwt2d(xd, fb)
            _close(c, fd.dwt2d_plain(xd, fb))
            _close(dwt.idwt2d(*c, fb, shape), fd.idwt2d_plain(*c, fb, shape))
            assert {k.__name__: k.launches for k in ops.KERNELS
                    if k.launches} == {"dwt2d_fused": 1, "idwt2d_fused": 1}
            return
        if case == "wide-support":
            _close(swt.swt2d_level(x, fb, 4), fd.swt2d_plain(x, fb, 4))
            want = {"swt2d_fused": 1}
        else:
            c = dwt.dwt2d(x, fb)
            _close(c, fd.dwt2d_plain(x, fb))
            _close(dwt.idwt2d(*c, fb, shape), fd.idwt2d_plain(*c, fb, shape))
            want = {"dwt2d_fused": 1, "idwt2d_fused": 1}
    finally:
        _mxu("auto")
    assert {k.__name__: k.launches for k in ops.KERNELS if k.launches} == want


# -- the 1D tensor-core forms K7a/K7b, K12a/K12b -----------------------------

SHAPES_MXU_1D = [(8, 256), (3, 130), (1, 4096), (5, 16), (2, 2), (300, 8),
                 (2048, 2048), (1, 4 * 1024 * 1024)]


@pytest.mark.parametrize("prec", ["highest", "bf16"])
@pytest.mark.parametrize("wname", ["db2", "sym8", "db10", "sym20"])
@pytest.mark.parametrize("shape", SHAPES_MXU_1D, ids=str)
def test_k7_match_plain(dev, wname, shape, prec):
    fb = get_filter_bank(wname)
    x = _rand(shape, dev)
    n = km.dwt1d_mxu_fused.launches + km.idwt1d_mxu_fused.launches
    _close_prec(km.dwt1d_mxu_fused(x, fb, prec),
                km.dwt1d_mxu_plain(x, fb, prec), prec)
    cshape = (*shape[:-1], shape[-1] // 2)
    a, d = _rand(cshape, dev, 1), _rand(cshape, dev, 2)
    _close_prec(km.idwt1d_mxu_fused(a, d, fb, shape[-1], prec),
                km.idwt1d_mxu_plain(a, d, fb, shape[-1], prec), prec)
    assert km.dwt1d_mxu_fused.launches + km.idwt1d_mxu_fused.launches == n + 2


@pytest.mark.parametrize("prec", ["highest", "bf16"])
@pytest.mark.parametrize("wname", ["haar", "db2", "sym8", "odd5", "sym20"])
@pytest.mark.parametrize("shape", SHAPES_MXU_1D + [(2, 37)], ids=str)
@pytest.mark.parametrize("level", [1, 2, 3, 4])
def test_k12_match_plain(dev, wname, shape, level, prec):
    """Every level whose support fits in the row runs on K12a/K12b; a wider
    one is refused before launch."""
    fb = _bank(wname)
    x = _rand(shape, dev)
    a, d = _rand(shape, dev, 1), _rand(shape, dev, 2)
    n = kms.swt1d_mxu_fused.launches + kms.iswt1d_mxu_fused.launches
    if kms.swt1d_mxu_unsupported(x, fb, level):
        with pytest.raises(ValueError, match="wider than the row"):
            kms.swt1d_mxu_fused(x, fb, level, prec)
        return
    _close_prec(kms.swt1d_mxu_fused(x, fb, level, prec),
                kms.swt1d_mxu_plain(x, fb, level, prec), prec)
    _close_prec(kms.iswt1d_mxu_fused(a, d, fb, level, prec),
                kms.iswt1d_mxu_plain(a, d, fb, level, prec), prec)
    assert (kms.swt1d_mxu_fused.launches
            + kms.iswt1d_mxu_fused.launches) == n + 2


@pytest.mark.parametrize("prec", ["highest", "bf16"])
@pytest.mark.parametrize("shape", [(2048,), (16, 512)],
                         ids=["single", "batched"])
@pytest.mark.parametrize("do_swt", [0, 1], ids=["dwt", "swt"])
def test_mxu_mode_1d_plans(dev, shape, do_swt, prec):
    """Wavelets sym8 L3 in 1D in mode "mxu": every level on K7a/K7b or
    K12a/K12b (3 + 3 launches, none of K3/K4/K10), "highest" within the
    reference envelope of the CPU plan, "bf16" within JAX's loose gate."""
    img = (np.random.default_rng(0).random(shape) * 255).astype(np.float32)
    kw = dict(do_swt=do_swt, ndim=1 if len(shape) == 2 else 2)
    ref = Wavelets(img, "sym8", 3, device="cpu", **kw).forward()
    try:
        _mxu("mxu", prec)
        ops.reset_counts()
        W = Wavelets(img, "sym8", 3, device=dev, **kw).forward()
        coeffs = W.coeffs
        W.inverse()
    finally:
        _mxu("auto")
    for lev, (g, r) in enumerate(zip(coeffs, ref.coeffs)):
        lev = lev or 3
        if prec == "highest":
            assert np.abs(g - r).max() <= 3e-4 * 2 ** lev
        else:
            assert np.sqrt(np.mean((g - r) ** 2)) <= (
                0.01 * 2 ** (lev - 1) * np.sqrt(np.mean(r ** 2)))
    err = W.image.reshape(img.shape) - img
    if prec == "highest":
        assert np.abs(err).max() < 7e-4
    else:
        assert np.sqrt(np.mean(err ** 2)) <= 0.04 * np.sqrt(np.mean(img ** 2))
    names = (("swt1d_mxu_fused", "iswt1d_mxu_fused") if do_swt
             else ("dwt1d_mxu_fused", "idwt1d_mxu_fused"))
    assert {k.__name__: k.launches for k in ops.KERNELS if k.launches} == {
        names[0]: 3, names[1]: 3}


@pytest.mark.parametrize("case", ["odd-row", "odd-output", "odd-bank",
                                  "wide-support", "float64", "auto"])
def test_mxu_mode_sends_uncovered_1d_levels_to_jax_route(dev, case):
    """Mode "mxu" sends what K7/K12 do not cover to K3/K4/K10, as JAX sends
    it to its VPU kernels; mode "auto" never takes K7/K12."""
    fb = _bank("odd5" if case == "odd-bank" else "sym8")
    shape = (4, 63) if case == "odd-row" else (4, 64)
    x = _rand(shape, dev)
    dtype = torch.float64 if case == "float64" else torch.float32
    x = x.to(dtype)
    try:
        _mxu("auto" if case == "auto" else "mxu")
        ops.reset_counts()
        if case == "wide-support":
            _close(swt.swt1d_level(x[:, :16], fb, 3),
                   fd.swt1d_plain(x[:, :16], fb, 3))
            want = {"swt1d_fused": 1}
        elif case == "odd-output":
            c = [_rand((4, 32), dev, s) for s in (1, 2)]
            _close(dwt.idwt1d(*c, fb, 63), fd.idwt1d_plain(*c, fb, 63))
            want = {"idwt1d_fused": 1}
        else:
            _close(dwt.dwt1d(x, fb), fd.dwt1d_plain(x, fb))
            _close(swt.swt1d_level(x, fb, 2), fd.swt1d_plain(x, fb, 2))
            # K12 takes odd rows and odd banks, K7 neither
            k12 = case in ("odd-row", "odd-bank")
            want = {"dwt1d_fused": 1,
                    "swt1d_mxu_fused" if k12 else "swt1d_fused": 1}
    finally:
        _mxu("auto")
    assert {k.__name__: k.launches for k in ops.KERNELS if k.launches} == want


# -- float64 instances of the tap-loop kernels -------------------------------

F64_TOL = 1e-12  # float64 kernel vs float64 plain, [0, 1) data
# each kernel's input: odd planes and rows, their coefficients
F64_SHAPES = {"K2": (32, 48), "K17": (32, 48), "K3": (3, 95), "K4": (3, 48),
              "K10a": (3, 95), "K10b": (3, 95)}
F64_CALLS = {
    "K1": lambda x, fb, f2d: (fd.dwt2d_fused(x, fb), fd.dwt2d_plain(x, fb)),
    "K2": lambda x, fb, f2d: (fd.idwt2d_fused(x, x, x, x, fb, (63, 95)),
                              fd.idwt2d_plain(x, x, x, x, fb, (63, 95))),
    "K3": lambda x, fb, f2d: (fd.dwt1d_fused(x, fb), fd.dwt1d_plain(x, fb)),
    "K4": lambda x, fb, f2d: (fd.idwt1d_fused(x, x, fb, 95),
                              fd.idwt1d_plain(x, x, fb, 95)),
    "K10a": lambda x, fb, f2d: (fd.swt1d_fused(x, fb, 3),
                                fd.swt1d_plain(x, fb, 3)),
    "K10b": lambda x, fb, f2d: (fd.iswt1d_fused(x, x, fb, 3),
                                fd.iswt1d_plain(x, x, fb, 3)),
    "K8": lambda x, fb, f2d: (fd.swt2d_fused(x, fb, 2),
                              fd.swt2d_plain(x, fb, 2)),
    "K9": lambda x, fb, f2d: (fd.iswt2d_fused(x, x, x, x, fb, 2),
                              fd.iswt2d_plain(x, x, x, x, fb, 2)),
    "K16": lambda x, fb, f2d: (kn.nsdwt2d_fused(x, f2d),
                               kn.nsdwt2d_plain(x, f2d)),
    "K17": lambda x, fb, f2d: (kn.insdwt2d_fused(x, x, x, x, f2d, (63, 95)),
                               kn.insdwt2d_plain(x, x, x, x, f2d, (63, 95))),
    "K18a": lambda x, fb, f2d: (kn.ns_swt2d_fused(x, f2d, 2),
                                kn.ns_swt2d_plain(x, f2d, 2)),
    "K18b": lambda x, fb, f2d: (kn.ins_swt2d_fused(x, x, x, x, f2d, 2),
                                kn.ins_swt2d_plain(x, x, x, x, f2d, 2)),
}


@pytest.mark.parametrize("wname", ["haar", "db4", "odd5", "sym20"])
@pytest.mark.parametrize("kernel", sorted(F64_CALLS))
def test_float64_instances_match_plain(dev, kernel, wname):
    """Each tap-loop kernel's float64 instance against its float64 plain
    version (the bank's float64 values, unrounded), odd sizes included; the
    non-separable ones on a dense random bank of the same size."""
    fb = _bank(wname)
    rng = np.random.default_rng(fb.hlen)
    f2d = Filters2D(list(rng.random((4, fb.hlen, fb.hlen)) / fb.hlen),
                    list(rng.random((4, fb.hlen, fb.hlen)) / fb.hlen),
                    f"dense{fb.hlen}")
    x = _rand(F64_SHAPES.get(kernel, (2, 63, 95)), dev).double()
    ops.reset_counts()
    got, want = F64_CALLS[kernel](x, fb, f2d)
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and g.shape == w.shape
        assert float((g - w).abs().max()) <= F64_TOL * (
            fb.hlen if kernel.startswith(("K16", "K17", "K18")) else 1)
    assert sum(k.launches for k in ops.KERNELS) == 1


@pytest.mark.parametrize("plan", ["dwt2d", "swt2d", "batched-1d", "signal",
                                  "signal-swt", "nonsep-custom", "haar"])
def test_float64_plans_on_the_card(dev, plan):
    """A float64 Wavelets plan runs on the float64 instances: roundtrip
    below 1e-10 (JAX's float64 gate), coefficients of the CPU plan within
    1e-11, exact launches."""
    rng = np.random.default_rng(3)
    img = rng.random((128, 96) if plan not in ("signal", "signal-swt")
                     else (4096,))
    kw = {"dwt2d": {}, "swt2d": dict(do_swt=1), "batched-1d": dict(ndim=1),
          "signal": {}, "signal-swt": dict(do_swt=1),
          "nonsep-custom": dict(do_separable=0), "haar": {}}[plan]
    wname = "haar" if plan == "haar" else "db4"
    W = Wavelets(img, wname, 3, dtype=np.float64, device=dev, **kw)
    R = Wavelets(img, wname, 3, dtype=np.float64, device="cpu", **kw)
    if plan == "nonsep-custom":
        f2d = _f2d("db3xcoif1")
        for P in (W, R):
            P.set_wavelets_filters(f2d.name, f2d.dec[0], f2d.dec[3],
                                   f2d.rec[0], f2d.rec[3], LH=f2d.dec[1],
                                   HL=f2d.dec[2], i_LH=f2d.rec[1],
                                   i_HL=f2d.rec[2])
    ops.reset_counts()
    W.forward()
    R.forward()
    got, ref = W.coeffs, R.coeffs
    W.inverse()
    for g, r in zip(got, ref):
        for a, b in zip(g if isinstance(g, list) else [g],
                        r if isinstance(r, list) else [r]):
            assert a.dtype == np.float64 and np.abs(a - b).max() <= 1e-11
    assert W.image.dtype == np.float64
    assert np.abs(W.image.reshape(img.shape) - img).max() < 1e-10
    counts = {k.__name__: k.launches for k in ops.KERNELS if k.launches}
    assert len(counts) == 2 and set(counts.values()) == {3}


# -- the whole-pyramid kernels K24/K25 and tail fusion ---------------------

PYR_BANKS = ["haar", "db2", "sym8", "bior4.4", "sym20"]
PYR_CASES = [((64, 128), 2), ((2, 96, 64), 3), ((256, 512), 5), ((16, 32), 4),
             ((3, 64, 32), 5)]


def _flat(pyr):
    return [pyr[0]] + [s for t in pyr[1:] for s in t]


@pytest.mark.parametrize("wname", PYR_BANKS)
@pytest.mark.parametrize("shape, levels", PYR_CASES, ids=str)
def test_k24_k25_match_plain(dev, wname, shape, levels):
    """One launch each for every level; deep levels of small planes wrap
    their periodic pads more than once (sym20 at (16, 32), L4)."""
    fb = get_filter_bank(wname)
    x = _rand(shape, dev)
    n = kp.wavedec2_pyramid_fused.launches
    got = kp.wavedec2_pyramid_fused(x, fb, levels)
    assert kp.wavedec2_pyramid_fused.launches == n + 1
    ref = kp.wavedec2_pyramid_plain(x, fb, levels)
    for g, r in zip(_flat(got), _flat(ref)):
        assert g.shape == r.shape
        assert float((g - r).abs().max()) <= TOL
    c = [_rand(ref[0].shape, dev, 1)] + [
        tuple(_rand(s.shape, dev, 2 + k) for k, s in enumerate(t))
        for t in ref[1:]]
    n = kp.waverec2_pyramid_fused.launches
    out = kp.waverec2_pyramid_fused(c, fb, shape)
    assert kp.waverec2_pyramid_fused.launches == n + 1
    assert float((out - kp.waverec2_pyramid_plain(c, fb, shape)).abs()
                 .max()) <= TOL
    assert float((kp.waverec2_pyramid_fused(got, fb, shape) - x).abs()
                 .max()) <= TOL


def test_pyramid_kernels_refuse_uncovered_calls(dev):
    """The public entries give None outside the coverage; the wrappers
    raise rather than run the plain version on the card."""
    fb = get_filter_bank("db2")
    x = _rand((96, 64), dev)
    assert kp.wavedec2_pyramid(x, fb, 6) is None
    assert kp.wavedec2_pyramid(x.double(), fb, 2) is None
    with pytest.raises(ValueError, match="does not take"):
        kp.wavedec2_pyramid_fused(x, fb, 6)
    pyr = kp.wavedec2_pyramid(x, fb, 3)
    with pytest.raises(ValueError, match="does not take"):
        kp.waverec2_pyramid_fused(pyr, fb, (96, 66))


@pytest.mark.parametrize("case", ["db2", "mxu-sym8", "odd-covered", "float64",
                                  "odd-a0", "two-levels", "torch-mode",
                                  "stack"])
def test_tail_fusion_routes_on_the_card(dev, case):
    """Tail fusion on: level 0 on its own kernel and the tail on one K24 /
    K25 launch where the pyramid kernels cover it, the per-level kernels
    elsewhere (decided before launch), against the CPU per-level plan."""
    shape = {"odd-covered": (255, 255), "odd-a0": (254, 254),
             "stack": (2, 128, 128)}.get(case, (256, 256))
    dtype = np.float64 if case == "float64" else np.float32
    img = (np.random.default_rng(4).random(shape) * 255).astype(dtype)
    wname = "sym8" if case == "mxu-sym8" else "db2"
    levels = 2 if case == "two-levels" else 3
    fb = get_filter_bank(wname)
    ref = dwt.pyramid_to_numpy(dwt.wavedec2(torch.from_numpy(img), fb,
                                            levels))
    one, per = {"mxu-sym8": (("dwt2d_mxu_fused", "idwt2d_mxu_fused"), None),
                "torch-mode": ((), ())}.get(
        case, (("dwt2d_fused", "idwt2d_fused"), None))
    fused = case in ("db2", "mxu-sym8", "odd-covered", "stack")
    if fused:
        want_f = {one[0]: 1, "wavedec2_pyramid_fused": 1}
        want = {**want_f, one[1]: 1, "waverec2_pyramid_fused": 1}
    elif case == "torch-mode":
        want_f = want = {}
    else:
        want_f = {"dwt2d_fused": levels}
        want = {**want_f, "idwt2d_fused": levels}
    dwt.set_tail_fuse(True)
    try:
        if case == "mxu-sym8":
            _mxu("mxu")
        if case == "torch-mode":
            dwt.set_kernels("torch")
        x = torch.from_numpy(img).to(dev)
        ops.reset_counts()
        pyr = dwt.wavedec2(x, fb, levels)
        counts_f = {k.__name__: k.launches for k in ops.KERNELS if k.launches}
        back = dwt.waverec2(pyr, fb, x.shape)
        counts = {k.__name__: k.launches for k in ops.KERNELS if k.launches}
    finally:
        dwt.set_tail_fuse(False)
        _mxu("auto")
    assert counts_f == want_f and counts == want
    tol = 1e-11 if dtype == np.float64 else 3e-4
    for lev, (g, r) in enumerate(zip(dwt.pyramid_to_numpy(pyr), ref)):
        for a, b in zip(g if isinstance(g, tuple) else (g,),
                        r if isinstance(r, tuple) else (r,)):
            assert np.abs(a - b).max() <= tol * 2 ** (lev or levels)
    assert np.abs(back.cpu().numpy() - img).max() < (
        1e-10 if dtype == np.float64 else 7e-4)


# -- the row-sharded levels: K26a/K26b, K27a/K27b, K28 -----------------------

from pypwt_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from pypwt_tpu_torch.parallel import ring as pring  # noqa: E402
from pypwt_tpu_torch.parallel import ShardedWavelets, BatchedWavelets  # noqa: E402,E501

SHARD_BANKS = ["haar", "db2", "sym8", "bior4.4", "odd5", "sym20"]
# (shards, shard shape): 16-row shards make sym20's and deep SWT levels'
# halos multi-hop; an odd column count; a batch
SHARD_CASES = [(4, (64, 96)), (4, (16, 96)), (2, (2, 32, 47)),
               (3, (2, 16, 64))]


def _global(shards, shape, dev, seed=0):
    return _rand((*shape[:-2], shards * shape[-2], shape[-1]), dev, seed)


def _shard_halos(x, shards, i, top, bot):
    """Shard i of plane x (rows split in ``shards``) and its periodic halo
    rows: ``top`` above it, ``bot`` below it (wider than a shard too)."""
    n = x.shape[-2] // shards
    rows = torch.arange(i * n - top, i * n + n + bot, device=x.device)
    ext = x.index_select(-2, rows % x.shape[-2])
    return (ext[..., top:top + n, :].contiguous(),
            ext[..., :top, :].contiguous(),
            ext[..., top + n:, :].contiguous())


def _coeff_halos(planes, shards, i, heights):
    body, halos = [], []
    for p in planes:
        b, t, o = _shard_halos(p, shards, i, *heights)
        body.append(b)
        halos += [t, o]
    return body, tuple(halos)


@pytest.mark.parametrize("wname", SHARD_BANKS)
@pytest.mark.parametrize("case", SHARD_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_k26_match_plain(dev, wname, case, dtype):
    fb = _bank(wname)
    shards, shape = case
    x = _global(shards, shape, dev).to(dtype)
    if shape[-1] % 2:
        return  # the synthesis below needs even coefficient planes
    tol = TOL if dtype == torch.float32 else 1e-12
    n = fd.dwt2d_sharded_fused.launches + fd.idwt2d_sharded_fused.launches
    for i in range(shards):
        b, t, o = _shard_halos(x, shards, i, *fd.halo_heights("dwt", fb, 0))
        got = fd.dwt2d_sharded_fused(b, t, o, fb)
        for g, r in zip(got, fd.dwt2d_sharded_plain(b, t, o, fb)):
            assert g.shape == r.shape and float((g - r).abs().max()) <= tol
    c = [_rand(_half(x.shape), dev, s).to(dtype) for s in range(1, 5)]
    lr = c[0].shape[-2] // shards
    for i in range(shards):
        body, halos = _coeff_halos(c, shards, i,
                                   fd.halo_heights("idwt", fb, lr))
        got = fd.idwt2d_sharded_fused(*body, halos, fb)
        ref = fd.idwt2d_sharded_plain(*body, halos, fb)
        assert got.shape == ref.shape and float((got - ref).abs().max()) <= tol
    assert (fd.dwt2d_sharded_fused.launches
            + fd.idwt2d_sharded_fused.launches) == n + 2 * shards


def test_k26_odd_columns(dev):
    fb = get_filter_bank("db2")
    x = _global(2, (2, 32, 47), dev)
    for i in range(2):
        b, t, o = _shard_halos(x, 2, i, *fd.halo_heights("dwt", fb, 0))
        for g, r in zip(fd.dwt2d_sharded_fused(b, t, o, fb),
                        fd.dwt2d_sharded_plain(b, t, o, fb)):
            assert float((g - r).abs().max()) <= TOL


@pytest.mark.parametrize("wname", SHARD_BANKS)
@pytest.mark.parametrize("case", SHARD_CASES, ids=str)
@pytest.mark.parametrize("level", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_k27_match_plain(dev, wname, case, level, dtype):
    fb = _bank(wname)
    shards, shape = case
    x = _global(shards, shape, dev).to(dtype)
    c = [_rand(x.shape, dev, s).to(dtype) for s in range(1, 5)]
    tol = TOL if dtype == torch.float32 else 1e-12
    n = fd.swt2d_sharded_fused.launches + fd.iswt2d_sharded_fused.launches
    for i in range(shards):
        b, t, o = _shard_halos(x, shards, i,
                               *fd.halo_heights("swt", fb, 0, level))
        got = fd.swt2d_sharded_fused(b, t, o, fb, level)
        for g, r in zip(got, fd.swt2d_sharded_plain(b, t, o, fb, level)):
            assert float((g - r).abs().max()) <= tol
        body, halos = _coeff_halos(c, shards, i,
                                   fd.halo_heights("iswt", fb, 0, level))
        got = fd.iswt2d_sharded_fused(*body, halos, fb, level)
        ref = fd.iswt2d_sharded_plain(*body, halos, fb, level)
        assert float((got - ref).abs().max()) <= tol
    assert (fd.swt2d_sharded_fused.launches
            + fd.iswt2d_sharded_fused.launches) == n + 2 * shards


@pytest.mark.parametrize("prec", ["highest", "bf16"])
@pytest.mark.parametrize("wname", ["db2", "sym8", "bior4.4", "db10", "sym20"])
@pytest.mark.parametrize("case", [(4, (64, 96)), (4, (16, 96)),
                                  (3, (2, 16, 64))], ids=str)
def test_k28_dwt_match_plain(dev, wname, case, prec):
    fb = get_filter_bank(wname)
    shards, shape = case
    x = _global(shards, shape, dev)
    n = km.dwt2d_sharded_mxu_fused.launches
    for i in range(shards):
        b, t, o = _shard_halos(x, shards, i, *fd.halo_heights("dwt", fb, 0))
        _close_prec(km.dwt2d_sharded_mxu_fused(b, t, o, fb, prec),
                    km.dwt2d_sharded_mxu_plain(b, t, o, fb, prec), prec)
    c = [_rand(_half(x.shape), dev, s) for s in range(1, 5)]
    lr = c[0].shape[-2] // shards
    for i in range(shards):
        body, halos = _coeff_halos(c, shards, i,
                                   fd.halo_heights("idwt", fb, lr))
        _close_prec(km.idwt2d_sharded_mxu_fused(*body, halos, fb, prec),
                    km.idwt2d_sharded_mxu_plain(*body, halos, fb, prec),
                    prec)
    assert km.dwt2d_sharded_mxu_fused.launches == n + shards


@pytest.mark.parametrize("prec", ["highest", "bf16"])
@pytest.mark.parametrize("wname", ["db2", "sym8", "odd5", "sym20"])
@pytest.mark.parametrize("case", [(4, (64, 96)), (4, (16, 96)),
                                  (3, (2, 16, 64))], ids=str)
@pytest.mark.parametrize("level", [1, 2, 3, 4])
def test_k28_swt_match_plain(dev, wname, case, level, prec):
    """Every level whose support fits in the shard's rows runs on K28; a
    wider one is refused before launch."""
    fb = _bank(wname)
    shards, shape = case
    x = _global(shards, shape, dev)
    c = [_rand(x.shape, dev, s) for s in range(1, 5)]
    for i in range(shards):
        b, t, o = _shard_halos(x, shards, i,
                               *fd.halo_heights("swt", fb, 0, level))
        if kms.swt2d_sharded_mxu_unsupported(b, t, o, fb, level):
            with pytest.raises(ValueError, match="wider than"):
                kms.swt2d_sharded_mxu_fused(b, t, o, fb, level, prec)
            return
        _close_prec(kms.swt2d_sharded_mxu_fused(b, t, o, fb, level, prec),
                    kms.swt2d_sharded_mxu_plain(b, t, o, fb, level, prec),
                    prec)
        body, halos = _coeff_halos(c, shards, i,
                                   fd.halo_heights("iswt", fb, 0, level))
        _close_prec(kms.iswt2d_sharded_mxu_fused(*body, halos, fb, level,
                                                 prec),
                    kms.iswt2d_sharded_mxu_plain(*body, halos, fb, level,
                                                 prec), prec)


# The tile walk of the synthesis kernel behind K11b and K28's stationary
# synthesis: a plane under one 32 x 32 tile, 33 x 65 tiles at level 1 (no
# divisor of a persistent grid), a batch of 3, levels 1-4, banks of hlen 2,
# 4, 16 and 40 (TF32 k-steps 2-6, bf16 1-3), and 16-row shards whose halos
# at sym8 come from both neighbours at level 2 and from two hops at level 3.
WALK_BANKS = ["haar", "db2", "sym8", "sym20"]
WALK_SHAPES = [(20, 24), (33 * 32, 65 * 32), (3, 96, 64)]
WALK_SHARDS = [(4, (16, 96)), (3, (20, 24)), (2, (3, 40, 72)),
               (2, (33 * 16, 65 * 32))]


@pytest.mark.parametrize("prec", ["highest", "bf16"])
@pytest.mark.parametrize("wname", WALK_BANKS)
@pytest.mark.parametrize("shape", WALK_SHAPES, ids=str)
@pytest.mark.parametrize("level", [1, 2, 3, 4])
def test_k11b_tile_walk_matches_plain(dev, wname, shape, level, prec):
    fb = get_filter_bank(wname)
    c = [_rand(shape, dev, s) for s in range(1, 5)]
    n = kms.iswt2d_mxu_fused.launches
    if kms.iswt2d_mxu_unsupported(*c, fb, level):
        with pytest.raises(ValueError, match="wider than the plane"):
            kms.iswt2d_mxu_fused(*c, fb, level, prec)
        return
    _close_prec(kms.iswt2d_mxu_fused(*c, fb, level, prec),
                kms.iswt2d_mxu_plain(*c, fb, level, prec), prec)
    assert kms.iswt2d_mxu_fused.launches == n + 1


@pytest.mark.parametrize("prec", ["highest", "bf16"])
@pytest.mark.parametrize("wname", WALK_BANKS)
@pytest.mark.parametrize("case", WALK_SHARDS, ids=str)
@pytest.mark.parametrize("level", [1, 2, 3, 4])
def test_k28_iswt_tile_walk_matches_plain(dev, wname, case, level, prec):
    fb = get_filter_bank(wname)
    shards, shape = case
    c = [_global(shards, shape, dev, s) for s in range(1, 5)]
    n = kms.iswt2d_sharded_mxu_fused.launches
    for i in range(shards):
        body, halos = _coeff_halos(c, shards, i,
                                   fd.halo_heights("iswt", fb, 0, level))
        if kms.iswt2d_sharded_mxu_unsupported(*body, halos, fb, level):
            with pytest.raises(ValueError, match="wider than"):
                kms.iswt2d_sharded_mxu_fused(*body, halos, fb, level, prec)
            return
        _close_prec(kms.iswt2d_sharded_mxu_fused(*body, halos, fb, level,
                                                 prec),
                    kms.iswt2d_sharded_mxu_plain(*body, halos, fb, level,
                                                 prec), prec)
    assert kms.iswt2d_sharded_mxu_fused.launches == n + shards


@pytest.mark.parametrize("prec", ["highest", "bf16"])
def test_k11b_k28_iswt_unaligned_planes_match_plain(dev, prec):
    """Planes and halos one float past a 16-byte boundary: at level 1 the
    synthesis copies their rows 4 bytes at a time, not 16."""
    fb = get_filter_bank("sym8")

    def unaligned(t):
        flat = torch.cat([torch.zeros(1, device=dev), t.flatten()])
        return flat[1:].view(t.shape)

    c = [unaligned(_rand((64, 96), dev, s)) for s in range(1, 5)]
    assert c[0].data_ptr() % 16 != 0
    _close_prec(kms.iswt2d_mxu_fused(*c, fb, 1, prec),
                kms.iswt2d_mxu_plain(*c, fb, 1, prec), prec)
    shards = 4
    g = [_global(shards, (16, 96), dev, s) for s in range(1, 5)]
    for i in range(shards):
        body, halos = _coeff_halos(g, shards, i,
                                   fd.halo_heights("iswt", fb, 0, 1))
        body = [unaligned(b) for b in body]
        halos = tuple(unaligned(h) for h in halos)
        _close_prec(kms.iswt2d_sharded_mxu_fused(*body, halos, fb, 1, prec),
                    kms.iswt2d_sharded_mxu_plain(*body, halos, fb, 1, prec),
                    prec)


# The same tile walk through the analysis kernel behind K11a and K28's
# stationary analysis (windows staged from a row table, tile groups, the
# output tile stored row by row).
@pytest.mark.parametrize("prec", ["highest", "bf16"])
@pytest.mark.parametrize("wname", WALK_BANKS)
@pytest.mark.parametrize("shape", WALK_SHAPES, ids=str)
@pytest.mark.parametrize("level", [1, 2, 3, 4])
def test_k11a_tile_walk_matches_plain(dev, wname, shape, level, prec):
    fb = get_filter_bank(wname)
    x = _rand(shape, dev)
    n = kms.swt2d_mxu_fused.launches
    if kms.swt2d_mxu_unsupported(x, fb, level):
        with pytest.raises(ValueError, match="wider than the plane"):
            kms.swt2d_mxu_fused(x, fb, level, prec)
        return
    _close_prec(kms.swt2d_mxu_fused(x, fb, level, prec),
                kms.swt2d_mxu_plain(x, fb, level, prec), prec)
    assert kms.swt2d_mxu_fused.launches == n + 1


@pytest.mark.parametrize("prec", ["highest", "bf16"])
@pytest.mark.parametrize("wname", WALK_BANKS)
@pytest.mark.parametrize("case", WALK_SHARDS, ids=str)
@pytest.mark.parametrize("level", [1, 2, 3, 4])
def test_k28_swt_tile_walk_matches_plain(dev, wname, case, level, prec):
    fb = get_filter_bank(wname)
    shards, shape = case
    x = _global(shards, shape, dev)
    n = kms.swt2d_sharded_mxu_fused.launches
    for i in range(shards):
        b, t, o = _shard_halos(x, shards, i,
                               *fd.halo_heights("swt", fb, 0, level))
        if kms.swt2d_sharded_mxu_unsupported(b, t, o, fb, level):
            with pytest.raises(ValueError, match="wider than"):
                kms.swt2d_sharded_mxu_fused(b, t, o, fb, level, prec)
            return
        _close_prec(kms.swt2d_sharded_mxu_fused(b, t, o, fb, level, prec),
                    kms.swt2d_sharded_mxu_plain(b, t, o, fb, level, prec),
                    prec)
    assert kms.swt2d_sharded_mxu_fused.launches == n + shards


@pytest.mark.parametrize("prec", ["highest", "bf16"])
def test_k11a_k28_swt_unaligned_planes_match_plain(dev, prec):
    """An input plane and halos one float past a 16-byte boundary (4-byte
    window copies at level 1), a plane whose rows are not a multiple of 4
    samples at level 1 and a (3, 255, 257) batch whose later planes start
    unaligned (4-byte copies and one-sample stores)."""
    fb = get_filter_bank("sym8")

    def unaligned(t):
        flat = torch.cat([torch.zeros(1, device=dev), t.flatten()])
        return flat[1:].view(t.shape)

    x = unaligned(_rand((64, 96), dev))
    assert x.data_ptr() % 16 != 0
    for y in (x, _rand((70, 99), dev), _rand((3, 255, 257), dev)):
        n = kms.swt2d_mxu_fused.launches
        _close_prec(kms.swt2d_mxu_fused(y, fb, 1, prec),
                    kms.swt2d_mxu_plain(y, fb, 1, prec), prec)
        assert kms.swt2d_mxu_fused.launches == n + 1
    shards = 4
    for shape in ((16, 96), (3, 40, 99)):
        g = _global(shards, shape, dev)
        for i in range(shards):
            b, t, o = (unaligned(z) for z in _shard_halos(
                g, shards, i, *fd.halo_heights("swt", fb, 0, 1)))
            n = kms.swt2d_sharded_mxu_fused.launches
            _close_prec(kms.swt2d_sharded_mxu_fused(b, t, o, fb, 1, prec),
                        kms.swt2d_sharded_mxu_plain(b, t, o, fb, 1, prec),
                        prec)
            assert kms.swt2d_sharded_mxu_fused.launches == n + 1


# The tile walk of the tensor-core DWT synthesis behind K6 and K28's
# synthesis (tc_dwt2d.cu: windows staged from a row table, tile groups that
# share A fragments): banks that reach every instance (TF32 k-steps 1-3,
# bf16 1-2), coefficient planes under one 32 x 32 tile, tiny ones whose
# window wraps more than once, 33 x 65 tiles with a partial tile on each
# axis, column counts that are not a multiple of 4 (4-byte copies), a
# batch; shards whose halos come from two hops (8-row shards at sym20).
IDWT_WALK_BANKS = ["db2", "sym4", "sym8", "db10", "coif5", "sym20"]
IDWT_WALK_SHAPES = [(1, 1), (3, 2), (20, 24), (33, 65), (3, 40, 72),
                    (33 * 32 + 1, 65 * 32 - 2)]
IDWT_WALK_SHARDS = [(4, (16, 96)), (3, (20, 24)), (2, (3, 40, 72)),
                    (3, (8, 34)), (2, (33 * 16, 65 * 32))]


@pytest.mark.parametrize("prec", ["highest", "bf16"])
@pytest.mark.parametrize("wname", IDWT_WALK_BANKS)
@pytest.mark.parametrize("shape", IDWT_WALK_SHAPES, ids=str)
def test_k6_tile_walk_matches_plain(dev, wname, shape, prec):
    fb = get_filter_bank(wname)
    c = [_rand(shape, dev, s) for s in range(1, 5)]
    out = (*shape[:-2], 2 * shape[-2], 2 * shape[-1])
    n = km.idwt2d_mxu_fused.launches
    _close_prec(km.idwt2d_mxu_fused(*c, fb, out, prec),
                km.idwt2d_mxu_plain(*c, fb, out, prec), prec)
    assert km.idwt2d_mxu_fused.launches == n + 1


@pytest.mark.parametrize("prec", ["highest", "bf16"])
@pytest.mark.parametrize("wname", IDWT_WALK_BANKS)
@pytest.mark.parametrize("case", IDWT_WALK_SHARDS, ids=str)
def test_k28_idwt_tile_walk_matches_plain(dev, wname, case, prec):
    fb = get_filter_bank(wname)
    shards, shape = case
    c = [_global(shards, shape, dev, s) for s in range(1, 5)]
    n = km.idwt2d_sharded_mxu_fused.launches
    for i in range(shards):
        body, halos = _coeff_halos(c, shards, i,
                                   fd.halo_heights("idwt", fb, shape[-2]))
        _close_prec(km.idwt2d_sharded_mxu_fused(*body, halos, fb, prec),
                    km.idwt2d_sharded_mxu_plain(*body, halos, fb, prec),
                    prec)
    assert km.idwt2d_sharded_mxu_fused.launches == n + shards


@pytest.mark.parametrize("prec", ["highest", "bf16"])
@pytest.mark.parametrize("wname", ["sym8", "sym20"])
def test_k6_k28_idwt_unaligned_planes_match_plain(dev, wname, prec):
    """Planes and halos one float past a 16-byte boundary: the synthesis
    copies their rows 4 bytes at a time, not 16."""
    fb = get_filter_bank(wname)

    def unaligned(t):
        flat = torch.cat([torch.zeros(1, device=dev), t.flatten()])
        return flat[1:].view(t.shape)

    c = [unaligned(_rand((40, 72), dev, s)) for s in range(1, 5)]
    assert c[0].data_ptr() % 16 != 0
    n = km.idwt2d_mxu_fused.launches + km.idwt2d_sharded_mxu_fused.launches
    _close_prec(km.idwt2d_mxu_fused(*c, fb, (80, 144), prec),
                km.idwt2d_mxu_plain(*c, fb, (80, 144), prec), prec)
    shards = 4
    g = [_global(shards, (16, 96), dev, s) for s in range(1, 5)]
    for i in range(shards):
        body, halos = _coeff_halos(g, shards, i,
                                   fd.halo_heights("idwt", fb, 16))
        body = [unaligned(b) for b in body]
        halos = tuple(unaligned(h) for h in halos)
        _close_prec(km.idwt2d_sharded_mxu_fused(*body, halos, fb, prec),
                    km.idwt2d_sharded_mxu_plain(*body, halos, fb, prec),
                    prec)
    assert (km.idwt2d_mxu_fused.launches +
            km.idwt2d_sharded_mxu_fused.launches) == n + 1 + shards


# The tile walk of the tensor-core DWT analysis behind K5 and K28's
# analysis (tc_dwt2d.cu: windows staged from a row table, tile groups that
# share A fragments, pair stores): banks that reach every instance (TF32
# k-steps 3-7, bf16 2-4), planes under one 32 x 32 output tile, tiny ones
# whose window wraps more than once, planes with a partial tile on each
# axis, column counts that are not a multiple of 4 (4-byte copies), odd
# output widths (scalar stores), a batch whose later planes start at odd
# offsets; shards whose halos come from two hops (4-row shards at sym20).
DWT_WALK_BANKS = IDWT_WALK_BANKS
DWT_WALK_SHAPES = [(2, 2), (6, 4), (40, 48), (66, 130), (3, 22, 38),
                   (2, 80, 144), (33 * 64 + 2, 65 * 64 - 4)]
DWT_WALK_SHARDS = [(4, (16, 96)), (3, (20, 24)), (2, (3, 40, 72)),
                   (3, (8, 34)), (5, (4, 40)), (2, (33 * 32, 65 * 64))]


@pytest.mark.parametrize("prec", ["highest", "bf16"])
@pytest.mark.parametrize("wname", DWT_WALK_BANKS)
@pytest.mark.parametrize("shape", DWT_WALK_SHAPES, ids=str)
def test_k5_tile_walk_matches_plain(dev, wname, shape, prec):
    fb = get_filter_bank(wname)
    x = _rand(shape, dev, 7)
    n = km.dwt2d_mxu_fused.launches
    _close_prec(km.dwt2d_mxu_fused(x, fb, prec),
                km.dwt2d_mxu_plain(x, fb, prec), prec)
    assert km.dwt2d_mxu_fused.launches == n + 1


@pytest.mark.parametrize("prec", ["highest", "bf16"])
@pytest.mark.parametrize("wname", DWT_WALK_BANKS)
@pytest.mark.parametrize("case", DWT_WALK_SHARDS, ids=str)
def test_k28_dwt_tile_walk_matches_plain(dev, wname, case, prec):
    fb = get_filter_bank(wname)
    shards, shape = case
    x = _global(shards, shape, dev, 8)
    n = km.dwt2d_sharded_mxu_fused.launches
    for i in range(shards):
        body, top, bot = _shard_halos(x, shards, i,
                                      *fd.halo_heights("dwt", fb, 0))
        _close_prec(km.dwt2d_sharded_mxu_fused(body, top, bot, fb, prec),
                    km.dwt2d_sharded_mxu_plain(body, top, bot, fb, prec),
                    prec)
    assert km.dwt2d_sharded_mxu_fused.launches == n + shards


@pytest.mark.parametrize("prec", ["highest", "bf16"])
@pytest.mark.parametrize("wname", ["sym8", "sym20"])
def test_k5_k28_dwt_unaligned_planes_match_plain(dev, wname, prec):
    """Planes and halos one float past a 16-byte boundary (the analysis
    copies their rows 4 bytes at a time, not 16), and outputs one float
    past an 8-byte boundary through the C entries (stored one float at a
    time, not in pairs)."""
    from pypwt_tpu_torch.ops import _build
    fb = get_filter_bank(wname)
    lib = _build.load_library()
    lo, hi = km._host_taps(fb.dec_lo), km._host_taps(fb.dec_hi)
    stream = torch.cuda.current_stream(dev).cuda_stream
    bf16 = int(prec == "bf16")

    def unaligned(t):
        flat = torch.cat([torch.zeros(1, device=dev), t.flatten()])
        return flat[1:].view(t.shape)

    def odd_outputs(shape):
        return [torch.empty(int(np.prod(shape)) + 1, device=dev)[1:]
                .view(shape) for _ in range(4)]

    x = unaligned(_rand((2, 40, 72), dev, 9))
    assert x.data_ptr() % 16 != 0
    n = km.dwt2d_mxu_fused.launches + km.dwt2d_sharded_mxu_fused.launches
    ref = km.dwt2d_mxu_plain(x, fb, prec)
    _close_prec(km.dwt2d_mxu_fused(x, fb, prec), ref, prec)
    out = odd_outputs((2, 20, 36))
    assert out[0].data_ptr() % 8 != 0
    assert lib.pypwt_tc_dwt2d(
        x.data_ptr(), *(o.data_ptr() for o in out), 2, 40, 72,
        lo.ctypes.data, hi.ctypes.data, fb.hlen, bf16, dev.index,
        stream) == 0
    torch.cuda.synchronize(dev)
    _close_prec(tuple(out), ref, prec)
    shards = 4
    g = _global(shards, (16, 96), dev, 10)
    lp, rp = fd.halo_heights("dwt", fb, 0)
    for i in range(shards):
        body, top, bot = (unaligned(t)
                          for t in _shard_halos(g, shards, i, lp, rp))
        ref = km.dwt2d_sharded_mxu_plain(body, top, bot, fb, prec)
        _close_prec(km.dwt2d_sharded_mxu_fused(body, top, bot, fb, prec),
                    ref, prec)
        out = odd_outputs((8, 48))
        assert lib.pypwt_tc_dwt2d_sharded(
            body.data_ptr(), top.data_ptr(), bot.data_ptr(),
            *(o.data_ptr() for o in out), 1, 16, 96, lp, rp,
            lo.ctypes.data, hi.ctypes.data, fb.hlen, bf16, dev.index,
            stream) == 0
        torch.cuda.synchronize(dev)
        _close_prec(tuple(out), ref, prec)
    assert (km.dwt2d_mxu_fused.launches +
            km.dwt2d_sharded_mxu_fused.launches) == n + 1 + shards


# The tile walk of the tap-loop synthesis behind K9 and K27b (swt2d.cu):
# widths around its 64-column tile (63, 64, 65, 131), rows that are not a
# multiple of 4 samples (99, 257), levels 1-4 in both precisions, sym20's
# windows past the staging budget (its phase 1 reads through the cache),
# planes and halos one sample past a 16-byte boundary, and a (3, 255, 257)
# batch whose later planes start unaligned.
SYN_WALK_BANKS = ["db2", "sym8", "odd5", "sym20"]
SYN_WALK_SHAPES = [(40, 63), (40, 64), (40, 65), (40, 131), (70, 99),
                   (3, 255, 257)]
SYN_WALK_SHARDS = [(4, (16, 64)), (4, (16, 63)), (3, (20, 131)),
                   (2, (3, 40, 99))]

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("wname", SYN_WALK_BANKS)
@pytest.mark.parametrize("shape", SYN_WALK_SHAPES, ids=str)
@pytest.mark.parametrize("level", [1, 2, 3, 4])
def test_k9_tile_walk_matches_plain(dev, wname, shape, level, offset, dtype):
    fb = _bank(wname)
    c = [_offset(_rand(shape, dev, s).to(dtype), offset)
         for s in range(1, 5)]
    assert (c[0].data_ptr() % 16 != 0) == bool(offset)
    tol = TOL if dtype == torch.float32 else 1e-12
    n = fd.iswt2d_fused.launches
    got = fd.iswt2d_fused(*c, fb, level)
    assert fd.iswt2d_fused.launches == n + 1
    assert float((got - fd.iswt2d_plain(*c, fb, level)).abs().max()) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("wname", SYN_WALK_BANKS)
@pytest.mark.parametrize("case", SYN_WALK_SHARDS, ids=str)
@pytest.mark.parametrize("level", [1, 2, 3, 4])
def test_k27b_tile_walk_matches_plain(dev, wname, case, level, offset,
                                      dtype):
    fb = _bank(wname)
    shards, shape = case
    c = [_global(shards, shape, dev, s).to(dtype) for s in range(1, 5)]
    tol = TOL if dtype == torch.float32 else 1e-12
    n = fd.iswt2d_sharded_fused.launches
    for i in range(shards):
        body, halos = _coeff_halos(c, shards, i,
                                   fd.halo_heights("iswt", fb, 0, level))
        body = [_offset(b, offset) for b in body]
        halos = tuple(_offset(h, offset) for h in halos)
        got = fd.iswt2d_sharded_fused(*body, halos, fb, level)
        ref = fd.iswt2d_sharded_plain(*body, halos, fb, level)
        assert float((got - ref).abs().max()) <= tol
    assert fd.iswt2d_sharded_fused.launches == n + shards


def test_sharded_kernels_refuse_wrong_halos(dev):
    fb = get_filter_bank("db2")
    x = _rand((16, 32), dev)
    t = _rand((2, 32), dev)  # db2's analysis pads are (1, 1)
    with pytest.raises(ValueError, match="halo"):
        fd.dwt2d_sharded_fused(x, t, t, fb)
    with pytest.raises(ValueError, match="shard rows"):
        fd.dwt2d_sharded_fused(_rand((15, 32), dev), t[:1], t[:1], fb)


def _virtual(n):
    return [torch.device("cuda", 0)] * n


@pytest.mark.parametrize("mode", ["auto", "mxu"])
@pytest.mark.parametrize("do_swt", [0, 1], ids=["dwt", "swt"])
def test_sharded_plan_launches_once_per_shard_and_level(dev, mode, do_swt):
    """ShardedWavelets on 4 virtual shards of cuda:0: K26 (K27), or K28 in
    mode "mxu", once per shard and level each way, and no unsharded
    kernel; the result equals the CPU plan's."""
    img = (np.random.default_rng(0).random((256, 192)) * 255).astype(
        np.float32)
    ref = ShardedWavelets(img, "sym8", 3, do_swt=do_swt,
                          mesh=pmesh.make_mesh(1, 4, [torch.device("cpu")] * 4))
    ref.forward()
    try:
        _mxu(mode)
        ops.reset_counts()
        W = ShardedWavelets(img, "sym8", 3, do_swt=do_swt,
                            mesh=pmesh.make_mesh(1, 4, _virtual(4)))
        W.forward()
        coeffs = W.coeffs
        W.inverse()
        counts = {k.__name__: k.launches for k in ops.KERNELS if k.launches}
    finally:
        _mxu("auto")
    fwd, inv = {("auto", 0): ("dwt2d_sharded_fused", "idwt2d_sharded_fused"),
                ("auto", 1): ("swt2d_sharded_fused", "iswt2d_sharded_fused"),
                ("mxu", 0): ("dwt2d_sharded_mxu_fused",
                             "idwt2d_sharded_mxu_fused"),
                ("mxu", 1): ("swt2d_sharded_mxu_fused",
                             "iswt2d_sharded_mxu_fused")}[mode, do_swt]
    assert counts == {fwd: 12, inv: 12}
    for a, b in zip([coeffs[0]] + [s for t in coeffs[1:] for s in t],
                    [ref.coeffs[0]] + [s for t in ref.coeffs[1:] for s in t]):
        assert np.abs(a - b).max() < 3e-4 * 8
    assert np.abs(W.image - img).max() < 7e-4


def test_sharded_routes_one_shard_and_float64(dev):
    """A ring of one shard runs the unsharded kernels (as JAX); a float64
    sharded level runs K26's float64 instance; "mxu" sends haar to K26."""
    fb = get_filter_bank("db4")
    x = _rand((64, 64), dev).double()
    from pypwt_tpu_torch.parallel import spatial
    ops.reset_counts()
    spatial.wavedec2_rowsharded(x, fb, 2, pmesh.make_mesh(1, 1, _virtual(1)))
    assert {k.__name__: k.launches for k in ops.KERNELS
            if k.launches} == {"dwt2d_fused": 2}
    ops.reset_counts()
    pyr = spatial.wavedec2_rowsharded(x, fb, 2,
                                      pmesh.make_mesh(1, 4, _virtual(4)))
    y = pring.gather_rows(spatial.waverec2_rowsharded(
        pyr, fb, pmesh.make_mesh(1, 4, _virtual(4))))
    assert float((y - x).abs().max()) < 1e-10
    assert fd.dwt2d_sharded_fused.launches == 8
    try:
        _mxu("mxu")
        ops.reset_counts()
        spatial.wavedec2_rowsharded(x.float(), get_filter_bank("haar"), 2,
                                    pmesh.make_mesh(1, 4, _virtual(4)))
    finally:
        _mxu("auto")
    assert {k.__name__: k.launches for k in ops.KERNELS
            if k.launches} == {"dwt2d_sharded_fused": 8}


def test_batched_plans_on_the_card(dev):
    """Data-parallel over 4 virtual shards (K1/K2 per shard, no exchange)
    and hybrid over 2 x 2 (K26 per shard)."""
    st = (np.random.default_rng(1).random((4, 64, 96)) * 255).astype(
        np.float32)
    for n_data, n_rows, want in ((4, 1, {"dwt2d_fused": 8,
                                         "idwt2d_fused": 8}),
                                 (2, 2, {"dwt2d_sharded_fused": 8,
                                         "idwt2d_sharded_fused": 8})):
        B = BatchedWavelets(st, "db2", 2,
                            mesh=pmesh.make_mesh(n_data, n_rows, _virtual(4)))
        ops.reset_counts()
        B.forward()
        B.inverse()
        assert {k.__name__: k.launches for k in ops.KERNELS
                if k.launches} == want
        # db2 L2 hybrid: 2 exchanges per level forward, 8 back
        assert B.ring.counts["ppermute"] == (0 if n_rows == 1 else 20)
        assert np.abs(B.image - st).max() < 7e-4


# -- the grid and sequence passes: K29a-K29h ---------------------------------

from pypwt_tpu_torch.parallel import spatial  # noqa: E402

K29_BANKS = ["haar", "db2", "sym8", "odd5", "sym20"]
# (shards, shard shape) split along the last axis: grid shards' rows, a
# signal (1D), JAX's batch of signals; 8-sample shards make sym20's halos
# multi-hop
LANE_CASES = [(4, (64, 96)), (4, (3, 8)), (8, (512,)), (3, (2, 64))]
# (shards, shard shape) split along axis -2: grid shards, an odd column
# count, 8-row shards (multi-hop)
ROW_CASES = [(4, (64, 96)), (4, (16, 33)), (2, (8, 40))]
# (route, precision): the tap-loop kernels K29a-K29d, float32 and float64,
# and the tensor-core forms K29e-K29h in both precisions
FORMS = [("cuda", torch.float32), ("cuda", torch.float64),
         ("highest", torch.float32), ("bf16", torch.float32)]


def _split_halos(x, shards, i, before, after, axis):
    """Shard i of x split along ``axis`` in ``shards`` and its periodic
    halos (wider than a shard too): (shard, before, after)."""
    n = x.shape[axis] // shards
    idx = torch.arange(i * n - before, i * n + n + after,
                       device=x.device) % x.shape[axis]
    ext = x.index_select(axis, idx)
    return (ext.narrow(axis, before, n).contiguous(),
            ext.narrow(axis, 0, before).contiguous(),
            ext.narrow(axis, before + n, after).contiguous())


def _k29(kind, axis, form):
    """(wrapper, plain version, coverage) of one K29 entry for ``form``."""
    mod, suffix = (fd, "") if form == "cuda" else (km, "_mxu")
    name = f"{kind}_{'lanes' if axis == -1 else 'rows'}{suffix}"
    fused, plain = (getattr(mod, f"{name}_fused"),
                    getattr(mod, f"{name}_plain"))
    if form != "cuda":
        return ((lambda *a: fused(*a, form)), (lambda *a: plain(*a, form)),
                getattr(mod, f"{name}_unsupported"), fused)
    return fused, plain, getattr(mod, f"{name}_unsupported"), fused


def _close_k29(got, ref, form, dtype):
    """The tensor-core forms on _close_prec's rule; K29a-K29d within TOL
    (float32) or 1e-12 (float64)."""
    if form != "cuda" or dtype == torch.float32:
        return _close_prec(got, ref, "highest" if form == "cuda" else form)
    for g, r in zip(*(((t,) if isinstance(t, torch.Tensor) else t)
                      for t in (got, ref))):
        assert g.shape == r.shape and float((g - r).abs().max()) <= 1e-12


def _run_k29(dev, wname, case, form, dtype, axis):
    """Three levels of analysis passes on the shards the previous level
    made, and the synthesis of random coefficients at each level's size,
    each shard's kernel against its plain version; launches counted."""
    fb = _bank(wname)
    shards, shape = case
    whole = list(shape)
    whole[axis] *= shards
    x = _rand(tuple(whole), dev).to(dtype)
    ana, ana_p, ana_why, ka = _k29("ana", axis, form)
    syn, syn_p, syn_why, ks = _k29("syn", axis, form)
    n0 = ka.launches + ks.launches
    launched = 0
    for _ in range(3):
        if x.shape[axis] // shards % 2:
            break
        pads = fd.one_axis_pads("ana", fb, 0)
        outs = []
        for i in range(shards):
            b, lo, hi = _split_halos(x, shards, i, *pads, axis)
            if ana_why(b, lo, hi, fb):
                assert form != "cuda"
                with pytest.raises(ValueError):
                    ana(b, lo, hi, fb)
                return
            got = ana(b, lo, hi, fb)
            _close_k29(got, ana_p(b, lo, hi, fb), form, dtype)
            outs.append(got[0])
            launched += 1
        x = torch.cat(outs, axis)
        c = [_rand(x.shape, dev, s).to(dtype) for s in (1, 2)]
        pads = fd.one_axis_pads("syn", fb, x.shape[axis] // shards)
        for i in range(shards):
            ba, la, ra = _split_halos(c[0], shards, i, *pads, axis)
            bd, ld, rd = _split_halos(c[1], shards, i, *pads, axis)
            halos = (la, ra, ld, rd)
            got = syn(ba, bd, halos, fb)
            assert got.shape[axis] == 2 * ba.shape[axis]
            _close_k29(got, syn_p(ba, bd, halos, fb), form, dtype)
            launched += 1
    assert ka.launches + ks.launches == n0 + launched


@pytest.mark.parametrize("form, dtype", FORMS, ids=lambda f: str(f))
@pytest.mark.parametrize("wname", K29_BANKS)
@pytest.mark.parametrize("case", LANE_CASES, ids=str)
def test_k29_lanes_match_plain(dev, wname, case, form, dtype):
    """K29a/K29b (K29e/K29f) on shards split along their samples."""
    _run_k29(dev, wname, case, form, dtype, -1)


@pytest.mark.parametrize("form, dtype", FORMS, ids=lambda f: str(f))
@pytest.mark.parametrize("wname", K29_BANKS)
@pytest.mark.parametrize("case", ROW_CASES, ids=str)
def test_k29_rows_match_plain(dev, wname, case, form, dtype):
    """K29c/K29d (K29g/K29h) on grid shards split along their rows."""
    _run_k29(dev, wname, case, form, dtype, -2)


def test_k29_kernels_refuse_wrong_halos(dev):
    fb = get_filter_bank("db2")
    x = _rand((16, 32), dev)
    t = _rand((16, 2), dev)  # db2's analysis pads are (1, 1)
    with pytest.raises(ValueError, match="halo"):
        fd.ana_lanes_fused(x, t, t, fb)
    with pytest.raises(ValueError, match="samples per row"):
        fd.ana_lanes_fused(_rand((16, 31), dev), t[:, :1], t[:, :1], fb)
    with pytest.raises(ValueError, match="halo"):
        fd.ana_rows_fused(x, t.T.contiguous(), t.T.contiguous(), fb)
    with pytest.raises(ValueError, match="rank"):
        fd.ana_rows_fused(_rand((2, 16, 32), dev), x[:1], x[:1], fb)


# -- the line walk of K7a/K7b and K29e/K29f (csrc/tc_dwt1d.cu) ---------------

# banks of hlen 4, 16 and 40
LINE_BANKS = ["db2", "sym8", "sym20"]
# rows of n = 2 x odd samples (each row's window starts at another offset
# from a 16-byte boundary, and so does each coefficient row), rows shorter
# than the bank (a wrap wider than the row), one line of 1024 outputs and
# one line plus 8, many short rows per item, row counts that are not a
# multiple of the rows per item, one 4 Mi-sample signal (2048 lines)
LINE_SHAPES = [(7, 74), (5, 2002), (3, 4), (2, 16), (4, 2048), (3, 2064),
               (300, 8), (1000, 32), (37, 64), (129, 16), (1, 1 << 22)]
# (shards, shard shape) along the samples: halos on both sides of a line
# plus 8 outputs, of rows 2 x odd, of short rows, of one signal's shards
LINE_SHARDS = [(4, (3, 2064)), (2, (5, 2002)), (4, (37, 64)),
               (8, (1, 1 << 19))]
OFFSETS = [0, 1]  # floats past a 16-byte boundary of each tensor's start


def _offset(t, floats):
    """t's values in a tensor whose data starts ``floats`` elements past
    where a fresh allocation would."""
    if floats == 0:
        return t
    flat = torch.cat([torch.zeros(floats, device=t.device, dtype=t.dtype),
                      t.flatten()])
    return flat[floats:].view(t.shape)


@pytest.mark.parametrize("prec", ["highest", "bf16"])
@pytest.mark.parametrize("wname", LINE_BANKS)
@pytest.mark.parametrize("shape", LINE_SHAPES, ids=str)
@pytest.mark.parametrize("offset", OFFSETS)
def test_k7_line_walk_matches_plain(dev, wname, shape, offset, prec):
    fb = get_filter_bank(wname)
    x = _offset(_rand(shape, dev), offset)
    assert x.data_ptr() % 16 == 4 * offset
    n = km.dwt1d_mxu_fused.launches + km.idwt1d_mxu_fused.launches
    _close_prec(km.dwt1d_mxu_fused(x, fb, prec),
                km.dwt1d_mxu_plain(x, fb, prec), prec)
    cshape = (*shape[:-1], shape[-1] // 2)
    a, d = (_offset(_rand(cshape, dev, s), offset) for s in (1, 2))
    _close_prec(km.idwt1d_mxu_fused(a, d, fb, shape[-1], prec),
                km.idwt1d_mxu_plain(a, d, fb, shape[-1], prec), prec)
    assert km.dwt1d_mxu_fused.launches + km.idwt1d_mxu_fused.launches == n + 2


@pytest.mark.parametrize("prec", ["highest", "bf16"])
@pytest.mark.parametrize("wname", LINE_BANKS)
@pytest.mark.parametrize("case", LINE_SHARDS, ids=str)
@pytest.mark.parametrize("offset", OFFSETS)
def test_k29ef_line_walk_matches_plain(dev, wname, case, offset, prec):
    """K29e/K29f on every shard of rows split along their samples, the
    halos exchanged from both neighbours."""
    fb = get_filter_bank(wname)
    shards, shape = case
    whole = (*shape[:-1], shape[-1] * shards)
    x = _rand(whole, dev)
    c = [_rand((*shape[:-1], shape[-1] // 2 * shards), dev, s)
         for s in (1, 2)]
    n = km.ana_lanes_mxu_fused.launches + km.syn_lanes_mxu_fused.launches
    apads = fd.one_axis_pads("ana", fb, 0)
    spads = fd.one_axis_pads("syn", fb, shape[-1] // 2)
    for i in range(shards):
        b, lo, hi = (_offset(t, offset)
                     for t in _split_halos(x, shards, i, *apads, -1))
        _close_prec(km.ana_lanes_mxu_fused(b, lo, hi, fb, prec),
                    km.ana_lanes_mxu_plain(b, lo, hi, fb, prec), prec)
        ba, la, ra = (_offset(t, offset)
                      for t in _split_halos(c[0], shards, i, *spads, -1))
        bd, ld, rd = (_offset(t, offset)
                      for t in _split_halos(c[1], shards, i, *spads, -1))
        halos = (la, ra, ld, rd)
        _close_prec(km.syn_lanes_mxu_fused(ba, bd, halos, fb, prec),
                    km.syn_lanes_mxu_plain(ba, bd, halos, fb, prec), prec)
    assert (km.ana_lanes_mxu_fused.launches +
            km.syn_lanes_mxu_fused.launches) == n + 2 * shards


def _leaves(c):
    """The arrays of a plan's ``coeffs``, 2D or 1D."""
    return [c[0]] + [s for t in c[1:]
                     for s in (t if isinstance(t, list) else [t])]


def _counts():
    return {k.__name__: k.launches for k in ops.KERNELS if k.launches}


@pytest.mark.parametrize("mode", ["auto", "mxu"])
@pytest.mark.parametrize("layout", ["grid", "seq"])
@pytest.mark.parametrize("do_swt", [0, 1], ids=["dwt", "swt"])
def test_grid_and_sequence_plans_on_the_card(dev, mode, layout, do_swt):
    """ShardedWavelets on 4 virtual shards of cuda:0 (a 2 x 2 grid, or a
    signal over 4): the DWT launches K29a-K29d (K29e-K29h in mode "mxu")
    once per shard and pass, 3 per shard and level each way on the grid
    and 1 in the sequence; the SWT runs torch ops (no TPU kernel); the
    result equals the CPU plan's."""
    rng = np.random.default_rng(0)
    img = ((rng.random((256, 192)) if layout == "grid" else
            rng.random(8192)) * 255).astype(np.float32)

    def mesh(d):
        return (pmesh.make_mesh2d(2, 2, [d] * 4) if layout == "grid"
                else pmesh.make_mesh(1, 4, [d] * 4))
    ref = ShardedWavelets(img, "sym8", 3, do_swt=do_swt,
                          mesh=mesh(torch.device("cpu"))).forward()
    try:
        _mxu(mode)
        ops.reset_counts()
        W = ShardedWavelets(img, "sym8", 3, do_swt=do_swt, mesh=mesh(dev))
        W.forward()
        coeffs = W.coeffs
        W.inverse()
        counts = _counts()
    finally:
        _mxu("auto")
    sfx = "_mxu_fused" if mode == "mxu" else "_fused"
    if do_swt:
        want = {}
    elif layout == "grid":
        want = {f"ana_lanes{sfx}": 12, f"ana_rows{sfx}": 24,
                f"syn_rows{sfx}": 24, f"syn_lanes{sfx}": 12}
    else:
        want = {f"ana_lanes{sfx}": 12, f"syn_lanes{sfx}": 12}
    assert counts == want
    for a, b in zip(_leaves(coeffs), _leaves(ref.coeffs)):
        assert np.abs(a - b).max() < 3e-4 * 8
    assert np.abs(W.image - img).max() < 7e-4


def test_grid_routes_float64_and_uncovered_banks(dev):
    """A float64 grid runs the float64 instances of K29a-K29d; mode "mxu"
    sends haar (not covered by K29e-K29h) to K29a-K29d."""
    x = _rand((64, 64), dev).double()
    m = pmesh.make_mesh2d(2, 2, _virtual(4))
    fb = get_filter_bank("db4")
    ops.reset_counts()
    pyr = spatial.wavedec2_gridsharded(x, fb, 2, m)
    y = pring.gather_grid(spatial.waverec2_gridsharded(pyr, fb, m), 2)
    assert float((y - x).abs().max()) < 1e-10
    assert _counts() == {"ana_lanes_fused": 8, "ana_rows_fused": 16,
                         "syn_rows_fused": 16, "syn_lanes_fused": 8}
    try:
        _mxu("mxu")
        ops.reset_counts()
        spatial.wavedec2_gridsharded(x.float(), get_filter_bank("haar"), 2, m)
    finally:
        _mxu("auto")
    assert _counts() == {"ana_lanes_fused": 8, "ana_rows_fused": 16}


# K2 and K26b on idwt2d.cu's pair body: each output against its plain
# version and against the SHA-256 of the output that the body before it
# (level2d.cuh's syn::tile, which K25 still runs) gave on the card
# for the same seeded inputs; `python tests/test_torch_kernels_cuda.py
# digests` prints a tree's digests in PAIR_DIGESTS's form. Banks of hlen
# 2, 4, 10, 16, 40 and 5.
PAIR_BANKS = ["haar", "db2", "bior4.4", "sym8", "sym20", "odd5"]
# K2: (type, output shape, offset): whole tiles, rows of 65 coefficients
# (not a multiple of 4: sample copies), odd outputs (the crop), a batch of
# 3, planes one sample past a 16-byte boundary
K2_PAIR_CASES = [("f32", (64, 128), 0), ("f32", (66, 130), 0),
                 ("f32", (2047, 2047), 0), ("f32", (2046, 2047), 0),
                 ("f32", (3, 40, 72), 0), ("f32", (66, 132), 1),
                 ("f64", (66, 130), 0), ("f64", (63, 127), 0),
                 ("f64", (3, 40, 72), 1)]
# K26b: (type, shards, coefficient shape of a shard, offset), shard 1: of
# 8 rows (a 16-row image shard: sym20's bottom halo of 15 rows spans two
# neighbours), of 131 columns, a batch of 3, offsets of one sample
K26B_PAIR_CASES = [("f32", 4, (8, 48), 0), ("f32", 4, (16, 64), 0),
                   ("f32", 4, (16, 64), 1), ("f32", 3, (10, 131), 0),
                   ("f32", 2, (3, 20, 36), 0), ("f64", 4, (8, 48), 0),
                   ("f64", 2, (3, 20, 36), 1)]
PAIR_CASES = ([("K2", c) for c in K2_PAIR_CASES]
              + [("K26b", c) for c in K26B_PAIR_CASES])


def _pair_id(kind, case, wname):
    return "-".join([kind, wname, *(str(v) for v in case)])


def _pair_output(kind, case, wname, dev):
    """(kernel output, plain output) of one case, the kernel launched
    once."""
    dtype = torch.float64 if case[0] == "f64" else torch.float32
    fb = _bank(wname)
    if kind == "K2":
        _, shape, off = case
        c = [_offset(_rand(_half(shape), dev, s).to(dtype), off)
             for s in range(1, 5)]
        n = fd.idwt2d_fused.launches
        got = fd.idwt2d_fused(*c, fb, shape)
        assert fd.idwt2d_fused.launches == n + 1
        return got, fd.idwt2d_plain(*c, fb, shape)
    _, shards, shape, off = case
    c = [_global(shards, shape, dev, s).to(dtype) for s in range(1, 5)]
    body, halos = _coeff_halos(c, shards, 1,
                               fd.halo_heights("idwt", fb, shape[-2]))
    body = [_offset(b, off) for b in body]
    halos = tuple(_offset(h, off) for h in halos)
    n = fd.idwt2d_sharded_fused.launches
    got = fd.idwt2d_sharded_fused(*body, halos, fb)
    assert fd.idwt2d_sharded_fused.launches == n + 1
    return got, fd.idwt2d_sharded_plain(*body, halos, fb)


def _sha256(t):
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


@pytest.mark.parametrize("wname", PAIR_BANKS)
@pytest.mark.parametrize("kind, case", PAIR_CASES, ids=str)
def test_k2_k26b_pair_body_matches_plain_and_parent(dev, kind, case, wname):
    got, ref = _pair_output(kind, case, wname, dev)
    tol = TOL if got.dtype == torch.float32 else 1e-12
    assert got.shape == ref.shape and float((got - ref).abs().max()) <= tol
    assert _sha256(got) == PAIR_DIGESTS[_pair_id(kind, case, wname)]


PAIR_DIGESTS = {
    'K2-haar-f32-(64, 128)-0':
        'ff17202fd61c767efb3051d03c3e8d33176746d137ee067cfaa6c7584fd55054',
    'K2-db2-f32-(64, 128)-0':
        'b0562b6420a0386d9f2e26cafa3d07f81838be095755b6d6677f877300cd5e47',
    'K2-bior4.4-f32-(64, 128)-0':
        '076e0f0b3d021ec8a38e547235d36597f6d66d3385c698d8f09786bfd15d9f72',
    'K2-sym8-f32-(64, 128)-0':
        '00d73533b1a9b808ac081ca785e98dc481234b19101536b5c53aee355582c362',
    'K2-sym20-f32-(64, 128)-0':
        '025d968c99fde269765250492e71e95f7f1c2087bccd0bef0fe688f1bfb1cf22',
    'K2-odd5-f32-(64, 128)-0':
        'ff52801ce738ca255966caadc17fd502769959917a572fb408911a47ae668262',
    'K2-haar-f32-(66, 130)-0':
        '86f2a0fcb9bb38e52eb520b8e8ced8b0fc577a85ac8f7ea59e015941436bd787',
    'K2-db2-f32-(66, 130)-0':
        '50da0a69a76fba5e7c0669eb1e8c1ac009485b5593f445e4f8a7ac7407f07581',
    'K2-bior4.4-f32-(66, 130)-0':
        'c2d723ef9c3ed9d614b79bc81fc33de112e303a955a118ae6863bb8f2192fc39',
    'K2-sym8-f32-(66, 130)-0':
        '4aa92c1a3c39490c2360f2df17f188dd0e54dc30a71cf71dd723bb54f40f2472',
    'K2-sym20-f32-(66, 130)-0':
        '0deefd306507b803eaad4b56a79667b54b38b8b3cb55e3398c6c59a6be08d00f',
    'K2-odd5-f32-(66, 130)-0':
        '3be6e2355e3308cf0c9da7c90ebe4602a50d0194223b2fffd2ff25d9fdb01be9',
    'K2-haar-f32-(2047, 2047)-0':
        '3e10c3fe8b36dece81810fe23d81f93d3f5031e312c54bafd7bf0d1286411d5b',
    'K2-db2-f32-(2047, 2047)-0':
        '21f8cd2bfc7f5127e9f4774aa9059f2ff14fdcd185f9a443908aa4b2565fa150',
    'K2-bior4.4-f32-(2047, 2047)-0':
        '93c7520b05cf46dc435cbb2a02b0fba71f5bffb614cac2cbfca44f976003f426',
    'K2-sym8-f32-(2047, 2047)-0':
        '8e5ce887d31f0a54f69b42b83e331920264f4a26b4857c1893cdf8200232a053',
    'K2-sym20-f32-(2047, 2047)-0':
        '505c94a96cbbf54c1837078a1038748ddbc3688021c5a72609d30c31a181dfad',
    'K2-odd5-f32-(2047, 2047)-0':
        '1b259b728efad39dba523aa38d89f6ee68235817a3f8211ab9e5ef989f5a9044',
    'K2-haar-f32-(2046, 2047)-0':
        'b8a074bc54710005cd3727eceed2dc90519ce99d8a311fbf7d8bbbe9c4e1d421',
    'K2-db2-f32-(2046, 2047)-0':
        'a10ab970ad49c20acb9cdd528eda92b8e67fdfcaa0bfa9a6ecde1ecb80a80d65',
    'K2-bior4.4-f32-(2046, 2047)-0':
        '74713cf6e8eb10bf85d24202fb06465878143b73704dad3c7b6d02ce45ae7d64',
    'K2-sym8-f32-(2046, 2047)-0':
        '1e658b80671a8b6371716e93ead1712b9dcfbf49326b985db2f0e326e537ae3f',
    'K2-sym20-f32-(2046, 2047)-0':
        '411d7258c7f82384d0ba74356cacdf901c418703b6dd310860b735a904bf2496',
    'K2-odd5-f32-(2046, 2047)-0':
        '0ecacca67aa6597f14f97d57d51a89157970efae7b915a21a76a3a179a7b943f',
    'K2-haar-f32-(3, 40, 72)-0':
        '1f078ba8dcb932b53f663a37ebb05db41c484638b4be675b3224ff14e462a173',
    'K2-db2-f32-(3, 40, 72)-0':
        '6e6b8b920264d39241153fab73285dad0de8cde98704c889aa1ec07377051b23',
    'K2-bior4.4-f32-(3, 40, 72)-0':
        'a3129fcccfcc2a00989033131b35022b243a62b72900cd978f0ad7de3bd4e44f',
    'K2-sym8-f32-(3, 40, 72)-0':
        'c1e69a52e89d1981711420466dcb87cd6dc2d4e02dbba09b483b5ec81616dd31',
    'K2-sym20-f32-(3, 40, 72)-0':
        '2ac7855c079eb085d480e07cb6fb9670635a5c8bfa0853d3a459e8d6018b5520',
    'K2-odd5-f32-(3, 40, 72)-0':
        'c9c961289d6bcb92c539b2a6ddca902bdcd0f71f5265de7a506dbbdde41b5046',
    'K2-haar-f32-(66, 132)-1':
        '41205655d3d0b3ff63873d1636315b4c4326ab3a63e1c1648489f9fc9d42d19f',
    'K2-db2-f32-(66, 132)-1':
        '4f0331411ab1a36ced4f5f66f01a35c178f009f73e2a8ac2c3820435c3a8c90a',
    'K2-bior4.4-f32-(66, 132)-1':
        'f8b3745acba9e301ba4e97f457f90d7e4467d1983956441af06ae5e42049c806',
    'K2-sym8-f32-(66, 132)-1':
        'b44cc351f3eb8ccdb6334e48ed9ee77b0f7f63010e173166ac0c7119cad78cdd',
    'K2-sym20-f32-(66, 132)-1':
        'eaa6bd8b739a7fa0ff53ec1bf669882150d1a5977841dc3ec0f840948df37164',
    'K2-odd5-f32-(66, 132)-1':
        '1ba2957b4b306f1118b61345f8eaf8a1a7682dbc61d7cb7ec6ed216efffc8966',
    'K2-haar-f64-(66, 130)-0':
        '292c1ffd72d3411bf5d2632d73621edf1c817700c950185aeba8805ac3e970b4',
    'K2-db2-f64-(66, 130)-0':
        '01094aa65994cccae02cb561cf3f3e359eb3129df72e745e6f4f892303e6b17d',
    'K2-bior4.4-f64-(66, 130)-0':
        'd5e023df97831f31db5c26197ddd1581dfe9435b3a7f806d761a901f05d6b475',
    'K2-sym8-f64-(66, 130)-0':
        'd0f17ed3ddfe784c1f86c97231bc38aa798d0f5df9833b4cde4a2ab043baefc6',
    'K2-sym20-f64-(66, 130)-0':
        '915f9903ed8a8ef1c1a4580170e21d0bc961785d32542f355bd0b45dee9bd110',
    'K2-odd5-f64-(66, 130)-0':
        '97bb95a4447ddddcafabe803781b3c924c8763b253cfd453b48bcc132bd6e729',
    'K2-haar-f64-(63, 127)-0':
        '78858aefa4cc5b68744dddba29c69bd868742eb3dcff74b0f64eeca378b3c12d',
    'K2-db2-f64-(63, 127)-0':
        'd0818560b884175ccb79a0bf62d6d85cf6cac7da3a4313d92effdccad6b0135b',
    'K2-bior4.4-f64-(63, 127)-0':
        'a4ba7bb6804acdd9896681320d3284a6cb97c3c5eecdc25564bd301846fd9ac1',
    'K2-sym8-f64-(63, 127)-0':
        '3f9a342069eda59b882c8f0535b5e467f4c16f3e3ea0b1628104b77c6f4f9bb9',
    'K2-sym20-f64-(63, 127)-0':
        '08fe77326e06d036285382b3dc179fd5324610d13edef8775a853d7fc1c5b51b',
    'K2-odd5-f64-(63, 127)-0':
        '081c31756abaccab4dc38746377ae7ce13d669546fcbd9c585af9eb85aa4e60f',
    'K2-haar-f64-(3, 40, 72)-1':
        'bb26c7637bb8fe906192d311c0c3a36e10666127fcdd8319d17148fa77b90a6d',
    'K2-db2-f64-(3, 40, 72)-1':
        'ee64b0b63fde444bcbf29fa5558acc4428a1abe91ae3759d72f2c9de92d11b17',
    'K2-bior4.4-f64-(3, 40, 72)-1':
        'a830f9f316020390fa878c4887313dd55a12dab731b4798b179c1117a35ce472',
    'K2-sym8-f64-(3, 40, 72)-1':
        '7b61958f50116165142f06eaf5a70e42fd870f64d69843df717f436419442bb8',
    'K2-sym20-f64-(3, 40, 72)-1':
        '5bd93f3cc5429efad386f1bcf9779c130fb36b6654792c4a3b792d123a50c942',
    'K2-odd5-f64-(3, 40, 72)-1':
        '0e370315f8fa7ca95bfd50e067e263136e18cfdef2656dd744bbd52bc2224833',
    'K26b-haar-f32-4-(8, 48)-0':
        '255143e27c3bbb98e6576e5ef198b0ee03056c53c0857c90ee3dbe23bf93ddeb',
    'K26b-db2-f32-4-(8, 48)-0':
        'a79fa0c19e16ed738574f5248c2f0d8fd77afdf63f1ba41623162417df07d9ee',
    'K26b-bior4.4-f32-4-(8, 48)-0':
        'ab99753c7980affc42d31af687c89e69b779b587cdf384438189927c926d91fc',
    'K26b-sym8-f32-4-(8, 48)-0':
        '54f1be5d64d016790a71ba0407c95c6712197c0997b767014dad142c6c901789',
    'K26b-sym20-f32-4-(8, 48)-0':
        '32d616468f1c1c5133ba7d2e5bada51a27e2e56a50404b6045b5616581db3740',
    'K26b-odd5-f32-4-(8, 48)-0':
        'cd983e9d6011f1b94130a137f0a8e8674883afdf5f5130601722b303971806f7',
    'K26b-haar-f32-4-(16, 64)-0':
        '11a9f624ecc53a47146ebc634bf7756f8a01b699304663de3d885d4d813bb714',
    'K26b-db2-f32-4-(16, 64)-0':
        'f185f6b0494d52078a083595c59f1c01d7a74eebb020e65951f537f75ce5ca07',
    'K26b-bior4.4-f32-4-(16, 64)-0':
        'c714ef81ba5331b262815bcb828f8f14b64f01fce31f8acca71bfc8b74b537a4',
    'K26b-sym8-f32-4-(16, 64)-0':
        '87fd973e0675d791d1a40f0e4fa1d5e2c1f19168f547996570ead777f9ae1619',
    'K26b-sym20-f32-4-(16, 64)-0':
        'd83c87b7a5645ee4ccdc73d090cb2bb17dc339b922af193da6bfad0a45404f25',
    'K26b-odd5-f32-4-(16, 64)-0':
        '0f836afad6dff29f6714d9000da6d8cb19ac38c7181b074122353c404e9d4af3',
    'K26b-haar-f32-4-(16, 64)-1':
        '11a9f624ecc53a47146ebc634bf7756f8a01b699304663de3d885d4d813bb714',
    'K26b-db2-f32-4-(16, 64)-1':
        'f185f6b0494d52078a083595c59f1c01d7a74eebb020e65951f537f75ce5ca07',
    'K26b-bior4.4-f32-4-(16, 64)-1':
        'c714ef81ba5331b262815bcb828f8f14b64f01fce31f8acca71bfc8b74b537a4',
    'K26b-sym8-f32-4-(16, 64)-1':
        '87fd973e0675d791d1a40f0e4fa1d5e2c1f19168f547996570ead777f9ae1619',
    'K26b-sym20-f32-4-(16, 64)-1':
        'd83c87b7a5645ee4ccdc73d090cb2bb17dc339b922af193da6bfad0a45404f25',
    'K26b-odd5-f32-4-(16, 64)-1':
        '0f836afad6dff29f6714d9000da6d8cb19ac38c7181b074122353c404e9d4af3',
    'K26b-haar-f32-3-(10, 131)-0':
        '2a88298a9a12a45fcd2a0999f79461b9749a1274d3523f40efa03cfbd9bff23e',
    'K26b-db2-f32-3-(10, 131)-0':
        'b5c614aa19eb336b7ee12b9fe330ddf0d2c93c2752d88ad745e50b5a76f50cc5',
    'K26b-bior4.4-f32-3-(10, 131)-0':
        'e714b997cb48a63c6c816ee3681defe297b29b7c857c16f1a51d0187d8ef5c67',
    'K26b-sym8-f32-3-(10, 131)-0':
        '7505b3c0ae074dcd343fc6e491090c4c7acc5e5470266c7b497eea388d6cdfd4',
    'K26b-sym20-f32-3-(10, 131)-0':
        'c948dcd947ad0cce77528ecabc1fc240c2bd74402cf2e4cdab127c85633315a7',
    'K26b-odd5-f32-3-(10, 131)-0':
        '5df0c8929dcf0d7eebf6d58aec16344def400f8030a71e6bc6783e8f280d4cc7',
    'K26b-haar-f32-2-(3, 20, 36)-0':
        '9ba9a3ec9d488b81f1c2d57ea004c6c55c9fc97dbc701981bb2e33e1567ea90e',
    'K26b-db2-f32-2-(3, 20, 36)-0':
        '8c54ce4f70d2864488c528096b001d1b1c1f6ff6a0b9488a90e50916d79d0d96',
    'K26b-bior4.4-f32-2-(3, 20, 36)-0':
        'aa1fd42ccedcec5af8024fa56b33a169367a21f8d221deca185d64b6c994238c',
    'K26b-sym8-f32-2-(3, 20, 36)-0':
        '1c5b52584171476e2c1a4e93baf1017e26eadad545652bf70037dc83d6bd8fc1',
    'K26b-sym20-f32-2-(3, 20, 36)-0':
        'bcb4a7afcdd97b22d573f139d3964315035add8aa2d028d970926f92232ecfc1',
    'K26b-odd5-f32-2-(3, 20, 36)-0':
        '8a13dbb3ff65bd53e334a5dd5245361c57d7c202e42a0cf3ab6b16427fe79dab',
    'K26b-haar-f64-4-(8, 48)-0':
        '8543bbeb4a2b7655212a2ebf9b2d3d35eb2c22540120af128eead0e2e4e94c21',
    'K26b-db2-f64-4-(8, 48)-0':
        '2a97582f4b67482f3201e5ef6a6ac815154e8ac4cfcb7581f4ab8b9c2c798cfc',
    'K26b-bior4.4-f64-4-(8, 48)-0':
        'd3d513453818dd36c230f35a992b649daa5c66b5d5d8b34f9c52937395c95e1e',
    'K26b-sym8-f64-4-(8, 48)-0':
        'd22b666c4aa0480302d3468e1f0239b716624412311b0f8ff0fef1525081bbde',
    'K26b-sym20-f64-4-(8, 48)-0':
        '93666b65c312c7c7b25cde45f5dcacff5eabeb4a78109960172ede312ab44c0a',
    'K26b-odd5-f64-4-(8, 48)-0':
        'ddc161dfc38be98d05e78dcd58e48300936ca9dcd9b3921853a65601f97b1373',
    'K26b-haar-f64-2-(3, 20, 36)-1':
        '630e2098ce1007da1ceacf46dbaaceb4a4f441b840826b102bf43547086a6dfa',
    'K26b-db2-f64-2-(3, 20, 36)-1':
        'fd479d9036ca29a0193e329a3123e0332993f2eecb5856cd24ad4315d10daf8d',
    'K26b-bior4.4-f64-2-(3, 20, 36)-1':
        '00af70bbbb05912fa2e01c61a4b9f4235d76741bd0f3a1d5924287f70116e026',
    'K26b-sym8-f64-2-(3, 20, 36)-1':
        '997c97ad6647aabd8ab249efd6a1edbc94f4c2841a5c38227f6df05e7fe5119a',
    'K26b-sym20-f64-2-(3, 20, 36)-1':
        '206752cf980a5bfba41ec66a165253e7c33e7427a4f4946f025a40c37d23a5ed',
    'K26b-odd5-f64-2-(3, 20, 36)-1':
        'bf014defb404706892361b65d82f428f8f902485fc3f60c8901773d096f896cd',
}


# K1 and K26a on dwt2d.cu's pair analysis body: each output against its
# plain version and against the SHA-256 of the outputs (a, h, v, d in that
# order) that the body before it (level2d.cuh's ana::tile, which K19 and
# K24 still run) gave on the card for the same seeded inputs; `python
# tests/test_torch_kernels_cuda.py digests` prints a tree's digests in
# PAIR_DIGESTS's and ANA_DIGESTS's form. Banks: PAIR_BANKS.
# K1: (type, input shape, offset): whole tiles, rows of 130 samples (not a
# multiple of 4: sample copies), odd planes on either or both axes
# (wrap_ext), a batch of 3, planes one sample past a 16-byte boundary
K1_ANA_CASES = [("f32", (64, 128), 0), ("f32", (66, 130), 0),
                ("f32", (2047, 2047), 0), ("f32", (2046, 2047), 0),
                ("f32", (2047, 2046), 0), ("f32", (3, 40, 72), 0),
                ("f32", (66, 132), 1), ("f64", (66, 130), 0),
                ("f64", (63, 127), 0), ("f64", (3, 40, 72), 1),
                ("f64", (2047, 2046), 0)]
# K26a: (type, shards, input shape of a shard, offset), shard 1: of 16 and
# 8 rows (sym20's top halo of 19 rows spans two or three neighbours), of
# 131 columns, a batch of 3, offsets of one sample
K26A_ANA_CASES = [("f32", 4, (16, 64), 0), ("f32", 4, (8, 48), 0),
                  ("f32", 4, (16, 64), 1), ("f32", 3, (10, 131), 0),
                  ("f32", 2, (3, 20, 36), 0), ("f64", 4, (8, 48), 0),
                  ("f64", 2, (3, 20, 36), 1)]
ANA_CASES = ([("K1", c) for c in K1_ANA_CASES]
             + [("K26a", c) for c in K26A_ANA_CASES])


def _ana_output(kind, case, wname, dev):
    """(kernel outputs, plain outputs) of one case, the kernel launched
    once."""
    dtype = torch.float64 if case[0] == "f64" else torch.float32
    fb = _bank(wname)
    if kind == "K1":
        _, shape, off = case
        x = _offset(_rand(shape, dev, 5).to(dtype), off)
        n = fd.dwt2d_fused.launches
        got = fd.dwt2d_fused(x, fb)
        assert fd.dwt2d_fused.launches == n + 1
        return got, fd.dwt2d_plain(x, fb)
    _, shards, shape, off = case
    x = _global(shards, shape, dev, 5).to(dtype)
    b, t, o = (_offset(p, off) for p in _shard_halos(
        x, shards, 1, *fd.halo_heights("dwt", fb, 0)))
    n = fd.dwt2d_sharded_fused.launches
    got = fd.dwt2d_sharded_fused(b, t, o, fb)
    assert fd.dwt2d_sharded_fused.launches == n + 1
    return got, fd.dwt2d_sharded_plain(b, t, o, fb)


@pytest.mark.parametrize("wname", PAIR_BANKS)
@pytest.mark.parametrize("kind, case", ANA_CASES, ids=str)
def test_k1_k26a_ana_body_matches_plain_and_parent(dev, kind, case, wname):
    got, ref = _ana_output(kind, case, wname, dev)
    tol = TOL if got[0].dtype == torch.float32 else 1e-12
    for g, r in zip(got, ref):
        assert g.shape == r.shape and float((g - r).abs().max()) <= tol
    assert _sha256(torch.stack(got)) == ANA_DIGESTS[
        _pair_id(kind, case, wname)]


ANA_DIGESTS = {
    'K1-haar-f32-(64, 128)-0':
        '08bf384180e0d3214e65275020c5dfe5913d2f6954948540fa744736caa8c1c2',
    'K1-db2-f32-(64, 128)-0':
        '197d5789dda03c35531d2f3cc397f1d09fabc099a1685f25c37bb19f462382b0',
    'K1-bior4.4-f32-(64, 128)-0':
        'e5792a9330faa208cc7cb8850586c9c2d2c3d26ce5cadcf9e26dca94de7dcbeb',
    'K1-sym8-f32-(64, 128)-0':
        'b1c2dc7a95d9058ddeac4a6c1bb6520e80bd70738f65d7772c218ef95123802a',
    'K1-sym20-f32-(64, 128)-0':
        '6fdf9c879f88d8c075a6eb1f300c87de8d45c011bbecc42020df4135055c9502',
    'K1-odd5-f32-(64, 128)-0':
        '5887de3fa74c4d5e8670c2aae5d83b6806b43c8d2e863ccfcaee606355c7d72a',
    'K1-haar-f32-(66, 130)-0':
        '31a4e7a0528af752cdfac1335e420007b3049637ece124c1ca21c5783e104f74',
    'K1-db2-f32-(66, 130)-0':
        'cbd5fa58773a96301264cf36985b28dff19f4f049375661f0258c207081f33af',
    'K1-bior4.4-f32-(66, 130)-0':
        'fd51f13b633b2304acc803afbb136899de41edd58aca1e0639273fc254a238d8',
    'K1-sym8-f32-(66, 130)-0':
        '91de3dfb98b9d073da78f36d58254c63377e75749008cdc3630f44f2c8eb8a38',
    'K1-sym20-f32-(66, 130)-0':
        '16fd4bbe4e200a4365557aa9f54fb5d14ffd789411db8de75e1a22f06369d8dc',
    'K1-odd5-f32-(66, 130)-0':
        '52bab42b8cd1984053601ccf56f6b8d7b9c7cbe4b1dc1a87ba5ea864b23946af',
    'K1-haar-f32-(2047, 2047)-0':
        '4b502bf6dfa3e8bdbc8b398c85401652d6a0f944aac8486e3aa63776693e2a4e',
    'K1-db2-f32-(2047, 2047)-0':
        '05670c7729ac75ec9f7ea82b13d7603d6090edaed88cee8bcff215963fe8e6cf',
    'K1-bior4.4-f32-(2047, 2047)-0':
        '0756ddfaacb2dd967089e38cf62d5a97f3b573e58250b82cb8532eac585e56ba',
    'K1-sym8-f32-(2047, 2047)-0':
        '5ec68a6a92625ff88093aa378acf3adf5784462c792e60095c79322325ff7f9d',
    'K1-sym20-f32-(2047, 2047)-0':
        '7071359fa475d3de71c3aef97a96b356273dbc4def23976e59478080b939857c',
    'K1-odd5-f32-(2047, 2047)-0':
        '3fa683108a18c481e19c15f9186297c5f0a76b2e0845feae36adc5547c6c209e',
    'K1-haar-f32-(2046, 2047)-0':
        'd54e779dbb83c92a19156a16ea2856ceb2ab162048359eb06147eb77e3332fbe',
    'K1-db2-f32-(2046, 2047)-0':
        '6365498c845a5537524e1456eed688076b99b811a07ce4ed693971b9b7e94a83',
    'K1-bior4.4-f32-(2046, 2047)-0':
        'e4c136185d6118fd47a4fe56fd753dc0277c1697a479a76139c89d3a5913334c',
    'K1-sym8-f32-(2046, 2047)-0':
        '762ed967f2d861d8f6f17cb4a0b1a3078113a83c4049cbf3f0df9666bf4f4949',
    'K1-sym20-f32-(2046, 2047)-0':
        '8e4909577e097a2e2c3a984bb1961b70e73d21654d6246fd41112322826ee66f',
    'K1-odd5-f32-(2046, 2047)-0':
        '201322510e4b5d0dfb582cef2c4cc9ebdb8ca4f644af6bb33df4ed651773dd69',
    'K1-haar-f32-(2047, 2046)-0':
        'b83cd04b137b8cc60fbc90519ee24cd7dc55aa04fd47ce1f63cb1dbdc2465086',
    'K1-db2-f32-(2047, 2046)-0':
        '6747fd4341c0f097765d441b869d511fe87bb587cc9ce095c550bf9de777dd25',
    'K1-bior4.4-f32-(2047, 2046)-0':
        '8b58cb88f60d83f92ca3f53d131dabbf7091470e903b924c8aa852219367da75',
    'K1-sym8-f32-(2047, 2046)-0':
        '75dd59b262146c11e3f320fcb82a252ad3c159e5ffbb90636d020b4c3c94bc5f',
    'K1-sym20-f32-(2047, 2046)-0':
        'aff6aab85986b68cdab33ea4374682685f254c879e0d41fcb0d920f9dbae9fc6',
    'K1-odd5-f32-(2047, 2046)-0':
        '3880bda46aaaa18533bb8e90d2b20bf1b071adf22fae65c3530f4349f41376a2',
    'K1-haar-f32-(3, 40, 72)-0':
        '40d2fb0d1fb71068af2988bf379316e149cb74de1fb710282cfe5dee41879902',
    'K1-db2-f32-(3, 40, 72)-0':
        'e3782bbc598d9c9802f1224eb0d568ecb587803cdcfc1e0ba5166d4c123dc0af',
    'K1-bior4.4-f32-(3, 40, 72)-0':
        'e28fee7154cd7f155cd385fa0cd948ebda0ae5c2d4d291aae2ca944cfad9b670',
    'K1-sym8-f32-(3, 40, 72)-0':
        '33ae8f5bd5d97de812db7c7e76e9f41e6278b407ce6fb390343c9d494b2769f9',
    'K1-sym20-f32-(3, 40, 72)-0':
        '969243ab01494dfad6a5d08fb020891da034d6781147841408f8489819b14a1c',
    'K1-odd5-f32-(3, 40, 72)-0':
        '91a44670e84d1cf2a5d902c91aba46d14f11f3f3940c1612ce97cc63d972521d',
    'K1-haar-f32-(66, 132)-1':
        '21894554810ca61287825c28d4b0b10ff17abe8505d57769f5d102109d015462',
    'K1-db2-f32-(66, 132)-1':
        '44beb63c09d55eb32b4abac475ce32d3afc18d2f8ea514036cdcd56912ae4686',
    'K1-bior4.4-f32-(66, 132)-1':
        'b5af24a9105fd1f705b92b1a28f56473dde94227c76a218a0b89b2252cc68885',
    'K1-sym8-f32-(66, 132)-1':
        'c68feaf11b94a57f6b4f2453fbd1979929e2ca43a4ced45e7ca5412710d3d939',
    'K1-sym20-f32-(66, 132)-1':
        '30f675406e843af917244a3bc24ac60a85bccc5bbc64a298f9a37a23b0a9c91f',
    'K1-odd5-f32-(66, 132)-1':
        '1e35e31b3bc7f440b3af99c4c3cc141cb26f8edcb931ae94749a01c3c3d158aa',
    'K1-haar-f64-(66, 130)-0':
        '8984275dfc139fdbfcb375613980e2c9f850cc59bb54b2d1e8fa4a64906e2aa6',
    'K1-db2-f64-(66, 130)-0':
        '062dee563c9b9caeda9c8415a50d633b9fe022d0ae9b2e0cc62e42d7786c7c4f',
    'K1-bior4.4-f64-(66, 130)-0':
        '2edf10400a3bc6e225ec06069612b8b9ede7c9ed5814da6d63e6db87bcf99b30',
    'K1-sym8-f64-(66, 130)-0':
        '303d7b967d2a6a7cd5ec7e7dcf6de498d99198f9684b8e31cc79eb80aa9b1179',
    'K1-sym20-f64-(66, 130)-0':
        '1a8709ff195b45c05bada46b955b0a2016429b5d2137c4f57a9ed3379f14bdb7',
    'K1-odd5-f64-(66, 130)-0':
        'e6d05129f85b9b776c05fe26308932f1f9fab5b7d7b2f962c953df95934e4ce6',
    'K1-haar-f64-(63, 127)-0':
        '903087fc5f6f5b365fb6848dcab4846660d01f71e762fa65a1fa9ee15e6f9d44',
    'K1-db2-f64-(63, 127)-0':
        'cc07bdd60fedf46a1b60ca6c7b0cba2cbb0bf42df18b8386e80e16ff588e9b88',
    'K1-bior4.4-f64-(63, 127)-0':
        '6127c47af64ec3594dc83b1a1b228717b9910ca59aaf07aef54e66cbc4347c3f',
    'K1-sym8-f64-(63, 127)-0':
        '2df91af53ac01768ccaaeb6abd3c0cbd081b26f1cc7455a492b127239258eae6',
    'K1-sym20-f64-(63, 127)-0':
        '1ee0c33a0f0807c2ae94447f738707eeb5274af8257b7b446d0b833b9c3d4180',
    'K1-odd5-f64-(63, 127)-0':
        'f158266bd8010da4b31fdb04d291f5a43c3439e0ab60aef2f5fe444a19246c0b',
    'K1-haar-f64-(3, 40, 72)-1':
        'ee9a993aabeec0d8a9037e53a6eadad1ceb9dcf23f68d2930410c1ceba2af092',
    'K1-db2-f64-(3, 40, 72)-1':
        '158485310d818be89376b7e62281ecaaa1296d9358de0253a7761e269dcf1913',
    'K1-bior4.4-f64-(3, 40, 72)-1':
        '1fcc9252692ee6fbb86145dca9500c21f75f767a638a1edd05adafffa3f1624a',
    'K1-sym8-f64-(3, 40, 72)-1':
        'ce417cb06b60f59138c7c02ff79843db3b13d42abfe352a506c71610891b9fca',
    'K1-sym20-f64-(3, 40, 72)-1':
        '8af50c088100d2630985f6422587f3c4e16192aaaf2a53612b6ae8ec9bfd3fda',
    'K1-odd5-f64-(3, 40, 72)-1':
        '44844da90aca73938de6e8a57390d088d7f0d5d4adeab2d84861243f887a7c3f',
    'K1-haar-f64-(2047, 2046)-0':
        'ed32aa3cdeda7edf5f9dfe96bd80cbca75e82e9ea0c70c918a4bc9da91baa8b9',
    'K1-db2-f64-(2047, 2046)-0':
        'd0a3eed9364d717b0f4a26c766a64d247cd690e6e617ed2f3709d026a161dd6d',
    'K1-bior4.4-f64-(2047, 2046)-0':
        'baa6926f21e61185680f5e857201c7853596522a0fe126b0cc251bc892b1fde6',
    'K1-sym8-f64-(2047, 2046)-0':
        'f409912e6b8ef06bd735ca1ad328373163f8980a41f682f169e4b3d1832a58fc',
    'K1-sym20-f64-(2047, 2046)-0':
        '27849f07d069ae1f977a9184bda214df2c5e57069b12b1bdcb6d80f36ef2d967',
    'K1-odd5-f64-(2047, 2046)-0':
        '24128d81577d7bd64321f42f18af6493b8f989ce050a4c70ae339e8323031dee',
    'K26a-haar-f32-4-(16, 64)-0':
        'd585400b28a1f0088efaccbb0efad46c6b3f9f8ac8e1febc3dab05df41449a01',
    'K26a-db2-f32-4-(16, 64)-0':
        'aa3fcef7984414138a580fd3a2d7d76c753d596ffc7542ea93d26b36ee1f7bbe',
    'K26a-bior4.4-f32-4-(16, 64)-0':
        'ab951dcf6340a0f709a8fbce187aaf2ca940543836c3eab141456f8bd7e97ab2',
    'K26a-sym8-f32-4-(16, 64)-0':
        '9fa27f57fa1a8d3a8f1945e662a2f3b93eceb17bbcccd758f4e279685ed7ea5b',
    'K26a-sym20-f32-4-(16, 64)-0':
        '439831010124082c420fbcbcb0db945fa3fdacb2db16c98ccd0b00d2c1e32d11',
    'K26a-odd5-f32-4-(16, 64)-0':
        '6882c86c6fbe70c74d447287c2b7e76523b6ff6575997b422dde3bbb3f6e35b4',
    'K26a-haar-f32-4-(8, 48)-0':
        '8b7abccd758f777b7db0025abde128536adf3667557c592fcd0194ff902fd23b',
    'K26a-db2-f32-4-(8, 48)-0':
        'c36b9eebd044d1eafa4e5ef53dded011e9dd6d7f8c7c1534921539bdcfe0cbab',
    'K26a-bior4.4-f32-4-(8, 48)-0':
        'fd070d818bce244645c3b9b59b7694df5c55322d8e816810e4949cec86f69900',
    'K26a-sym8-f32-4-(8, 48)-0':
        '221ef883e2bd1858423e31deb9764c8b36ee65ba78dd13c854f96b0596e25ba2',
    'K26a-sym20-f32-4-(8, 48)-0':
        'e833863e59e4a296b16af2c720140bd72c5f3530fae5df086f088b1421646fb0',
    'K26a-odd5-f32-4-(8, 48)-0':
        '0ccc618ab38c82bdc95b1b585d69160e7bd3cd36112e6cd3c0ee66def5dc79cb',
    'K26a-haar-f32-4-(16, 64)-1':
        'd585400b28a1f0088efaccbb0efad46c6b3f9f8ac8e1febc3dab05df41449a01',
    'K26a-db2-f32-4-(16, 64)-1':
        'aa3fcef7984414138a580fd3a2d7d76c753d596ffc7542ea93d26b36ee1f7bbe',
    'K26a-bior4.4-f32-4-(16, 64)-1':
        'ab951dcf6340a0f709a8fbce187aaf2ca940543836c3eab141456f8bd7e97ab2',
    'K26a-sym8-f32-4-(16, 64)-1':
        '9fa27f57fa1a8d3a8f1945e662a2f3b93eceb17bbcccd758f4e279685ed7ea5b',
    'K26a-sym20-f32-4-(16, 64)-1':
        '439831010124082c420fbcbcb0db945fa3fdacb2db16c98ccd0b00d2c1e32d11',
    'K26a-odd5-f32-4-(16, 64)-1':
        '6882c86c6fbe70c74d447287c2b7e76523b6ff6575997b422dde3bbb3f6e35b4',
    'K26a-haar-f32-3-(10, 131)-0':
        '811867f2912f5c641471d2df956f746b6a2f94032047e368a7e5bb44c8277e8f',
    'K26a-db2-f32-3-(10, 131)-0':
        '36569fd94e9c5e1f7a502a4f35e21bdf2300f63f9233cccddf101de44f173e5c',
    'K26a-bior4.4-f32-3-(10, 131)-0':
        '9abd2c30bee3aa1f773dea843859d7fb460fd20e46270faf6e258925b34bbdb2',
    'K26a-sym8-f32-3-(10, 131)-0':
        '5fa84006599748ed01653fc1cf9aa519684329c9f53df7da12f3ea63b07395a8',
    'K26a-sym20-f32-3-(10, 131)-0':
        'c3854c9d3334a1be119dd461fb7b9e64249f5811aa342816a047002bc3c844cc',
    'K26a-odd5-f32-3-(10, 131)-0':
        '2edbd40416076aa13645bc43683d58fb87afec188034dfd405eead214c88efea',
    'K26a-haar-f32-2-(3, 20, 36)-0':
        '3bf8798ee019306768bf9004ea462cb2e49f557873c1d5697cb67810848f8eb5',
    'K26a-db2-f32-2-(3, 20, 36)-0':
        'a2352d42a21e89c0c14be06982ed78961c3a29e3bb3f523e5700260df6592c33',
    'K26a-bior4.4-f32-2-(3, 20, 36)-0':
        '61dadf47c9b3b2ea400e01b3a2ee5d74046fa5148a93fe1b335c0eac31dd4bf8',
    'K26a-sym8-f32-2-(3, 20, 36)-0':
        'dabb05dcabb99a5d0760c11ce3a2d06c10223a488eed6124bef0d9dbe2c979a4',
    'K26a-sym20-f32-2-(3, 20, 36)-0':
        'ed0082459c1eff30b6917c53a799dd5ddeab29b3377964ca40ac1b5c6c5ab5a3',
    'K26a-odd5-f32-2-(3, 20, 36)-0':
        '1093b44f78c15dd318fe1226102875e8ab9d30de6d2c1e362cd08a35446efc7b',
    'K26a-haar-f64-4-(8, 48)-0':
        'cf1f3680f8e3c2cfadb9c0a6703f9cd2c7562c549234f2ef9faa5c4bc784374b',
    'K26a-db2-f64-4-(8, 48)-0':
        'c2f596128627d3ed395fd4ffde17335af7899dd3f8a1000304dd877f04e08abd',
    'K26a-bior4.4-f64-4-(8, 48)-0':
        'e0e877ecf8fee06726da13243a3564ee34d75a6a9028818db3767721697ba773',
    'K26a-sym8-f64-4-(8, 48)-0':
        'f7e6ddd47c7996b9e56704ad92b1e302d67bf92d3fbcce0ebb8843f9a3758987',
    'K26a-sym20-f64-4-(8, 48)-0':
        '160e0e8bc0dc2d1581774deabfbbaacbef10859da893ca93efde3645f4910294',
    'K26a-odd5-f64-4-(8, 48)-0':
        'ff9a7e1c148b9acf0cd8d0643ed8a4179c22ebb8abf01b3cd53fd05af4324087',
    'K26a-haar-f64-2-(3, 20, 36)-1':
        '43bca12c29c08567d0d5aa8f071687c66b0addca2799fb8c0cdbceeaf98d1aa1',
    'K26a-db2-f64-2-(3, 20, 36)-1':
        'a7eb1b21bd89f67ed9a9979220b09dabe6f6de8886c86c004e70e0c1ba158453',
    'K26a-bior4.4-f64-2-(3, 20, 36)-1':
        'c0c8f16f39c486560becc5537d55f1fb68dc322af1dbf157343329d36af25589',
    'K26a-sym8-f64-2-(3, 20, 36)-1':
        '40e3a31b4245c9729ec19a1fdb0bbf8651e9c8c019d9dd534efb09ed1bc37c55',
    'K26a-sym20-f64-2-(3, 20, 36)-1':
        '832e81bbe60d6dcb2113738e5b644123d10baa76fbf3fcd415240f86d9330679',
    'K26a-odd5-f64-2-(3, 20, 36)-1':
        'f83e737a215dff0bc73b69bc50950ec565d8abed2bfb66aec56cf9491e42daf8',
}


# K29g and K29h, tc_dwt2d.cu's row passes: each output against its plain
# version and against the SHA-256 of the output that the kernels before
# their redesign (windows staged through registers, stores straight from
# the C fragments) gave on the card for the same seeded inputs; `python
# tests/test_torch_kernels_cuda.py digests` prints ROWS_DIGESTS's form too.
# Banks of hlen 4, 10, 18, 26, 34 and 40 reach every instance (k-steps:
# K29g TF32 3-7 and bf16 2-4, K29h TF32 1-3 and bf16 1-2).
ROWS_BANKS = ["db2", "db5", "db9", "db13", "db17", "sym20"]
# (shards, input rows of a shard, nc, input offset, output offset); K29h
# takes half the rows: whole and crossed tiles, nc % 4 of 1, 2 and 3 and nc
# below 64, 8-row shards (multi-hop halos), inputs or outputs or both one
# float past a 16-byte boundary
ROWS_CASES = [(4, 64, 96, 0, 0), (3, 130, 130, 0, 0), (4, 8, 33, 0, 0),
              (2, 66, 35, 0, 0), (4, 8, 40, 0, 0), (2, 64, 64, 1, 0),
              (2, 64, 68, 0, 1), (2, 70, 129, 1, 1)]


def _rows_id(kind, case, wname, prec):
    return "-".join([kind, wname, prec, *(str(v) for v in case)])


def _rows_output(kind, case, wname, prec, dev):
    """(kernel output, plain output) of one case: the C entry launched once
    on the shard, its halo rows and NaN-filled outputs made here."""
    fb = _bank(wname)
    shards, rows, nc, oi, oo = case
    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    bf16 = int(prec == "bf16")

    def empty(n, m):
        return torch.full((n * m + oo,), float("nan"),
                          device=dev)[oo:].view(n, m)

    if kind == "K29g":
        pads = fd.one_axis_pads("ana", fb, 0)
        b, t, o = (_offset(v, oi) for v in _shard_halos(
            _rand((shards * rows, nc), dev, 7), shards, 1, *pads))
        out = [empty(rows // 2, nc) for _ in range(2)]
        taps = [fd._host_taps(f) for f in (fb.dec_lo, fb.dec_hi)]
        err = lib.pypwt_tc_ana_rows(
            b.data_ptr(), t.data_ptr(), o.data_ptr(),
            *(v.data_ptr() for v in out), rows, nc, *pads,
            *(v.ctypes.data for v in taps), fb.hlen, bf16, dev.index, stream)
        assert err == 0
        return (torch.stack(out),
                torch.stack(km.ana_rows_mxu_plain(b, t, o, fb, prec)))
    L = rows // 2
    pads = fd.one_axis_pads("syn", fb, L)
    body, halos = _coeff_halos(
        [_rand((shards * L, nc), dev, s) for s in (8, 9)], shards, 1, pads)
    body = [_offset(v, oi) for v in body]
    halos = tuple(_offset(v, oi) for v in halos)
    out = empty(2 * L, nc)
    ptrs = fd.halo_array(halos)
    taps = [fd._host_taps(f) for f in (fb.rec_lo, fb.rec_hi)]
    err = lib.pypwt_tc_syn_rows(
        body[0].data_ptr(), body[1].data_ptr(), ctypes.addressof(ptrs),
        out.data_ptr(), L, nc, *pads, *(v.ctypes.data for v in taps),
        fb.hlen, bf16, dev.index, stream)
    assert err == 0
    return out, km.syn_rows_mxu_plain(*body, halos, fb, prec)


@pytest.mark.parametrize("prec", ["highest", "bf16"])
@pytest.mark.parametrize("wname", ROWS_BANKS)
@pytest.mark.parametrize("case", ROWS_CASES, ids=str)
@pytest.mark.parametrize("kind", ["K29g", "K29h"])
def test_k29g_k29h_row_body_matches_plain_and_parent(dev, kind, case, wname,
                                                     prec):
    got, ref = _rows_output(kind, case, wname, prec, dev)
    _close_prec(got, ref, prec)
    assert _sha256(got) == ROWS_DIGESTS[_rows_id(kind, case, wname, prec)]


ROWS_DIGESTS = {
    'K29g-db2-highest-4-64-96-0-0':
        'e251c35566bb7fc648535accbfbe383608eae5c3c17768a3a17cd05309229816',
    'K29g-db2-bf16-4-64-96-0-0':
        'dbcd8d59cf1dc763fc56d56e64ae1483607a69e9bcbe5f6f3873e121dca68e88',
    'K29g-db5-highest-4-64-96-0-0':
        'b8cd29ee03f8b75bcdf38601e8e0cb58ad0119898639606afc65d0fccfbecab9',
    'K29g-db5-bf16-4-64-96-0-0':
        '2132f6fa150b8986fac43cd827f0d86ee8d847de472abec7f2e043b985f20dae',
    'K29g-db9-highest-4-64-96-0-0':
        '88c3661baa10eb3663a52948d3657a3e4fc0be71b09f875892863f297f94f7aa',
    'K29g-db9-bf16-4-64-96-0-0':
        '3b5fb30b2869e6edc3fe6d3a07aeebf53bc9ffe50df786453ad646bb7dc0bc29',
    'K29g-db13-highest-4-64-96-0-0':
        '26ad6c285708488a588d4317d9ec67f2995c25c4cb8c962107471d749a400757',
    'K29g-db13-bf16-4-64-96-0-0':
        '13f8a0ab914e9f1c6bed7ef46259f62fd0dc480841b1a63fce2f1eb953f6df69',
    'K29g-db17-highest-4-64-96-0-0':
        '97feabd5376faf0fc2e6669d5de825dcf2f5430f37e088075305d2fede35a5b9',
    'K29g-db17-bf16-4-64-96-0-0':
        '67255a393e257bf747d5fa8c2c6fa76dd5c4bc2208772d86710b2be322d43d28',
    'K29g-sym20-highest-4-64-96-0-0':
        '1ec8d725dc5fda7322ccd973f78c8478027bc4b8034f8797c2e7fc10f9e81f02',
    'K29g-sym20-bf16-4-64-96-0-0':
        'f541acd55190a7846135ba900f85e9bf27b84c7fc70da5aa09f87ca03c9cba8c',
    'K29g-db2-highest-3-130-130-0-0':
        'd09058986b17dda5de3c93a50d6ae272cce7b981052e778b7f939c9f7a607d59',
    'K29g-db2-bf16-3-130-130-0-0':
        '655490749d21f895290014e1df59f779ba311edd01b9dd9cab3d62443cecb553',
    'K29g-db5-highest-3-130-130-0-0':
        '231ac41819177409de2ebb4d7c1f010767dca13da4b6a5dfae9499a9af75d59e',
    'K29g-db5-bf16-3-130-130-0-0':
        'e0b60fa5c7977fe7ae57e101ab8dbc99f09134aeaca7f0252d5387b0d43a6cfd',
    'K29g-db9-highest-3-130-130-0-0':
        '7d69635bf8c5cc282e52e106a42afad3f5880e504a6ef3d54c0b7a7232ae99df',
    'K29g-db9-bf16-3-130-130-0-0':
        '2ee705e2973a009f5da1900c40057ba96250188253d58b4dc6d29b8e5f345855',
    'K29g-db13-highest-3-130-130-0-0':
        '0428c15cb8fb12a330a332ba277fc77627aa1e486832666f8076c23dc88d54ee',
    'K29g-db13-bf16-3-130-130-0-0':
        '324a4a4a6eb7dfb41995da45bba46977110f310f2eb0d09ae872294bedbf8942',
    'K29g-db17-highest-3-130-130-0-0':
        '10701b01f1c2ea4ffc73ca7e64a9f31e0a1d26db803a5a33a53c5718a51b93fc',
    'K29g-db17-bf16-3-130-130-0-0':
        '5423b73c7c0d0d6c3f6fa60cb514806f6f5c34aeaf90d25d4cf785d7816c514c',
    'K29g-sym20-highest-3-130-130-0-0':
        '2b33701c2abb286e7fa4206dd0eb10783a8d3d8622f6468a4dae4520f4ba61b9',
    'K29g-sym20-bf16-3-130-130-0-0':
        '52cc9c3d15c17076078f6ecfd65f1a5bb99352b7c7c29064d33f2bc3bd2e2e6b',
    'K29g-db2-highest-4-8-33-0-0':
        'd72d4f1932591dc72dff143ac930fedd1a71df22a690a21788eca0751973b89b',
    'K29g-db2-bf16-4-8-33-0-0':
        '205316504df8ce7de4c840b0199abb20d9327b3739fbfe5139098b10c00f6ce1',
    'K29g-db5-highest-4-8-33-0-0':
        '8fd35c94e0366a774946e667d90b1d3d1b1189fb8b93426dbcd8bbb461435d90',
    'K29g-db5-bf16-4-8-33-0-0':
        'f85df028babc695c432e3a34184cee48537ba54bab86f9f4e3e46df0e15012dc',
    'K29g-db9-highest-4-8-33-0-0':
        'b249850bb7098ff9e53d8ea668d8ece1c5013991e34fc963fbc97af2f4aa8f46',
    'K29g-db9-bf16-4-8-33-0-0':
        'a9b92cf016fdce1bd5a44fb64d33a7f661f3df188c6701139f62bc7fa173557c',
    'K29g-db13-highest-4-8-33-0-0':
        'b16483ab29d90224fd23e92de64cb69e8da1f451adc91e3bffe1a9f4d08f7a71',
    'K29g-db13-bf16-4-8-33-0-0':
        '3f10830bbb5473d0cc0533ac639e331759d2edc2f0cd7f930118886dc3059f1b',
    'K29g-db17-highest-4-8-33-0-0':
        '60e5724d96b363a1df216d8b06a2579e30b810970c6d8465b4bd0a5497f248ee',
    'K29g-db17-bf16-4-8-33-0-0':
        '13443bdb2beda1bd68ad3110ade9389b12f4f589d718d96204e975ac1cce1339',
    'K29g-sym20-highest-4-8-33-0-0':
        'e1dffa3e6c7f1163fa598a93c4c37cbad429292495ed162fe6985272a8daa80e',
    'K29g-sym20-bf16-4-8-33-0-0':
        'b2c82deb597ae98f7045f4994bd5c6c3b6a9f811c3e183b6b7fa96bb5fe6e29e',
    'K29g-db2-highest-2-66-35-0-0':
        'd7a0a94d348a9b9619e1abaa31a23f11ff0126d3eb449447b801626730569c7a',
    'K29g-db2-bf16-2-66-35-0-0':
        'af770a3b8bdacd57102f6c7f4b0886efb87084a94a2289ede009646ff06e6765',
    'K29g-db5-highest-2-66-35-0-0':
        '6235409cc85b3d27732d055bdb8eca8141c9e15562f971206ccc1cf2612ee166',
    'K29g-db5-bf16-2-66-35-0-0':
        'ca0e2d01e2f5b341149291f5ce71920df85f5d4dcd806ebb013d09bf0b7c9a32',
    'K29g-db9-highest-2-66-35-0-0':
        '88975ab3650513d64ec55a08204da45a5f8c773b061bc6b1923709bdb5548b85',
    'K29g-db9-bf16-2-66-35-0-0':
        'f34d8366b736353c0a43b2f38045fb5553b9cb03fa2243fc09efba8295b546ab',
    'K29g-db13-highest-2-66-35-0-0':
        '47e31b6dd8340c43a530e2f4595359d3bcbdf5b5db8c1b3e6cbc1de4899d2967',
    'K29g-db13-bf16-2-66-35-0-0':
        '510a405e0e55964e870fee8f1994b4f203fcf7da419ba295de8f9dd0f65c932e',
    'K29g-db17-highest-2-66-35-0-0':
        '33a267f6e31fd808da4de1f391a61e445bc4472c27e490a3eba779b9342f0167',
    'K29g-db17-bf16-2-66-35-0-0':
        'ef660556a7e48d42c37c50001e8ec0736deb4e1dedac400ad1f51f3faecbd160',
    'K29g-sym20-highest-2-66-35-0-0':
        '2a25f043734eb51055e9dcd2337659a0b0b5ca17a1e25e2e804248fe09d1075e',
    'K29g-sym20-bf16-2-66-35-0-0':
        '12c4079b406a520779c7ec27ab86fd22619c5f37ad7ef20fc290051d1a6ef22a',
    'K29g-db2-highest-4-8-40-0-0':
        '8be05327da932ad9a3e3cc6f43d5a2769240550b78519073bf65dbdcc3777ba4',
    'K29g-db2-bf16-4-8-40-0-0':
        '316842e31ef184f265e67658f14d97844d1cd6ef3c3c9e4c7dc7d59607d5c5c6',
    'K29g-db5-highest-4-8-40-0-0':
        'cd2bbb49a96ed7fb3d38ce5dd044aa9f7764dcc835698a2fa99b3fe7fb37bfcf',
    'K29g-db5-bf16-4-8-40-0-0':
        'f44e42d07f0c5265974210e52bf0b25cbbe636ce1092b652bc618d9757d5082e',
    'K29g-db9-highest-4-8-40-0-0':
        '339e8eeda1f24773fcfce231f58fe78cdd4f7e8d3a02d6400370b9035e1c5774',
    'K29g-db9-bf16-4-8-40-0-0':
        '51646e5ad77269d84cc98486740272cb1e69997e77affe0998a92735f88fe458',
    'K29g-db13-highest-4-8-40-0-0':
        '6386d12a6f8eeb0fcde12f303e1552c4add9ac0cc1afc75a5587a0596b749a78',
    'K29g-db13-bf16-4-8-40-0-0':
        'fc62697e9bbdc59b24852a76603b8706064ef6e8627d84af87a4f989f3dec652',
    'K29g-db17-highest-4-8-40-0-0':
        '0f4f086e43c341b82a3c27644842fbde1d6ec5d9b14fb759940fe2a46515e3ef',
    'K29g-db17-bf16-4-8-40-0-0':
        'ec3f4933f305bcbb5e3a96367e21bba87087abd229ae7a0a89adf44a534a282e',
    'K29g-sym20-highest-4-8-40-0-0':
        '6ece617b700c854350c710619120adfda0d69f901df292d0b55c8d5541017ced',
    'K29g-sym20-bf16-4-8-40-0-0':
        '398663abc1a7460983c01a3e92256e8c6aa6b5cd884a1d9ccac6b095b2731a44',
    'K29g-db2-highest-2-64-64-1-0':
        '4c5b3adfb3efa82c67ba483aeec188572eb609d452a025b4fc4fa043886710b9',
    'K29g-db2-bf16-2-64-64-1-0':
        '2831012a9d8291f65e9bea578d25c7aef6123d177ce2851d2fcb983fca594c25',
    'K29g-db5-highest-2-64-64-1-0':
        'ee7e2e02c96ead9e55f1b8854cc2b24a92d1044ddea82102255a27248be2c7ff',
    'K29g-db5-bf16-2-64-64-1-0':
        'c384d7b268f3bd27c2e6927a1a174bc36e92fd53d661459966ffc157ccc31e13',
    'K29g-db9-highest-2-64-64-1-0':
        '403db7dda5111949345a6e7feafeb771d0c92a64831fc1537db361a370b4122e',
    'K29g-db9-bf16-2-64-64-1-0':
        'f6b9e3c35f9358a8cdeb7eccc8ac570937d0b2524f96a03a7d7d184d1dfd708a',
    'K29g-db13-highest-2-64-64-1-0':
        '77878220a40e8507eec8fc736822e577f13df655b4ba6df36a6d5d66ec873f5a',
    'K29g-db13-bf16-2-64-64-1-0':
        'af8408a5e058fba463d56593f9e7a90cc83a5d3b09dd7a684ae7ea12fe008009',
    'K29g-db17-highest-2-64-64-1-0':
        '17fc192724ff79250e443850c78e12eebe54f4805876d9c3dc19f7172335e491',
    'K29g-db17-bf16-2-64-64-1-0':
        '6e30ceea3494eebaf79b4e37bb6ab029f4368cddac4b15e46f53a2f29a4a5204',
    'K29g-sym20-highest-2-64-64-1-0':
        '0fb3b6e90a9e7453dbd200fb57ef89867cf8ff1b0ee4f33bfb9d6593ee7ad708',
    'K29g-sym20-bf16-2-64-64-1-0':
        'cd797d9f342d7ae47f70489bc318d03ef00e326e71afc10712c0f61fd2b9829d',
    'K29g-db2-highest-2-64-68-0-1':
        '0cc548ce380c6575c945c24729cebc833f569ba187d1d327fcfb38d6cb72b6d2',
    'K29g-db2-bf16-2-64-68-0-1':
        '3a3d95b43b26a14965a430e8a98dfbcaf41322905d3a7976d67e70c6fa30eb4d',
    'K29g-db5-highest-2-64-68-0-1':
        'a673a3ee0b5b0bf7ae8469d0e7b01e8d4607682fc1471d23b8e927f58a2b7fb6',
    'K29g-db5-bf16-2-64-68-0-1':
        '8670f4f74a08f3175d7b48f04da4b4080b3912345f85edcc6eb80c3947cc4e2a',
    'K29g-db9-highest-2-64-68-0-1':
        'acb0cf70851c2836a10507e241e6971a507c0b10fc3e2f221b75657980409306',
    'K29g-db9-bf16-2-64-68-0-1':
        '862707560940f6986e95754f5955c6f51a0b21e34c33b8f55675242fa6ba7f18',
    'K29g-db13-highest-2-64-68-0-1':
        '230b2f4b8bd122891548bfe404245ad0abeaec957019b887b669a761cbf0ecb1',
    'K29g-db13-bf16-2-64-68-0-1':
        '70660e37db90bedad1b592e3a3d9ccc2b7d1dd5ff9b50ac0f4362310ee283a6e',
    'K29g-db17-highest-2-64-68-0-1':
        '6d1c48192230999d7221e597b81fe8387757be34483d203d9df4429e3dad572f',
    'K29g-db17-bf16-2-64-68-0-1':
        '2a975f40f2dcc6407018d493c9e39b7fcdf85065f7d01d0c010ce2457e08f621',
    'K29g-sym20-highest-2-64-68-0-1':
        '1568b5cff9261940554bdedc0db5bfbb21a5f3d36efe685414b975fbcdba9ed8',
    'K29g-sym20-bf16-2-64-68-0-1':
        '2952a469d84bdd3a6a30034ed02ddb358486b42fe23c90e385590a3a22a26985',
    'K29g-db2-highest-2-70-129-1-1':
        'a5125b7b502531644ef79a9444524678afda2b6438224a3b867227c8377d5746',
    'K29g-db2-bf16-2-70-129-1-1':
        '946296b028c759ef2f3ffe840833df4a8067a58f8308d79f6843bd788599fb2d',
    'K29g-db5-highest-2-70-129-1-1':
        '02b87804c2509a24145d7c4050cf5dfc003ed88c829f421da6c888e762f949d7',
    'K29g-db5-bf16-2-70-129-1-1':
        '3bb84c44b8c8c8cd89c0709d6164e9480281877254c9951f25d22dc6c119fb67',
    'K29g-db9-highest-2-70-129-1-1':
        '3a3a00b8c1616f56dd8340d51ac23e5a058311b5b3a10d09321b5dc8084dcc37',
    'K29g-db9-bf16-2-70-129-1-1':
        '03aa661619bd05d5fc714f9276f5c5ded482f62e34a90c0c2a479b4263c32245',
    'K29g-db13-highest-2-70-129-1-1':
        '1958671ff336175b101d4c8a02bc901d24ed22c2aa495c4965b9084ebee97f37',
    'K29g-db13-bf16-2-70-129-1-1':
        '20efff036e7dde62fe82d5094f5ee99b23ebd8e366987511c5acda8dfb23c798',
    'K29g-db17-highest-2-70-129-1-1':
        '71e7c4f98f8deb7589b2f551cb095676c6479a8d503f82cfd7f201faa392b455',
    'K29g-db17-bf16-2-70-129-1-1':
        'f5a8c45900d8dfc3fa21ae495729c96523ab9036f1ac5b8b7242ed7c1c704e94',
    'K29g-sym20-highest-2-70-129-1-1':
        '02c086f52c12dff34627d6881fbe32a36181647bc56e2684b7cb690b31a0a917',
    'K29g-sym20-bf16-2-70-129-1-1':
        '478ce4233a2a0a707a79fe05521025cd4d83a6f35f1010aff6ed438378c07b9b',
    'K29h-db2-highest-4-64-96-0-0':
        '94f2177afac7d495e4256bf6ffc2b8c5cca4f7ae61c8d19448bc5f9ef6c43745',
    'K29h-db2-bf16-4-64-96-0-0':
        '795a8093e75fb840a253da9553f8e435a7ea26bd8c4b4d60cec9062d704e7da1',
    'K29h-db5-highest-4-64-96-0-0':
        '2134f70a1f6113ad38271658c0f2d51ae9f3da367fab358713f5de9343363f4f',
    'K29h-db5-bf16-4-64-96-0-0':
        '13aed5cd8dfa339bc0f76f9c9fa023e5eb889a23f779363dfbb6efa23243b15f',
    'K29h-db9-highest-4-64-96-0-0':
        'ce7f1d0d1ae6c23cddf5254e0c27bc4e199ad876e46c3560fd98d07090271499',
    'K29h-db9-bf16-4-64-96-0-0':
        '2493e5293cdfc1a5df2c70cb68c5bcbf50f8ff6b981f66c6d9e0e65e1ec81e54',
    'K29h-db13-highest-4-64-96-0-0':
        'fc2c192cf1ac60bdbad65f7377244ab243b0c6b0bd4b01ccc681b1e5bfb37715',
    'K29h-db13-bf16-4-64-96-0-0':
        '27894b5c7365c0bc9a8bc75f7c546661adbacc55a7597f96642dd2e26ede6116',
    'K29h-db17-highest-4-64-96-0-0':
        '9a58d8e96270e0f1aa6becb4e2773c0023cd8137546b7e084a08c6241244fe18',
    'K29h-db17-bf16-4-64-96-0-0':
        '53712500cc85124de11791902b43d5427e6308879ab040353edde1091a77514c',
    'K29h-sym20-highest-4-64-96-0-0':
        'c7df1d4f21ecd424dc57887e3f983df205f71aa8e46728683505fd0f32b0b11d',
    'K29h-sym20-bf16-4-64-96-0-0':
        '7bf9a827102fb4ce00d0024d8c272631e35929ae3a89732ed9e90dba00b99ced',
    'K29h-db2-highest-3-130-130-0-0':
        'b6b222a98b388e1085aae8b826e85afabc14f3dbbdcc3fce49f56c603b426f37',
    'K29h-db2-bf16-3-130-130-0-0':
        'c5b6d5c61d045445915f6132981eb02b1cc4932929420a62f2f7fb364bf4d685',
    'K29h-db5-highest-3-130-130-0-0':
        '277786e42c71ff6c5b5b637fc0a9e980be758115933a0634a6be5249602ccbbc',
    'K29h-db5-bf16-3-130-130-0-0':
        'e33e3a1afecab407299ceb6121b19a824bf5fd487eb4589c01ccbf0ec87368d4',
    'K29h-db9-highest-3-130-130-0-0':
        '5d194861bb24107b2045e3d5cb574d30cae1c669783f04b7bf8b5fdf6953e607',
    'K29h-db9-bf16-3-130-130-0-0':
        'a17b5ffee42cf74bc896a29af397382e952a04fc2412febc3409ef2b9a0892ec',
    'K29h-db13-highest-3-130-130-0-0':
        '62a5eb8ded86f481f6dd733f6cb3ad821ad61115be2e966d6edd68d76ce71246',
    'K29h-db13-bf16-3-130-130-0-0':
        '7164b59cfc941b3c387e23974fe2569bcae28b9b7dbfd7a545f79a85335774c0',
    'K29h-db17-highest-3-130-130-0-0':
        'd8d6865fdb1f807644474f025326da14b9505a7f8ef10111c9282558e01e6ecb',
    'K29h-db17-bf16-3-130-130-0-0':
        '833f252f17ba5a6b5496cf39cbec075412286f183a713f89514bec8a20979908',
    'K29h-sym20-highest-3-130-130-0-0':
        '89988dd4f43faf711c561ed6cfebd212b1fd10fb4686bfc1739a230c12ba98e6',
    'K29h-sym20-bf16-3-130-130-0-0':
        'cca2c35d9a955ee3a14f0aa27ddb1b156b75df24ea76a07f1afbe6900974eb84',
    'K29h-db2-highest-4-8-33-0-0':
        '38fdd03bea4ab789cf5ae8d69502014db5b3ad0c42da14b8fcde6a106021d088',
    'K29h-db2-bf16-4-8-33-0-0':
        'b53df7cf5370bdde4e1d98df69ebb8f4793d66679d392ecaa636dfb0ea8b3a06',
    'K29h-db5-highest-4-8-33-0-0':
        '80ab3452e0ef3b979ef6efd93f71f6b3251d34228c21023e5843e9b56da7fa3e',
    'K29h-db5-bf16-4-8-33-0-0':
        '6e36684ba12f95a8877cd11bf4c4dc26090418a18b633fd3ab74200dcb9e8504',
    'K29h-db9-highest-4-8-33-0-0':
        '06cc50858d473695ae70583c139256b2347164d48f152cf3813ab844e1ac8660',
    'K29h-db9-bf16-4-8-33-0-0':
        'bd91be0115092a540dc735fa950de469d8de9709cae016a2a0c6e4a2d7296089',
    'K29h-db13-highest-4-8-33-0-0':
        '74ec4297988d26933a7cde6050530e676aa115b5ae088c87e1f88b3ce1b6571a',
    'K29h-db13-bf16-4-8-33-0-0':
        '61a75122e1d0534b65ee55277161b630e29949a6839f65e951940de8907767aa',
    'K29h-db17-highest-4-8-33-0-0':
        '4fb17a4f0dccd70f61b4925579ff3843ee4c97e7b2cf4c3196f1153755cbf573',
    'K29h-db17-bf16-4-8-33-0-0':
        '5fb44829e2997b61fe2d5e8341570424730eb911beebb2bf7d768cff1e40dd9b',
    'K29h-sym20-highest-4-8-33-0-0':
        'd9afac613757dbbeedf8b5fd56980222ca8cd10df21fa40b8d5d7811ef81b026',
    'K29h-sym20-bf16-4-8-33-0-0':
        '6010fb3baf56b69658641bb0ada9e1ed7f86402fbbea4f4a0779cb974a17275a',
    'K29h-db2-highest-2-66-35-0-0':
        '5747e70813adac7e75f9649618d350429f2734dd860256a2d01b69480e25a0b3',
    'K29h-db2-bf16-2-66-35-0-0':
        '32f5143c72b5a19983a66c29dd8d95e4923b30042f0a0cee97d1040b3d80f59f',
    'K29h-db5-highest-2-66-35-0-0':
        '6c66f6ab65486ecc4e9c8859ec8962a0832d8c7436575b3e78774b3e4ad5e9ee',
    'K29h-db5-bf16-2-66-35-0-0':
        '4233d0a53ec9ef18c0d953367b1cf257e5d907c96546fa3a556b57a6605661eb',
    'K29h-db9-highest-2-66-35-0-0':
        '62c12d58b543e24c30d86c4f3e7af2422059ca8818faedcd0856d8babab2e7f2',
    'K29h-db9-bf16-2-66-35-0-0':
        'dd9b07df4d98dcd23e1ce7a652245b382926df158d8748fa2903f6265927b0c8',
    'K29h-db13-highest-2-66-35-0-0':
        'ed8641f842b1157e5f4e1083eb1e9254928ae77ab0cebdd05f2e6c9943840056',
    'K29h-db13-bf16-2-66-35-0-0':
        '89f1d4559413b92b4b7dd4041f2dc2be93a72ca538bbf0980efe4a580de9962f',
    'K29h-db17-highest-2-66-35-0-0':
        '648e970d29051996c5e459ea5b91c27076555add49ab6d419598123139f377f3',
    'K29h-db17-bf16-2-66-35-0-0':
        '86e28e97f949dbd1b726fdee727c27e69f2490d4d5b97a16c06e8973ac77c71c',
    'K29h-sym20-highest-2-66-35-0-0':
        'f7c2f9429467c277eb172a9fc40bee3a05bf961ba26bd5a901b0ae337bf35990',
    'K29h-sym20-bf16-2-66-35-0-0':
        '970b8e896b8ae476245315b93406d35a9a243719d185831a985dc354f426ee3c',
    'K29h-db2-highest-4-8-40-0-0':
        '86071447fbc92f6d4bb393f1e18f26496c132fa34b552c0a39fa5bc739d97741',
    'K29h-db2-bf16-4-8-40-0-0':
        'd180d721ed368862038ef775e3c307b3b09c93b89a0314ed8ff82679fa630054',
    'K29h-db5-highest-4-8-40-0-0':
        '8d72551ea425b933b0ce3318390cf289e0a7571ba107950ba7ce110fb2268a11',
    'K29h-db5-bf16-4-8-40-0-0':
        'd8b4ade641c36ab9fc4e25e38d3a9fc23683249d7d2226b8751886865d8cb7f6',
    'K29h-db9-highest-4-8-40-0-0':
        'ccce8ebca9eb43202a880be6b3e2fbaec2bfa8c7ed4be63e51c4dce4f733f742',
    'K29h-db9-bf16-4-8-40-0-0':
        '64d0871f8d1106f6ed4400ee4b05504306b00432a11e12c46835e8345e420c92',
    'K29h-db13-highest-4-8-40-0-0':
        '7e869497aef46224eaf859e8ec39c4ced1aed93cbcf4da3bd95404a61e264918',
    'K29h-db13-bf16-4-8-40-0-0':
        '79248ef59b0e10f3eb505c50e399d3c7f682f3b6a1e9e2f15c9bcb91db0cd6d2',
    'K29h-db17-highest-4-8-40-0-0':
        '516fc40fca16f175d858acef07ffb61d625eb5db2385153a1c65a29e02fa73e5',
    'K29h-db17-bf16-4-8-40-0-0':
        'c3064c59a3ac0c3ddd855af9f47e94c269daa3a8946481b2fd7a8ce3bf702126',
    'K29h-sym20-highest-4-8-40-0-0':
        'ad3320b5aae84e07cf63b3c14c5d9b19cb6ee315e5be16429921267cd91d02af',
    'K29h-sym20-bf16-4-8-40-0-0':
        'a5584a325145ec9ce17ba279f9e4b13fce8761506212b1ccee20fd348ebab023',
    'K29h-db2-highest-2-64-64-1-0':
        '967bae5b2df02e7de72156b4f6d2e6e4427307f0ee99bb1643bb0a4e972196a9',
    'K29h-db2-bf16-2-64-64-1-0':
        'abdee2265ec9676f891c02e05d89a19b9564d915688672ef07e677904c45291c',
    'K29h-db5-highest-2-64-64-1-0':
        '621aa5f6f45d67d2478168ce5a9dbfb070f43f6d2e270e1575f60230ad309d77',
    'K29h-db5-bf16-2-64-64-1-0':
        '1c1bdbe36d801e3c70f05587a7849742deb82cd33c729bc5872758c6f61c0b26',
    'K29h-db9-highest-2-64-64-1-0':
        'b57afe6ee4ab62cbb769f4aba3a47be2896879409c11b23e30caf974fdf48bca',
    'K29h-db9-bf16-2-64-64-1-0':
        'bc98f765e6b1f89f2a23b8d1c4fbe7d9463ed96023a2641e90093343e9af9c5a',
    'K29h-db13-highest-2-64-64-1-0':
        '9808a89bab010b8b615e1b15eee4421c1456c93e03f7ba981168439fe316295f',
    'K29h-db13-bf16-2-64-64-1-0':
        '9ac5ef9fae41a12ca7cb181d7f8a9b8a9f9f2bf68aecab0147b3154ad43c3d3a',
    'K29h-db17-highest-2-64-64-1-0':
        '40140d8a1bb7131933d41394c86de04632eeff53c3a2c3744c9d28933da4a8cc',
    'K29h-db17-bf16-2-64-64-1-0':
        'e16a60d885b21824941bb30120b7599a7a4c2c01325f0a0859492d930f8f4b54',
    'K29h-sym20-highest-2-64-64-1-0':
        '0fbef6549ff28ecdfe8ae68a8cf6c7483a079280998eed707a5f39803ad43ed4',
    'K29h-sym20-bf16-2-64-64-1-0':
        '9fbce1bcf1317d651b259714dbe922c983328743519e41b4deaae8d6c09193b0',
    'K29h-db2-highest-2-64-68-0-1':
        '30521a4abec61e3c81dc4641695dae80dbec752a689cabb9630d47dbe5b36778',
    'K29h-db2-bf16-2-64-68-0-1':
        '5625019c3cf1e2c437375aee6bdfa647af8d643008c84d98f31eaffd20695465',
    'K29h-db5-highest-2-64-68-0-1':
        '9742bc9b9b0d7d5c01c74347e4e1cc727253fd00e95b804dacfdd4741205ff0c',
    'K29h-db5-bf16-2-64-68-0-1':
        '2d9a5d5389bee7c3952fc3161e69c79b99b97436c8968957cd62f123e923594e',
    'K29h-db9-highest-2-64-68-0-1':
        'c6fc567d753e5615051a8e6332ed04ad99fa18fedc609c42aa5bebef255021e4',
    'K29h-db9-bf16-2-64-68-0-1':
        '602e7b7c55df1d96e38febf504bc49b8e9486db009e509b6fd9be275c374e7ab',
    'K29h-db13-highest-2-64-68-0-1':
        '5606993e85c067004250cc9cc0f857da9f388f74048a602bc411b59652181e2e',
    'K29h-db13-bf16-2-64-68-0-1':
        '95aeb0d22c9a229e3d71a3aa234eeec28bce6c7807ef6e8c1fcdb3c24e61c8b4',
    'K29h-db17-highest-2-64-68-0-1':
        'ba42efc34cbca53c25f93644251a555f8c9f059cbcee7a99dce67c834fcd09b4',
    'K29h-db17-bf16-2-64-68-0-1':
        '6ab4cb1d5a0e0d548035fe6e2fc85d7f4886c613da55a9afa5cb6ecae890c289',
    'K29h-sym20-highest-2-64-68-0-1':
        'a62e2d71214d52a3b22d1817748628c5c5c9fb83907f7d6e3e1f4deb841fc9e0',
    'K29h-sym20-bf16-2-64-68-0-1':
        'd2a7da35be9ef85e38aeec3df76707ee63dd91b5d6b8677ad46ad8e648b58a18',
    'K29h-db2-highest-2-70-129-1-1':
        '24cce0d603a58613c32bdebad08eb5ad0ac5e8c57ea628f5c183cf742d8a4b21',
    'K29h-db2-bf16-2-70-129-1-1':
        '9957e7e03456a02296e517140fa3da9f3e1818b478bd29598d39a7836e6856d6',
    'K29h-db5-highest-2-70-129-1-1':
        '6e370e88c3c43f18a64e384b74517387150701a219e05c0bc626a43e2da32fdc',
    'K29h-db5-bf16-2-70-129-1-1':
        '8c9f62ea48bb8d8fedada0227f3420b6ad60d35fa7d29cb6be8f45fa8e8c017a',
    'K29h-db9-highest-2-70-129-1-1':
        '6ea6cac3159d8c41fd341a15464406aa9fd56d715510e255d40c95e7d9400129',
    'K29h-db9-bf16-2-70-129-1-1':
        '09cd50c348b325137e15387bf27ff4a66c03563d7659882a4fdcee1cf725c63a',
    'K29h-db13-highest-2-70-129-1-1':
        'd4cddff962fadbda77cb07b298cc07abd384b7a4aae04c80754b401407a1406c',
    'K29h-db13-bf16-2-70-129-1-1':
        'c28a59af3131bed2cfa66abf68cb30cd1bfb19e15381221353981622d9c5b837',
    'K29h-db17-highest-2-70-129-1-1':
        'f6b59a99c1b1958a779df702fa3c74abafcc97d87bd2e91975d8504926233420',
    'K29h-db17-bf16-2-70-129-1-1':
        '7b9f5baba68a35e761a76791f87d518d8769dc4179eb6dc81dd9f99b627696ee',
    'K29h-sym20-highest-2-70-129-1-1':
        'f40fe650f7d3b79dc9faabfe586721a134f18bbba4325e20d5db98c18919d012',
    'K29h-sym20-bf16-2-70-129-1-1':
        '3e3e743eca876c96888877bfd64779ad08f0da9c2741d4bc4a83ea04b7e1b9ca',
}


# K29d, axis_rows.cu's row synthesis: each output against its plain version
# and against the SHA-256 of the output that its first body (32 x 32 tiles,
# one output a thread, windows staged sample by sample) gave on the card for
# the same seeded inputs; `python tests/test_torch_kernels_cuda.py digests
# K29D` prints K29D_DIGESTS's form. Banks of h2 1, 2, 8 and 20 and an odd
# one; ROWS_CASES (whole and crossed tiles, nc % 4 of 1, 2 and 3, 8-row
# shards, inputs or outputs one sample past a 16-byte boundary) and the
# timed shape, level 0 of one 4096^2 grid block (2048 coefficient rows of
# 2048); float32 and float64.
K29D_BANKS = ["haar", "db2", "odd5", "sym8", "sym20"]
K29D_CASES = ROWS_CASES + [(2, 4096, 2048, 0, 0)]


def _k29d_id(case, wname, dtype):
    return "-".join(["K29d", wname, "f64" if dtype == torch.float64 else "f32",
                     *(str(v) for v in case)])


def _k29d_output(case, wname, dtype, dev):
    """(kernel output, plain output) of one case: the C entry launched once
    on shard 1 of the coefficient planes, its halo rows and a NaN-filled
    output made here."""
    fb = _bank(wname)
    shards, rows, nc, oi, oo = case
    L = rows // 2
    pads = fd.one_axis_pads("syn", fb, L)
    body, halos = _coeff_halos(
        [_rand((shards * L, nc), dev, s).to(dtype) for s in (8, 9)], shards,
        1, pads)
    body = [_offset(v, oi) for v in body]
    halos = tuple(_offset(v, oi) for v in halos)
    out = torch.full((2 * L * nc + oo,), float("nan"), dtype=dtype,
                     device=dev)[oo:].view(2 * L, nc)
    ptrs = fd.halo_array(halos)
    taps = [fd._taps(f, out) for f in (fb.rec_lo, fb.rec_hi)]
    err = fd._entry(_build.load_library(), "pypwt_syn_rows", out)(
        body[0].data_ptr(), body[1].data_ptr(), ctypes.addressof(ptrs),
        out.data_ptr(), L, nc, *pads, *(v.ctypes.data for v in taps),
        fb.hlen, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    assert err == 0
    return out, fd.syn_rows_plain(*body, halos, fb)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("wname", K29D_BANKS)
@pytest.mark.parametrize("case", K29D_CASES, ids=str)
def test_k29d_row_body_matches_plain_and_parent(dev, case, wname, dtype):
    got, ref = _k29d_output(case, wname, dtype, dev)
    tol = TOL if dtype == torch.float32 else 1e-12
    assert got.shape == ref.shape and float((got - ref).abs().max()) <= tol
    assert _sha256(got) == K29D_DIGESTS[_k29d_id(case, wname, dtype)]


K29D_DIGESTS = {
    'K29d-haar-f32-4-64-96-0-0':
        '7ffa19cafc8f3e4757324e24621a086fdf5886d6ec56cd26b309fef0fec8d2de',
    'K29d-haar-f64-4-64-96-0-0':
        '04458d96e4c288ab910650845fb8c07d2a7d7fa9e4283169f7ebc4b3611205de',
    'K29d-db2-f32-4-64-96-0-0':
        'b6d41990bbc6955af5ba00b6eb945976c5aaf7ec3e1c3568a65d055056b9a6fc',
    'K29d-db2-f64-4-64-96-0-0':
        'acf47bf3dae2127d4817ddc20aedbb3efe1f72d9cf7fc27648ed986e9d1445c1',
    'K29d-odd5-f32-4-64-96-0-0':
        'bf314bfc860846873734cf962f4cee1e5c718ab2cd49305fa18aa9b496e3689d',
    'K29d-odd5-f64-4-64-96-0-0':
        '27fb6999fe71b101b741b8a6f253e8e89a5d96f8788364361beba2f320af1855',
    'K29d-sym8-f32-4-64-96-0-0':
        '45a0f7f4002bbce6338155214fd1b3711ed45ae5cc4ba12e75df87faf2ff4dce',
    'K29d-sym8-f64-4-64-96-0-0':
        '9c91a21aaecb9b41a42042316b44998a30b9817fd71ce42aaf4dfef2fdc27709',
    'K29d-sym20-f32-4-64-96-0-0':
        '92524cfe7a54f87dc5ba3772078c6d3bb6d4528d2d46d2ee7ca6919c025de06c',
    'K29d-sym20-f64-4-64-96-0-0':
        '5e7f062ee80114660156dd8d518cd31a1e24a8b324cf5c88699b956dfc47a176',
    'K29d-haar-f32-3-130-130-0-0':
        '8c989b4cd91b4b50e71598b199c2ffd8ddf0a34b0aa53ad1d76452145d2f8af9',
    'K29d-haar-f64-3-130-130-0-0':
        '13009d3bb297c3799e0134286f7eee612d231cd983cb8fe4e8e6d24d834795ec',
    'K29d-db2-f32-3-130-130-0-0':
        '790d425644ea6075db5c4102294ecd0e3044803a7180826c2901c63a75f1c6d9',
    'K29d-db2-f64-3-130-130-0-0':
        'c2ebfd21d4df4d877f89a07e63d17df6e157f95105305adf2ae1571dbbd833cb',
    'K29d-odd5-f32-3-130-130-0-0':
        '92bd5cf3c5789ea858cac29d7e896c2ac14cf32e5940194f9978e576aee43341',
    'K29d-odd5-f64-3-130-130-0-0':
        '24cb359d125b7c149158b384ef7baec688c3d64800a7d453159133f2701b285d',
    'K29d-sym8-f32-3-130-130-0-0':
        '42cd4fa70fe98bf6fdb439d373404678bbcf1e792d904ffc199c024aefc2d1ef',
    'K29d-sym8-f64-3-130-130-0-0':
        '1c1c8ec1d48108063efe1c1abaf5c7918b000d5146bf00f522fa95e13ce49aff',
    'K29d-sym20-f32-3-130-130-0-0':
        '91783c444b281b34cb93e31e3107b17ee7d152a58624fc00ef4fff814a432cb9',
    'K29d-sym20-f64-3-130-130-0-0':
        '588d3c495b8dcd412007f2643457cfb6d19994fd0fe709e4c1676365bf877d6d',
    'K29d-haar-f32-4-8-33-0-0':
        '660362ac66994010cc9db83ea638e560e7bd0d8ee737fa542baaf88c3ca28a1f',
    'K29d-haar-f64-4-8-33-0-0':
        '36472ceb4304e9b85011b4d615a7c99ed30020bd3c4b99d30058b822a6fae1b9',
    'K29d-db2-f32-4-8-33-0-0':
        '496bb02f49e2c66ebd38a3a93f58aa7da3ff8186f57c7cfbad503ac08805acfd',
    'K29d-db2-f64-4-8-33-0-0':
        'b97243b01b0718821fa57dd3dbcaabf0b56f0781dade663a3951da49f1a76b95',
    'K29d-odd5-f32-4-8-33-0-0':
        '8e8accedac218aedd18fceaef48e4fd56b695da7ba985a81d716039e36be7b71',
    'K29d-odd5-f64-4-8-33-0-0':
        '871fd819f3337ae43cc2237f68921ca7c3684d32bfbd6e3e6833a457c5b5d325',
    'K29d-sym8-f32-4-8-33-0-0':
        '99e4f859f4d75c24d669242170943f5cc55cb7defc907d9cc0a0e026d7983202',
    'K29d-sym8-f64-4-8-33-0-0':
        'b001dbaf17442161b8000f3fce82989bb86aeb412dc61d89ce161b4a927657a6',
    'K29d-sym20-f32-4-8-33-0-0':
        '82bf419be5174843e5878dacb254db0d37ccc8b82403396671eec6bc1062d4d9',
    'K29d-sym20-f64-4-8-33-0-0':
        '6211f0a141030c458e31c2f740fd7dfa5c8f8232c98b939d746d9f58bd8f44ad',
    'K29d-haar-f32-2-66-35-0-0':
        '495cfbf429a5ab3c5f73ec7bd64603bfea91f6f38f1f40730e896db6fb6c6aa1',
    'K29d-haar-f64-2-66-35-0-0':
        'ad65432182e135e30b7f72b3d7229e89bcf9f8601446b02169c095a8d6939e79',
    'K29d-db2-f32-2-66-35-0-0':
        '05823c51406b02615aa16884ad72607d121d03ab76d4f1097339926209afdbc7',
    'K29d-db2-f64-2-66-35-0-0':
        '9041190fe78a9af1163772f707a53fd5245dc9f7fd5a21005f557d5cc6e72862',
    'K29d-odd5-f32-2-66-35-0-0':
        '1e121bf92f09352448c4a70497cb49f1f14a00a0fca969c6f0924f9d0ea713d5',
    'K29d-odd5-f64-2-66-35-0-0':
        '050f48848e5d780141889ad199c60074840c047113fe07ce453e980eb41ae41a',
    'K29d-sym8-f32-2-66-35-0-0':
        '19dfa99ff40a11a215bdc8d7917c43dfe6abf8d4f3fefaacd69ea47a05dd64be',
    'K29d-sym8-f64-2-66-35-0-0':
        'b78f0a9aed9cfc3c97ec9ac29fff80075a3cb5c4e7362c1b4ee5fc6bf0e455f8',
    'K29d-sym20-f32-2-66-35-0-0':
        '3d45720c1feb03e3063ebcbba0040fa0600648d7071d05b90c323fb5a9ba310c',
    'K29d-sym20-f64-2-66-35-0-0':
        'f182d9a5934c71645bab132595484e727c34e17dece8152f92db2ff3e3c2aca7',
    'K29d-haar-f32-4-8-40-0-0':
        '7fcf969bf4bdb54b8f7a9a7af959a6a58cf382944707f1360c557096526d1c75',
    'K29d-haar-f64-4-8-40-0-0':
        '5ea8f3df23ab9944a094463045def165163cb06f8e6bbcb3d896b533e1ad52c4',
    'K29d-db2-f32-4-8-40-0-0':
        '01cc3b9d3d3754fc1b7bb8a8bfd08fa62248652840e5645e04f39ad6d856fa0b',
    'K29d-db2-f64-4-8-40-0-0':
        '12e1e37f6fea63b5f6b77bccec05826bfc0f77111cb3ad11ce9f405e797c69aa',
    'K29d-odd5-f32-4-8-40-0-0':
        '2ad802f9048a912042e6de0adf84e0c288b446ba59a2bc97beff4afcd6e2e40e',
    'K29d-odd5-f64-4-8-40-0-0':
        '63653c5e7386595f92615d0208fdc8e0a9e163f1732e7aedf4ce0c36daa6acd5',
    'K29d-sym8-f32-4-8-40-0-0':
        '16f247770f675e22c4bcec1398f25a1c0efc8e06de161e720eb004e0329990c3',
    'K29d-sym8-f64-4-8-40-0-0':
        'da95c0f4a0ebf98cbbf8824a7d9d25d43ae34664591aa83006e9a9a943d95225',
    'K29d-sym20-f32-4-8-40-0-0':
        '960179250c738ff579e2406f4ce8a2124d2b1c64373515bae6e3f4b803693ca6',
    'K29d-sym20-f64-4-8-40-0-0':
        'c1ddcc551957bf7860129c49e233abd736e52d38158f187bb95972d9032afbf9',
    'K29d-haar-f32-2-64-64-1-0':
        '37b077ebf9d7ef72f3d6dfd8e98970531ed97b37f92acaf17b641985d6108124',
    'K29d-haar-f64-2-64-64-1-0':
        'bf7adce605d26e26d4ec09f2dba3e643605034951187c1a3c76e884749ee5249',
    'K29d-db2-f32-2-64-64-1-0':
        'd7dcdc29d22c5b2bedf21e82847c737d6c56baf6f6d4de76f74d5a36338cce3c',
    'K29d-db2-f64-2-64-64-1-0':
        'b1c3a4cf608aa8074f55d25e21e2c56a4deda4c5858915ccd7004734996bda58',
    'K29d-odd5-f32-2-64-64-1-0':
        '66e8d2fdb1eb820d84a7bf9c2a85879bec8cf9c1ffeb75b17ff9ee633b6069fc',
    'K29d-odd5-f64-2-64-64-1-0':
        '64de8a56d9bd6bd4f231b27ca44d6135c8f14956e6d05ecda904c792e1000fdb',
    'K29d-sym8-f32-2-64-64-1-0':
        'f9e97cb906aa711ae6ae00ad8c269454e167a22d9adcda4db9ccffdae461a33c',
    'K29d-sym8-f64-2-64-64-1-0':
        '3a9eb31259624d736021ac74363b08290e7ab32779d7f349b9f1863cf0d9c377',
    'K29d-sym20-f32-2-64-64-1-0':
        '25175f74ece6203457a0741387d72b7e8120778138a5cf6c5412cfce06845b50',
    'K29d-sym20-f64-2-64-64-1-0':
        'a094d2921c4a328ad460ef7809b88cd569f6792a6e1b0cbbdfdfcc052841f495',
    'K29d-haar-f32-2-64-68-0-1':
        '73f0b935123225a07bcd6c4fd7f96bdd9773082702d151909d8c0f77c94e025c',
    'K29d-haar-f64-2-64-68-0-1':
        'dcf8871942825b1ba7a8d92702f067bcd4f2e0209c5aeddf5c937c3978331032',
    'K29d-db2-f32-2-64-68-0-1':
        '85bfac883fa7ca7301792f5684a5b84ca2b95f63247a80f04904c09d492aee29',
    'K29d-db2-f64-2-64-68-0-1':
        '4f1d39aab3f8218faccbf32508b361c7329072f90ba795c5dc59bda0f1daf83b',
    'K29d-odd5-f32-2-64-68-0-1':
        '5ec49f5eed04cc97c0fc5a57d843f954e6475f3be002c00a3fe20b1c5e13cb72',
    'K29d-odd5-f64-2-64-68-0-1':
        '3716a569d939cac6ef08992444f41916dd0b08b517f18d52475b803deee214dc',
    'K29d-sym8-f32-2-64-68-0-1':
        '37659eb76e216afeed7ff6f3dcbcaf5698cde2e115442f6ec8999f825cdec487',
    'K29d-sym8-f64-2-64-68-0-1':
        'ab9def5dedab3391914530eb67947ac68b4e9ebcb312353ec1c269114b7c45e8',
    'K29d-sym20-f32-2-64-68-0-1':
        'fd03add4a44c8c8ff58ff321a734a173bac44887c6421d08e311b26852a03c86',
    'K29d-sym20-f64-2-64-68-0-1':
        '77d5198ed54fc75068395866dc185d5bb1118bdbd14eb80c36622d971508f735',
    'K29d-haar-f32-2-70-129-1-1':
        '367f3916780b438ca9e0e0b24a5ac9d82a4d1f4677f6a569be9cecbec14b4de0',
    'K29d-haar-f64-2-70-129-1-1':
        'ffd4ef21292c1f544ef710c3ede71be268de9faa39b4945c045edd8c3981ebc6',
    'K29d-db2-f32-2-70-129-1-1':
        'e4ee73fd61f5eab95ba09d8348b0a223493d56d82ec3f234bc739c886e296dfd',
    'K29d-db2-f64-2-70-129-1-1':
        '15d5637e8cae5eb3ba8680c2933700f15dfa73bcc6c6e5888d47d42d4aa1b7e5',
    'K29d-odd5-f32-2-70-129-1-1':
        'b87ea9f459a71bc811bcaa42b4093cb8131d1ec798cf411fbfc6f5f639180e94',
    'K29d-odd5-f64-2-70-129-1-1':
        '0693bd714065899266c2e2d77a7b38dc048962cc951c563cf7c3facae701bf5a',
    'K29d-sym8-f32-2-70-129-1-1':
        'c7c385d3f41c8945b64903b886797bd2a323fb7b6e84bab43e45465ceb7b18b0',
    'K29d-sym8-f64-2-70-129-1-1':
        'd121dfeecfe585c622262ca2419cfb9140db820f02dc99c8aa4b6b1c7c0c7393',
    'K29d-sym20-f32-2-70-129-1-1':
        '98c0d47da5955d3184d8c9d1b3f247e38330b7896683d000d741c2ba62c2f72c',
    'K29d-sym20-f64-2-70-129-1-1':
        '089ade022dcde62dadc8394aec928b1a4051f4af9ee19df23bd97411e6ba3542',
    'K29d-haar-f32-2-4096-2048-0-0':
        'a9dd6611f0308783c47a4efecaaee4e5055918e4dd28405b7f25666ad5b5a8c1',
    'K29d-haar-f64-2-4096-2048-0-0':
        '607413ee84cc43efcb784ec5e18aaa890c18221bf711364ed8ef9caeb08636a8',
    'K29d-db2-f32-2-4096-2048-0-0':
        'c7785b6e17982a1380f19d439af50e97bb783ee2af9767b65035e48a6b539fa0',
    'K29d-db2-f64-2-4096-2048-0-0':
        '4850a2eccfc9b761e5ceebde6b2d01b2f8fdfe53942e05a76d987b6a85432a09',
    'K29d-odd5-f32-2-4096-2048-0-0':
        '466c5f9b6ad5e2114b189c779c97650ece8255f5bfd34a778da3e29610b02f14',
    'K29d-odd5-f64-2-4096-2048-0-0':
        '9260cb8ce97e011ae77a9239efe3990c74da4a516fc082adb325e80da2c005f3',
    'K29d-sym8-f32-2-4096-2048-0-0':
        '26a32754199ae25be21a0f3bc94d3bcbecd23e00ed164050cc9fe0101aba5b58',
    'K29d-sym8-f64-2-4096-2048-0-0':
        '74b853e80090ff8bf0cf91c62f94a7b3be2281d14bb92e161241d034e29c5d78',
    'K29d-sym20-f32-2-4096-2048-0-0':
        'a11bc94de447ea5fb2a3bad1f7d58913bd658bd36a7cf626f9676481476b1346',
    'K29d-sym20-f64-2-4096-2048-0-0':
        '387e248f2cd30f5148559edcd750344aa3e2e3ec3dea80ce5130e7d26e1f1b34',
}



# K20 on idwt2d.cu's pair body with its unshift: each output against its
# plain version and against the SHA-256 of the output that K20's body
# before it (level2d.cuh's syn::tile) gave on the card for the same seeded
# inputs; `python tests/test_torch_kernels_cuda.py digests` prints a tree's
# digests in K20_DIGESTS's form. Banks: PAIR_BANKS. Cases: (output shape,
# shift, accumulator and scale 0.25, offset): every parity of the shift
# and shifts wider than a tile (reduced mod the plane) on (64, 128), with
# and without the accumulator; rows of 65 coefficients (sample copies); a
# 2048^2 level; a batch; an odd unshifted axis (the pair body's crop); a
# shifted odd axis (the direct form); inputs and accumulator one sample
# past a 16-byte boundary
K20_SHIFTS = [(0, 0), (1, 0), (0, 1), (1, 1), (5, 3), (70, 131)]
K20_CASES = ([((64, 128), s, acc, 0) for s in K20_SHIFTS
              for acc in (False, True)]
             + [((66, 130), (1, 1), True, 0),
                ((2048, 2048), (1, 1), True, 0),
                ((3, 40, 72), (1, 1), True, 0),
                ((2047, 2048), (0, 1), True, 0),
                ((2047, 2047), (1, 1), True, 0),
                ((64, 128), (1, 1), True, 1),
                ((66, 132), (5, 3), True, 1)])


def _k20_id(case, wname):
    return "-".join(["K20", wname, *(str(v) for v in case)])


def _k20_output(case, wname, dev):
    """(kernel output, plain output) of one case, the kernel launched
    once."""
    shape, (sr, sc), acc, off = case
    fb = _bank(wname)
    c = [_offset(_rand(_half(shape), dev, s), off) for s in range(1, 5)]
    a = _offset(_rand(shape, dev, 5), off) if acc else None
    scale = 0.25 if acc else 1.0
    n = ks.idwt2d_unshift_fused.launches
    got = ks.idwt2d_unshift_fused(*c, fb, shape, sr, sc, a, scale)
    assert ks.idwt2d_unshift_fused.launches == n + 1
    return got, ks.idwt2d_unshift_plain(*c, fb, shape, sr, sc, a, scale)


@pytest.mark.parametrize("wname", PAIR_BANKS)
@pytest.mark.parametrize("case", K20_CASES, ids=str)
def test_k20_pair_body_matches_plain_and_parent(dev, case, wname):
    got, ref = _k20_output(case, wname, dev)
    assert got.shape == ref.shape and float((got - ref).abs().max()) <= TOL
    assert _sha256(got) == K20_DIGESTS[_k20_id(case, wname)]


K20_DIGESTS = {
    'K20-haar-(64, 128)-(0, 0)-False-0':
        'ff17202fd61c767efb3051d03c3e8d33176746d137ee067cfaa6c7584fd55054',
    'K20-db2-(64, 128)-(0, 0)-False-0':
        'b0562b6420a0386d9f2e26cafa3d07f81838be095755b6d6677f877300cd5e47',
    'K20-bior4.4-(64, 128)-(0, 0)-False-0':
        '076e0f0b3d021ec8a38e547235d36597f6d66d3385c698d8f09786bfd15d9f72',
    'K20-sym8-(64, 128)-(0, 0)-False-0':
        '00d73533b1a9b808ac081ca785e98dc481234b19101536b5c53aee355582c362',
    'K20-sym20-(64, 128)-(0, 0)-False-0':
        '025d968c99fde269765250492e71e95f7f1c2087bccd0bef0fe688f1bfb1cf22',
    'K20-odd5-(64, 128)-(0, 0)-False-0':
        'ff52801ce738ca255966caadc17fd502769959917a572fb408911a47ae668262',
    'K20-haar-(64, 128)-(0, 0)-True-0':
        '7c33227419d4375abfcdae8efc22c07e46b3f94259a5ff496d55c34ea2735a58',
    'K20-db2-(64, 128)-(0, 0)-True-0':
        '2a06168a7e1f1d297d98ec0bedb62446dbe794db2d23489a2f59a6ee925b2dcd',
    'K20-bior4.4-(64, 128)-(0, 0)-True-0':
        '0601922a7f165451d7e9d9e290ba05eb08ba1316d4e9db985956966f82940117',
    'K20-sym8-(64, 128)-(0, 0)-True-0':
        '6406590419bc727865e8b5afb88aae5be368ec5be94194a4a2963c1513ffc5f8',
    'K20-sym20-(64, 128)-(0, 0)-True-0':
        '5f327bc77f03965761ce78a7988fc5af2cfbc1ea63f43da3888000afc253ccf3',
    'K20-odd5-(64, 128)-(0, 0)-True-0':
        'e3d7a14dc8115a2c84906083ffc8a7158e3576c2022d1d89d869b2130b4ff856',
    'K20-haar-(64, 128)-(1, 0)-False-0':
        'eac4035550cf1ee2c28b8e019c630870139b341351b92e2f3085db52fc19454e',
    'K20-db2-(64, 128)-(1, 0)-False-0':
        'de54e17fb56df8fd81242794844ccbbf0205f3b4e80f0c85d164ecbef60672a4',
    'K20-bior4.4-(64, 128)-(1, 0)-False-0':
        '5fbd335d77c43a1ae6850688b2729e0b534222a8fe0d6cd18c9f0f39b81ff07a',
    'K20-sym8-(64, 128)-(1, 0)-False-0':
        'fe40d520d8f4a2166a2e595beda870c077101a14d5548550f1711c95839e5f96',
    'K20-sym20-(64, 128)-(1, 0)-False-0':
        'd608bf478deecf752071a34a2daaae31853032d5d6af781be1bc73372feae0dd',
    'K20-odd5-(64, 128)-(1, 0)-False-0':
        '8bf007dc5074fe77d044fa13d98009e63afe10944e8c30dd661dd04c871e5232',
    'K20-haar-(64, 128)-(1, 0)-True-0':
        '333f4ee13310918a4744aee6da96afe7ab1e0243695810602e32c8a0520f5d04',
    'K20-db2-(64, 128)-(1, 0)-True-0':
        '35c60b9e56467aa8d101f639440fd5c446fda7b0011e538171cdef57fd24235d',
    'K20-bior4.4-(64, 128)-(1, 0)-True-0':
        'ab51b6592f5e1deff3b98402a1bc4b560501bfb914f4d9b0819de14e88756f43',
    'K20-sym8-(64, 128)-(1, 0)-True-0':
        'fd8d5d488476a79546597a6d0d8132cca9b72b97fa8756cba27b5c007d9949cd',
    'K20-sym20-(64, 128)-(1, 0)-True-0':
        '841372069936f2a9fafa658bef24266b0d44e8a7647efb6b17e0dff53d220a29',
    'K20-odd5-(64, 128)-(1, 0)-True-0':
        'a3e498c0d34cae8f85b29b4f68cd7344a36785c2cd8a8c7c905fd99c7d5e0ccb',
    'K20-haar-(64, 128)-(0, 1)-False-0':
        '133f983d812620aec18932aa575ac3a9f2d6a76791b6d7aa1781ac9762688322',
    'K20-db2-(64, 128)-(0, 1)-False-0':
        '2878f9127ba8c245105895475958b0231089f54bf08d8baeb0ca4137e482e61d',
    'K20-bior4.4-(64, 128)-(0, 1)-False-0':
        '69dda06bc8846a28c3ebf33fdc4e4e649285ef4956f2db17959fe5c4154ce131',
    'K20-sym8-(64, 128)-(0, 1)-False-0':
        '168271c09114145b49886e9ddc698a51592eb1dd551d470aba16b2717cceb636',
    'K20-sym20-(64, 128)-(0, 1)-False-0':
        '2706d76d864df1c4906870299ce0d0e0454e59d63fd9fe5c0eae915e22318712',
    'K20-odd5-(64, 128)-(0, 1)-False-0':
        'f2e9e62d06812c8d80ed0fd41a0066d6d1c5c294c3e74388699c7cd04f3fe0e1',
    'K20-haar-(64, 128)-(0, 1)-True-0':
        '1359205dac934849fcd39bcc5b052542935c62631ebb082b243827ab5638beb6',
    'K20-db2-(64, 128)-(0, 1)-True-0':
        '10c7ad419e7b1bcc529e1ec1df44b259d02f971b8077bfad1001a90038dd82e6',
    'K20-bior4.4-(64, 128)-(0, 1)-True-0':
        '39c213f89b3e4d2475b30c192bc8c2a0fafba05279357b100106e0fcba204216',
    'K20-sym8-(64, 128)-(0, 1)-True-0':
        'ef7f38ccdeb1381ecda8b374e94816af5b03f4e152f0cd15e8d5d8eecdd23a4f',
    'K20-sym20-(64, 128)-(0, 1)-True-0':
        '72470015ecad3ff961f0d19150cd6ca0ba377ece267e7321d03e229bf1e01648',
    'K20-odd5-(64, 128)-(0, 1)-True-0':
        'e5dab064809897e9af7b0f2c762e16aa5675d83feb365a53d636abb51d3ed74d',
    'K20-haar-(64, 128)-(1, 1)-False-0':
        '32c982d2a5a8d29aee418d2716e0d09451d4e505bd51442874b351d6c0f8568b',
    'K20-db2-(64, 128)-(1, 1)-False-0':
        'f78d8cb2586871efff1609856cc9aae609f602eee795e3970e7aad185611943d',
    'K20-bior4.4-(64, 128)-(1, 1)-False-0':
        '99c192f70cba5c901a702f1ec71dec906d2943a124c59890eccad6c23973a66a',
    'K20-sym8-(64, 128)-(1, 1)-False-0':
        'fede9f86d3d0409e8a918e738575fd3f0d3b8922c7d42da71486fe43255d6009',
    'K20-sym20-(64, 128)-(1, 1)-False-0':
        'dbe30c0dbf3c2120bf504030ddd47f9e47d10928075548aa95392fcb1100b6e2',
    'K20-odd5-(64, 128)-(1, 1)-False-0':
        'e5049400cf1513e8abf383e5f4c8eed68d71dc54d6ec35ce3bbb8748a7ac5f0c',
    'K20-haar-(64, 128)-(1, 1)-True-0':
        '2b7c52ae35695f9783f58b35797b477a0ae2387e16fc77c20960c90c4525ce8c',
    'K20-db2-(64, 128)-(1, 1)-True-0':
        '3f86877c88aae74aa65b2432b253dd3a36d9f6f2c12c672a895cef40ff5e4f59',
    'K20-bior4.4-(64, 128)-(1, 1)-True-0':
        '2f4b1c860387ad98fe1207c35e3c5b6267d081e3186f76added88c494bf843c6',
    'K20-sym8-(64, 128)-(1, 1)-True-0':
        'ae2acdc00dd563328a3de7ab41992b55fe1910beb8eca8ba3c1e8156f237953e',
    'K20-sym20-(64, 128)-(1, 1)-True-0':
        '5a53b4e5e2b2267ea22bcf7c2527e2b8233cb3c8eb939d59372359fb65a48c7e',
    'K20-odd5-(64, 128)-(1, 1)-True-0':
        '4301dcc582da7fa0e7e09ffe73c63df4fa31f3366eea9ce72d254b9b91074bbe',
    'K20-haar-(64, 128)-(5, 3)-False-0':
        '2e66d48d6cfa16a3b6ac0031bd5b60efead2a150be8189a168f40ea669b9ce56',
    'K20-db2-(64, 128)-(5, 3)-False-0':
        '4505b60cb15751d2c81dcbf3118b0d1898b0dac18b6e2e506843693a9d0381ca',
    'K20-bior4.4-(64, 128)-(5, 3)-False-0':
        '7d9027c1717f163bcb08b2c68cac59fe64c162b786a2feae827afb12e41d8c70',
    'K20-sym8-(64, 128)-(5, 3)-False-0':
        '99124dd6ba52eae878f7a7ccf606f856b7e24c1dfe496f57a77395f72df2aacb',
    'K20-sym20-(64, 128)-(5, 3)-False-0':
        '4888853f90265c3645cc0ba009cbe5f727c4241fee5bf00c77112f0dddbd062e',
    'K20-odd5-(64, 128)-(5, 3)-False-0':
        '3d352ec2d6e5b1323494c7585714a4e6cf1ef13c047fc991a2553664c787bae3',
    'K20-haar-(64, 128)-(5, 3)-True-0':
        '8bfb0d4fe05986a9d8db22a218741702f3c8f3fe49f9c37632e5a33d50d152ec',
    'K20-db2-(64, 128)-(5, 3)-True-0':
        '9ed9a09166ebed1bbe7983d8d51d06a85665164ba704e60fc218bd1c566fa895',
    'K20-bior4.4-(64, 128)-(5, 3)-True-0':
        '1d4abcaa853d9df506959fa4a623b1f65680ab2ba0a173fea27fa6f21485b0ca',
    'K20-sym8-(64, 128)-(5, 3)-True-0':
        '9ad40161c7aeac9809b8a54f725347336dcbc9609d693ee2e3d8502dc24842a7',
    'K20-sym20-(64, 128)-(5, 3)-True-0':
        'a3d530a0e2678b7efad4a68079f5ab1dcd2c341611aec6466d4695bea3d003e4',
    'K20-odd5-(64, 128)-(5, 3)-True-0':
        '8cf3662ec7f68f6e4744cc884c02b8c218a1bdf748a43821c24dc36729e40370',
    'K20-haar-(64, 128)-(70, 131)-False-0':
        'f072eff75468a01a33efb3123ed220c1f0dcdab73e13e04253d660025f89a708',
    'K20-db2-(64, 128)-(70, 131)-False-0':
        '88b889e81c4edc01365046375dd44cf4fb2b345537134583e631be2732a92920',
    'K20-bior4.4-(64, 128)-(70, 131)-False-0':
        'eacf936231fb823a025a57466cb8d4d9fb23ed67ab0672195f1991da631b33f6',
    'K20-sym8-(64, 128)-(70, 131)-False-0':
        '320439708ae85033e6d9dc07f4bd122bb0df11ab721b20f4c8ed6104441cadf1',
    'K20-sym20-(64, 128)-(70, 131)-False-0':
        '8cff3351f53114bd34aea1db7b9546c62dfcd28c18eb2bf1247df956f55dc57c',
    'K20-odd5-(64, 128)-(70, 131)-False-0':
        '60f1899d8b81c266b9fe942cc4408e7fd34d640d21b778214f3e5c24430d0e23',
    'K20-haar-(64, 128)-(70, 131)-True-0':
        '0638ac55bd3a98ee526fd17a63e0e7c27e1d10aac25446cfe0bf942265eb6bfd',
    'K20-db2-(64, 128)-(70, 131)-True-0':
        '6d7a5f38ff4da969fe7bf205990e0938cf6cbacfebd04767e6579ea0a802bc5c',
    'K20-bior4.4-(64, 128)-(70, 131)-True-0':
        '65e716b3e249b9aad8381747e16bbe6d9b1c2c2f19c95837027b190d6c031429',
    'K20-sym8-(64, 128)-(70, 131)-True-0':
        '9f92fe263f04b00fa04d6bace260bd09ac1c6cd30bf63bc816e7a6d9ef056afe',
    'K20-sym20-(64, 128)-(70, 131)-True-0':
        '504535ff3a91ee6477b1255018b0ce1c25570bd948a2cb0cb6c9369308eab228',
    'K20-odd5-(64, 128)-(70, 131)-True-0':
        '4b7275155139bd2401d8b4576fe84630b9eaddef9ea1dc916d680476361da0cd',
    'K20-haar-(66, 130)-(1, 1)-True-0':
        '142eca5f3d23079f64aabad5d94d56d44796ea91997ed5531c968f095adcfe7e',
    'K20-db2-(66, 130)-(1, 1)-True-0':
        'ead32908869be1efb3456d3ce4e779e82715170f92d92553b6fdd25e354ea9d3',
    'K20-bior4.4-(66, 130)-(1, 1)-True-0':
        'f3b41d063a61eb58fc1871842fecfa17c74fb07d82f3166b5970a26ea64d7d72',
    'K20-sym8-(66, 130)-(1, 1)-True-0':
        '2c599787da435cb3606cda04ffdaeabc297dd395bee9d9f65832643139d19bf0',
    'K20-sym20-(66, 130)-(1, 1)-True-0':
        'c73da5354a4edd54c372af4652971459d17b8657b3c483d45d907b3fe0ee2d3e',
    'K20-odd5-(66, 130)-(1, 1)-True-0':
        '372b05b5985145113ec2d2bf4787da4cc263fd48b67e5f53f178cb6704d9e499',
    'K20-haar-(2048, 2048)-(1, 1)-True-0':
        'c73c969682b26949361f79fac1a8a6808fedc79b179bc2dcbdf02a3264d78c07',
    'K20-db2-(2048, 2048)-(1, 1)-True-0':
        '98e0fe587606617647040e66282447a34286753714ae9250c43cb645e0a8b166',
    'K20-bior4.4-(2048, 2048)-(1, 1)-True-0':
        '6fcc13047993a82c5164488c910599e9942a228d8abddc87c2baef3604beb607',
    'K20-sym8-(2048, 2048)-(1, 1)-True-0':
        '094d5fe1c14a8a0f538277509ba90175a1d34082b2db2f8ddf63734f933ec797',
    'K20-sym20-(2048, 2048)-(1, 1)-True-0':
        'db7ebd32fe0544e5ebd7a56d20f308a2bc747f0822b5d6f62fc0b4c6ac92f430',
    'K20-odd5-(2048, 2048)-(1, 1)-True-0':
        'e5fae2d58522326fd61cbf95d96f7c00a5af9a5066123639322a22a9ced3adb3',
    'K20-haar-(3, 40, 72)-(1, 1)-True-0':
        '83c2720b0ed43941439f70e95d1292573450f2ba070892d92b19c41e6a1ad23f',
    'K20-db2-(3, 40, 72)-(1, 1)-True-0':
        '994ef16d61b0866c6a49e611e6acff35773abb511aa6e21ce0de2d5007a84656',
    'K20-bior4.4-(3, 40, 72)-(1, 1)-True-0':
        '86adddd721233bd0c1477f1a2fac4fa4048f2227c1981f1c07ddae9440a00639',
    'K20-sym8-(3, 40, 72)-(1, 1)-True-0':
        'e6deaff4d03c837bf25dcf36a9ca9524c317e8f0f2f621d89ac2c4820c063ff2',
    'K20-sym20-(3, 40, 72)-(1, 1)-True-0':
        'f347b33d5437f5ae643136a8a0cbf6151b18ab436342c5feed9a5bc4163f9b1e',
    'K20-odd5-(3, 40, 72)-(1, 1)-True-0':
        '08ec9ea5f5d18b277c3c3b11162e2a65f3c921e07d8342008ab9c9995e86214f',
    'K20-haar-(2047, 2048)-(0, 1)-True-0':
        '46be21b1ca7b9d2ecc3a1d1f703c69da797630e0d414e01e8da7bd298e5058be',
    'K20-db2-(2047, 2048)-(0, 1)-True-0':
        'dc1d7e8d27536d6bdc853f9cc23147774341c049bc4f59dff10a4c5777ebc03f',
    'K20-bior4.4-(2047, 2048)-(0, 1)-True-0':
        '675d96758cef1689c77469704cf5168e2ef41e99f690e69f739f3e4edb165ddc',
    'K20-sym8-(2047, 2048)-(0, 1)-True-0':
        'b931d47449465dde605cca98e50fb0af9adcf9c406f54d6cb34aa779b2597a92',
    'K20-sym20-(2047, 2048)-(0, 1)-True-0':
        '89f1fec1c012268f943695102bdcea6cbdb621e56e69d3a05258486c824f39fe',
    'K20-odd5-(2047, 2048)-(0, 1)-True-0':
        '66dace99c737fa5eccbaf2cf6edfe10c6cc784154b38acdeeb9c8b907b4b17eb',
    'K20-haar-(2047, 2047)-(1, 1)-True-0':
        'd309cc96e669aa57f4bf8efdce38e7f57610462e12f34ee09d321362fd9c8b9f',
    'K20-db2-(2047, 2047)-(1, 1)-True-0':
        'c3c726d4339771feb54aabee78fea5b771b4b42f0dfc14b25eedd559fdbbb6cb',
    'K20-bior4.4-(2047, 2047)-(1, 1)-True-0':
        '47cac6d0ec5ec0da482ac00016eb0fadb4f592ebeb8e60bb2f5a89c005cc6d6d',
    'K20-sym8-(2047, 2047)-(1, 1)-True-0':
        'e7e460622b6df0022e0e29d5065eadc9c7236e0150bb4acc76890e1851ac08b2',
    'K20-sym20-(2047, 2047)-(1, 1)-True-0':
        '9c13e7219f26199eded18e11161a6dc0db6c9f32237fe1c44eacbfbe1eb44467',
    'K20-odd5-(2047, 2047)-(1, 1)-True-0':
        'e38f459ad3761601aa54835625c3bd3d0169295600ac661677962acb62ccc967',
    'K20-haar-(64, 128)-(1, 1)-True-1':
        '2b7c52ae35695f9783f58b35797b477a0ae2387e16fc77c20960c90c4525ce8c',
    'K20-db2-(64, 128)-(1, 1)-True-1':
        '3f86877c88aae74aa65b2432b253dd3a36d9f6f2c12c672a895cef40ff5e4f59',
    'K20-bior4.4-(64, 128)-(1, 1)-True-1':
        '2f4b1c860387ad98fe1207c35e3c5b6267d081e3186f76added88c494bf843c6',
    'K20-sym8-(64, 128)-(1, 1)-True-1':
        'ae2acdc00dd563328a3de7ab41992b55fe1910beb8eca8ba3c1e8156f237953e',
    'K20-sym20-(64, 128)-(1, 1)-True-1':
        '5a53b4e5e2b2267ea22bcf7c2527e2b8233cb3c8eb939d59372359fb65a48c7e',
    'K20-odd5-(64, 128)-(1, 1)-True-1':
        '4301dcc582da7fa0e7e09ffe73c63df4fa31f3366eea9ce72d254b9b91074bbe',
    'K20-haar-(66, 132)-(5, 3)-True-1':
        'd65de20ae7fa110b5dcb9e20b75f47962f24939f8321bad806b628716ac7383f',
    'K20-db2-(66, 132)-(5, 3)-True-1':
        '4bac6224888677227d9ac6bbb954f2b1620eda0f6ce0b5698c622cbefdd9662b',
    'K20-bior4.4-(66, 132)-(5, 3)-True-1':
        '9164278e20b34668b57cb4784b0f9d74a292970a7d4357188a8cf748e27881b0',
    'K20-sym8-(66, 132)-(5, 3)-True-1':
        '11ccfd4f4a3c04e9f9f22b13c1b4bfbbf49a42785854d69a4e1cbc90a7343597',
    'K20-sym20-(66, 132)-(5, 3)-True-1':
        'b56caf5a321b7f904d0a6192f47c247fd9151b0111c421c959be63f704877bc6',
    'K20-odd5-(66, 132)-(5, 3)-True-1':
        'a0b4afeaaf24309d56e22c5f18a47406f9e6aecfcc3b7ff583d3ab1e436b5f10',
}


# K19 on dwt2d.cu's pair analysis body with its roll and threshold: each
# output against its plain version and against the SHA-256 of the outputs
# (a, h, v, d in that order) that K19's body before it (level2d.cuh's
# ana::tile, now K24's alone) gave on the card for the same seeded inputs;
# `python tests/test_torch_kernels_cuda.py digests K19` prints a tree's
# digests in K19_DIGESTS's form. Banks: db2, sym8, sym20. Cases: (input
# shape, shift, threshold mode, offset): chip_smoke.py's K20 digest shifts
# (each parity, (5, 3), wider than a tile, a row shift past the TPU
# kernel's halo, wider than the plane; reduced mod the plane) in the three
# epilogues on (64, 128); rows of 130 samples (sample copies); the 2048^2
# frame at the random spin's level-0 shift, a static spin's (3, 3) and a
# phase-bit one; 2047^2 and 2046 x 2047 (odd axes, shifted and not); a
# batch of 3; planes one sample past a 16-byte boundary
K19_BANKS = ["db2", "sym8", "sym20"]
K19_SHIFTS = [(0, 0), (1, 0), (0, 1), (1, 1), (5, 3), (70, 131), (127, 1),
              (4101, 4099)]
K19_CASES = ([((64, 128), s, mode, 0) for s in K19_SHIFTS
              for mode in (None, "soft", "hard")]
             + [((66, 130), (1, 1), "soft", 0),
                ((66, 130), (5, 3), "hard", 0),
                ((2048, 2048), (1, 1), "soft", 0),
                ((2048, 2048), (3, 3), "soft", 0),
                ((2048, 2048), (1, 0), None, 0),
                ((2047, 2047), (1, 1), "soft", 0),
                ((2046, 2047), (0, 1), "hard", 0),
                ((2046, 2047), (5, 3), None, 0),
                ((3, 40, 72), (5, 3), "soft", 0),
                ((64, 128), (1, 1), "soft", 1),
                ((66, 132), (5, 3), "hard", 1)])
K19_BETA = 0.3
HARD_MARGIN = 1e-5  # a hard threshold may fall on either side this near


def _k19_id(case, wname):
    return "-".join(["K19", wname, *(str(v) for v in case)])


def _k19_output(case, wname, dev):
    """(kernel outputs, plain outputs, plain outputs before the threshold)
    of one case, the kernel launched once."""
    shape, (sr, sc), mode, off = case
    fb = _bank(wname)
    x = _offset(_rand(shape, dev, 5), off)
    n = ks.dwt2d_shifted_fused.launches
    got = ks.dwt2d_shifted_fused(x, fb, sr, sc, mode, K19_BETA)
    assert ks.dwt2d_shifted_fused.launches == n + 1
    sr, sc = sr % shape[-2], sc % shape[-1]
    return (got, ks.dwt2d_shifted_plain(x, fb, sr, sc, mode, K19_BETA),
            ks.dwt2d_shifted_plain(x, fb, sr, sc))


@pytest.mark.parametrize("wname", K19_BANKS)
@pytest.mark.parametrize("case", K19_CASES, ids=str)
def test_k19_ana_body_matches_plain_and_parent(dev, case, wname):
    got, ref, bare = _k19_output(case, wname, dev)
    for g, r, b in zip(got, ref, bare):
        keep = (b.abs() - K19_BETA).abs() > HARD_MARGIN
        assert g.shape == r.shape
        assert float(((g - r).abs() * keep).max()) <= TOL
    assert _sha256(torch.stack(got)) == K19_DIGESTS[_k19_id(case, wname)]


K19_DIGESTS = {
    'K19-db2-(64, 128)-(0, 0)-None-0':
        '197d5789dda03c35531d2f3cc397f1d09fabc099a1685f25c37bb19f462382b0',
    'K19-sym8-(64, 128)-(0, 0)-None-0':
        'b1c2dc7a95d9058ddeac4a6c1bb6520e80bd70738f65d7772c218ef95123802a',
    'K19-sym20-(64, 128)-(0, 0)-None-0':
        '6fdf9c879f88d8c075a6eb1f300c87de8d45c011bbecc42020df4135055c9502',
    'K19-db2-(64, 128)-(0, 0)-soft-0':
        '98351165885ab59cf12cded0a5205789e21957c716755381460274f1158567c3',
    'K19-sym8-(64, 128)-(0, 0)-soft-0':
        'ba9a88e72090f4269e7313d402aa59f34b35d647c96f62fd3361db730984cc18',
    'K19-sym20-(64, 128)-(0, 0)-soft-0':
        '27bcdfee2253d0f849f24e6f5d3bb151f93c060a8b2408e26d046d215688f5b9',
    'K19-db2-(64, 128)-(0, 0)-hard-0':
        '32fd185b7c9c58d8bf5a2f66c5a24f0e0502208788b3123ae889ee533035444b',
    'K19-sym8-(64, 128)-(0, 0)-hard-0':
        'f013099eb06d50780f25c58c15c1b20157cb4922e02634847d5a64039dda8366',
    'K19-sym20-(64, 128)-(0, 0)-hard-0':
        '1dfba2bd4928b15bca62e8626eccabb919139f98e71107af534980ff5c324c18',
    'K19-db2-(64, 128)-(1, 0)-None-0':
        '0f157fa29ef30dec64a5ad99c00a40d4a005f0aadb9d212ef98a8e814ef8969b',
    'K19-sym8-(64, 128)-(1, 0)-None-0':
        '65c9bc5c12ee8b1e47ba58acdbbeb25b4f0091fb550346a636588f2fcf253237',
    'K19-sym20-(64, 128)-(1, 0)-None-0':
        'b69ee3522fd807845895a3e9f919fc2c9fdebfb5b9317b34f9bc24c82e143d14',
    'K19-db2-(64, 128)-(1, 0)-soft-0':
        '1adf15adc937e1816ea6e6f50c4d6db6ff28991f0aff9aa49de9300794c83c7c',
    'K19-sym8-(64, 128)-(1, 0)-soft-0':
        'fc97658cca9ac855056e93c6be2824405930a67dd03115ccc5d6ddbd5c340e2d',
    'K19-sym20-(64, 128)-(1, 0)-soft-0':
        'b90b24d398fe97edf26ac05831c29cc229de034d488047c8a1a4cd44820a5af3',
    'K19-db2-(64, 128)-(1, 0)-hard-0':
        '1363fff3f2d47c0e3e1e59f790084eb96c67031a4cfdace9ff35ac9a495ce327',
    'K19-sym8-(64, 128)-(1, 0)-hard-0':
        'e8130129fdad1b0d8766473a1c5f8120305005537503729777534d001b19f4bb',
    'K19-sym20-(64, 128)-(1, 0)-hard-0':
        'a60f6dd58bdc326b0e4dfbc5ce7788aa6ee431ede0ebd8b5727ce412194ca0d7',
    'K19-db2-(64, 128)-(0, 1)-None-0':
        'e042bcb2b84ba63533dfd389e3f81317f53566b0605244e250826b5f26128bf7',
    'K19-sym8-(64, 128)-(0, 1)-None-0':
        '7da7f68c769ebfa7b92cb129970466ee5711861c5ccd577ca1e6f8ce4eef2505',
    'K19-sym20-(64, 128)-(0, 1)-None-0':
        '4423dfc230d44d80b2bb6808357463db69225d2f24f66ed530c0a7bfa2feeb57',
    'K19-db2-(64, 128)-(0, 1)-soft-0':
        'cd62b1c3501a0b77a931d7db24c29e5382e8b964ae374479a93fd427163cb647',
    'K19-sym8-(64, 128)-(0, 1)-soft-0':
        'c3871eef40ff5b41866a01ecc5f9a14e24555c315aa82f66aab65f400e0db089',
    'K19-sym20-(64, 128)-(0, 1)-soft-0':
        '7a9b642bdebaf4c3d986ad391429395a78ea7922a43edbaaa27489d14fc82c12',
    'K19-db2-(64, 128)-(0, 1)-hard-0':
        '32c77cadad4826205896fb9b455b14a33c848798bca679108a955d9e4a3425d3',
    'K19-sym8-(64, 128)-(0, 1)-hard-0':
        '3d2a582105aa5ffc1a8dce023cc08cfb522d7373e017bd0b64d0b36ad24b4a6e',
    'K19-sym20-(64, 128)-(0, 1)-hard-0':
        '95ff3fc3baa19cd786fc1b7ebb92c8c7fcf4fcd17cab64df4e1d1d3e64fbaf29',
    'K19-db2-(64, 128)-(1, 1)-None-0':
        'a783d36984bacb56ea04b7e63a59cfd4437254966519fd8c2942da456997443a',
    'K19-sym8-(64, 128)-(1, 1)-None-0':
        '6fe29858520eb53dd244db0afe8d69e7dd6d921b337f1046dc11840434a6eff0',
    'K19-sym20-(64, 128)-(1, 1)-None-0':
        '116ab5da303c7a090b400faea4ef1e0ae12a6dc718b923639e9aafac8b56367c',
    'K19-db2-(64, 128)-(1, 1)-soft-0':
        '17c7dd0fd02b2f95dc770e2d4473aec580437774b1f737add863abd19758230f',
    'K19-sym8-(64, 128)-(1, 1)-soft-0':
        '05ee16df2fc12f67118d92a3405c28fe0c441e164268a338b05c3e38bbc7cfd6',
    'K19-sym20-(64, 128)-(1, 1)-soft-0':
        '02b9144c2100b1730751cb3c1b19e2391ad865b13e7f0d5b5e3e672a475b5a3c',
    'K19-db2-(64, 128)-(1, 1)-hard-0':
        'd03255d1ed79a7e707b94326d85485fa0e6e4f4c4d8eeff3307416cda21dca1e',
    'K19-sym8-(64, 128)-(1, 1)-hard-0':
        'defaf9726738ac30535224ec2d215ad518889d6a1ff0839ff499aab8a3bdadf3',
    'K19-sym20-(64, 128)-(1, 1)-hard-0':
        '9255d21d00e440ffa0dd619ce54bc6cb6f90d39c37436d66d52cc3d1eac3e4e1',
    'K19-db2-(64, 128)-(5, 3)-None-0':
        'ef0cd7d34508ef1343a1aea9f0b7e9d4c8495745df444f5ff95446ac8a1f2485',
    'K19-sym8-(64, 128)-(5, 3)-None-0':
        '2f466283bf7214b0e67ac80b3109bccab15faf32b34a14625b9398595281ea0a',
    'K19-sym20-(64, 128)-(5, 3)-None-0':
        '08f22f3231e0c0e89eedf43f9374c6928d83a382fffe30e90a6e2cac5bd4d226',
    'K19-db2-(64, 128)-(5, 3)-soft-0':
        '710b87595f66ad7f4157efcf8f5e8df237669059efe4365dafa35287cd6c3f96',
    'K19-sym8-(64, 128)-(5, 3)-soft-0':
        '3e471a9adedb063d106c2278862bcafa67c8f25f43b51e2c571d9454273790b9',
    'K19-sym20-(64, 128)-(5, 3)-soft-0':
        '63f65d8619e6274e748b19834cf8bdeba24aa5afcfdd0b4be8be7e9a52325d3b',
    'K19-db2-(64, 128)-(5, 3)-hard-0':
        '8351dff3c9e70ca973915742cc80f7514ff5aa0c690155896621055bcd110f56',
    'K19-sym8-(64, 128)-(5, 3)-hard-0':
        '32127c41c98e7f8feafb2027e2176ccbc52885f6b0527144ff40e430ce6e6bf6',
    'K19-sym20-(64, 128)-(5, 3)-hard-0':
        '6a5b151937fe8ae19bf22bb4d38c8eba6085f80e7d45e2aeed0f51defd2342e0',
    'K19-db2-(64, 128)-(70, 131)-None-0':
        '2624fd5f258c857d46c2181bb7d25cd90f104a1c1ac0fcb30d9690ec6aeb31b2',
    'K19-sym8-(64, 128)-(70, 131)-None-0':
        '3a14ee741059ea6f66b9daaec15b12716aafe9a9ce860d5c0f4a376df74fb8c4',
    'K19-sym20-(64, 128)-(70, 131)-None-0':
        'c2c692bdfeae69a91ed80189b0db656617f89f41a1fe9ae15a87573957b1182a',
    'K19-db2-(64, 128)-(70, 131)-soft-0':
        '53d594594556726dffdbb4541841a90b6d2f2a190bd5c7ca166278cb6e629a45',
    'K19-sym8-(64, 128)-(70, 131)-soft-0':
        '21f8a735c393af46f761ad7259048f6fcf7a77b71f6a6336c788137428a1ff34',
    'K19-sym20-(64, 128)-(70, 131)-soft-0':
        '22fc72ab3f4452ec0ddc9ba4ea9522289527c660c8f73d62df291c75bcec532e',
    'K19-db2-(64, 128)-(70, 131)-hard-0':
        'c029fded2b58ef220f8b60d8a8a529641d40b42f5ecd6a8c44baaf01d666f2b3',
    'K19-sym8-(64, 128)-(70, 131)-hard-0':
        'ef3ef8facce543567caea270ef981ddf2a102faa6a2acebcc673156125d988ce',
    'K19-sym20-(64, 128)-(70, 131)-hard-0':
        'bbcd5c8fb2c1b0f95f11a799b4a01713935e8896d9c0332f2bb0288590cdef31',
    'K19-db2-(64, 128)-(127, 1)-None-0':
        'e1996d30aabc1d181e2ea7f215d3ffa8f226fc56149cd2c69fcf3457c0c81dc6',
    'K19-sym8-(64, 128)-(127, 1)-None-0':
        '624f888c6f2e73bb491574d1917def05424ba6af4dfd89e7938f5e7ad325082a',
    'K19-sym20-(64, 128)-(127, 1)-None-0':
        '425d9ea29462a294b00d7dd61afe4ca38567c0bea049a24754b2c8bcc0839d9c',
    'K19-db2-(64, 128)-(127, 1)-soft-0':
        'b6be03d26301a83d580e70565da29b4c43b79223eea62def3816cfc8eb9b9275',
    'K19-sym8-(64, 128)-(127, 1)-soft-0':
        'b7605bdab51bf504f74700f4c1eed8e6a5b68657ebe138976b4bace8db03301a',
    'K19-sym20-(64, 128)-(127, 1)-soft-0':
        '3bc8aede8f4b9b10aa53063d24b158787c78c3ba5d7b3464a3101e041edf01a7',
    'K19-db2-(64, 128)-(127, 1)-hard-0':
        'c5fe0117dabd3105ae649a8227a5b93366723e7de0139d467b15feda37c9c849',
    'K19-sym8-(64, 128)-(127, 1)-hard-0':
        '5b375df0c7bd7dda62c4c177993f924ff8c7d33550845d49e3326e426967e5ce',
    'K19-sym20-(64, 128)-(127, 1)-hard-0':
        'ec64e25d64e83a00de481726873758166f6db3d1b06b10131d2095e35d56a589',
    'K19-db2-(64, 128)-(4101, 4099)-None-0':
        'ef0cd7d34508ef1343a1aea9f0b7e9d4c8495745df444f5ff95446ac8a1f2485',
    'K19-sym8-(64, 128)-(4101, 4099)-None-0':
        '2f466283bf7214b0e67ac80b3109bccab15faf32b34a14625b9398595281ea0a',
    'K19-sym20-(64, 128)-(4101, 4099)-None-0':
        '08f22f3231e0c0e89eedf43f9374c6928d83a382fffe30e90a6e2cac5bd4d226',
    'K19-db2-(64, 128)-(4101, 4099)-soft-0':
        '710b87595f66ad7f4157efcf8f5e8df237669059efe4365dafa35287cd6c3f96',
    'K19-sym8-(64, 128)-(4101, 4099)-soft-0':
        '3e471a9adedb063d106c2278862bcafa67c8f25f43b51e2c571d9454273790b9',
    'K19-sym20-(64, 128)-(4101, 4099)-soft-0':
        '63f65d8619e6274e748b19834cf8bdeba24aa5afcfdd0b4be8be7e9a52325d3b',
    'K19-db2-(64, 128)-(4101, 4099)-hard-0':
        '8351dff3c9e70ca973915742cc80f7514ff5aa0c690155896621055bcd110f56',
    'K19-sym8-(64, 128)-(4101, 4099)-hard-0':
        '32127c41c98e7f8feafb2027e2176ccbc52885f6b0527144ff40e430ce6e6bf6',
    'K19-sym20-(64, 128)-(4101, 4099)-hard-0':
        '6a5b151937fe8ae19bf22bb4d38c8eba6085f80e7d45e2aeed0f51defd2342e0',
    'K19-db2-(66, 130)-(1, 1)-soft-0':
        '97b28903a5a5d1ab8c34fa460d0494dbe1d93dba13ad6374f7c6e1105b7e538d',
    'K19-sym8-(66, 130)-(1, 1)-soft-0':
        'fc13b534d314e3e66c811cf57b0410719b957cd3f2cdbfd8c6385b792b8b4488',
    'K19-sym20-(66, 130)-(1, 1)-soft-0':
        '66fe6b3584b316a012bc2b7e6290c4ca4a00556cb344ce6dc1e00679f295333a',
    'K19-db2-(66, 130)-(5, 3)-hard-0':
        '01173728e7f66a71068574b0a3f2e573f1db25f3d580eb2acc7f2b4db76702cf',
    'K19-sym8-(66, 130)-(5, 3)-hard-0':
        'a55b868b8c662b23137b38097a1a59aa93ab1eeb130c44a403d1dab8b480207d',
    'K19-sym20-(66, 130)-(5, 3)-hard-0':
        '9b09d2605bbea234f05f45ce91b350a9868847649d68937436b1a7723414430e',
    'K19-db2-(2048, 2048)-(1, 1)-soft-0':
        '1d482143a711d63f8e82e6a528eacbfde88daf1f2c139f9e1933c42d269fb861',
    'K19-sym8-(2048, 2048)-(1, 1)-soft-0':
        '60f23121343a23e9b5923ae80210cd390e1da658ef9de9191b44ea21bff6eabe',
    'K19-sym20-(2048, 2048)-(1, 1)-soft-0':
        'afee914f50acbf68d39d5797975a7d773b9f9d4ed564f7ac4cd8bb0118ccb6a7',
    'K19-db2-(2048, 2048)-(3, 3)-soft-0':
        'e7d849be1d47245855b8d341aebe67b579a17f0c22c22aef4d9a70d6a1dd527f',
    'K19-sym8-(2048, 2048)-(3, 3)-soft-0':
        '06318df7dbbff16177207cec971a16a47d95447ec4b853a99a380d86f4532482',
    'K19-sym20-(2048, 2048)-(3, 3)-soft-0':
        'abdbea5df69207c175fc5853a1d94b749f5210a3a1a815cb6f0f994e94e00aad',
    'K19-db2-(2048, 2048)-(1, 0)-None-0':
        'fdc6ab0e255f13a7d6e2794bed02a9e7628eb3af45a8d886c736c7e0a77877d1',
    'K19-sym8-(2048, 2048)-(1, 0)-None-0':
        'f495fbffc28e664ad99938dff677a8eb64c5b9325de9c4174b9fb791fdc57b1c',
    'K19-sym20-(2048, 2048)-(1, 0)-None-0':
        '87e89cf123013283d7d8854fe3234d00cc3be56f716cd9078546dc24ad24e29e',
    'K19-db2-(2047, 2047)-(1, 1)-soft-0':
        '6cd1a21e9ca6cee610c6dc360be49b38820bacab1a4fe7d32c57c74c0ea74a17',
    'K19-sym8-(2047, 2047)-(1, 1)-soft-0':
        'ef2a854a2c0c13bfde210b7a9c40f068d9342c6aae2d4bad3055cc62431a25fb',
    'K19-sym20-(2047, 2047)-(1, 1)-soft-0':
        'f8b94834e62db52cfc8452672031900ecabeb7fa8f443122ddc71c5b75cb2f53',
    'K19-db2-(2046, 2047)-(0, 1)-hard-0':
        'f5fe68b08ac118e5b37b28936cfab686b0d39d3171a75ed706b613c85e6650e9',
    'K19-sym8-(2046, 2047)-(0, 1)-hard-0':
        '5ce20691ef4b6803f36fd0e81d8b6bb180929524d8965c197b448bfd71434b07',
    'K19-sym20-(2046, 2047)-(0, 1)-hard-0':
        'c53143e7c200fd2fd8dc11646a735aac0c8e31a0311f3d614e46d15d81abe523',
    'K19-db2-(2046, 2047)-(5, 3)-None-0':
        'd9afc0dba3dd415e58caa2abb5e0f02056e615b57e2742dfa114a753bec4fadd',
    'K19-sym8-(2046, 2047)-(5, 3)-None-0':
        '5d6cc102e373a4953f038a44c7dd16e6516a4aa3d4ec92ba81eeff8e7519960e',
    'K19-sym20-(2046, 2047)-(5, 3)-None-0':
        '376afaa06e03ff443f0d7dc5d64417257492e05595800e22b87eee601d9b7892',
    'K19-db2-(3, 40, 72)-(5, 3)-soft-0':
        '86ccddd8e03ac1904dd5169478739d0864355791b12c923b1934c2cc7b20cabc',
    'K19-sym8-(3, 40, 72)-(5, 3)-soft-0':
        '557ae6d65b471c26d2fda80d50478c5a7ace8e0f869256854c65a82873d2f71a',
    'K19-sym20-(3, 40, 72)-(5, 3)-soft-0':
        '7cb2c32b1afb77493867a09122a96b001fc4c5f6ffb012c5bdeaf660d35204f4',
    'K19-db2-(64, 128)-(1, 1)-soft-1':
        '17c7dd0fd02b2f95dc770e2d4473aec580437774b1f737add863abd19758230f',
    'K19-sym8-(64, 128)-(1, 1)-soft-1':
        '05ee16df2fc12f67118d92a3405c28fe0c441e164268a338b05c3e38bbc7cfd6',
    'K19-sym20-(64, 128)-(1, 1)-soft-1':
        '02b9144c2100b1730751cb3c1b19e2391ad865b13e7f0d5b5e3e672a475b5a3c',
    'K19-db2-(66, 132)-(5, 3)-hard-1':
        '0a1f26456c36ace09cbda8f796a2d903c03cc671867b06b4fcbeaa0c54ec9331',
    'K19-sym8-(66, 132)-(5, 3)-hard-1':
        'a20c72d4984650c5c10175ecf420b08225e545342f151b7d4ceb8d2ea0d5082d',
    'K19-sym20-(66, 132)-(5, 3)-hard-1':
        '931512d43d9bfb6735c3d0460eb51c5fa2bd4262c4928d161f40364d79e53f56',
}

# K18b on nonsep_swt2d.cu's stencil body: each output against its plain
# version and against the SHA-256 of the output that K18b's body before it
# (one thread per pixel, every tap through L1) gave on the card for the
# same seeded inputs; `python tests/test_torch_kernels_cuda.py digests`
# prints a tree's digests in K18B_DIGESTS's form. Banks: hlen 6, 4, 8, an
# odd 5 and a dense 40 (read through the cache, not staged). Cases: (type,
# shape, level, offset): levels 1-3 of (64, 128) and of a 2048^2 frame; a
# dilation that reaches the plane; odd planes; rows of 70 samples (sample
# copies); a batch; a plane of more row tiles than one launch's grid holds;
# planes one sample past a 16-byte boundary; float32 and float64.
K18B_BANKS = ["db3xcoif1", "rank2mix", "dense8", "dense5", "dense40"]
K18B_TALL = (65535 * 32 + 5, 3)
K18B_CASES = ([("f32", (64, 128), lev, 0) for lev in (1, 2, 3)]
              + [("f32", (2048, 2048), lev, 0) for lev in (1, 2, 3)]
              + [("f32", (16, 64), 6, 0), ("f32", (2047, 2047), 1, 0),
                 ("f32", (33, 47), 2, 0), ("f32", (40, 70), 1, 0),
                 ("f32", (3, 40, 72), 2, 0), ("f32", K18B_TALL, 1, 0),
                 ("f32", (64, 128), 1, 1),
                 ("f64", (64, 128), 1, 0), ("f64", (2048, 2048), 1, 0),
                 ("f64", (16, 64), 6, 0), ("f64", (33, 47), 2, 0),
                 ("f64", (3, 40, 72), 2, 1)])


def _k18b_bank(name):
    if name in ("db3xcoif1", "dense8"):
        return _f2d(name)
    if name == "rank2mix":
        f = get_filter_bank("db2")
        lo, hi, o = f.dec_lo, f.dec_hi, np.outer
        mix = [0.8 * o(lo, lo) + 0.2 * o(hi, hi),
               0.8 * o(hi, lo) + 0.2 * o(lo, hi),
               0.8 * o(lo, hi) + 0.2 * o(hi, lo),
               0.8 * o(hi, hi) + 0.2 * o(lo, lo)]
        return Filters2D(mix, mix, name)
    n = int(name.removeprefix("dense"))
    g = np.random.default_rng(n)  # taps / n^2: outputs of order 1
    return Filters2D(list(g.random((4, n, n)) / n ** 2),
                     list(g.random((4, n, n)) / n ** 2), name)


def _k18b_id(case, name):
    return "-".join(["K18b", name, *(str(v) for v in case)])


def _k18b_output(case, name, dev):
    """(kernel output, plain output) of one case, the kernel launched
    once."""
    kind, shape, level, off = case
    dtype = torch.float64 if kind == "f64" else torch.float32
    f2d = _k18b_bank(name)
    c = [_offset(_rand(shape, dev, s).to(dtype), off) for s in range(1, 5)]
    n = kn.ins_swt2d_fused.launches
    got = kn.ins_swt2d_fused(*c, f2d, level)
    assert kn.ins_swt2d_fused.launches == n + 1
    return got, kn.ins_swt2d_plain(*c, f2d, level)


@pytest.mark.parametrize("name", K18B_BANKS)
@pytest.mark.parametrize("case", K18B_CASES, ids=str)
def test_k18b_stencil_body_matches_plain_and_parent(dev, case, name):
    got, ref = _k18b_output(case, name, dev)
    tol = TOL if got.dtype == torch.float32 else 1e-12
    assert got.shape == ref.shape and float((got - ref).abs().max()) <= tol
    assert _sha256(got) == K18B_DIGESTS[_k18b_id(case, name)]


# K18a on the same stencil body, on the same banks and cases: its four
# outputs against their plain versions and against the SHA-256 of the four
# (stacked) that K18a's body before it (one thread per pixel, every tap
# through L1) gave on the card for the same seeded input; `python
# tests/test_torch_kernels_cuda.py digests K18A` prints a tree's digests in
# K18A_DIGESTS's form.
def _k18a_id(case, name):
    return "-".join(["K18a", name, *(str(v) for v in case)])


def _k18a_output(case, name, dev):
    """(kernel outputs, plain outputs) of one case, the kernel launched
    once."""
    kind, shape, level, off = case
    dtype = torch.float64 if kind == "f64" else torch.float32
    f2d = _k18b_bank(name)
    x = _offset(_rand(shape, dev, 5).to(dtype), off)
    n = kn.ns_swt2d_fused.launches
    got = kn.ns_swt2d_fused(x, f2d, level)
    assert kn.ns_swt2d_fused.launches == n + 1
    return got, kn.ns_swt2d_plain(x, f2d, level)


@pytest.mark.parametrize("name", K18B_BANKS)
@pytest.mark.parametrize("case", K18B_CASES, ids=str)
def test_k18a_stencil_body_matches_plain_and_parent(dev, case, name):
    got, ref = _k18a_output(case, name, dev)
    tol = TOL if got[0].dtype == torch.float32 else 1e-12
    for g, r in zip(got, ref):
        assert g.shape == r.shape and float((g - r).abs().max()) <= tol
    assert _sha256(torch.stack(got)) == K18A_DIGESTS[_k18a_id(case, name)]


K18A_DIGESTS = {
    'K18a-db3xcoif1-f32-(64, 128)-1-0':
        '31e76b77b9c6ff347577d951e547a451bca9cae34001a49a312e9d295439dd11',
    'K18a-rank2mix-f32-(64, 128)-1-0':
        '6dcfce85a20875832aeba0f1b73a7deeeb9d9ad276bef595defbf104f98b5cf6',
    'K18a-dense8-f32-(64, 128)-1-0':
        'fb8dcdc63813158ad0b8633c34b343273b5e0f82bc9866d61b6abcc0372d4a5d',
    'K18a-dense5-f32-(64, 128)-1-0':
        '7f5c7419d85866ce742ca073b47b3e5effc8fa725a46834cdaa1d4f3ec63ef41',
    'K18a-dense40-f32-(64, 128)-1-0':
        'ecac75128f2a75c9f99e2ba83ddcadb3201389171e4499f6d539e03aa2846dba',
    'K18a-db3xcoif1-f32-(64, 128)-2-0':
        '46092d59872e639f5bdb4df357fa5ab7d33a5065e5b36e35aa7274659bbdf241',
    'K18a-rank2mix-f32-(64, 128)-2-0':
        'cf8c5d7d3959dc5dab45087a061711aecac1e6bbdc2e2fe776d3ee60b2b60649',
    'K18a-dense8-f32-(64, 128)-2-0':
        '0fa00a4a3871cfb030a4ffb6e2cf32470c174b991d29cdbd0f6b77fe4d947ec8',
    'K18a-dense5-f32-(64, 128)-2-0':
        '946073bcd09f5ccf298eace268186f3c22ee4dc093ee7d887ca4184b94dd8141',
    'K18a-dense40-f32-(64, 128)-2-0':
        '2497aaf200ef4248c34f8f85bbe2208ed884cbcd555cc1cfc5472d429d6cd06b',
    'K18a-db3xcoif1-f32-(64, 128)-3-0':
        '0efb2f78be36a7eac7a6bd6d860110768f1b7210a59964eb6c4017fb7a40c53a',
    'K18a-rank2mix-f32-(64, 128)-3-0':
        'd7189c2b68b86e50d2321ca2b88edbe35b5d89ac5297a92dcbf9410834bdc9ec',
    'K18a-dense8-f32-(64, 128)-3-0':
        '2e266a2c7f5c94a70ded3619b007f82b7e3157e6f4f85e556f59abb751404c19',
    'K18a-dense5-f32-(64, 128)-3-0':
        'bd99222d27c8123176c7831eaff7b7b52c413e53b07d6e5e02d3e4637106538e',
    'K18a-dense40-f32-(64, 128)-3-0':
        '04214202092c48a1526244a90905c48634274ceb428b8f04ad26052d95124d17',
    'K18a-db3xcoif1-f32-(2048, 2048)-1-0':
        '14677c2b57a080b15d5370c3121646f28bb7669b482660bd3c0f7f7d95d067a3',
    'K18a-rank2mix-f32-(2048, 2048)-1-0':
        'b82296b89a3e61bbea1ac0049761ffb56460fef9c561ed536f674e6937f03165',
    'K18a-dense8-f32-(2048, 2048)-1-0':
        'f38d242997339312bf5df96c2a7d6a07c902186b4c86563e7935694122861228',
    'K18a-dense5-f32-(2048, 2048)-1-0':
        '1cb73ccab14ed5edb54413fbcdf267f55979224b62e870b255275eecad1598fc',
    'K18a-dense40-f32-(2048, 2048)-1-0':
        '75e719c66a97bf8e5058320323411bafeaa578e118e287f01ad6dcbd96ddecf7',
    'K18a-db3xcoif1-f32-(2048, 2048)-2-0':
        'd67bef7e8d0d5a7e5f1431e5d14c8609948a909cd90d062bb7905a070d8170a1',
    'K18a-rank2mix-f32-(2048, 2048)-2-0':
        'd3a36f4c318fdcd3f6761e0acd09009d928990e0411330fdb20fbb9b1e41451c',
    'K18a-dense8-f32-(2048, 2048)-2-0':
        '44342adda90a513317305038b100b9a8c55bb3a99be5aaf1280219fc61ee5f75',
    'K18a-dense5-f32-(2048, 2048)-2-0':
        '33805c93c719f80d1310fc122f0981ee77ba026f90a8beba8aedcbbc84ee30dc',
    'K18a-dense40-f32-(2048, 2048)-2-0':
        'b63f87e102448ea176d79b8958ae5048994aa2186411d8d9b366f3eb6ee2419d',
    'K18a-db3xcoif1-f32-(2048, 2048)-3-0':
        'daa259aab28fe646489296696ad633e0f185c0806d3b03716a30e87f8e99bc7c',
    'K18a-rank2mix-f32-(2048, 2048)-3-0':
        'e71d42289a7298cf7b27ad74d102fa6952de1a0dc3df06def2e489fe4a0684ec',
    'K18a-dense8-f32-(2048, 2048)-3-0':
        'a812b2f16181cfcdc26401ceeaae2b0831275df1bbebc63d404ea745d5a64fa5',
    'K18a-dense5-f32-(2048, 2048)-3-0':
        'f197e3722a6747d7fba27bed5d8b6c5682ed1ace25e7181a3ad4bc35c882f128',
    'K18a-dense40-f32-(2048, 2048)-3-0':
        '4b8d8f315981f3858c3ed32c31371fdc075eaacdaf21a39d21fceea201b42e50',
    'K18a-db3xcoif1-f32-(16, 64)-6-0':
        'c383715d6a7a3e38d8141a4c6237f9f257fadec5910fa8bb90f01d98b2661400',
    'K18a-rank2mix-f32-(16, 64)-6-0':
        '13cfbfc4c7acff042feb77eaa69256d6f2d542577e94284199b33f8f7b65c1f2',
    'K18a-dense8-f32-(16, 64)-6-0':
        '0158a192f53a02c4f84e8a48898d0ec37cedfce94ff5f8652f150602f884fad2',
    'K18a-dense5-f32-(16, 64)-6-0':
        'd9d23b5936b052893b527d1cc023282f24f5660de82fd1a7aae8810d5c2f0488',
    'K18a-dense40-f32-(16, 64)-6-0':
        '99fcd27c1a342bb09a1e1965fae681ca25800ad01397f3a5a83b36084f954c30',
    'K18a-db3xcoif1-f32-(2047, 2047)-1-0':
        'd55ef5d8a7b09d907bbaa95869b18d852e8b7f8750a31080ed5375f1e1afc30b',
    'K18a-rank2mix-f32-(2047, 2047)-1-0':
        '7ef3139b8bb8fc1f584f070a2bb879697823810ab34d8ecf4015c9ac0190b7d5',
    'K18a-dense8-f32-(2047, 2047)-1-0':
        '24c88fab65b86d0246a9a7af2882f2cc26547b07920e7137f5fff4132d33ba17',
    'K18a-dense5-f32-(2047, 2047)-1-0':
        '0f7d5ee05e333e77c50249f6450f3fdd9167c2f69cbbca680572dc47d3334312',
    'K18a-dense40-f32-(2047, 2047)-1-0':
        'ee59d44a94e91b369c25242f704a73d017b26de7d56dcbc8b87e212bb3323407',
    'K18a-db3xcoif1-f32-(33, 47)-2-0':
        '4480ecb22229c0e087a0b3c604932e4d776fa40774a9dfc3fbfb073f5a9354b5',
    'K18a-rank2mix-f32-(33, 47)-2-0':
        '71191706eb061b527ebcc9745f9310ca66ecc630728ad3b03019456550e4781c',
    'K18a-dense8-f32-(33, 47)-2-0':
        'c4535b9f6b8eeee4f6cfbbbe1f99ef1aec2368d4dcec7326d398968ea2a205a2',
    'K18a-dense5-f32-(33, 47)-2-0':
        'e2884a804a3d4eeee2d5ce9ae94b776a621dc29d1e7ea12e43e8ae0584e79464',
    'K18a-dense40-f32-(33, 47)-2-0':
        '064198ecd2ae904d64e109b2b8c9e9d52d10acd92a893f3679d8f95db0363e37',
    'K18a-db3xcoif1-f32-(40, 70)-1-0':
        'f7d55404868470ec0b0fa92bd5725b613d8a8247366db8d99bacccf5bc1dc16b',
    'K18a-rank2mix-f32-(40, 70)-1-0':
        'ba4bf8d810a094511a897882bd3b9603ab1b1cfa92922511d2f8334241f5804e',
    'K18a-dense8-f32-(40, 70)-1-0':
        'f92eaf1dab3a61ba128732da675d1981b2125b38e5abfd1830d83705a1124784',
    'K18a-dense5-f32-(40, 70)-1-0':
        '3f29a4cc0fc390a80a755afc4ae48aa4bb1eba53f85b7f6a1a93a4e424ee0f75',
    'K18a-dense40-f32-(40, 70)-1-0':
        '6cafb07e0767626f958206827a46009b935037be028348afd4093dc3f3e6a88a',
    'K18a-db3xcoif1-f32-(3, 40, 72)-2-0':
        '18d0a28bf91775f663d6d1ff09e2884a7c015b5bac50962d5de677eeaa4fb4d0',
    'K18a-rank2mix-f32-(3, 40, 72)-2-0':
        '24afece9c431874901fbe1e1b4e0046e8fec1425c85f8fe649a6b57fb57fe8b8',
    'K18a-dense8-f32-(3, 40, 72)-2-0':
        '96b65edf9f552f3e431ee55486f325aa3d87dcbb271478416043bc68be1ccb63',
    'K18a-dense5-f32-(3, 40, 72)-2-0':
        '457d01801adf149801f0129abe016de8bd502419ec40886412a3a2fbbf22c6e0',
    'K18a-dense40-f32-(3, 40, 72)-2-0':
        '058e19a790a8bdba11873a23f2bc4ba43b0d098afe0f177331e1dae4c89c4271',
    'K18a-db3xcoif1-f32-(2097125, 3)-1-0':
        '7e64cc5ff1b32c1a20863fd4f24556920f2e29022f5f66dad1e2cb0c91fb1d6a',
    'K18a-rank2mix-f32-(2097125, 3)-1-0':
        'c934ceb4e2f7b0f578fa41e6937d6d8ff1c015f47ebfd40836d3014d43dd1e8d',
    'K18a-dense8-f32-(2097125, 3)-1-0':
        '44fba6024dc93d0f799e25ced7d470121175b25e7f8e2b806da9a72dc9813c06',
    'K18a-dense5-f32-(2097125, 3)-1-0':
        'b5640c4ab8b1f76e58b9815178b372013c78e3960f55af658e067d780e7094c3',
    'K18a-dense40-f32-(2097125, 3)-1-0':
        'c3e2403944a455d54fcb3c47736722a8ba890f8f585beee7bcc90db471df1dbd',
    'K18a-db3xcoif1-f32-(64, 128)-1-1':
        '31e76b77b9c6ff347577d951e547a451bca9cae34001a49a312e9d295439dd11',
    'K18a-rank2mix-f32-(64, 128)-1-1':
        '6dcfce85a20875832aeba0f1b73a7deeeb9d9ad276bef595defbf104f98b5cf6',
    'K18a-dense8-f32-(64, 128)-1-1':
        'fb8dcdc63813158ad0b8633c34b343273b5e0f82bc9866d61b6abcc0372d4a5d',
    'K18a-dense5-f32-(64, 128)-1-1':
        '7f5c7419d85866ce742ca073b47b3e5effc8fa725a46834cdaa1d4f3ec63ef41',
    'K18a-dense40-f32-(64, 128)-1-1':
        'ecac75128f2a75c9f99e2ba83ddcadb3201389171e4499f6d539e03aa2846dba',
    'K18a-db3xcoif1-f64-(64, 128)-1-0':
        '1e17e8ecd5b34983c01bb579004e1f3290d0eead1bfd2bf99326e1ec9629fbab',
    'K18a-rank2mix-f64-(64, 128)-1-0':
        '92c8840bc36e68d1822c7866c4ee52419eaec7132e89cdf07ec46d828fc68ec0',
    'K18a-dense8-f64-(64, 128)-1-0':
        '5f178a8a01dfb10a75dd4cc63968732f0eab9d8e9d09116116827d1c013c82bc',
    'K18a-dense5-f64-(64, 128)-1-0':
        '76aa4189fae3858e82b026682490f3d233fae612c4e8fb4f26b4453bd4f08dd8',
    'K18a-dense40-f64-(64, 128)-1-0':
        '28d94298f62933a3720af98219d8fb8ba67a1cad74d98bb128123fdc776d22d8',
    'K18a-db3xcoif1-f64-(2048, 2048)-1-0':
        'e22c98f4c745e2de470afc8db953101e6f5a2f9cd7a1166731d6e37ca4483eab',
    'K18a-rank2mix-f64-(2048, 2048)-1-0':
        '677afc902421235aa6f7d805da265d6c6a173a4cea18a7810f77b478c5cdf43b',
    'K18a-dense8-f64-(2048, 2048)-1-0':
        'a77f273b1604387b75ffb0c1a9062a0fdce9b85fbf3cbdb88c45482639374fc9',
    'K18a-dense5-f64-(2048, 2048)-1-0':
        '9ede8f231d4c06f75027ffcba6e33263c1da26bcd2e91546226606949e547d47',
    'K18a-dense40-f64-(2048, 2048)-1-0':
        'ca5ac26318a88cf0eab56604ddcd95ff6ff1d52a33872943a10945f60763eeca',
    'K18a-db3xcoif1-f64-(16, 64)-6-0':
        '4be9ca59175dd6fb4111984bb7d61a9d68e5b361b8c417e674c7e9e80d725072',
    'K18a-rank2mix-f64-(16, 64)-6-0':
        'b3b39197428da050aa6d222d27355aaa98bdcee99a4a73ba0f1bdbd8e2142ba2',
    'K18a-dense8-f64-(16, 64)-6-0':
        'fe391c49bbb26b8d37be2e7e537821a8ad92444471679d2f78c763c0a5560565',
    'K18a-dense5-f64-(16, 64)-6-0':
        'e7a19bc6e0dc0fa26a83560cf1a423fafb40a5fa85f22a804c8021d1e396098c',
    'K18a-dense40-f64-(16, 64)-6-0':
        '8f11d1a0d2976d17d357a758af0b612a0873e33aeabf54f8c2afa19e009ec7f0',
    'K18a-db3xcoif1-f64-(33, 47)-2-0':
        '85c68aaf1278965bedb9328de4afe31cfbb503cd031a774c5112381c48364d56',
    'K18a-rank2mix-f64-(33, 47)-2-0':
        '8fcf6b7a99bdab4d92c5dc49a12fea19d2425d22d2ce67cffa60b86b90f00518',
    'K18a-dense8-f64-(33, 47)-2-0':
        'b6e7c8b5245e04f50b22b6d38a72ab308f7f049604f074c8e88d7369c9f65675',
    'K18a-dense5-f64-(33, 47)-2-0':
        '75a874946c3aca156653aeb28f1b92cadc2856eb5908c46a604fec20a8615a3a',
    'K18a-dense40-f64-(33, 47)-2-0':
        'd694302cb9a00698422f6cf3bec6c402f7eb92088bb319c10df4d7ddb0587348',
    'K18a-db3xcoif1-f64-(3, 40, 72)-2-1':
        'f70a0ad6a91b4974113e4256c10080d1a51decdc3fcfe86c275aaf331c2ea34a',
    'K18a-rank2mix-f64-(3, 40, 72)-2-1':
        'fc677f452a189258ab18834a26b149b97eaaa1dedb4e6ff1e4b045f8cce5059a',
    'K18a-dense8-f64-(3, 40, 72)-2-1':
        '0bb57fdfd0ae2115f5df2d12e9e88a686394ef4046029d11eeeca9a4a9f43826',
    'K18a-dense5-f64-(3, 40, 72)-2-1':
        'ef84831c0ce7cbbaebb5c7ad8e5f66dc637adf5fa85bd57f2397bd17f7f5ea70',
    'K18a-dense40-f64-(3, 40, 72)-2-1':
        '108f356958d1653059fc236c3d98e1cf06b458ed370c9f09770a1d6debd857cf',
}

K18B_DIGESTS = {
    'K18b-db3xcoif1-f32-(64, 128)-1-0':
        '5c7e2dfae213399988b584444a08a8d3322b148bfb5d9e05f2430febc83b1735',
    'K18b-rank2mix-f32-(64, 128)-1-0':
        '7100acb71420927b0c3d2daf70300ea14def4a53776cb046a04e654c3c5e0aed',
    'K18b-dense8-f32-(64, 128)-1-0':
        '65912972cfcb6e692f59d11c43e0f99b563c01533efca04c6bc243524179d51a',
    'K18b-dense5-f32-(64, 128)-1-0':
        '604257d257401cb37f7241365b7cbf672d0bf309f23b9b2718737c1d7e2d83fb',
    'K18b-dense40-f32-(64, 128)-1-0':
        'e188d2dc4f5eaeb661dddf99c1bc582a0fda26a8bfe0c09cd3d3cd19c281bcc5',
    'K18b-db3xcoif1-f32-(64, 128)-2-0':
        'd4be833986b9dcb0ff3a36890a46a6c76b967d228baad49b8a14cfed907da293',
    'K18b-rank2mix-f32-(64, 128)-2-0':
        'a39b8139c6a8f5da51c00410afe883d0f6f50e6bdb6e1796e7b373037c6e8a81',
    'K18b-dense8-f32-(64, 128)-2-0':
        '948ebcec0f98198d92ab1bcb67a5a3c224fe326a9b201a37b987dc49d4dde2d3',
    'K18b-dense5-f32-(64, 128)-2-0':
        '04946f88031b23300d7c69f9a84107bb5bc04ab6aeca862c7afd97eeca2ef495',
    'K18b-dense40-f32-(64, 128)-2-0':
        '0d4ef0a59bcf2841d78f0507e1b738e5a3a4f18fe6bad989723f568ede131f13',
    'K18b-db3xcoif1-f32-(64, 128)-3-0':
        '4d37782410f50fbd277832ce8690fc76e6d0fb4710ae3c5737a88cba9f199b2a',
    'K18b-rank2mix-f32-(64, 128)-3-0':
        'a0d849beb4c7152b133a9d9bdf38f03beed93ad355c9c7a5d9559a1b375780b6',
    'K18b-dense8-f32-(64, 128)-3-0':
        '5f8357909476a0ca9f8842aeb2cabd65d30460e56726bec42b882efa7e1707a2',
    'K18b-dense5-f32-(64, 128)-3-0':
        '0ea31c149639a9ef58835d30c7252bcc87a274ad07f2c8d87220ab56954c8166',
    'K18b-dense40-f32-(64, 128)-3-0':
        '8fbecb2a9e6722b9d2a26645a78b9a4e203231bea3c704d6cf38abb566437a41',
    'K18b-db3xcoif1-f32-(2048, 2048)-1-0':
        '3d29b8a1072cad941d2561a8b722a121ad0cd546150f7c84f9b5fceb6d16baac',
    'K18b-rank2mix-f32-(2048, 2048)-1-0':
        '9256aca8a9680ee4088ff827fb97640869be8b8e1b1f1da17f5fb34425efbe6d',
    'K18b-dense8-f32-(2048, 2048)-1-0':
        '278524c0db3993254e50ec706550c86d3029690a34b055178c178bad18bf400e',
    'K18b-dense5-f32-(2048, 2048)-1-0':
        'cb16131a106ef6767e52702be86de131ec2dc5164f0bcd44cb5c2e815e95a63d',
    'K18b-dense40-f32-(2048, 2048)-1-0':
        '68d2ccfcfa3a8be57d781cbf49dca25f97875c5c9a42f7db4f86f8e78ffc78de',
    'K18b-db3xcoif1-f32-(2048, 2048)-2-0':
        '7e45a34a3e123fb11b1a8e0952dbd28a604af66a0fd4c94098e440bebc7b3c20',
    'K18b-rank2mix-f32-(2048, 2048)-2-0':
        '56c4dc1a0e7a41da1c79d7f990e912a3c1906142f3d7290d9d3ef3bceba9c15b',
    'K18b-dense8-f32-(2048, 2048)-2-0':
        'a9b45af9b92542688fea8eb4f7644e8ee350112afcaa207de6c8bd209b5be453',
    'K18b-dense5-f32-(2048, 2048)-2-0':
        'e055c6b400b1018aecf9a2440e2ad28fa34a92871ab5247bc50033494ae2fd38',
    'K18b-dense40-f32-(2048, 2048)-2-0':
        '34c169f4a85dada9bd01bfbc6735eb4eb6ef20dde66df5f3b9879197afbe3381',
    'K18b-db3xcoif1-f32-(2048, 2048)-3-0':
        '01e029a82feaba6ce87eae5ca4f2e8befb78d7fcab4866c9829aaaeaf77b4dfd',
    'K18b-rank2mix-f32-(2048, 2048)-3-0':
        '87b9dae9cf1f853d806691f82f8d157f07ae6b8dd4da59fa2e3bce138eff7915',
    'K18b-dense8-f32-(2048, 2048)-3-0':
        '3c986c3e1cbb91f3fbabc08ce72e2d7ce6ddeb2b5f49d25261fefc6be2a79e27',
    'K18b-dense5-f32-(2048, 2048)-3-0':
        '4c048ce257f53ad6b552ec09e920c9a200d36153c3d0d56563abc233e754a4e2',
    'K18b-dense40-f32-(2048, 2048)-3-0':
        'e682b2f7fc108214bf30d38d984e756d00b74de1044190b7e76ec72e39a5e96f',
    'K18b-db3xcoif1-f32-(16, 64)-6-0':
        '44edb70ba4a094d0c7b2381ef746d7e2de6ca77bca0804ccaf85b4c5c648f3eb',
    'K18b-rank2mix-f32-(16, 64)-6-0':
        'c2c4e22c609cb84d583391ea932255147ec42e4704fc4ba5aa8c47be955f8d42',
    'K18b-dense8-f32-(16, 64)-6-0':
        '7c112c82c7cd20de44ea7c22ad338416ca5262c5e01fc327f5559283bd968458',
    'K18b-dense5-f32-(16, 64)-6-0':
        '5df885f856ae6a2066180855bc09fd10452c5c84c901a86d02a72399c5a60042',
    'K18b-dense40-f32-(16, 64)-6-0':
        'da95d966a5a9f9b6ef3068323581dd70242c287019010f2bbcb1d4be592e2fd3',
    'K18b-db3xcoif1-f32-(2047, 2047)-1-0':
        '1105c4b33625648aa2c2c06847a167000eb79f196faae2a39e897ca82ca0150a',
    'K18b-rank2mix-f32-(2047, 2047)-1-0':
        '4a05f77cc70afe6694426902260004f4bab8eade7b82a202c985b40507ee8f69',
    'K18b-dense8-f32-(2047, 2047)-1-0':
        '78c2130ab9c1ba48a59cf11ffd66f403f2ce24ec23f05051f4d2dc02977d322b',
    'K18b-dense5-f32-(2047, 2047)-1-0':
        '7ce9f6a61e7be5c37b361157ba1574020822822d5d67758ceaa1c6c55536c83a',
    'K18b-dense40-f32-(2047, 2047)-1-0':
        '425752f8593cc27fd457182e49d1c23e0ee8a0e8d7ed39582f6d0f2f21748cac',
    'K18b-db3xcoif1-f32-(33, 47)-2-0':
        '608a74005ff67b01e1986d3a52d739d6e4426dfda7307a14503f13440034be8f',
    'K18b-rank2mix-f32-(33, 47)-2-0':
        '94febc9ce82ca27136d41b189dc3ebd57e6dcaa7d82b5f7db91213eb96b0544a',
    'K18b-dense8-f32-(33, 47)-2-0':
        '65427ee38db7944571cf86664f146a1955c668f26187ac18fd0e1749fc5bec24',
    'K18b-dense5-f32-(33, 47)-2-0':
        '992e3f2abf823cd97f3cb797a0917806297defc28456c788d7f8183b063348f9',
    'K18b-dense40-f32-(33, 47)-2-0':
        '947f25bf202107f71a0cac128e7b905dee1b7a64d730857f7ccdd54d18136d20',
    'K18b-db3xcoif1-f32-(40, 70)-1-0':
        '516367d4411ae5fa8ace9587d74c9c872ee328e6e328cec2dd0ef397dd9549db',
    'K18b-rank2mix-f32-(40, 70)-1-0':
        'd14c023bfb81b472765512816e35bf2df706abe0c098dd0a406c5097e6da8f32',
    'K18b-dense8-f32-(40, 70)-1-0':
        '989ee0b2ba87762ccb090eebd8f85793e60fd13eee1732d41c4664024a294548',
    'K18b-dense5-f32-(40, 70)-1-0':
        'e8ce1675cef3a4b055e43b00cd34cce76ba26f95aa6266d82d13d5125728a5c6',
    'K18b-dense40-f32-(40, 70)-1-0':
        'd518f2da17aa51561aaf03e2503be02e3eded9ea938ef8bba558b89f24d17044',
    'K18b-db3xcoif1-f32-(3, 40, 72)-2-0':
        '2d0f127e025cffac6f576f28d1ad5ab17863b357d241ad440c79cc1813be811e',
    'K18b-rank2mix-f32-(3, 40, 72)-2-0':
        'bc3a2b1f4b4816914a8891c7873842bb1826b17fed09824d28be52913c1191ec',
    'K18b-dense8-f32-(3, 40, 72)-2-0':
        '1578beb15cdc545ff91b7c5ec1ff60738487a4e15949dfec1c5350538db5c5cb',
    'K18b-dense5-f32-(3, 40, 72)-2-0':
        'ed1546b0090fcb15ba7dd66179057add2b60a6510dd1fbf2d9c5583fbb439c98',
    'K18b-dense40-f32-(3, 40, 72)-2-0':
        '1de482becd91b4bc084297c8a5ac6640690b8277be63a919d960b5262a86ebb6',
    'K18b-db3xcoif1-f32-(2097125, 3)-1-0':
        '00705716989d76f836e06537fad0b1a341edb2e2406c0479b9dbffab7018c905',
    'K18b-rank2mix-f32-(2097125, 3)-1-0':
        '94d9f1e479bc7e53bb90eef0c4bfc50e13afac8a8127479ebf1ed3ddf858d0a3',
    'K18b-dense8-f32-(2097125, 3)-1-0':
        '410bcd0889bffb34995de0ca12a9b4194fd302ac11db22c23778436868b57aa8',
    'K18b-dense5-f32-(2097125, 3)-1-0':
        '0c77227e45f13827a20b6b793ae1e02dafbe3b905a8f2356cbc5c689e98424fe',
    'K18b-dense40-f32-(2097125, 3)-1-0':
        '458caa6e80db26d8bddad425871ea6af091bb9dbce659213d63a192edc592734',
    'K18b-db3xcoif1-f32-(64, 128)-1-1':
        '5c7e2dfae213399988b584444a08a8d3322b148bfb5d9e05f2430febc83b1735',
    'K18b-rank2mix-f32-(64, 128)-1-1':
        '7100acb71420927b0c3d2daf70300ea14def4a53776cb046a04e654c3c5e0aed',
    'K18b-dense8-f32-(64, 128)-1-1':
        '65912972cfcb6e692f59d11c43e0f99b563c01533efca04c6bc243524179d51a',
    'K18b-dense5-f32-(64, 128)-1-1':
        '604257d257401cb37f7241365b7cbf672d0bf309f23b9b2718737c1d7e2d83fb',
    'K18b-dense40-f32-(64, 128)-1-1':
        'e188d2dc4f5eaeb661dddf99c1bc582a0fda26a8bfe0c09cd3d3cd19c281bcc5',
    'K18b-db3xcoif1-f64-(64, 128)-1-0':
        'c19d731c0f1e3d7368884da5ecbd6832514d1c15f37d6ec97b37ed17506d58d0',
    'K18b-rank2mix-f64-(64, 128)-1-0':
        'e27fe6c97ec0a4dff61d80360c0dad1efa946cfe0a56221c02838dac13af2a89',
    'K18b-dense8-f64-(64, 128)-1-0':
        'ef0f6d6009ede769a1aa3893d2e95c7f0c39cd72cf46f2c9121f0fdce06330e2',
    'K18b-dense5-f64-(64, 128)-1-0':
        '1ae7bcfb2888b05580bdd5c0213da7cff61e09a73593323df6dedd994bb6c3c3',
    'K18b-dense40-f64-(64, 128)-1-0':
        'ee6ce1af7470151a84cd7357b64de09e86e4d9070eee2e644925fa2ec9b95e29',
    'K18b-db3xcoif1-f64-(2048, 2048)-1-0':
        '3b48cc290b646c87451b876814ccc524a46e2b08c9e989c0a60251b42f6af5ae',
    'K18b-rank2mix-f64-(2048, 2048)-1-0':
        '21a716a0a98c1dbeb1a092f7389e246fc67d3455361fd638675477195a8fb21b',
    'K18b-dense8-f64-(2048, 2048)-1-0':
        'ce269bb4985ab837ebbdb20343e2507235930756721ac2ec6f60ed51915dbc46',
    'K18b-dense5-f64-(2048, 2048)-1-0':
        '050531ce07cb42982abe4cc387801e64d2288c2306a4c940cfd50d2c4526893b',
    'K18b-dense40-f64-(2048, 2048)-1-0':
        '1a677de7b0940711f91c53a4607c8b739bd5a55b915f6c8f3af898fc631be641',
    'K18b-db3xcoif1-f64-(16, 64)-6-0':
        '883642a96d95823560f14773b732b1be0a4ac6c0c00bcd9f0584c5c88c060040',
    'K18b-rank2mix-f64-(16, 64)-6-0':
        '045653a42cda32cfaa296606fd5c0178d9c00363a19f5c55a7da0a892eb4d4e8',
    'K18b-dense8-f64-(16, 64)-6-0':
        '6c52e85cfbe845dedbee311d453cbcf8b6be629d53ef6411523cb23dfc03dacc',
    'K18b-dense5-f64-(16, 64)-6-0':
        '79c762d9bfa4a2c79f846af5109929868af0a6e965cbb32b9638c6fb190cb63c',
    'K18b-dense40-f64-(16, 64)-6-0':
        '330ca9d073131d0571948d5c9e4a3fe365538932a8932b04f02937b5863b8907',
    'K18b-db3xcoif1-f64-(33, 47)-2-0':
        'd7d98d684d5e513073da3f7549bacaeba1f62fd696010810bf85a58147d2a550',
    'K18b-rank2mix-f64-(33, 47)-2-0':
        '1e4e55793b9c95af9eb0de77de41cdd2fd3901d30bf9ce0dd98f36e9f2f9cbdc',
    'K18b-dense8-f64-(33, 47)-2-0':
        'c45e553b8fd86ccdbca94d845ad2d84b44785782e003bf79f5e5ccc25285eb7d',
    'K18b-dense5-f64-(33, 47)-2-0':
        '7a4c13e6a7c7410b7fca9ca4442d5682485de26b5019d20e4514bdc5cde9c264',
    'K18b-dense40-f64-(33, 47)-2-0':
        'd94efc600fca0393cccf50ce786298fc5d1b54cc73f620ad03f67841ce5301c1',
    'K18b-db3xcoif1-f64-(3, 40, 72)-2-1':
        '8fa438ad7cbb502092d185f8ee3a829b36f4e00a953d414614e6e0db31b2c4b6',
    'K18b-rank2mix-f64-(3, 40, 72)-2-1':
        '2982883baa5a0babfcc502143427558159ebce694e4e8247eaebd27c0f7aec78',
    'K18b-dense8-f64-(3, 40, 72)-2-1':
        'dab104a84cdbc17011d15c8bdf0ac9f8400b1e885168154fb9c1e33b0a2a1e8f',
    'K18b-dense5-f64-(3, 40, 72)-2-1':
        '47b7fb09c947e6d289af285ae6af99e498bab929f578a52d112c6f6f87e51aef',
    'K18b-dense40-f64-(3, 40, 72)-2-1':
        '69d99daa01ea8b34388e39734473d215adb5b0726e53f03071df397f09530995',
}


# K12a / K12b, tc_swt1d.cu's class-window body: each output against its
# plain version and against the SHA-256 of the output that the body before
# its redesign (a block per item, windows staged sample by sample through
# registers, every output through a shared tile) gave on the card for the
# same seeded inputs; `python tests/test_torch_kernels_cuda.py digests K12`
# prints K12_DIGESTS's form. Banks of hlen 2, 4, 5, 16 and 40, both
# precisions; (rows, n, level, input offset, output offset): levels 1-4 of
# 8 rows of 256; n not a multiple of 4 (130) and odd (75: the dilation
# does not divide it); short rows packed 25 and 21 to an item (64 x 40 at
# levels 1 and 2); rows that wrap within an item (5 x 72); 32 classes an
# item (2 x 4096 at level 7); inputs or outputs one float past a 16-byte
# boundary; and the timed shapes, levels 1-3 of the 2048 x 2048 sinogram
# and of the (1, 4 Mi) signal. The C entries are called on outputs made
# here, NaN-filled; a case whose dilated support passes the row (which the
# wrappers refuse) is left out.
K12_BANKS = ["haar", "db2", "odd5", "sym8", "sym20"]
K12_CASES = ([(8, 256, lev, 0, 0) for lev in (1, 2, 3, 4)]
             + [(3, 130, 1, 1, 0), (3, 130, 3, 0, 1), (2, 75, 1, 0, 1),
                (2, 75, 2, 1, 1), (64, 40, 1, 0, 0), (64, 40, 2, 0, 0),
                (5, 72, 2, 1, 0), (2, 4096, 7, 0, 0), (1, 1000, 1, 1, 1)]
             + [(2048, 2048, lev, 0, 0) for lev in (1, 2, 3)]
             + [(1, 4 << 20, lev, 0, 0) for lev in (1, 2, 3)])


def _k12_fits(case, wname):
    hlen, level = _bank(wname).hlen, case[2]
    return max(*conv.swt_pads(hlen, level, False),
               *conv.swt_pads(hlen, level, True)) <= case[1]


K12_PARAMS = [(kind, case, wname) for kind in ("K12a", "K12b")
              for case in K12_CASES for wname in K12_BANKS
              if _k12_fits(case, wname)]


def _k12_id(kind, case, wname, prec):
    return "-".join([kind, wname, prec, *(str(v) for v in case)])


def _k12_output(kind, case, wname, prec, dev):
    """(kernel output, plain output) of one case (K12a: lo and hi stacked):
    the C entry launched once on seeded rows at the case's input offset,
    into NaN-filled outputs at its output offset."""
    fb = _bank(wname)
    rows, n, level, oi, oo = case
    bf16 = int(prec == "bf16")
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _build.load_library()

    def empty():
        return torch.full((rows * n + oo,), float("nan"),
                          device=dev)[oo:].view(rows, n)

    if kind == "K12a":
        x = _offset(_rand((rows, n), dev, 12), oi)
        lo, hi = empty(), empty()
        taps = [fd._host_taps(f) for f in (fb.dec_lo, fb.dec_hi)]
        err = lib.pypwt_tc_swt1d(
            x.data_ptr(), lo.data_ptr(), hi.data_ptr(), rows, n, level,
            conv.swt_centre(fb.hlen, False), *(t.ctypes.data for t in taps),
            fb.hlen, bf16, dev.index, stream)
        assert err == 0
        return (torch.stack([lo, hi]),
                torch.stack(kms.swt1d_mxu_plain(x, fb, level, prec)))
    a, d = (_offset(_rand((rows, n), dev, s), oi) for s in (13, 14))
    out = empty()
    taps = [fd._host_taps(f) for f in (fb.rec_lo, fb.rec_hi)]
    err = lib.pypwt_tc_iswt1d(
        a.data_ptr(), d.data_ptr(), out.data_ptr(), rows, n, level,
        conv.swt_centre(fb.hlen, True), *(t.ctypes.data for t in taps),
        fb.hlen, bf16, dev.index, stream)
    assert err == 0
    return out, kms.iswt1d_mxu_plain(a, d, fb, level, prec)


@pytest.mark.parametrize("prec", ["highest", "bf16"])
@pytest.mark.parametrize("kind, case, wname", K12_PARAMS, ids=str)
def test_k12_body_matches_plain_and_parent(dev, kind, case, wname, prec):
    got, ref = _k12_output(kind, case, wname, prec, dev)
    _close_prec(got, ref, prec)
    assert _sha256(got) == K12_DIGESTS[_k12_id(kind, case, wname, prec)]


K12_DIGESTS = {
    'K12a-haar-highest-8-256-1-0-0':
        '14e4b3bc91cdb03a804e1ed8cc6502a9322bb11f649df23e4b2ccd15baaf9d42',
    'K12a-haar-bf16-8-256-1-0-0':
        '1f72941e8d224f3b3133537edb0c5515903deb83548c483e6f27dab8d7bf19df',
    'K12a-db2-highest-8-256-1-0-0':
        'c45f8960bc707decf6947dc5f6c7641a98b550c20d46124142d6cd8155e2f661',
    'K12a-db2-bf16-8-256-1-0-0':
        '20f08d116d330e62611e1c38cc7697946b1a9540c88263020c3f46e36ef80065',
    'K12a-odd5-highest-8-256-1-0-0':
        '6a18948469864e7d991cc687a75ae794c853f0ab2011ee3170e646ac934b8dd2',
    'K12a-odd5-bf16-8-256-1-0-0':
        '776d125c95a3b51863fdd548ec06e49d8cedbb6cecd27d6d1cfe7540e32485a5',
    'K12a-sym8-highest-8-256-1-0-0':
        '2ecd9a67a4fd53cb04f63e57f1f06816eb45897cf7ba2684341371b942ee6aa5',
    'K12a-sym8-bf16-8-256-1-0-0':
        '3b8fb89d4e66825a7c189179f4934121886b2be90802a4a707f831c6ad4bde51',
    'K12a-sym20-highest-8-256-1-0-0':
        '9865cea19efafac779cdfc45e24334ed2972c80941bf24ccec2feb3d95c1178b',
    'K12a-sym20-bf16-8-256-1-0-0':
        '9b8f6658c34812f8286d5ee6ac79c7ce0b74b6ad11306614f39dbea053f85d3d',
    'K12a-haar-highest-8-256-2-0-0':
        '1db62bca6ea305842159a6c2b35bcf5b53ac40a27cefa2f247d17a0dab95ade4',
    'K12a-haar-bf16-8-256-2-0-0':
        'd468c5d62b6047af68f8f88eccaf3c6df103fe43ea5ac612aab9e0479e42ca0e',
    'K12a-db2-highest-8-256-2-0-0':
        '61fdbf55c292ae200743017ae4bbc345f011a8d6b7099ede308c6bffaf1f0be4',
    'K12a-db2-bf16-8-256-2-0-0':
        '3380936fb1454ea8257a314e75e4f9699b724751ee35622c05797a6fa8b7b959',
    'K12a-odd5-highest-8-256-2-0-0':
        '4c30721a5183d84368770e19d0015d540e422808abab4c5b07e302cdc1e4c8a5',
    'K12a-odd5-bf16-8-256-2-0-0':
        'dd128a8015d815d4113dca4ae9fe62cd9edffc848fea69f2735189b4c9c26b07',
    'K12a-sym8-highest-8-256-2-0-0':
        '3a02fa87db9937de6dffa8d9a8d6b378eb2475735484cc031b1640a7f6a17d5f',
    'K12a-sym8-bf16-8-256-2-0-0':
        'd81fbc8ec966bde3d63282aac401f8da6ab307ac0fcd76adbf5b158d27dff4f4',
    'K12a-sym20-highest-8-256-2-0-0':
        '97ad35bb834a926fbd6453c6f3b8a1ff0e19ed47a5a4864e9533badc8259b6c2',
    'K12a-sym20-bf16-8-256-2-0-0':
        'c06d100a155d81afc6fea70bf4ee7f2a390fd075894522d3b995614aa5f21848',
    'K12a-haar-highest-8-256-3-0-0':
        '2cb67cc678a4e2512fb37b1aea16f3d3efb474e48d2a014d6e26a3623e6b60e7',
    'K12a-haar-bf16-8-256-3-0-0':
        'dc5f35db7438a354081870fc036dd8c2ba0e50264c4087a9c73878eee03b7c41',
    'K12a-db2-highest-8-256-3-0-0':
        'db1b04843408131fd09b5609d55d79a644d6dc5225281fc530fa593e318e9df2',
    'K12a-db2-bf16-8-256-3-0-0':
        '1c7aeb70d96d45d7e93e939b4639b8f3dfffc161cb14605cedb39480a692c17a',
    'K12a-odd5-highest-8-256-3-0-0':
        'd5fbb72f481e7ac6161756e15aa77488d3688ed88440bf56b003dc3ed8a18b35',
    'K12a-odd5-bf16-8-256-3-0-0':
        '929f24489bbadfebf28ddd7759221292e310042293adef7be46893ee6da0590c',
    'K12a-sym8-highest-8-256-3-0-0':
        'aead391863692f3243ee713ac79356ba37444037292d297f0cb99c21b366103a',
    'K12a-sym8-bf16-8-256-3-0-0':
        'e551526095226b547fa3bd6272c14e2504ab47574f5d2b264625f4cd48687595',
    'K12a-sym20-highest-8-256-3-0-0':
        'f0f6ddc2df08dcc164fe72bb482c627d6a07db5f270af308745e99204da2cc15',
    'K12a-sym20-bf16-8-256-3-0-0':
        '9e94a6ecccaba65165082d14adb7a997581138a42e77083f82ac5d3b5c052b94',
    'K12a-haar-highest-8-256-4-0-0':
        '3dd2b47c394bb208d9a6c3336d4afa1f6a72a4e383d51bde9c61c429c6cf7682',
    'K12a-haar-bf16-8-256-4-0-0':
        '10a3be69ed77b98d281516623f4d606881161a947e3da0ab2d94ba5caae4a7d4',
    'K12a-db2-highest-8-256-4-0-0':
        'e979db00063640ccfecd56c74c9a095a544db745b1bc2cea1cd09f88eb5a3ee6',
    'K12a-db2-bf16-8-256-4-0-0':
        '888ab20e30edb19432107f690d0c405fc96699293be2645414b04ceba2b16f41',
    'K12a-odd5-highest-8-256-4-0-0':
        '0e7897537a47146dae4bc0248e73d89b998460eef1e737ac7741cdded17b2040',
    'K12a-odd5-bf16-8-256-4-0-0':
        'e3bef1315371ef5789cb2e7ee4c7d2739f92b486d41b8157986f63a698866e6e',
    'K12a-sym8-highest-8-256-4-0-0':
        '8df96e8a73e36bcf87d55050d4a5f5d9d0cb73e9d4f9d21170bd168d9794aa71',
    'K12a-sym8-bf16-8-256-4-0-0':
        'b3ee2620dec0eab2914f741d3accfeb2458842f688787f51751d6469f99e9422',
    'K12a-sym20-highest-8-256-4-0-0':
        '37b8e9655bd1e7aa5ca5ea82286740016c64169de73cac847020a61c1e76849b',
    'K12a-sym20-bf16-8-256-4-0-0':
        'ea47b7876bf66505c7294d6c33e433082d2b1bd4c9cd41060ad13b6f8c4040d9',
    'K12a-haar-highest-3-130-1-1-0':
        'a488612834786ef3568d545086c83e9b15ef24ca92d7875d7abd45a00728ab2c',
    'K12a-haar-bf16-3-130-1-1-0':
        '164697975bc4865b7e0d0dc3dfe62c02217ecce724675836d7d1962b08e5a454',
    'K12a-db2-highest-3-130-1-1-0':
        '4b343204d03418a0a8c818c3f6411e0d27c097b979d65742dccb789de41fac11',
    'K12a-db2-bf16-3-130-1-1-0':
        'cbf8f03cc44cfe715144d0433f0069ed646fe4643c30677777c3d0d02eea9b17',
    'K12a-odd5-highest-3-130-1-1-0':
        'd1f697bf4fbe4bd616b021fd0187b698347a9aa2ab7b1b2e2938fb064bea6aeb',
    'K12a-odd5-bf16-3-130-1-1-0':
        '96f53290a82b277e71b6d0a37a47156c76e6d6101efa581e7ff8b8c31ac9f372',
    'K12a-sym8-highest-3-130-1-1-0':
        'bbb4974120139e5bf92f43e735d750dff5a8268ab15befff4c6861a24c514c48',
    'K12a-sym8-bf16-3-130-1-1-0':
        '72cc5724a2be66f98967a9abb0e8236dfa783f9da811ff2ba32d3bdb23858c37',
    'K12a-sym20-highest-3-130-1-1-0':
        'eb99a1ec47531da949c88b0193d64c322d14ea75fe544df4274e24134a764557',
    'K12a-sym20-bf16-3-130-1-1-0':
        'c102b72659c75d078c0c45cb960c30f8364d7b14538b695716758c8f075f0b49',
    'K12a-haar-highest-3-130-3-0-1':
        '51af3cfa7eaf5d3619f9160f1b05e41ba44c00d2a5bdb3d35b03e07f53dec5df',
    'K12a-haar-bf16-3-130-3-0-1':
        '9e3bc9f212e01852d3728e59caef13a9a67113d24c1954031309a6cfe4fb8c7a',
    'K12a-db2-highest-3-130-3-0-1':
        '0898014446ef0dfd6c0f1f235c56e9e21b544d65be5dcd31c65df865665bee45',
    'K12a-db2-bf16-3-130-3-0-1':
        '0887bed601e7b45024b5ce298e64082f652f6d965039b0d24fe01a8a7213dcd4',
    'K12a-odd5-highest-3-130-3-0-1':
        '22b0121445637517a2986993cccac40d0529c488b9e4d3890447d9929fca411c',
    'K12a-odd5-bf16-3-130-3-0-1':
        '773a2f135d735a99b91d6e4c6627fc4ada1b6ba38714cf5000f135ac04efc464',
    'K12a-sym8-highest-3-130-3-0-1':
        '2ab9220c64184df2875d7c551640bd73d1416dcc2aaeb25baf9415cde896a61f',
    'K12a-sym8-bf16-3-130-3-0-1':
        '792c623b47a7374bcf22fde7ea2c242aa7cc7f93b5096411d6a128b0a5234bc9',
    'K12a-sym20-highest-3-130-3-0-1':
        '5f97047f663c9889e9109e06b4e7cae5b6a915e3fc9ea7658e8914b2fa11e77e',
    'K12a-sym20-bf16-3-130-3-0-1':
        '5b467685ff7160c1e63213ac1bf600c28040bcfc12375744aebe0e07fd1a52ec',
    'K12a-haar-highest-2-75-1-0-1':
        '8f1006bde2ebc10f5da25023e605167619070a5da73b69dbc6fdbd309ce3fff0',
    'K12a-haar-bf16-2-75-1-0-1':
        '4b10dd30f5302f66e76106eae6e99d656745008e1734a573875360707eb01d69',
    'K12a-db2-highest-2-75-1-0-1':
        'bac03707968f885382c8666d839dd6bbaf7e760a26464e3d0e6581cda3f05f9c',
    'K12a-db2-bf16-2-75-1-0-1':
        '3c85a0a4b61aab8c697c3db8697112bccb6ebc9f3bc8f0da83f7de8a2fbf6bff',
    'K12a-odd5-highest-2-75-1-0-1':
        '1b715e4df27837944a1c148b7f0fa9aad73841ec9fc0671d82fa667d175602e8',
    'K12a-odd5-bf16-2-75-1-0-1':
        '65657916ee6b6bc3115edd126bda60e87427579482fcb14d9d1085f05fa9007a',
    'K12a-sym8-highest-2-75-1-0-1':
        '6642d901a5cd497331c479309ee28fd014814cbc4e2605f4bfcda54951314baf',
    'K12a-sym8-bf16-2-75-1-0-1':
        '1e079d3951eff23ad06f1d144b13e8e7b0fe8317ae52c7fc604d03f353cca35e',
    'K12a-sym20-highest-2-75-1-0-1':
        'fd7394520ee3560450657a6c288269dd3763cac7478c88b5a6df5531c3cd740d',
    'K12a-sym20-bf16-2-75-1-0-1':
        'a064491924f435183897a20ff6fbfc1891636a67d32bd7b45322a51fd30a46c3',
    'K12a-haar-highest-2-75-2-1-1':
        'a1ccc0ea53ad725a56ffe55b8ec58e11acf9997f757b8e7ab548f81e254d0c97',
    'K12a-haar-bf16-2-75-2-1-1':
        '02f4f91605e717954bcd50a79c4ed9718d7944d7c92564880f817397838571a7',
    'K12a-db2-highest-2-75-2-1-1':
        '5bfd45f031507e0aad57744336cd54f036fe2b9a770226e8bbf030ee53b02b0d',
    'K12a-db2-bf16-2-75-2-1-1':
        '6f4ef7643f4d937f899dd3cc248f6b3e2fda982d2f621c0dc0fc92bfaf138b66',
    'K12a-odd5-highest-2-75-2-1-1':
        '40040fd362973ae6353e09253355e5df0e4179c93617dc3c1085d7b7a95bc478',
    'K12a-odd5-bf16-2-75-2-1-1':
        '7a055e8472344b72811b18148851dd2243de9de20bb76e54e94d9c439b4b01f1',
    'K12a-sym8-highest-2-75-2-1-1':
        '309827921da0f4221ee6779812fc61b501a033efe7ea6138b655f31a09aef09f',
    'K12a-sym8-bf16-2-75-2-1-1':
        'fec3a2689e49bfb132d69bafe9bcba1d90890e274ac575e47e340a37e478be65',
    'K12a-sym20-highest-2-75-2-1-1':
        'ca21a2f73b96f4113b53828e3f8bb4c430c13fc1e8ba4d18c445cfb270ca69b5',
    'K12a-sym20-bf16-2-75-2-1-1':
        '394296c9c2b7079a96ee7b11f28b9f251f7f9ad156dba5a529192d5ff8540c69',
    'K12a-haar-highest-64-40-1-0-0':
        '565fa0c352c6d9ce8445754783bc4fe6e077a6117ce99e107ce5fe8200e42b22',
    'K12a-haar-bf16-64-40-1-0-0':
        '028deb90e9e0005c5ce837d5f9917101028595c2acb5313242cc9a0446520b34',
    'K12a-db2-highest-64-40-1-0-0':
        '18314ecf2456667ff8045c3a2e037b21e66c4363aa1c4cfc461f6987d865e7b6',
    'K12a-db2-bf16-64-40-1-0-0':
        '02712c665b9794026375510119b010b070c97c66c9e1c844fcdbb829a58dc988',
    'K12a-odd5-highest-64-40-1-0-0':
        '558a999746de382b8a5d326d5647d6f53fa77452a2d5bfb8b22a5e8e1c2f5f4f',
    'K12a-odd5-bf16-64-40-1-0-0':
        'f5d1706ffc9fe755c4de66b7a329e3ee79dccba773ebc8c8fa2239954f0bc68e',
    'K12a-sym8-highest-64-40-1-0-0':
        '89c4daa699fc4545275110803074fdec08c61af5411109da3b456bb54c1fae3e',
    'K12a-sym8-bf16-64-40-1-0-0':
        '27706eebe2f2a46fa8fc00c2f3e66c6fa7793b14cd711701e39e757f0005d044',
    'K12a-sym20-highest-64-40-1-0-0':
        '77622390503f6e78584856a7da97726db1ed7ff6078d32c7acdd768dbddd992d',
    'K12a-sym20-bf16-64-40-1-0-0':
        '04220f760080d20feeb617ca2e27170e8699e60a5b357768e5f6da54cbfe358e',
    'K12a-haar-highest-64-40-2-0-0':
        'c3d9a3bca225000e9a8cf02f9a1656b21d5b71eb716f1b4df3a6239b59064b05',
    'K12a-haar-bf16-64-40-2-0-0':
        'be579ce19f2ec0321c8cba59deb1834e521940c550a7daf296cddb1fa541a0dd',
    'K12a-db2-highest-64-40-2-0-0':
        '4db259d5375af9543f2ecb5683ec2f45bd679318829cb8c5e51aa2cf32257430',
    'K12a-db2-bf16-64-40-2-0-0':
        '835e4d5e8ed9aa7ccad09e182de0389ce80ebc85793e90a4d9fccba42ac9457c',
    'K12a-odd5-highest-64-40-2-0-0':
        'f9dfb0b9fd843678d14d4e893aa83417f247d0827066c0bf2bc23ea3924b10bf',
    'K12a-odd5-bf16-64-40-2-0-0':
        '38b977537799af9831b49acbf5d03a06250a835a76a3f0d11060054d014b8c14',
    'K12a-sym8-highest-64-40-2-0-0':
        '2183ca52a8d442590079e36c1a39fcc8716196058bc171a53c50a76a176ebf4f',
    'K12a-sym8-bf16-64-40-2-0-0':
        '5b18e09031fc2f0896e8bde8fa23ecbdfcd6562789b50672e614dec4d54ac249',
    'K12a-sym20-highest-64-40-2-0-0':
        '320b5efa2280582f105258d2f8eef6ff47285dbd79004832f2ede67078705a46',
    'K12a-sym20-bf16-64-40-2-0-0':
        '0fcbb2b5ab5fe094d93f192cb347a56baaa036055b66a581a4fdea09dd4134d8',
    'K12a-haar-highest-5-72-2-1-0':
        '782ef7703cfc7bec9d3c3b304a6238797ba4c4ac3e74200ad76a9fccc5f1e01a',
    'K12a-haar-bf16-5-72-2-1-0':
        '3f0fd6a151f1b51ead9da8a72893836925580463c73055d8092e21590ac167a1',
    'K12a-db2-highest-5-72-2-1-0':
        '7e7bf4862488491da0a4a3e3017fe9403fdba0b44176b3322a22a3a8d5931b96',
    'K12a-db2-bf16-5-72-2-1-0':
        'c571c11bb146a370eacbfe91c741e838a8d358a72f096986e2d3c98681eefa22',
    'K12a-odd5-highest-5-72-2-1-0':
        '474d42f42d761be4c2b29c4c0d4bc77bf326bd6e487463ad73e6a11d2eead3e5',
    'K12a-odd5-bf16-5-72-2-1-0':
        '0e5a8628f4b9c7aa878faafde138a55dfab0efc9f0cfe23a021379bd94c92c88',
    'K12a-sym8-highest-5-72-2-1-0':
        '2e93dc17c800861f292e2b5d8a2a8a3caa5f7a4de1e1b18425f33d8a59935008',
    'K12a-sym8-bf16-5-72-2-1-0':
        '9a50b8e7d368d0e32333fd84638729cdbf19a520331cce229eff2fab7044e66a',
    'K12a-sym20-highest-5-72-2-1-0':
        '93ff820b63935f1baa7f96d4e87629b496b0b124caca250619cf8c5513b52686',
    'K12a-sym20-bf16-5-72-2-1-0':
        'e0c82a4d96e17aaf336956394dd0b12d2416b0b80562052c34769b513c9151c6',
    'K12a-haar-highest-2-4096-7-0-0':
        '385f0b98afb0366c43fdd790d7c45e41cee9d6b05345615a4397f2624e61cb78',
    'K12a-haar-bf16-2-4096-7-0-0':
        'ac38e8e10f44023a00f4b0a61ffd48b80c854522219de1c74822799196318b9e',
    'K12a-db2-highest-2-4096-7-0-0':
        'b24c1c9f8c785aa36cdf8e25890a3cf314e77a7db95e56786153a19c41f19612',
    'K12a-db2-bf16-2-4096-7-0-0':
        'b8f4713120455e91d16577d3a34d6330d2d5865caf3c7d27c032e8649c7ffdfa',
    'K12a-odd5-highest-2-4096-7-0-0':
        '4c7b2d419caa666b9088ce7dad3b20b58755e09859d5af54c6179f09f4f74516',
    'K12a-odd5-bf16-2-4096-7-0-0':
        'f0812e203de4e759355dee5525023aa088e8819f6a4d225f6b9b8b7a24dacb54',
    'K12a-sym8-highest-2-4096-7-0-0':
        '1302229bae6642bf5ee5b5f2461b7190cc5abcd907fcae9dd28a2da7f012b1fb',
    'K12a-sym8-bf16-2-4096-7-0-0':
        'b378f2a19e911634046186c9b68fb69904b1ed345ddae04df78a12df97403804',
    'K12a-sym20-highest-2-4096-7-0-0':
        '50ae40049fcdf10e6374c05925208dde72eebd0b4554b8caa3ae6d33dd974f91',
    'K12a-sym20-bf16-2-4096-7-0-0':
        '94e0106e37d77420d41dcac64b115847aa8e312a1c5d26c4412c73dda45b47d7',
    'K12a-haar-highest-1-1000-1-1-1':
        '8f650c43ec34c29bb6e1878f2ecd5105a4225c29c6a04725a3aa00d4ae692c2a',
    'K12a-haar-bf16-1-1000-1-1-1':
        'd44f13546a4189d34bbb7176542ea709b8215e8a6bdec60915a2639d574b7794',
    'K12a-db2-highest-1-1000-1-1-1':
        'a17b07752aac2887e49e5fc99a56192ac19f67981e2250d519ffc6d1e9b56673',
    'K12a-db2-bf16-1-1000-1-1-1':
        'ffbc9ea432bc7087e659283ab66dfcf8db12d38792bcdb7a4fd88f5898f1d88f',
    'K12a-odd5-highest-1-1000-1-1-1':
        'b6819c4606c9157673aa7d403f806278ee65184d5cc3fe6b457fc90135b9377f',
    'K12a-odd5-bf16-1-1000-1-1-1':
        '7922fc86c6053085a251e9e17cb4e5f4f3b6d3d01e8442e2eaf080af77130b6c',
    'K12a-sym8-highest-1-1000-1-1-1':
        '9621d68fda2f7ba56190d310b43c1c59893b90bf79500738da87ca77fe613fa5',
    'K12a-sym8-bf16-1-1000-1-1-1':
        '2e1e2d70a593acd4e2e24096afe6abc7c5f0a61d9ceb38846156af82965ecd53',
    'K12a-sym20-highest-1-1000-1-1-1':
        '68b3efcbca85d32a4623ec25a70b27f4aaa536f2b5e0abf3e89d5b6edf368bfd',
    'K12a-sym20-bf16-1-1000-1-1-1':
        '9657d72bc8a32be3e3b4d7501367e949bf1288f90ab862118d8adef8b38245d4',
    'K12a-haar-highest-2048-2048-1-0-0':
        'e3dfa6f5b53b4bff5b14f409d0762385daa0a0d2132a7fc6b5af060e3985dd49',
    'K12a-haar-bf16-2048-2048-1-0-0':
        '817f28ef09e20f475874ffeccd1a95b11d758e49320ccbbc8d5605b02ac8a4ef',
    'K12a-db2-highest-2048-2048-1-0-0':
        'c1d765f2f672dba47418943a92b9368af4a314c7f2ad392285740ad64fd02208',
    'K12a-db2-bf16-2048-2048-1-0-0':
        'a59ec7cc79ad5ff90c6b97f06995ef4a39b00cd6b9fd57efd4543a84d26a8223',
    'K12a-odd5-highest-2048-2048-1-0-0':
        '13a97134b93e33ffb37b715f3c72ba59d62a9dd2ba74d9ada368239f41725e5a',
    'K12a-odd5-bf16-2048-2048-1-0-0':
        'cf9d551582c2951669f90c41f387683023d386e0b97f906ff7c0cb13f33c2eea',
    'K12a-sym8-highest-2048-2048-1-0-0':
        'e3034c7095743d6dee5818277dd67771f12d3724376e50636a50b19f6c00a13e',
    'K12a-sym8-bf16-2048-2048-1-0-0':
        '50375443dd3acfe713339ee552015a0aec720a61c558899ff0f29dc63802860c',
    'K12a-sym20-highest-2048-2048-1-0-0':
        '291dfc1c9c0ca8292fea86b173272e220f28636f77940765c53a3b88e283014e',
    'K12a-sym20-bf16-2048-2048-1-0-0':
        '74393e0734730c9b6896b3922e9201d7acd7eeef649502e9d0ebcb2c0f774bef',
    'K12a-haar-highest-2048-2048-2-0-0':
        '512879f0fdd00e07c6648c6fd0a8309ee97941098ee9f920b57d29564e4f293f',
    'K12a-haar-bf16-2048-2048-2-0-0':
        'd15507f7647a4da66bbe039725e37ee89e4c1966bec06643071387288f89fa8e',
    'K12a-db2-highest-2048-2048-2-0-0':
        '245f9f7a17f7038243d988bc5cf90fb0505c467c34e55795ca50e217459f5e59',
    'K12a-db2-bf16-2048-2048-2-0-0':
        '3f6197bb538bcf801484f22bc44fb85b1bffb64846a7a424e002242cfb0d63aa',
    'K12a-odd5-highest-2048-2048-2-0-0':
        '234000eda75d2359d623170ca5beb792195139a72e7e5158905901f7d3251f4b',
    'K12a-odd5-bf16-2048-2048-2-0-0':
        '83c228e443e3f03b0835cf3b8d54fa87972846f5204f7ec70e3a849d00251e15',
    'K12a-sym8-highest-2048-2048-2-0-0':
        'ee022cfc7f14b23d1677b08e83246d7fcb19febfca158108c54d385d213bc64b',
    'K12a-sym8-bf16-2048-2048-2-0-0':
        'b7487ccc4424ed1a2ba7b48c4c60ba94a7cd7180de6acb5b582a44c6a3dc2d23',
    'K12a-sym20-highest-2048-2048-2-0-0':
        '2c0300a1da94aadb2c50877c4ea1073a50187c31fa0d350816e1025d1b54b873',
    'K12a-sym20-bf16-2048-2048-2-0-0':
        '4ab121da8e988aab73424020e891494f44929711639532e4c204992b5bbaf650',
    'K12a-haar-highest-2048-2048-3-0-0':
        '1e5c6b4b6972730ecbe06c3ccf6fb832ebed34bc3305df5f9f73d4c9c1120019',
    'K12a-haar-bf16-2048-2048-3-0-0':
        '0c2973bb261217cfc110182f1f8727bfa143ab5f59aa0c037eeecfce64ce783d',
    'K12a-db2-highest-2048-2048-3-0-0':
        '4eaa805c38f7d7a7750c7cccb1c680255f4952be4a2ffd7a40b2241e8e5ea4b0',
    'K12a-db2-bf16-2048-2048-3-0-0':
        'c781b923b914ab4b8e36af1c42f7d4330863fa300fe33767f25181ccd764c13d',
    'K12a-odd5-highest-2048-2048-3-0-0':
        '0ec0d2088f9b381cfe99c19ea61a410bc4ddf5f0f7901daca52955848b475828',
    'K12a-odd5-bf16-2048-2048-3-0-0':
        '21d717b812b59d4f9f005ed60f88da7a3ac15e2f431d5e584b326405fc19b0b4',
    'K12a-sym8-highest-2048-2048-3-0-0':
        '248c28784473eda499779d1bb8aeb2f9f25dfc2636cb0ae46d9f4b5ef6bdc1a5',
    'K12a-sym8-bf16-2048-2048-3-0-0':
        '0e2f039e6f3d378fb2cafab909f81c3765a2d6bf743550f90224392e076ac33d',
    'K12a-sym20-highest-2048-2048-3-0-0':
        '2e3306a06bbc7bae7b34c03081e74f6cff7cf499255f6c4a04aeb0879882122b',
    'K12a-sym20-bf16-2048-2048-3-0-0':
        '71ba10ef8554f6057c7e61af8eacf805c78ca4d97998d02cf1d47a3df802b2a7',
    'K12a-haar-highest-1-4194304-1-0-0':
        'e37cdafb62446c7fe88a2461dd792d39b3153712557b3580f548d01fd7280bf5',
    'K12a-haar-bf16-1-4194304-1-0-0':
        'fe29e800f781a0776d25a901b168c5b9087aa44e43fccd32abdd689240dc9d96',
    'K12a-db2-highest-1-4194304-1-0-0':
        'df2393fb3bd04732688bf5a136d4e56f5fda03c8ec83a0ac4646a6e11f545bd5',
    'K12a-db2-bf16-1-4194304-1-0-0':
        'a50461425fdb3a3de7e5fc73d9c1b40f704a4f68e61aa44d9d22504986a4192a',
    'K12a-odd5-highest-1-4194304-1-0-0':
        '614a9cb0ad717453debe4879c38eaa5edfd1f1bbbd706be67321c0e1751d356c',
    'K12a-odd5-bf16-1-4194304-1-0-0':
        '6193c24783d70df6c990677953c0b8bbc53f8f11b097b61675093b20f86b4147',
    'K12a-sym8-highest-1-4194304-1-0-0':
        '2e13932a4114765ce3146dd62ea5656cb8b57234a721157a69324ee82b8a13fc',
    'K12a-sym8-bf16-1-4194304-1-0-0':
        'bd12f48c86f63e73bb086f02e194b9d97a1fb6c2566b1deb965c9189a7653bf2',
    'K12a-sym20-highest-1-4194304-1-0-0':
        '65d75aa2557786c55855ccc5b54712336fe41ca853cdd8ada63892c5356a42c3',
    'K12a-sym20-bf16-1-4194304-1-0-0':
        'e1cf71d74567d1b9485bcddbaa083ef2ef62f9ad19dee056671068019648580e',
    'K12a-haar-highest-1-4194304-2-0-0':
        '1ff5989afbff13315b07b3f0ea3d59efcdec2436c98b6426f28a1aff9c172bc1',
    'K12a-haar-bf16-1-4194304-2-0-0':
        '323b963d2143af076171a1b5cb321931aa0a4eb101a5e2a0db6cc49dda09b7f8',
    'K12a-db2-highest-1-4194304-2-0-0':
        '211cefa177aed6c87a55addd1f23a56934284963136d96edb88b7f287590ed8d',
    'K12a-db2-bf16-1-4194304-2-0-0':
        'c27f0165e41c243eb6011ac12c2f0403d92e5951beb75c48610cc292f82fa5f3',
    'K12a-odd5-highest-1-4194304-2-0-0':
        '65c97eee72c4272966f222b70df4aa06fe28fd13c9881c05c8a1473fee344377',
    'K12a-odd5-bf16-1-4194304-2-0-0':
        'cfff9e4ba9df98991c026e05afcc74a047f5cccd346b1c45e6b6ac2eff47836e',
    'K12a-sym8-highest-1-4194304-2-0-0':
        '7db68ea34d723db4a7077c55661cdbfd542dd05f904318220949f2dff692b124',
    'K12a-sym8-bf16-1-4194304-2-0-0':
        'f561a411475c723f329d362620bb86c4feded8068755528a432daaea28ed97ca',
    'K12a-sym20-highest-1-4194304-2-0-0':
        '4a144060403059fd997bada60b9cd74a7f9936f889ceb528de603ffd8267e946',
    'K12a-sym20-bf16-1-4194304-2-0-0':
        '8ee4303a8155fc5f596bc99bfe9439fb1808044e9566754ba7352e4b018c4baf',
    'K12a-haar-highest-1-4194304-3-0-0':
        'e46abbfb49c2d0cd400a5a5bf7c7994ca68a55f2bae5a6c54230aaf355318e2d',
    'K12a-haar-bf16-1-4194304-3-0-0':
        '6cdbc77dd25d24cdbcf3c8eef5d195be53b0176fb03085a4139278b10eba8e6e',
    'K12a-db2-highest-1-4194304-3-0-0':
        '640fb57168d272d5f46a6d3bf072c08bdbba9b6355fc34a8f11116f4524bb239',
    'K12a-db2-bf16-1-4194304-3-0-0':
        '000a814da52a9891c721172bcf91cd06867bf320236601b250327cdd3ac98670',
    'K12a-odd5-highest-1-4194304-3-0-0':
        '299d030751e7b5303de645d68878af354a64873536340a533e796104c925fe89',
    'K12a-odd5-bf16-1-4194304-3-0-0':
        '58d00205553c6cf65187f4953e54d611daa8413110f9b3a3a520a3fab58b2204',
    'K12a-sym8-highest-1-4194304-3-0-0':
        'f78dd62a0a4fa82ddcdf8cb6d907fd0f88292fbabcce8c333e57aa86dc72263c',
    'K12a-sym8-bf16-1-4194304-3-0-0':
        '7e6ba4ce69c6d3be8be05deb2ae5633395f05234f51e2a3bfeeecda821085342',
    'K12a-sym20-highest-1-4194304-3-0-0':
        'dafc80bfdafdb9057c1b2a167d8ea458395cfb648dc922bb65b89038ba810ab3',
    'K12a-sym20-bf16-1-4194304-3-0-0':
        '19ebf4cbe8983d997fe00ac3bdb8a0d9b73f68f9204cec1518e70d1caa928813',
    'K12b-haar-highest-8-256-1-0-0':
        '837226106eff1f5621cba3fa9009de19091fcd318bc9c0ed84555357217af157',
    'K12b-haar-bf16-8-256-1-0-0':
        'e0375a48ce6365c121096f9e09bcf0aff386aa8cd2bfe1cc627691718fab968e',
    'K12b-db2-highest-8-256-1-0-0':
        '9625e7c71c49aea48103ad94769022ef96d72c5580e7ff79644c636d27c570da',
    'K12b-db2-bf16-8-256-1-0-0':
        'deb7f2172a2783f3b0504a8b2d349bde6f7638e2993d40e6013f05d28a1141d4',
    'K12b-odd5-highest-8-256-1-0-0':
        '3b6a59c0985713f03f7ec20824c2a2b0efb5a40d6e1022c1bb7a06548b4f5a70',
    'K12b-odd5-bf16-8-256-1-0-0':
        '266fdda4f8a46a8894203116fa266cb49971996c4b599ea1caffb2d72a0f66cf',
    'K12b-sym8-highest-8-256-1-0-0':
        '03af36d35fafface9c452c926acd7fc6d4642ff94179ce60ad43386a8335ea05',
    'K12b-sym8-bf16-8-256-1-0-0':
        'bdbac005e2682e6c24afc8cea2cfb9dd9af036786b6491d1fd5accf6da7cfdd7',
    'K12b-sym20-highest-8-256-1-0-0':
        'bd52b1993891fab05fffcf2352d7e1afd819221cec84971d41993a23e17484d3',
    'K12b-sym20-bf16-8-256-1-0-0':
        '710151063db63b976bece2b1529dc2ac866dc6a5fba2bb87f908bd5831cb6d07',
    'K12b-haar-highest-8-256-2-0-0':
        '8baf1e3d5c0e4de18c10517e90eeaf20b4a6c1de4b6a9d0e6f6462e7b7f3d8bb',
    'K12b-haar-bf16-8-256-2-0-0':
        'd7a429b8544533cb340f920cfdc08d2df14afd863d58a0dd052d153273dcdc9c',
    'K12b-db2-highest-8-256-2-0-0':
        'b75ca41fad0384e5fcfecb9bab937fd8ee95b7f704f4dbe6fb524d2c876970cb',
    'K12b-db2-bf16-8-256-2-0-0':
        'ea628346cdc723acba391214763e587259b88aea649fb33aa874d82893236ad3',
    'K12b-odd5-highest-8-256-2-0-0':
        'af1b32334e7384344b3a0ca910c870abf8cc24ded98a147ea832d11c628752d1',
    'K12b-odd5-bf16-8-256-2-0-0':
        'f3f2949c9176784ebb0c545c8e49873c4e942421baad289d029632ffb8849c0d',
    'K12b-sym8-highest-8-256-2-0-0':
        '84f3e37cea98be353e6715d499b0c47211e62168a654b25b41ab22157e7be36f',
    'K12b-sym8-bf16-8-256-2-0-0':
        '69341fdc03f5f476b13c41c2cc095f7808aeaae65464d0034d3a2b78c348e251',
    'K12b-sym20-highest-8-256-2-0-0':
        'be4d062d53426a0975cd08f9a74d719e94fc1134a014027cc912f91e8aca6106',
    'K12b-sym20-bf16-8-256-2-0-0':
        'cf115add2d28a83b5a0d1a8a3728c62443d7872f7ede4b15de0fcd524727ad4f',
    'K12b-haar-highest-8-256-3-0-0':
        '9e0480cd30a0c6dbb0737bf8ec22e8125cefa238b75bb7308d35036c542f7773',
    'K12b-haar-bf16-8-256-3-0-0':
        'a5161879acee96f901beafc3625ce91afe3b89ea66324e4de00b15e9be99baf3',
    'K12b-db2-highest-8-256-3-0-0':
        'e03d98a9e176c408b787cca6729a7a238ac9ce6932bf00ffed70502280f1cb63',
    'K12b-db2-bf16-8-256-3-0-0':
        'c3618aa0357f46544264279085420cb5676cb1008926d44519a0e90dbded8098',
    'K12b-odd5-highest-8-256-3-0-0':
        '2c8732795aeb727215de1e952bd64bccd74273b8915733f2f300c0b278ceca2a',
    'K12b-odd5-bf16-8-256-3-0-0':
        '0a8e20720c892ae40c0be9b5de75c0507814ec171e50a71f2cdfe3d78af52191',
    'K12b-sym8-highest-8-256-3-0-0':
        '4fb211e00f8456c22e462664d10b51f4be3fcacae96b8afe036acd6df872bff4',
    'K12b-sym8-bf16-8-256-3-0-0':
        '030cbaf443e3fff54f6ab9140d07e346f8651e5b1a45297d5d8a3db7be94966a',
    'K12b-sym20-highest-8-256-3-0-0':
        '671f59cd12dd3acb959e07779ebfc1c44c9c9879e9951e8eab12082e4a2c2ec0',
    'K12b-sym20-bf16-8-256-3-0-0':
        '7094d30a214ddbdc4b69f97a840a4bc0eabf92c049cff9992c26e70ceaa335a5',
    'K12b-haar-highest-8-256-4-0-0':
        '17de7d7242f8de1e81775d3b37a2886c4f927903733c98724047226f8d002dd1',
    'K12b-haar-bf16-8-256-4-0-0':
        '25a3d0245419e5ac29bab8ad91819308537b8532c1c49e6634d20d71b5e8c002',
    'K12b-db2-highest-8-256-4-0-0':
        '1ca62d9b3e4f0bb5735b5c44a725cc5c5a3cf187065fbdfe975a669570c0929b',
    'K12b-db2-bf16-8-256-4-0-0':
        '95769936bd8b168bf7711a6b29f02b6ba69529101d8d495009ef56c83f343db0',
    'K12b-odd5-highest-8-256-4-0-0':
        '2da97bc048f195bb09b65fbdea9dd9a596a635b3fa873b073ec28e62d9ad795c',
    'K12b-odd5-bf16-8-256-4-0-0':
        '514b17951c7cd61c373015e67d9d8b80b9c00b3413a799197e244ac0d56770d4',
    'K12b-sym8-highest-8-256-4-0-0':
        'f69b1826dc8b72a7aff2a7d51e081c01b4a8283a58285771dc84a5e0e7951646',
    'K12b-sym8-bf16-8-256-4-0-0':
        'b1e630ab4a85f49204634898a2443bf367049f5076425754310125406e4f835f',
    'K12b-sym20-highest-8-256-4-0-0':
        '04ccf72b1630039a594583d3c6663567650387982f8248df588c590ca0b68580',
    'K12b-sym20-bf16-8-256-4-0-0':
        'bdc74e25415faaf944ab7f267f83b353a4e740fd9403b6edfebe814df1f23518',
    'K12b-haar-highest-3-130-1-1-0':
        '68a00e245f729ddc751412367a52344e4bc576a2c05c4c65ef12610d703022c2',
    'K12b-haar-bf16-3-130-1-1-0':
        'b33694f9100b738c7e5bb783648cca5b78b7f10e7279b29f1014d62599a817ec',
    'K12b-db2-highest-3-130-1-1-0':
        '3771d4b7d970663f146a23ba6754f0ae492b89ccf3eb87ceecdfd04a4b30843c',
    'K12b-db2-bf16-3-130-1-1-0':
        'a30773adc23c3efbbbebaac752654d0a84f155002d2b25368fdac90604c97ca4',
    'K12b-odd5-highest-3-130-1-1-0':
        'b15655994e2102dcd474c654fe0da8b3b5b0e9e82bd479be9d64cb9a2ca272be',
    'K12b-odd5-bf16-3-130-1-1-0':
        '2372f246125117ac9d52add4f2d65e8481110695a30adfc771591203ae7eb389',
    'K12b-sym8-highest-3-130-1-1-0':
        '928d3a410fb44c7fa270e7b841c718fb8a159fd1d7c1d4ce1a74ef0aa2fe07a8',
    'K12b-sym8-bf16-3-130-1-1-0':
        '3f61e3dee6dc1ee10f9f75ccefc3e5a66a89b7920e766fc6c061e44cfdfb40ea',
    'K12b-sym20-highest-3-130-1-1-0':
        'a23fdf28b08f7983486e7684018b16318cf5a670b839bab2dbc11ef1eb44a796',
    'K12b-sym20-bf16-3-130-1-1-0':
        '01abd884d9b37437eb0cd068e94233732d423bedf0aa268135ef6d8b48057e1b',
    'K12b-haar-highest-3-130-3-0-1':
        '612a0759512edbaaecd4e7ba9469edb10079a0ac3f31a90cd66cb623b71a5c6b',
    'K12b-haar-bf16-3-130-3-0-1':
        '68c1c570c11ff17a522e72f2e6c883e993bb4fa68004eafdb1b8454fd7e7ee0d',
    'K12b-db2-highest-3-130-3-0-1':
        'c6c25b86441dd936537c946b134735700dfdc12a490cc735b8faf7a853f2f6f4',
    'K12b-db2-bf16-3-130-3-0-1':
        '80ee2a3d9037ed7fa351c500853528ba23f7eeb09f8fd013a781ca04c863d58a',
    'K12b-odd5-highest-3-130-3-0-1':
        '2560896b35363da0e4f1f62f47c66ea7c54da05091bc05d5b1af8c980b4f849d',
    'K12b-odd5-bf16-3-130-3-0-1':
        '5c9ff704a2d1de3b04422e9dddac7ce9b45256926e48a81408fe6693aefdf477',
    'K12b-sym8-highest-3-130-3-0-1':
        '03202ea2e1fa61e254ab7cdafa0a9dab1e25c596fc33891b03f36aade21d535c',
    'K12b-sym8-bf16-3-130-3-0-1':
        '04c8d0ef075bdc16f2f3ad945bea460b611043360763146456dfa6184585fc33',
    'K12b-sym20-highest-3-130-3-0-1':
        '57baeefc07fb012149edf05814833e68f1589184f908809a401e69365c5e8845',
    'K12b-sym20-bf16-3-130-3-0-1':
        'b12e84bbade86cb3c4ac19adb148d4ea9e59f7dc3977ef31e74a25de7768be11',
    'K12b-haar-highest-2-75-1-0-1':
        'c34a234c57b15ca9a43b09cd266a29fbf67bea4770590c1f21ffaeabe2be33b8',
    'K12b-haar-bf16-2-75-1-0-1':
        '8ed90ccd676db7c3277d7d7cb74eae78ee01630f449394f99e99c0d059b951fe',
    'K12b-db2-highest-2-75-1-0-1':
        '043023e58997206da427c5e7173cb328ccb438d0e95671e84d11d3881616cea1',
    'K12b-db2-bf16-2-75-1-0-1':
        'a5300e051b790f7e4e22074bc0ca39236455223f2b5110ac6d648de167fd04f5',
    'K12b-odd5-highest-2-75-1-0-1':
        '5da07291280b315185dc8de2862097ea0bf94b4b6fb000c10b287bffe059e64c',
    'K12b-odd5-bf16-2-75-1-0-1':
        '8963f982ba95bc24c9c50eeded91b44e8c496f9d42c1fbf95124f059bd28d1bc',
    'K12b-sym8-highest-2-75-1-0-1':
        '683e97dfa80c6bacf8d7cf428304c1fc09a74c9ed59a36d0185488bb9b1b70ac',
    'K12b-sym8-bf16-2-75-1-0-1':
        '9f8a074c72c72d51bedcfc4b4e5d5ad3c231a1306184170a13e686be438996c8',
    'K12b-sym20-highest-2-75-1-0-1':
        '699d08328ac21b22975c578d88af4bc320a82d84d081aa457d3cb891e7c6b87c',
    'K12b-sym20-bf16-2-75-1-0-1':
        '3682997b9326ae39536b97b47f0a67341405030727d2270bd73816ca97fbde76',
    'K12b-haar-highest-2-75-2-1-1':
        '0112a8813ac7b296c4f05a340473be34ac9f7ddffce56df5fb171e29bc933889',
    'K12b-haar-bf16-2-75-2-1-1':
        '0e9d8e744643f121091e004360f4a601617355477e0c729dfdddbb0f5efb6a20',
    'K12b-db2-highest-2-75-2-1-1':
        'a062672389032dd778da748b5959c991c5451e3ed924b76dad960f94895aed1b',
    'K12b-db2-bf16-2-75-2-1-1':
        'bf1048e465c4e00275529b71fab2278dd381dd7490c3c01094f6754208a67da6',
    'K12b-odd5-highest-2-75-2-1-1':
        '0e6575c5abbe374d02512d5cab3ab035f5cb9ff19e6fffc0a0ac87427c8780a6',
    'K12b-odd5-bf16-2-75-2-1-1':
        '2cc79c2ba8b36f1d2f93b24c73d0dfbb42779281cf90cbb12ec0b7e0a9b89e5f',
    'K12b-sym8-highest-2-75-2-1-1':
        'cbdb5226fd5c9556677f7851aa29bc51792f9bd6ca68cd72d98699d9d4eb1fea',
    'K12b-sym8-bf16-2-75-2-1-1':
        '2180cfca18748a130a10b360532719e9c12e990a6dad702e5ebfc07adc0d6539',
    'K12b-sym20-highest-2-75-2-1-1':
        'c24d65cff2215d8afb15eef80d143c36a06f4b828551ba85c438cce9d38dba89',
    'K12b-sym20-bf16-2-75-2-1-1':
        'ec83d6b046ba0890f9f76ff6ee0b98bed60255d541d8ddc266060910f3ff84ca',
    'K12b-haar-highest-64-40-1-0-0':
        'f2e1787b06b78651d44f6c58383567996a5177e42bb9fcc713201aee81024c41',
    'K12b-haar-bf16-64-40-1-0-0':
        '35b8eb002c2da514c976d8e0c2bbc78c52208e61604ea94e2ac5081eb1aeeacf',
    'K12b-db2-highest-64-40-1-0-0':
        'e11bd8e81b6e284c62d307ebf2606713248dc066d493ca7c2b20f040f00185b8',
    'K12b-db2-bf16-64-40-1-0-0':
        '5129c1ad1ebade5126a0f66a066546fa43071d55ef8bd58dedf186a0604e8b1b',
    'K12b-odd5-highest-64-40-1-0-0':
        '46fb3816303a5b6f424614c40441a1d05a2f8212f5c52563f76dc5fc8ff72ec1',
    'K12b-odd5-bf16-64-40-1-0-0':
        'a8c3fb07351d74f3e67edca07d2e20a3daa8e685b3c1f0c5ee025c7c43efdefe',
    'K12b-sym8-highest-64-40-1-0-0':
        '3ac32b1f8f9a6ad67e67a5a5b853c1d833db4ac2a47d6f177e73016072881626',
    'K12b-sym8-bf16-64-40-1-0-0':
        '4525535803cd6c3f185251267992b2fed29ab5f22884d2f589940b2db2723e5a',
    'K12b-sym20-highest-64-40-1-0-0':
        'd716fd228aa1e1e14c257c924beb19e771e1301033a9cc5f30caf2abd8c35ed4',
    'K12b-sym20-bf16-64-40-1-0-0':
        '34c66727b0c27c025648a3f8f484cd397b91f462511a1356420df6f34fed032f',
    'K12b-haar-highest-64-40-2-0-0':
        '63d9e6b864d83d99cbaefc572457903acde5a44383c0fce9c0c1409b08f58710',
    'K12b-haar-bf16-64-40-2-0-0':
        'd60728d0b9800d264bfffb223dc61ddd8edd11aac07fad51e9479114ad49aca9',
    'K12b-db2-highest-64-40-2-0-0':
        'cbea281cee3786e908dc9b9a77d01b269ddef73e7becfcb245f714312ff6f832',
    'K12b-db2-bf16-64-40-2-0-0':
        '06072fd73c8947feafcca463ff131c5f26aa88f8bf75bfeedcf717b9ec45d4e5',
    'K12b-odd5-highest-64-40-2-0-0':
        '17d82fa601289d561b99fff2d2ad2817c4fe8762e2851cce1cc706b6006baa10',
    'K12b-odd5-bf16-64-40-2-0-0':
        '0b7a92a6650d1da4f162678713659935f08809fb61328e36d3920b296c7e5b1e',
    'K12b-sym8-highest-64-40-2-0-0':
        '88ad1243e64d7cd557af0985b0434852d6ecaf75a9cf446badbf2632def69672',
    'K12b-sym8-bf16-64-40-2-0-0':
        'c9d16f5b08d0a66ca4b1fd6a43c619f17dc563517af0377c858f7220b72a0edc',
    'K12b-sym20-highest-64-40-2-0-0':
        '8847dc4ca32ecf9484d178ffa8dc2e4cff2c1f48284e01d0495bc84633c32835',
    'K12b-sym20-bf16-64-40-2-0-0':
        '5ea83e36a0fe1ce7df201673a6f0f1269a5481e23a6daf7c3a336317427dad1c',
    'K12b-haar-highest-5-72-2-1-0':
        '8b8575bb18f522fc5398e5ec71f4d0c1c81559b48d9a27f34d58e813fd048687',
    'K12b-haar-bf16-5-72-2-1-0':
        '05c34ce64fea6d45e60a3602ad704f527b4c765ae9dcee45b210e43a5c9efc6d',
    'K12b-db2-highest-5-72-2-1-0':
        '29e86fa074528315d31871dbf95654df9f11873b1ac3ea5c7bf94cacdd2de7fe',
    'K12b-db2-bf16-5-72-2-1-0':
        '256cbcca4f3142dc66455558d32ef106a7273ce6f176492b39097e9d76816cdc',
    'K12b-odd5-highest-5-72-2-1-0':
        'a77aa582cf3c1764c3abc567d5ccafa0ace4ea01a86419b93ca5c9886307245b',
    'K12b-odd5-bf16-5-72-2-1-0':
        'cf3aa6f6968dcd48da5dbdea17a3c2bbc65d14297882fd677e4971dbdf0edecc',
    'K12b-sym8-highest-5-72-2-1-0':
        'ff364fa10702c4ea085cc5615bfccff2ef74e26010240a88adeac0d6cdf1ab11',
    'K12b-sym8-bf16-5-72-2-1-0':
        '4f4c87e8b2c9be6e552e2bd4be470aa4818b87a320b32977b8ef62ab5f10a81f',
    'K12b-sym20-highest-5-72-2-1-0':
        '427815ba3d25f1e8e818447c693beee242ce2e69cf42a2e71c4023a9409f1e92',
    'K12b-sym20-bf16-5-72-2-1-0':
        '65d9124ab0b96d5c0c1fe29648129b80d74316817820f927f553cb809d78fe2e',
    'K12b-haar-highest-2-4096-7-0-0':
        'b070be4263f2d48656b336daf3c25298b1290b1146af70062ebcefd39dac5278',
    'K12b-haar-bf16-2-4096-7-0-0':
        'ff9a91864d92a089962e2432f663d50045a247a918ffe8cb55a3bd45abbef1ff',
    'K12b-db2-highest-2-4096-7-0-0':
        'd97dd5b980c3fb753c42c3a8bf476522fa7f16c4c0d1310dfc9330e2f490e3f8',
    'K12b-db2-bf16-2-4096-7-0-0':
        '197e36e9920d1b06c46f082e939e6f287c077faaf70dcc88bac1d4682644ea6a',
    'K12b-odd5-highest-2-4096-7-0-0':
        'aa03471e3ccc17c6354a0e9b61918159d91b5e07588547c8f5d3d64ab117afc6',
    'K12b-odd5-bf16-2-4096-7-0-0':
        '91a393cdd54de405856e16e4baac987e3eaa61278e2500cbc07ab2817f2ce1ba',
    'K12b-sym8-highest-2-4096-7-0-0':
        '4280b9711308ca982727cf8c67cd12764c746437178461f736ac51950fe92f92',
    'K12b-sym8-bf16-2-4096-7-0-0':
        'c4254e3bc927e8d916a2c318700263e84aff1fced47dd83daf854a05fbbe7c4f',
    'K12b-sym20-highest-2-4096-7-0-0':
        'edc329878029ad0f9ae1f09f7d08bccc9c8c4515e4695fa2b04aaefbec411a50',
    'K12b-sym20-bf16-2-4096-7-0-0':
        '8e4a8c64c5d0e813479317f18e012a730a5f00f7cc9a401f778cc1e8d11ccd17',
    'K12b-haar-highest-1-1000-1-1-1':
        'ed6f964ea495b3e41014688ea3fe67120f9b23af0ba839718f6a5abc7db5c0d5',
    'K12b-haar-bf16-1-1000-1-1-1':
        '6e23a7cc59d1a8884e2d6aab8b8d88a84980b91caca530b678d450dd29617609',
    'K12b-db2-highest-1-1000-1-1-1':
        '8269622f24d795bdf90bf31973c32d84bc5736bde7dc535d6e947890d457e311',
    'K12b-db2-bf16-1-1000-1-1-1':
        '896d3bb9c2c20dea3cd0a7f6c8dc4d6cb48cbbe7251beeb60447841ac46c03d7',
    'K12b-odd5-highest-1-1000-1-1-1':
        '23f174df350c8744fc3706a0c7a77130541fcbdd0f7aa50784470fb41acfb4b4',
    'K12b-odd5-bf16-1-1000-1-1-1':
        'c6a8f25eeee620402972fc29af5e1909597f303ac125a103aa2c2358a993454f',
    'K12b-sym8-highest-1-1000-1-1-1':
        '0e07e4821533472116c3d0c407c076f4f51c827687de0839af42799d7fa1abdc',
    'K12b-sym8-bf16-1-1000-1-1-1':
        'd9537dfa631667390ba36f027af54c95fa680cfa06c0232cdb76672240079040',
    'K12b-sym20-highest-1-1000-1-1-1':
        '80e4578395ea8e3ef39483e39c1122a0c150206811ae508af256a6b5d41e1e39',
    'K12b-sym20-bf16-1-1000-1-1-1':
        'be08317bfa18c89599292e29c1e99f48f96af5816263f460f97fc69da6e82086',
    'K12b-haar-highest-2048-2048-1-0-0':
        'f82f47691c88ea8b90479348f6d91ea651bd1ba76567af27a7cce1c4c2c32253',
    'K12b-haar-bf16-2048-2048-1-0-0':
        '27f88cdba4f0912b543251407f60ea941d68b5e397da60244781f7396e9df025',
    'K12b-db2-highest-2048-2048-1-0-0':
        '5ea3f9c6d25562928d1591e7d196ccd64d917f1d6d158a67f9d269e984140b4e',
    'K12b-db2-bf16-2048-2048-1-0-0':
        '4762bc8e5e817917d2728eec39404a05f13d5b08fe3ecca9f88438ec18fa108e',
    'K12b-odd5-highest-2048-2048-1-0-0':
        '471d0e22db4ce6d6bce8b3dbb13969ae82ce13a5d8ccb89ee27181f94d5a04b8',
    'K12b-odd5-bf16-2048-2048-1-0-0':
        'daa6abf69be5e81869d6017102e174946feb000738f782a79ca5342dda9f0f89',
    'K12b-sym8-highest-2048-2048-1-0-0':
        '5c8119a04caf63eee4e2e91cb26c1d94b2430c4f44bcc455a5ee5602923f9742',
    'K12b-sym8-bf16-2048-2048-1-0-0':
        'c82b4e22ad3673015eb8bd644d8b36f80c21f6a44beb842aa26ec1f85ad95172',
    'K12b-sym20-highest-2048-2048-1-0-0':
        'be6f2692932f5ca7e78181512adf0b2c1b892a409fa2d75733940464583ba6ba',
    'K12b-sym20-bf16-2048-2048-1-0-0':
        '5822e3a172885191b9f1f03813aa6df383f67f386c9c08ade45496952d83bd63',
    'K12b-haar-highest-2048-2048-2-0-0':
        'bf26c69b401a523e6912686dda5cfc2c9d25e8b54914f5bef09e0d1579322b14',
    'K12b-haar-bf16-2048-2048-2-0-0':
        '9dfdcb274f8d854e3b54e19630eff32f286f7e0aede4ab5e0b367c0bc8989664',
    'K12b-db2-highest-2048-2048-2-0-0':
        'f3fa8a84162d5e7ad4ac2958fcc9d42505915a4be90668ae7e9273a0d77a5d88',
    'K12b-db2-bf16-2048-2048-2-0-0':
        '3d9c3741d251034ca021a3d500b4a1bad4978927b661014bbec135b9ed60c46a',
    'K12b-odd5-highest-2048-2048-2-0-0':
        'dec1fd66c771f213f3be37ad634f24906112d7e43b4dcb04d35ace38e0ddf8d6',
    'K12b-odd5-bf16-2048-2048-2-0-0':
        'ec31de34da9b432fefc5ac698ed16f083e0cdef6c6b6c5ed4e2758367d2b3a1c',
    'K12b-sym8-highest-2048-2048-2-0-0':
        '96d3dad2002bdd9918ee0b634add1350b4b3b91f710d2003314b5cb04849a7c9',
    'K12b-sym8-bf16-2048-2048-2-0-0':
        '8cc18712f2276fedd002f2b12e3492bb2ff86a33d0c98331f9f47494bbc1cb88',
    'K12b-sym20-highest-2048-2048-2-0-0':
        '962b07ff4378d763887dff6169fee0fe3999b78f66c159bb04fcb1ea1658b115',
    'K12b-sym20-bf16-2048-2048-2-0-0':
        '75df06f115fb883d6e3f77516c69f78a5204fd86109ef62bf0623b62fbabfe51',
    'K12b-haar-highest-2048-2048-3-0-0':
        '5afaca0067dd7e0fb80113b885c47750e115df5e2c7e4ed9eca6237e75419d44',
    'K12b-haar-bf16-2048-2048-3-0-0':
        '6199103d86a060eda5ba20ee0330fe018642935c0e352594d7a9e432e7f1b937',
    'K12b-db2-highest-2048-2048-3-0-0':
        'a460ced08479f661d2c1a06294923ba2db86f6c9932c480c1af0b606effaf6b9',
    'K12b-db2-bf16-2048-2048-3-0-0':
        '591dd13e4c3f445bc712bda2ac4a6138d2eaf162b349784a37dcd2ef3cdd4f95',
    'K12b-odd5-highest-2048-2048-3-0-0':
        '50b9b35d1037518ac97fd74a061ad3d220d44c0348487df6ac161c4ce0400b6d',
    'K12b-odd5-bf16-2048-2048-3-0-0':
        'bca961989a77ff424abaaec21747e0307565a3bfaf86db7a94f45af24a282226',
    'K12b-sym8-highest-2048-2048-3-0-0':
        '5f8a7787e446b977d6bdde2a79742bcccfb5cf899ab1e063d1be8b8af9290799',
    'K12b-sym8-bf16-2048-2048-3-0-0':
        'aebb8b884d2b9f5dcd247ce12c3c83ea5b8faa074bc85b0872b291398351f7c8',
    'K12b-sym20-highest-2048-2048-3-0-0':
        'bddd15875c0f39275521413a5657ddd91b88bb7e7b4d05bd8e62c3485bcd8790',
    'K12b-sym20-bf16-2048-2048-3-0-0':
        '652438ab705fba478128ee3528283fcb820b4cc2c5b216d6826ae36338bd21dd',
    'K12b-haar-highest-1-4194304-1-0-0':
        'abb7a5106e01bd8d9da5cd24b4ab27096268a29babcde265c3c53f93906f6b30',
    'K12b-haar-bf16-1-4194304-1-0-0':
        '5948d8e444f8c0c2be8090085e8aab36b7e7cf290d8e75e3a22d9238137d1489',
    'K12b-db2-highest-1-4194304-1-0-0':
        'f37ed11e158c7b5d5faea3fb03dbcebba0931dff25f9fb59be758343cc89c282',
    'K12b-db2-bf16-1-4194304-1-0-0':
        'b6f7ff9947e0c145becc9b3c43f6005002290ebc2562cafb2fb2649591ba364c',
    'K12b-odd5-highest-1-4194304-1-0-0':
        'dd2cce1cddbe98ce0625dd42f39840f349fe326ad5f8953155998354af2e06ea',
    'K12b-odd5-bf16-1-4194304-1-0-0':
        'e97003234ed08eac4eb090a045fd3bfce0ee4e64948dc41fe28c837cca5620a7',
    'K12b-sym8-highest-1-4194304-1-0-0':
        '2c07f162e5a8ca97e94d29d0cdbe77020c3145f0a0a7a85286beb20659cfced4',
    'K12b-sym8-bf16-1-4194304-1-0-0':
        'f4d961a5e982936b40d44374c9fadbfa21d2b82b0ab589e1bf40598bc7af3338',
    'K12b-sym20-highest-1-4194304-1-0-0':
        '0f83c4c1bb97847d790d3fa1998e7eaaff7f052d2dfa5efc8294e964a4903469',
    'K12b-sym20-bf16-1-4194304-1-0-0':
        '21f4a4bc5298711788ca0ba02dfb40617bc537d76fa3de45e2c86de1a52371b9',
    'K12b-haar-highest-1-4194304-2-0-0':
        'b17482cb9e8b525dc4d305f1ec0d1e466bd3b23bdb25e7dc563ff65067b72bcb',
    'K12b-haar-bf16-1-4194304-2-0-0':
        'd06f6a9ee4607d39c69c5c0a552ea2d6127e9f791425d76614946bf70550c064',
    'K12b-db2-highest-1-4194304-2-0-0':
        'e9120b20f413206d41122a5c9a2eb77a94658dbd235720dec9ef7be17edebe80',
    'K12b-db2-bf16-1-4194304-2-0-0':
        'ddad6ae062cf2492b50c8ca3fb25b1bbef16c2e7cd2916853685bde95e583935',
    'K12b-odd5-highest-1-4194304-2-0-0':
        '4d2b4f16d7f655f59e5d55ceb85d9cc77f82d3aa0d5498921ff5cc4361afcda5',
    'K12b-odd5-bf16-1-4194304-2-0-0':
        '41a843340a96f9b394e92fa4848585f88390789f92a22c88711cb01405403052',
    'K12b-sym8-highest-1-4194304-2-0-0':
        'b1391ed1ff36fe320a4fbbac59da04de25ccc7354d888e6c0c88c6604f7b6f97',
    'K12b-sym8-bf16-1-4194304-2-0-0':
        'e6d0458b386a91a5c29f1416bcc62c142322194ce4cf98870b4ebd2d03fef39b',
    'K12b-sym20-highest-1-4194304-2-0-0':
        'cb96585f91916af269e3dcdf06978b87a28bde6a961f6b567e356a947f05cd16',
    'K12b-sym20-bf16-1-4194304-2-0-0':
        'c77bf1a5cd8ce1235bc33bea62fa7ece50943ed6978d7f8e96771f4e43f2bd39',
    'K12b-haar-highest-1-4194304-3-0-0':
        'bb4d78f785f7a47bccdde3468a2f9dedf33cbfa5cba613da47103746495cc198',
    'K12b-haar-bf16-1-4194304-3-0-0':
        '606d5c8cea78685ba4ec569b999fb784ed14902c5a8f457ea36a438a14a908b6',
    'K12b-db2-highest-1-4194304-3-0-0':
        'a891b715c9011db2386faa916d56084c2a0a697ed8d9419894b09315cdb30dfb',
    'K12b-db2-bf16-1-4194304-3-0-0':
        'fc42d378e371a23be7d3f563ad48362878053da48c2f2b9edfc54f188efd6fcf',
    'K12b-odd5-highest-1-4194304-3-0-0':
        'a2fe897e2a444a4ec3bb4d187026f999ea37bf726abe32e50b23e9934c9b220b',
    'K12b-odd5-bf16-1-4194304-3-0-0':
        '50720230c16e40b380279fa0eac07234259890e38171821563837bfec7900a18',
    'K12b-sym8-highest-1-4194304-3-0-0':
        '2af4883347145bcacf002fd0da4a10871801411f727b1bb946d2f991096a0ad9',
    'K12b-sym8-bf16-1-4194304-3-0-0':
        '16f6fe5a59716884a18a1bd8def71d6fda020bb22162a8ec62b77968d5335b0f',
    'K12b-sym20-highest-1-4194304-3-0-0':
        '3dfa83d314ef56577056c0c7c242e2d61a415aa7779b28c2bc94f4ec1a48f1e6',
    'K12b-sym20-bf16-1-4194304-3-0-0':
        '8b31080dddbd57b851a1c07b28067b86985c460476c2076eae851476abaaf82e',
}


# K10a / K10b, swt1d.cu's persistent window body: each output against its
# plain version and against the SHA-256 of the output that the first body
# (a block per 1024-output tile, the window staged by scalar loads, the
# taps and their offsets read from shared memory) gave on the card for the
# same seeded inputs; `python tests/test_torch_kernels_cuda.py digests K10`
# prints K10_DIGESTS's form. Banks of hlen 2, 4, 5, 16 and 40, float32 and
# float64; (rows, n, level, input offset, output offset): levels 1-4 of 8
# rows of 256; a dilation equal to the row (4 x 16 at level 5) and past it
# (3 x 10 at level 6); n not a multiple of 4 (130) and odd (75), where the
# dilation does not divide it; short rows packed to an item (64 x 40 at
# levels 1 and 2, 300 x 8); a wrap wider than the row (4 x 16 at level 3);
# classes wider than a warp (2 x 4096 at level 7, 2 x 1000 at level 8);
# inputs or outputs one sample past a 16-byte boundary; and the timed
# shapes, levels 1-3 of the 2048 x 2048 sinogram and of the (1, 4 Mi)
# signal. The C entries are called on outputs made here, NaN-filled.
K10_BANKS = ["haar", "db2", "odd5", "sym8", "sym20"]
K10_CASES = ([(8, 256, lev, 0, 0) for lev in (1, 2, 3, 4)]
             + [(4, 16, 5, 0, 0), (3, 10, 6, 0, 0), (3, 130, 1, 1, 0),
                (3, 130, 3, 0, 1), (2, 75, 1, 0, 1), (2, 75, 2, 1, 1),
                (64, 40, 1, 0, 0), (64, 40, 2, 0, 0), (300, 8, 1, 1, 1),
                (4, 16, 3, 0, 0), (2, 4096, 7, 0, 0), (2, 1000, 8, 1, 0)]
             + [(2048, 2048, lev, 0, 0) for lev in (1, 2, 3)]
             + [(1, 4 << 20, lev, 0, 0) for lev in (1, 2, 3)])
K10_TYPES = {"f32": torch.float32, "f64": torch.float64}


def _k10_id(kind, case, wname, dt):
    return "-".join([kind, wname, dt, *(str(v) for v in case)])


def _k10_output(kind, case, wname, dt, dev):
    """(kernel output, plain output) of one case (K10a: lo and hi stacked):
    the C entry launched once on seeded rows at the case's input offset,
    into NaN-filled outputs at its output offset."""
    fb = _bank(wname)
    rows, n, level, oi, oo = case
    dtype = K10_TYPES[dt]
    npt = np.float64 if dtype == torch.float64 else np.float32
    suffix = "_f64" if dtype == torch.float64 else ""
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _build.load_library()

    def rand(seed):
        return _offset(_rand((rows, n), dev, seed).to(dtype), oi)

    def empty():
        return torch.full((rows * n + oo,), float("nan"), dtype=dtype,
                          device=dev)[oo:].view(rows, n)

    if kind == "K10a":
        x = rand(10)
        lo, hi = empty(), empty()
        taps = [fd._host_taps(f, npt) for f in (fb.dec_lo, fb.dec_hi)]
        err = getattr(lib, "pypwt_swt1d" + suffix)(
            x.data_ptr(), lo.data_ptr(), hi.data_ptr(), rows, n, level,
            *(t.ctypes.data for t in taps), fb.hlen, dev.index, stream)
        assert err == 0
        return (torch.stack([lo, hi]),
                torch.stack(fd.swt1d_plain(x, fb, level)))
    a, d = rand(11), rand(12)
    out = empty()
    taps = [fd._host_taps(f, npt) for f in (fb.rec_lo, fb.rec_hi)]
    err = getattr(lib, "pypwt_iswt1d" + suffix)(
        a.data_ptr(), d.data_ptr(), out.data_ptr(), rows, n, level,
        *(t.ctypes.data for t in taps), fb.hlen, dev.index, stream)
    assert err == 0
    return out, fd.iswt1d_plain(a, d, fb, level)


@pytest.mark.parametrize("dt", list(K10_TYPES))
@pytest.mark.parametrize("wname", K10_BANKS)
@pytest.mark.parametrize("kind", ["K10a", "K10b"])
@pytest.mark.parametrize("case", K10_CASES, ids=str)
def test_k10_body_matches_plain_and_parent(dev, case, kind, wname, dt):
    got, ref = _k10_output(kind, case, wname, dt, dev)
    tol = TOL if dt == "f32" else 1e-12
    assert got.shape == ref.shape and float((got - ref).abs().max()) <= tol
    assert _sha256(got) == K10_DIGESTS[_k10_id(kind, case, wname, dt)]


K10_DIGESTS = {
    'K10a-haar-f32-8-256-1-0-0':
        '595f28468ce763312cf6d7ccaa08d974946513ce95c625013a4998c77c4f95ab',
    'K10a-haar-f64-8-256-1-0-0':
        '7897f2c9398073761bd58ae26210df991b294893b8b07d4c6c3f91648a12aa8f',
    'K10a-db2-f32-8-256-1-0-0':
        '5610c0abcdda4c60dfb3abae3935bb48b4d0021f615ec0e3838ceaf838a17d8d',
    'K10a-db2-f64-8-256-1-0-0':
        '5fa0cd0120e7ddb58946da93b163d9d5b250ad45655972d29440bed615c4f812',
    'K10a-odd5-f32-8-256-1-0-0':
        '7e48879284ecf050a357c701e02ef6be79709d4a1f6b7eef210607c2c2ddf050',
    'K10a-odd5-f64-8-256-1-0-0':
        'ecbcbffdbc4df186e8f880cea4cd1c0bf27e3ff1b08bceba14a76667608f84e2',
    'K10a-sym8-f32-8-256-1-0-0':
        'f73a31da11c8bcf5ea19bbf7ee7be5a2037038caa9a96440ab4d3cc2da0eba20',
    'K10a-sym8-f64-8-256-1-0-0':
        '303c1dd1b81a110f50acff24378f8b11eaf237c2d7c09f667620ca22d9e2b3c3',
    'K10a-sym20-f32-8-256-1-0-0':
        '779a06fecec79d901ee6374c3c8495f29e337d83919c90b5aa442d401233ebb9',
    'K10a-sym20-f64-8-256-1-0-0':
        '0bddad97f7dbf8514bd80397d76a6a446ca07d687e9e0666d4565ace4a0e0472',
    'K10b-haar-f32-8-256-1-0-0':
        '5d9c13689a81d3e1f66a92e8c325b5d7c25acd0d230f3f44a7408718f1de66ed',
    'K10b-haar-f64-8-256-1-0-0':
        '149a7eb8df90d2763052b18ea833e07aa9aa4c0e1a606c72cc6c53c728a7e04e',
    'K10b-db2-f32-8-256-1-0-0':
        '6dcc2caeaf20189e38e1baaef1a0b1fc80a8a82a830f9963113cc5a3508a49be',
    'K10b-db2-f64-8-256-1-0-0':
        'dc9b2cb00c4ab3a172a073df2a2772c4703bb3cad8cc36117cdd7e7760470d21',
    'K10b-odd5-f32-8-256-1-0-0':
        '85e465edde3b372fbb3d14f48d512d483643fc6291f0573932dc041da4f16940',
    'K10b-odd5-f64-8-256-1-0-0':
        'f421f2b7c48d87e6b9d2bb94429041bfceed9dc7cde89e319e9ff6baaa373ed9',
    'K10b-sym8-f32-8-256-1-0-0':
        '0d245f7cbe92d1c7cb54a0f5452c1b960f1ffcb12051b1c3231f8e4b2b9bfe18',
    'K10b-sym8-f64-8-256-1-0-0':
        'eb572466e55b3d4750bdec31c135f84fe5b6c63dcf1daa490c8ef057b0d97a09',
    'K10b-sym20-f32-8-256-1-0-0':
        'be4417912ca9b4991d80d07c6d70e7f70fe231ee78c7ba0df1be6731718f05b6',
    'K10b-sym20-f64-8-256-1-0-0':
        'a7c878d44c9b1327d93bb49c2ec0f843ec5c36c21fe358ae4981061e26627b1f',
    'K10a-haar-f32-8-256-2-0-0':
        'fe3dd8e8ae685689b3dba84e9aec542db138692b8e729d2b6daa96110fac7531',
    'K10a-haar-f64-8-256-2-0-0':
        'faf02d58d85099325af9045d56bc8300c68a2b582cbb161a82289e0841d75f3b',
    'K10a-db2-f32-8-256-2-0-0':
        'b3db85830bf738ca787ef55eb1072e347ac78104b71e33d1742a3a1eb5800219',
    'K10a-db2-f64-8-256-2-0-0':
        '94478ed408a92af178b56e13d3e0464e654c569501efa54c7f61ae9e75b3faac',
    'K10a-odd5-f32-8-256-2-0-0':
        '21851fee1d3cdf1e420826af4ec780347f7b0f6d6cb08cbf15e98b5c4919eac3',
    'K10a-odd5-f64-8-256-2-0-0':
        'f718c9ace36b34f7d40395550b569c5df2acf9abdf54c4d4f4c6686474c8c577',
    'K10a-sym8-f32-8-256-2-0-0':
        '94e64088681fa3f6e2ddb7cf8590025f39181688c552c215d1b00dea63e50b40',
    'K10a-sym8-f64-8-256-2-0-0':
        '38eeef12c60b4b845a4ad6a3b2fb4647c6eb7d950d44aeabff74b6db7b80c8b4',
    'K10a-sym20-f32-8-256-2-0-0':
        'e8a592b14729b46154f835e972890b600612e0554c86d8c271f6e0eebaedd399',
    'K10a-sym20-f64-8-256-2-0-0':
        'fcee4d473f3aa1b41c60b35f388ac65d49f4f9adcbb54491d6fa118ff55f3c50',
    'K10b-haar-f32-8-256-2-0-0':
        '2cfd098c9d0f5f54896b0da22b159b65c4026efcd6f6eb7f3115de687140fd41',
    'K10b-haar-f64-8-256-2-0-0':
        'f6aa1b65e7da389d7fee2f8992eac750594ff2d9faa687c1be3e4340aa69ec80',
    'K10b-db2-f32-8-256-2-0-0':
        '5005f8a8d9f758dfc109fc732c284f64795c040d7fdc0dd9ebc8e34b25c1f191',
    'K10b-db2-f64-8-256-2-0-0':
        '732f3d9652e409fca89acf4adccf22a061f705f9cb6544e7edcc413c618f9496',
    'K10b-odd5-f32-8-256-2-0-0':
        'f7f8ebbc9ec3821f45dbe14443b6426568084cfa8ed1f060c088c0d53e0c7e88',
    'K10b-odd5-f64-8-256-2-0-0':
        '5162d497a67d79f2399dcb3f1b230f1a0876c4b3cb278b3dfe5ef4cb56382b1e',
    'K10b-sym8-f32-8-256-2-0-0':
        'dbfe56ae592e73237e4bb5a78dabc067b8e23eb2b8069ddba2cd708cb4f4ec85',
    'K10b-sym8-f64-8-256-2-0-0':
        '272ac46334df4dbca509713b8727c879a0d4f8191b5e4d789a77b023eab8aa02',
    'K10b-sym20-f32-8-256-2-0-0':
        '9ebbbd623ba165a16c0baf829448e0c99268637d8a75a5f55a48d061421e6bac',
    'K10b-sym20-f64-8-256-2-0-0':
        'a80da2cfef34575929f73f9fa8833746da1fc30bddc57f8f7173231afa3d6829',
    'K10a-haar-f32-8-256-3-0-0':
        '27059de5a9485f4ba7394f69a8288e6be132107f9b4ac50441fe14968ecc68dc',
    'K10a-haar-f64-8-256-3-0-0':
        '901eec9f7ce600dd23cc7e8974287b418debbdb1a4eade43a10bd9acd8628f07',
    'K10a-db2-f32-8-256-3-0-0':
        '2855647a921455e8c2c742289a054dac1fbbaedae87a9e1b6e266a9ba8ab9731',
    'K10a-db2-f64-8-256-3-0-0':
        '0e7184ea353c6b2020e952452ff39d0b878ba0604a071a7a3eeb682672bb80d4',
    'K10a-odd5-f32-8-256-3-0-0':
        '872ebdb5177a8465326b269c7028da0382d621ed56c2a2d5c0c94fce28aa996b',
    'K10a-odd5-f64-8-256-3-0-0':
        '63f20f2c1ad09a9b1bb79d8fb49b12240ddd7621ee734348683adc7d4a7a34e6',
    'K10a-sym8-f32-8-256-3-0-0':
        '13e61c0cfa6e45d3213f57a5214779871364ba6ea4c462e2f99008895964c88d',
    'K10a-sym8-f64-8-256-3-0-0':
        'c2af5237e6a243a0a271c8152870a94db0f6834f5691c5778439493a1eab2ac2',
    'K10a-sym20-f32-8-256-3-0-0':
        '14a449e80a8c340e6b9c119de0948f5ab14cbee3840edc35a56f3d017fed1340',
    'K10a-sym20-f64-8-256-3-0-0':
        'e9cca161d384063f6d36a7bb5019ed34d65778a24893c61974d2e651e99ac8e2',
    'K10b-haar-f32-8-256-3-0-0':
        '81759c2d60184ce0dd0745130fe1aaf015b9f106f87da77c11163f8f29fd78f7',
    'K10b-haar-f64-8-256-3-0-0':
        'ff1a6401ca3a1a4b613d18c662020c7d02295e009e7c26b55bd2dfe43b0d8636',
    'K10b-db2-f32-8-256-3-0-0':
        'fc65baa37c8ad34aaf65812e265457e525b736b4d6754d605d3a21daedc0c842',
    'K10b-db2-f64-8-256-3-0-0':
        'efbe54a2164b86ee25b8e5797e511b09171a6930b7323e88969c58139ec67146',
    'K10b-odd5-f32-8-256-3-0-0':
        '0712e1ef69a4375b6587d33eba40f4a52d72306ee1b60de997fbd99be558b463',
    'K10b-odd5-f64-8-256-3-0-0':
        '68092b7907bba97b6c12ab3a7417b425288066f5c03677664312fe07099f174d',
    'K10b-sym8-f32-8-256-3-0-0':
        '3f46036c3e48b2bf07a34e9032a76d99f5d9bb8152780ec4e2dab3eb797cc727',
    'K10b-sym8-f64-8-256-3-0-0':
        'dc782a70f61b4162e2b90fa03bfaec1f61475fae79bef3936fb9c322c1d4bb91',
    'K10b-sym20-f32-8-256-3-0-0':
        '0be31adf11d9ac14bafe610f4e8c9d411b4b740aef614ca7152fd90c0dfba85d',
    'K10b-sym20-f64-8-256-3-0-0':
        '7f5512ad9161087dfb6101f736f42ad0600f1f32a3e987fea9bcf6744f574b6a',
    'K10a-haar-f32-8-256-4-0-0':
        'e5e8eb183f3dea5447e908200604ac4737b99eeb9d713eab2a86474e5dca7c06',
    'K10a-haar-f64-8-256-4-0-0':
        '5709dcd6532033f666da4ce0e5dc2cf459f64649420459d30d0ab7b50cf52b47',
    'K10a-db2-f32-8-256-4-0-0':
        '62679d18dd832ac216b203a7c88e70be3a0a6bf2e4441e6eb6c1a2a11fb5af28',
    'K10a-db2-f64-8-256-4-0-0':
        '81a82147fd1d08f2003c934aa6a9a223a84fe54481793675c4d3f96088a8a9a8',
    'K10a-odd5-f32-8-256-4-0-0':
        '684f186bf60909c70bbf1b3b7c2b52c3e7fe6fe51feedfc5292fb73ee916614f',
    'K10a-odd5-f64-8-256-4-0-0':
        '600f5261d4abb0547664cb865c4ca578599f6c59e78fcde2945451b6ef140c5f',
    'K10a-sym8-f32-8-256-4-0-0':
        '99d940569a3f0031dda6b0a255fa1a89b3c90bc0aaf5cfa73f078660890aca29',
    'K10a-sym8-f64-8-256-4-0-0':
        '6bd234efc21a04d4daca2a6ecb73cb490034d34573fafbb185b47ceb6af086f3',
    'K10a-sym20-f32-8-256-4-0-0':
        '8a1479bc73b0545c9e7bb7f3b741cd3ab26b6c7b93af1877d6c8c6b9a3c07bb3',
    'K10a-sym20-f64-8-256-4-0-0':
        'b816c8061764e37d19a8f29ef138dee333dd65075b8dabe5094289902b5048aa',
    'K10b-haar-f32-8-256-4-0-0':
        'f91201d61598e594ebf1526c687ec844e020d29a1b873caea0091acc759c9aeb',
    'K10b-haar-f64-8-256-4-0-0':
        '9200c39635749fea80026bee0eaf1bf4d020c9cbbdeda0fff6f131f4be92be08',
    'K10b-db2-f32-8-256-4-0-0':
        'af1cc817c03884a082bbe54240dd75dd762c169c490e859c593b6841f09ce7e2',
    'K10b-db2-f64-8-256-4-0-0':
        'cca977c8d70e70b2fcfd0600c396bd9c6e376eb3ee717106c8017d3fe232b7de',
    'K10b-odd5-f32-8-256-4-0-0':
        'f7283fa0dfe1946edc20f4f435eacba74c7d00825f6a728d885b204897ac5dde',
    'K10b-odd5-f64-8-256-4-0-0':
        'b158f88c0b6fa84c4e080574c9888a95ca489aef4e0100441d76b2577ae18a6c',
    'K10b-sym8-f32-8-256-4-0-0':
        'ecf008adc1f06e43aacb73b0ff24ee40bc78231ca08c37c514444b19442226ca',
    'K10b-sym8-f64-8-256-4-0-0':
        '22a6dbc67c81bac281f2c7f1c15046d300f6484e61ed52717436f88be5875cb3',
    'K10b-sym20-f32-8-256-4-0-0':
        'de58b4b6f30248089d0664ced856b1a4143c8245ff164a9135d35a03d095f944',
    'K10b-sym20-f64-8-256-4-0-0':
        '2184c230405ac2ccb73142750b2aaff099461ea19611bcc1710e2f41ebe4d919',
    'K10a-haar-f32-4-16-5-0-0':
        '17079b3add79e8ad6b3e497bb73b056db473522a6ae6b933371271ea5a8d3ac4',
    'K10a-haar-f64-4-16-5-0-0':
        '2e0cd02c5b3e24d7b1116f253d3bcf66f8efa74e1e1cd1ef0688c3b6670dd86c',
    'K10a-db2-f32-4-16-5-0-0':
        '9adc385af013901782b7ded4390c2256ee331c197bf9741d27caba52a1afa18d',
    'K10a-db2-f64-4-16-5-0-0':
        'ef5690b71b0981d6c3ca919ad46d23ad7a30c19728993efaf2dcbcf6d8338ac0',
    'K10a-odd5-f32-4-16-5-0-0':
        'a8484fc54c9bdcf8e4cad7a7cdc7345d1e47d368fe5eba8dcdc0e93ecec0de06',
    'K10a-odd5-f64-4-16-5-0-0':
        '7f0d035be6e90a9cb2f97354fa20292605667d35d27632ac4efd29b0bdd7db9d',
    'K10a-sym8-f32-4-16-5-0-0':
        '577542519217176fd9be28f3b1504423297bfdd7112cc0fe0551f4f731aa9165',
    'K10a-sym8-f64-4-16-5-0-0':
        'a47d848bda413d88a3858ed999f3eeb11963b534bb85ce29d8f566118f1f20ed',
    'K10a-sym20-f32-4-16-5-0-0':
        '08c1cb5259a90bc8943309ffe53a683d05eb0141961693a6e1c35663f89890fe',
    'K10a-sym20-f64-4-16-5-0-0':
        'ac2c0dfb64ff26e417d12ffca07c78b35ac167e1a8426285b2000eab8771e18f',
    'K10b-haar-f32-4-16-5-0-0':
        'de8fb6933fff28eaaaba39cb2c261022778dbe5929789fe5bce69912f2c021ce',
    'K10b-haar-f64-4-16-5-0-0':
        'bf020f1ea8e34e0e6ab9fb5b10b44b8ce1c457a1da0ba114f2d4d5e7fa1581f5',
    'K10b-db2-f32-4-16-5-0-0':
        'd2c21ba6dbf7ea82b6fc4d2053ea3f75993f7aa04e638b7f70d5abf29b13fb8f',
    'K10b-db2-f64-4-16-5-0-0':
        '5a1fcaf68c936a8af6b3cd0138f16ba50771b887c5959f15177a728df213261c',
    'K10b-odd5-f32-4-16-5-0-0':
        '5927280ad9fad52fe93fbf8bab6ae43e51a5b6beda4c64667a6ee3212c5a89e9',
    'K10b-odd5-f64-4-16-5-0-0':
        '40096641a9301d161fc6fb152da09c78c094b20dde58c32801700034a7297119',
    'K10b-sym8-f32-4-16-5-0-0':
        '8f99408a5fea16d414feadc0c7bb4f5d0030b872177bd1ee70f34ec9314a4e87',
    'K10b-sym8-f64-4-16-5-0-0':
        'ede5397782772267094913d2e67ab222225ad376a7023974508fbefd3b5896d5',
    'K10b-sym20-f32-4-16-5-0-0':
        '80e657a9710eca08aeb3526776033f53c6b5a0c97c1db99cad2fbb3e05fa35fc',
    'K10b-sym20-f64-4-16-5-0-0':
        '2e72cc6c84ad29b464bc3cd23707fbf8456890c5a6a522a13ca9de34e58c9ebe',
    'K10a-haar-f32-3-10-6-0-0':
        '44ff8a79bacb127c57fd18d5d4d3d1f71e23f6b312975bc5a2e3b1b0422b4dfc',
    'K10a-haar-f64-3-10-6-0-0':
        '6a184093861aa244bcece1e1158a21396d08200795f14d45a1e0e2e296636300',
    'K10a-db2-f32-3-10-6-0-0':
        '177916131364d2bbb309503d138bff92c5a7308f71cf63ca10dd1af26cc6bafe',
    'K10a-db2-f64-3-10-6-0-0':
        '15b9363e5a51b92a5f0ba445a61c5fe37264aa580080edf6179d7be1eac12859',
    'K10a-odd5-f32-3-10-6-0-0':
        '23d1880cc079247cd2ec4e1ed554f8018d6b89f352edc83b747bffa69bdb83b0',
    'K10a-odd5-f64-3-10-6-0-0':
        'd615b6d2477dc15f2d55f2e48e3e4b78bd31ef855049a5887f86d461558bf8aa',
    'K10a-sym8-f32-3-10-6-0-0':
        '802e732eaec8c2dacc8b796755c78c7659358ab313104647386a0e8746b083ef',
    'K10a-sym8-f64-3-10-6-0-0':
        '5579bcb5b2a1a2832e4e408c43f49e3d04bd92552d9c843d794da46fc0ca8445',
    'K10a-sym20-f32-3-10-6-0-0':
        '9ca83bace48931dde917dbd62d820fd190135f164cbf3e80cf155f5462cbf8cd',
    'K10a-sym20-f64-3-10-6-0-0':
        '2f96d7d7b72b2d25b327a35268a136aed787363f1dc0faddc4685835e040bff1',
    'K10b-haar-f32-3-10-6-0-0':
        'fcc85af055ace657b3d65d8c8d8e2a16b4d598bc2b5130a2bca818444086188b',
    'K10b-haar-f64-3-10-6-0-0':
        'ed37084a697350731a383c584c86e8cc4748ef70cf72276e7507a8e67ecbec9f',
    'K10b-db2-f32-3-10-6-0-0':
        '8a685dbe603866e91871074249ca5c8dcf88aef2985afe7b4fecf50fc3b2b7c5',
    'K10b-db2-f64-3-10-6-0-0':
        '1256041d5d1fb4b5b04f23480c101d0fcaeffce0ccd37c56d95ac5994521b8e5',
    'K10b-odd5-f32-3-10-6-0-0':
        'b11c36647c5c48bebbf59697a05ed9e3fc186e96d86dee6569ad58f8da9904e3',
    'K10b-odd5-f64-3-10-6-0-0':
        '24ca8243878349bf97941fab47e94d405c16df114236ff42758d69d1e1ea5c5e',
    'K10b-sym8-f32-3-10-6-0-0':
        'a1c042ea51df8a75982e5c1ca9e24d6beb939c8c74df0057a4d3a159d43d3456',
    'K10b-sym8-f64-3-10-6-0-0':
        'f67659856d415ec53554c0ecda1cfcfe18af3636d0c91eae2754f714f2202816',
    'K10b-sym20-f32-3-10-6-0-0':
        '09349f766c4924a4f59a3e472d9adf6075dda130868eede4364dd6445cb5556c',
    'K10b-sym20-f64-3-10-6-0-0':
        'c3781986fc0314e68794d87c670369bfa7627b14aeb257d1a9bc4a59ad5fcd65',
    'K10a-haar-f32-3-130-1-1-0':
        '906a84eedcc9a08ee1f74e4edc18416ae7d9c6722b13bd25cddf915e7a933e73',
    'K10a-haar-f64-3-130-1-1-0':
        '695d1165d5145310297bdfdd87fcf5383074119c6e4d038b76880bed6923b803',
    'K10a-db2-f32-3-130-1-1-0':
        'bc108e4145ae2d90a3d33d1a23911b42d44e4c7dfca2699c8c7686a5c7ef368a',
    'K10a-db2-f64-3-130-1-1-0':
        '4ba946921432e50640057bb678cbaeabd2f37b448d979810c611e6e441e7c5a0',
    'K10a-odd5-f32-3-130-1-1-0':
        '63ae19798dad3161ed664e1364a7ef2e3e6d1a7a7425291ea27bef9ab36af627',
    'K10a-odd5-f64-3-130-1-1-0':
        '185e01d94b6e475fbe903644b6af3d8ad914831aefdf901ffdd2f259ccd93112',
    'K10a-sym8-f32-3-130-1-1-0':
        '19babf967d8ba0f956088efd630971b62aed5d6a9dca95a4e05c5642ace238e9',
    'K10a-sym8-f64-3-130-1-1-0':
        'eda26186e55d3595955030b48a5bd2baed2437d3479286a92098af9656e0e4c4',
    'K10a-sym20-f32-3-130-1-1-0':
        'c46e66ecb5204e3f95f163152362ecbf6349c5d58625d4c1733263b24990085b',
    'K10a-sym20-f64-3-130-1-1-0':
        '6d78b17b267ec903e4b31cc1c01e86be684de64bf688eaaba424bf0bfce078e9',
    'K10b-haar-f32-3-130-1-1-0':
        '7596b7c29a84e4bc2bb3cf3dd7aca13dc02fc49d3072d0fd88b2aa82f2d35324',
    'K10b-haar-f64-3-130-1-1-0':
        '95b55a5dee93244f93d7c0d1458c43ff8eabfa349e678ab3400ea1a393438334',
    'K10b-db2-f32-3-130-1-1-0':
        '125c49cd2bc066b7184f156631f7a568e6c73456e4d2c6abd38a17e753a68a2c',
    'K10b-db2-f64-3-130-1-1-0':
        '5b41ea659920ff55ef02b87be539dc9b45bb4b9551572789f489b2fbb5699f48',
    'K10b-odd5-f32-3-130-1-1-0':
        '2872b9d82b434f9f07caee9d558b5afe3a29e1d178cb10bd7268c4002ec7a1da',
    'K10b-odd5-f64-3-130-1-1-0':
        'f0cdc822fb0d4100a8bd4ddda2e0a2054cd2e9727b99c778e83c14da661433a0',
    'K10b-sym8-f32-3-130-1-1-0':
        '2bf94fc519c75723c408420190c7aedee71d1306339078ee36ab4f12b1075b88',
    'K10b-sym8-f64-3-130-1-1-0':
        'f9fc732440f5d929d07eaeba7d841f670ac2d331842ddeb09b19783ad6f21846',
    'K10b-sym20-f32-3-130-1-1-0':
        '24947c5fb1ac4c3abc2ea71a55dd879731bee3ae9a73b52fb985481e643a2587',
    'K10b-sym20-f64-3-130-1-1-0':
        '8f5588575602e3ea706684804f2f7427e32a9839b5bd6e844cacd719975cf6eb',
    'K10a-haar-f32-3-130-3-0-1':
        '802ab28b33cad31121f4650388802b963e4477a98db2cd3c8a5e67147e936b7f',
    'K10a-haar-f64-3-130-3-0-1':
        '9153631024b9bbc924bc05ad0507d4ce26ed54c920d34954628ae36297b57b74',
    'K10a-db2-f32-3-130-3-0-1':
        'e66f2f8ca6d90c6d3343dcc4e04d95282ccc8c820235b643392e684c2ad9ed1b',
    'K10a-db2-f64-3-130-3-0-1':
        '45590f143c77570fa8ddde69e64b10a8db28aa64c7b272847ab055fde996e31a',
    'K10a-odd5-f32-3-130-3-0-1':
        '2e884f1f0f8be97bbf5d1327393f30def9fd3d1c4764858d382e3b99e337880d',
    'K10a-odd5-f64-3-130-3-0-1':
        'c7102259ce46985e23d6e0261c0efd617b500f9afb1b7315d0b5f6f3cd2acb09',
    'K10a-sym8-f32-3-130-3-0-1':
        '59c35eddf4b83d4c4b467955d3aad02d0112c29c6c7ec65d475fad731a70bb48',
    'K10a-sym8-f64-3-130-3-0-1':
        'ae43ee6e274c23c6e38bb0a4a80278f8f2e36ffb841e6e46df506fd0240a6436',
    'K10a-sym20-f32-3-130-3-0-1':
        '632b8e303705302d3aa3ea5ce1d1a04f59e5c7bd3c9c0df80d304b08c70a7cfc',
    'K10a-sym20-f64-3-130-3-0-1':
        'd63b4dbf30984d05ea60c090b2a9ab25521f7cd9761975e9c96e1f3482ce4a58',
    'K10b-haar-f32-3-130-3-0-1':
        '0165207a166eefafee9d319fa79234a2e134775dfbda6e1c0ed152f9f491e364',
    'K10b-haar-f64-3-130-3-0-1':
        'dda718f683c545b1ed0e67b4645385c506e769ad4f376c097f452a48aff15dc0',
    'K10b-db2-f32-3-130-3-0-1':
        'aa6538ac1559475c218afb269a3f049b58c225f0bdc19e759a9438f8b44b9047',
    'K10b-db2-f64-3-130-3-0-1':
        'ebbcbdc28104b65d0acab935509498360c86c8792746f9e6e241c62a4174cf2b',
    'K10b-odd5-f32-3-130-3-0-1':
        '0f3af7e41dee21b45d0cde51d00f7a605cf7fbc3097eeb6f0bd1998d7e707a99',
    'K10b-odd5-f64-3-130-3-0-1':
        'e68173212ea200d284f60ae4a9375e8140db431ee60d0a66bec6fb43c329cdea',
    'K10b-sym8-f32-3-130-3-0-1':
        '4b4f0300298c6859439aee817ae0356fc4fe9e7ee61855cf529eb66a0339458e',
    'K10b-sym8-f64-3-130-3-0-1':
        'c0400ab88c8a822ed6bf0370e2c75c54477d5fbb75c4c8640f175d4012dcaf20',
    'K10b-sym20-f32-3-130-3-0-1':
        '2e1395ff28e2048f1c25db92c8850b16fdd50ec8f3d3c790e2cf3cd9cdfa8b46',
    'K10b-sym20-f64-3-130-3-0-1':
        'ded3ad95062e3af51f656d4d2583824b7324ad636ad62d5e39caa37dc1b67b5c',
    'K10a-haar-f32-2-75-1-0-1':
        '2e683a083602b865ff1029608cdedfde86d9fadfb5be92b28e1d961ea64eb741',
    'K10a-haar-f64-2-75-1-0-1':
        '1f89909601eb7bc6b975721b3b90c8ac44f2066b844e401ef5080ab5817a00e0',
    'K10a-db2-f32-2-75-1-0-1':
        '5f5723d9567ac2695038f35078792f00bb1f04cf61999c66bbb45d9679e2e7c3',
    'K10a-db2-f64-2-75-1-0-1':
        'a9ce46f886a7899260cada2eb0eaab7c96927ebf2b046db0c0dc52b79ab52825',
    'K10a-odd5-f32-2-75-1-0-1':
        '0b2d50e4acff9e68d87406a9006d31a84227c20bf591d1559271e022ae54de09',
    'K10a-odd5-f64-2-75-1-0-1':
        '15c3011468d815c71ffa61d620de4977347ed72344ccedf159ce4b84ecc86fa4',
    'K10a-sym8-f32-2-75-1-0-1':
        '0c7dca8d163fd1c9ba92e4c9ebcf88556ec81e9b7688e03d069e613966a6b945',
    'K10a-sym8-f64-2-75-1-0-1':
        '8dfe81642bef659ce4ce1f763759c4a00929c148c9bb36c646b390558390c85f',
    'K10a-sym20-f32-2-75-1-0-1':
        '4099477fd0346323bdaec7724ad78a5e621daeed914f513c3afb510b353713c2',
    'K10a-sym20-f64-2-75-1-0-1':
        'cda4d0580771abf7798c488c1976a2d71bcf5b215bdce8ae0afbb4837c198a69',
    'K10b-haar-f32-2-75-1-0-1':
        'afff104b5e3762413ad0b22cff0d5fce461df01748a453e6e6bef69cc2b94d58',
    'K10b-haar-f64-2-75-1-0-1':
        '598b58a7bfa13877721f2524eae63395e26b488a48208d2ed03e0b1b9d3d7a82',
    'K10b-db2-f32-2-75-1-0-1':
        '725cf9fb5d00738f220a57781e2d04a4f5a2d495d47089af7be15052f91831a9',
    'K10b-db2-f64-2-75-1-0-1':
        '971efdc88720af988177efef10e532abdc452df0621383bb0d7ad3eda6c20150',
    'K10b-odd5-f32-2-75-1-0-1':
        '037f2fa310ff90944ee9240f9ac5d9f6ef5ee6321c37befde3c50828825ff40f',
    'K10b-odd5-f64-2-75-1-0-1':
        '1fdde76b5e33b580aea4a92106d8993112890dbeae2103dbe0245784a71d6b01',
    'K10b-sym8-f32-2-75-1-0-1':
        '668281184653452c9ba30f5259f01f8d7c58be539baaa7889f53b85aa8067251',
    'K10b-sym8-f64-2-75-1-0-1':
        'fff241f245047ad066d90e70153e45091fc96bf7dddae6aa9c9d3167d3ce2b4d',
    'K10b-sym20-f32-2-75-1-0-1':
        '4d01e0e96cdf03465bed1eaef52db100b6be8891ecfc7afc72d165e407ccbd69',
    'K10b-sym20-f64-2-75-1-0-1':
        '59adaddf7c8eab46abc7c518a33391b99ad232d94f6b1762ea3ff6e467c648c3',
    'K10a-haar-f32-2-75-2-1-1':
        'a4717bb06ce7f838415742c8f34cd50308c57f2bd2e123087565c2488bfa86d6',
    'K10a-haar-f64-2-75-2-1-1':
        'b4f887b2393a87c716e0090b4d2b577dbef6bf288341e044c31784425c458053',
    'K10a-db2-f32-2-75-2-1-1':
        '31b4aee6435e6417b97bad79df9e5a6d6e5b2f443a66695568e77496d7a351c0',
    'K10a-db2-f64-2-75-2-1-1':
        '16ef0661e56d04448ad497f70f8198c3e5d7b19f009bdcfe8308d46a7fb40271',
    'K10a-odd5-f32-2-75-2-1-1':
        '0c385844bdbb8b05572e55875cf95f895ae68241f3acdd89b8497ecc2b347473',
    'K10a-odd5-f64-2-75-2-1-1':
        '34f5519cef9037dc45c7bb9a6d4066a192169575dc7fe7bdfc7f1025ccd1fb3d',
    'K10a-sym8-f32-2-75-2-1-1':
        'a114299c00893da8b761f4375b3e1191ad355cd7756963fe5906d855adddc5ac',
    'K10a-sym8-f64-2-75-2-1-1':
        '42b8c33dbb7108bc6b84004a7befa079394d47b242be026f4790e79ca5959820',
    'K10a-sym20-f32-2-75-2-1-1':
        '29519e1189b1d9823da9406ad39ba8efbae62bfe15f20ced0cf1e128ee1e6cb1',
    'K10a-sym20-f64-2-75-2-1-1':
        'b6c60bf2fb56caf4cf64f0bd599003a626a63fe74ffc61a89b65b35a62334250',
    'K10b-haar-f32-2-75-2-1-1':
        '925fc501edfaeedba01e77b5b1853d09c09208b0b9855c1d4bd6269ecce52f17',
    'K10b-haar-f64-2-75-2-1-1':
        'cedcc563e1821ccb3e423391b8416ceb55ea14cacd88a4d0bcc01a52b8039d71',
    'K10b-db2-f32-2-75-2-1-1':
        'bdeb418b8da6b0eaecd8bd44060970685e519e9e7e0f3b7492800f8dd8031776',
    'K10b-db2-f64-2-75-2-1-1':
        'dc2984525e4ee932cbbbf3e66cd5e8cdd90576b9c224c19d14ebded928daf303',
    'K10b-odd5-f32-2-75-2-1-1':
        '255cbba126f26e4a475b79470cde8531fb7e5f125ffe7f7200b91933f4f20176',
    'K10b-odd5-f64-2-75-2-1-1':
        '09812ac810380a8cb158dd8cf3b7fe7bde73b6bdd2638717b5b7ee0be092e28b',
    'K10b-sym8-f32-2-75-2-1-1':
        '9230e47ebeb06bccefc794e64c2ca85b5d2a6601fa0f13b405f718dfeb595c3a',
    'K10b-sym8-f64-2-75-2-1-1':
        'e6b3ff2d5b9594302bf99eacb045571a080499d08e73768f2498e24dfa171abc',
    'K10b-sym20-f32-2-75-2-1-1':
        '0d19072e1c6ab02b5c4ff8639eb8ac9b3b98e16333746d8c2b824af10e03e7ca',
    'K10b-sym20-f64-2-75-2-1-1':
        '756d2e8e46e9ab557ea00f2aba204c96bf3e61fb205551da34237bb5cfc0ff4b',
    'K10a-haar-f32-64-40-1-0-0':
        '338ff266f48cf06c09841e4789db5d1782e0c4d92c68b7cacf4e7e582b3ca26c',
    'K10a-haar-f64-64-40-1-0-0':
        '1abae9c7ec818bee87ed509675815e976809225ee45af975e1ee3e6a9e305797',
    'K10a-db2-f32-64-40-1-0-0':
        'c84573f16f3e9d14a32eb2cc1baf951c739ca73a57db3ee72df308609ebaf855',
    'K10a-db2-f64-64-40-1-0-0':
        '3aff83cde3c21ddc95adcb4cb3866fc4abf25ff6d39c9e040a24e7a5edf53de0',
    'K10a-odd5-f32-64-40-1-0-0':
        '6fb67fa8c56cc0264e70dd4a4391e94bf6d9857532a6562672e8947ef85f951a',
    'K10a-odd5-f64-64-40-1-0-0':
        '47eb0eec8be4f7a603ab64de6948e5d86f21088f587611a5ea67ca9a1f216e64',
    'K10a-sym8-f32-64-40-1-0-0':
        '5cfa32f38c728bb4c3c2d56168a91e92d535a1e059f89d0b11ce1b202778bbe3',
    'K10a-sym8-f64-64-40-1-0-0':
        'a4482da97601a4b6f8ac9b0c3c8204c28d1dfd5994943bd184d3dd8c9e9e87c6',
    'K10a-sym20-f32-64-40-1-0-0':
        'ac5f85f1bea669405eb2bb46e9daa4707b4686452025e29e526a15b923effa1f',
    'K10a-sym20-f64-64-40-1-0-0':
        '0e88ec907b1c5af8c56ffa8c8b9e4829c32ecb2e2da476275cba6c5c2c5feaac',
    'K10b-haar-f32-64-40-1-0-0':
        '9b43873ef96355d3084e022c1e329462f6496ed8112b71dec2dba82ba81c90e2',
    'K10b-haar-f64-64-40-1-0-0':
        '64db500ed49be5f925b2e1b8bd7137c6b09c0c919641d19068e3d9d164a45c5c',
    'K10b-db2-f32-64-40-1-0-0':
        '163c0ff2a8f3459f1a1bca6d9bebbd9fe0362d589733da5b8e05932400ef86f1',
    'K10b-db2-f64-64-40-1-0-0':
        'cbce02abe1f068d266ab623cb924fd821129e40bff66430cf17a48f640ba43a1',
    'K10b-odd5-f32-64-40-1-0-0':
        '7ab03b409fbda6f499010f60451884c6d8b15044bc9b72258221cffc96055b52',
    'K10b-odd5-f64-64-40-1-0-0':
        '1b00b9465d2fe63ede478666745be45667636fbcbf68b8967d6c1601843daf00',
    'K10b-sym8-f32-64-40-1-0-0':
        '200ad2a776f8e335c8a6983b61a4794b6f886325722e38962038d6bea527cc32',
    'K10b-sym8-f64-64-40-1-0-0':
        'de4f6a2a02c1d5e27ab27a05970387f2fb35318eda442887dcdd9d9752bba1b6',
    'K10b-sym20-f32-64-40-1-0-0':
        '2741a017375e31a5205aafe55293c4a1cea62528298879ca0e4b0dacca1558fd',
    'K10b-sym20-f64-64-40-1-0-0':
        'c11f3416162f728631408798251df140d2b190d230cfb277012fbe758955f8f4',
    'K10a-haar-f32-64-40-2-0-0':
        '09ed8765e0ce1999a975526a7d17698f19fa1688e8c565e831e5385fd816fa7d',
    'K10a-haar-f64-64-40-2-0-0':
        'a1fe4c7bd9eb4de3a4a22a9515668625aced83ac0e23d34c9ed539c4478b901e',
    'K10a-db2-f32-64-40-2-0-0':
        'b5a673c8f3c262fb677256ccfaa51d19125feccb9fa2ba2cd62298910e47634d',
    'K10a-db2-f64-64-40-2-0-0':
        'e21177553bd3b930d451535d87a34d7b9ee2b3b9623a530fdb28052256864d06',
    'K10a-odd5-f32-64-40-2-0-0':
        '197e7666a2b9174e229d774962cd9144250250903fa253cde87bb09f5f6e4248',
    'K10a-odd5-f64-64-40-2-0-0':
        '5a37a381d23b529a9b6e8e0ec27e831a8c2500c724b1f958f852317a2bd2a6c4',
    'K10a-sym8-f32-64-40-2-0-0':
        '15c7d892d5feeb38d4859236243fb121e37beb1e8b42ba24a20e280361e5a871',
    'K10a-sym8-f64-64-40-2-0-0':
        'bbcaaf9457ed20fad70c2be2c2a45faa455f2b5ccd88d3f90b6b347bf81667d0',
    'K10a-sym20-f32-64-40-2-0-0':
        '4138f854d5fee6102d2abc3bf1c144eaafcde9e88c505d40930ddfae0b49d30d',
    'K10a-sym20-f64-64-40-2-0-0':
        'd8cb66297ae0c33ce4dad24fe8af2247b1651d2fc9b68224acc493b94a7b55a2',
    'K10b-haar-f32-64-40-2-0-0':
        '164c90b21c6eac2413639507c68ca35706c3821ad0aa6ce191e4e3072e62020a',
    'K10b-haar-f64-64-40-2-0-0':
        '7719bb404742821940fab8e8da9f5c6fa6af558e2c0ef144e8064d4972cb682e',
    'K10b-db2-f32-64-40-2-0-0':
        'd3d72410f1b557300ada32f4e28590e35f390efa884993134da3394c881dc7b9',
    'K10b-db2-f64-64-40-2-0-0':
        '98886ad9aaec3975cc2d89ceca048e2cfafe91106c835d0783d70ac0380f58ba',
    'K10b-odd5-f32-64-40-2-0-0':
        '31fe4dbdbd8ba5278e0177eaa64700b97fd8bb9c1b89d718b4d3646524ef2a12',
    'K10b-odd5-f64-64-40-2-0-0':
        'bb39501efd35f03bbdde6f22f8eaf92d03a917a9de0aaafcc6430ef1c87c60a7',
    'K10b-sym8-f32-64-40-2-0-0':
        '80fdba4b0b5a95a3bfe88baa819f88418289cac684258fefda531ac1a3fdd51f',
    'K10b-sym8-f64-64-40-2-0-0':
        '4a915cd2e4c11e1393691dcfa71e67c992ffa8637940cdb1430adb31edd3bb92',
    'K10b-sym20-f32-64-40-2-0-0':
        '1f07760421810d66846c04914598a82e60da6de7480801837b369006e3be41a7',
    'K10b-sym20-f64-64-40-2-0-0':
        'c05609ced9abe65a0eaac0b2a5f08313c990008c602e92ab709ae25c86fc00bf',
    'K10a-haar-f32-300-8-1-1-1':
        '46702a5791190df32a7766df99ff3f0304f7d37db6102fa3b6e88045b920eafe',
    'K10a-haar-f64-300-8-1-1-1':
        'b6edb76bb21e8b7a72806a4901553a75af0c0449dac412fd0d07fd43f2b6260e',
    'K10a-db2-f32-300-8-1-1-1':
        '4bd0ec7eec3cd75f553bd5b9ca6d65c17a96213d3ef1fe99e6445a79398c8623',
    'K10a-db2-f64-300-8-1-1-1':
        'e9f736dd0fa3de97641df54221cebc31b0ae38aca281789aef0dd9aef323da91',
    'K10a-odd5-f32-300-8-1-1-1':
        'af93b0948f96015d2920797f6dc5e7871c85cf7e191493eeec16485845fdc4f6',
    'K10a-odd5-f64-300-8-1-1-1':
        '45aa066e0268381db0aaf52ef4a8d1978b508cc000ab027a3c9b0ad713ca04eb',
    'K10a-sym8-f32-300-8-1-1-1':
        '714ca55096f64196f464e988cc04c9a90836ddc0d670ceb970035c8bc126b06b',
    'K10a-sym8-f64-300-8-1-1-1':
        '59eaab466baebf7b11838a98fc43db53b81008626bff639c7c760bcf436ee261',
    'K10a-sym20-f32-300-8-1-1-1':
        '78227c9fe9a3c41e652187cda644f4cdf086a4da3b87039f0ca16613ba18fbfb',
    'K10a-sym20-f64-300-8-1-1-1':
        '2bdb05ba55d19f4049f132f67f5360e02b1363a6c54f84b79ba366a3c7fba166',
    'K10b-haar-f32-300-8-1-1-1':
        '4c7bc9d307c5e62d74baaad8682e0892c73777733315baf6f51be9c84f4308fc',
    'K10b-haar-f64-300-8-1-1-1':
        '7619621a7740460cd4e1dd9080b68c18dd90be5dc0e90e799c3847a824ad416f',
    'K10b-db2-f32-300-8-1-1-1':
        '137128e8bb230b519c38f5d2572db0f19326cf32b43d3825591c4eaddb2d5796',
    'K10b-db2-f64-300-8-1-1-1':
        '98a26d567894ad4c50b89667ce4f3f7bac664bfe96f1027ced8b6aea3f189a3e',
    'K10b-odd5-f32-300-8-1-1-1':
        '3a729b0aab52566a0571d468832b3b74f9af13c5d694ca7f9e4048058ef46e08',
    'K10b-odd5-f64-300-8-1-1-1':
        '7220e55e8eba1f0c58150a19f21a77a00ae0d9cd4d0b17b2a69db8fe5bd40367',
    'K10b-sym8-f32-300-8-1-1-1':
        '444080bed1ac82a6456717d7001c652266a1da18e39a885a3949a0296033e14a',
    'K10b-sym8-f64-300-8-1-1-1':
        'e213e62bbbb8dee669f0596931f1109e76278e6908b0f1392b00f6aef27137d7',
    'K10b-sym20-f32-300-8-1-1-1':
        '64b6c15231e88cdd9d9b0815fc5bf1b82d00b44e5824042851beae5b420e43e6',
    'K10b-sym20-f64-300-8-1-1-1':
        'd94773d5ae69e16a99ed266ebb4f4ecf3439bbae674a1954f1573b1549e9fc2d',
    'K10a-haar-f32-4-16-3-0-0':
        'ead563fcffd75ae6a28aff42f481562686f7bab5a4df1860835e0736dd5b82f5',
    'K10a-haar-f64-4-16-3-0-0':
        '29434bb82a7756ca874034654b5df0d53bf4068b56263913ef57b71dff34992b',
    'K10a-db2-f32-4-16-3-0-0':
        'ab690cd663c40b31cf15e86ff315729795a13daf55d0303d4b5655fddb2f6b3d',
    'K10a-db2-f64-4-16-3-0-0':
        'e9bef2a466daf0aa625fa73f76255d7550c35705bc636dffaff5f48c91072857',
    'K10a-odd5-f32-4-16-3-0-0':
        '2de21dfc508fac9153e3833ebfe080bcb66614fcdc7daae31d43f4761edb1fa2',
    'K10a-odd5-f64-4-16-3-0-0':
        'd7be64db8c1c995f8f11834b8e88b77c64f516ce0033379aededdf81b58dcca1',
    'K10a-sym8-f32-4-16-3-0-0':
        'cfd4d6618850150c4341bcc44c4db3fe7c5361562250bd1177894f9ff2da1501',
    'K10a-sym8-f64-4-16-3-0-0':
        'a8111b73de965ef6c83e20502a240b904caa7b5568c4f9f0212ab1d3a39af18e',
    'K10a-sym20-f32-4-16-3-0-0':
        'dd478e8aa6cff2b5174fdc4ecf6eb7d44f3d188d1350db9645d7d42d1423d746',
    'K10a-sym20-f64-4-16-3-0-0':
        'a7ea5dd0e2fc1a838cbdcbb11c10da54c1b355e2fecf494646a87a93d2762f50',
    'K10b-haar-f32-4-16-3-0-0':
        '2c7c931507460497dabfa373af6e2b0b9eb62b33b7ac5b1b82e3e3e72fdb37ca',
    'K10b-haar-f64-4-16-3-0-0':
        '0c0131453ec668ce20604f024c67087faedf999318b0514953d7ed13f6ea4af2',
    'K10b-db2-f32-4-16-3-0-0':
        '64cdff55045b969dc28958960f24a1b92746cddebaa667e86cb784a4bdb64e24',
    'K10b-db2-f64-4-16-3-0-0':
        'd64a0fd678530df80774c1263b8f79164ac73b82bc5bdeb6c0a9de6e1e76912e',
    'K10b-odd5-f32-4-16-3-0-0':
        '917acad96cca65438cc5c30750cb223d92a25d13b7753ffe73f50afa319d8e20',
    'K10b-odd5-f64-4-16-3-0-0':
        '151f8adadd509c778c20b8e6674edc63b43db2e0779ccafa2a97712a8208f5f0',
    'K10b-sym8-f32-4-16-3-0-0':
        'f42c48c1519757c326a83900771e1a593157e7eb7f5af8df6e5767a1d2a8ef4a',
    'K10b-sym8-f64-4-16-3-0-0':
        '07ec6ee60a6028d1f01d880dc8d9f1593143fe400ac6e4134c53b67b1d37b001',
    'K10b-sym20-f32-4-16-3-0-0':
        'da696fb8425dbe9729cf3fe2158a3d11ed75b19a670f23ef065c8760592e838c',
    'K10b-sym20-f64-4-16-3-0-0':
        '4813ee7b75c4cdeb4ad0c6807bad99dc5c1b6b59384b3336fdec99f9a30dd84b',
    'K10a-haar-f32-2-4096-7-0-0':
        '5ab81fdcb0058f44c9081741e044124306c81d2cb6d020954c5fb2d3df026222',
    'K10a-haar-f64-2-4096-7-0-0':
        'ac44e67e539575c3eb62a33f0724b9712e122c2f931bb4a5087747bfa7296248',
    'K10a-db2-f32-2-4096-7-0-0':
        '075a00e0789181710f79a448df03561c3b3c2f9c3798163a2034f9702daee3aa',
    'K10a-db2-f64-2-4096-7-0-0':
        '15d8cfbeb6b0a45d3cf7ea07c655ac0230271ce6046b9d7360ce62439ca98732',
    'K10a-odd5-f32-2-4096-7-0-0':
        '3a8b4fa72d14c24162fb50d8c817883081fc560802909b505f4bed261680a979',
    'K10a-odd5-f64-2-4096-7-0-0':
        'd6d69898734884df5ac3eabfe3faed8b400937b2bf2aa59f39a243189798fbfe',
    'K10a-sym8-f32-2-4096-7-0-0':
        '4c9bd0514e3fe22d4b91d93064614c75324a9cd31798cc372ad0914893fce76f',
    'K10a-sym8-f64-2-4096-7-0-0':
        'b69f990f489d5dd83ad9f13f67bb2373efd38e3d84c515f4d8adf75b96f8e802',
    'K10a-sym20-f32-2-4096-7-0-0':
        'a47a4b538abfb15bb3afb39e6e7e33ac8d955fc9e7d6a1e023fe5e1366a9efe9',
    'K10a-sym20-f64-2-4096-7-0-0':
        'bf634ba42e3a9814e874b086ebace7e6d4c885769c72d19e6391b23d3ea0001a',
    'K10b-haar-f32-2-4096-7-0-0':
        'c431ed240e6e7f02e7cae54bde66a09017d0d608124b4cdfc6cd854239e9eb03',
    'K10b-haar-f64-2-4096-7-0-0':
        '85cd36d2b002e09f846840b4c77220707107fa2836a15d0d4e0636235f3772d4',
    'K10b-db2-f32-2-4096-7-0-0':
        '8659bdb40ce5c9075fe3aa01ae0f283d8ef9d92293780c8df40eb8735a1a020f',
    'K10b-db2-f64-2-4096-7-0-0':
        '3595b617b5af58af64e0759ccc359769016790cc460daebc2de93507729fff3c',
    'K10b-odd5-f32-2-4096-7-0-0':
        '72c4a8e52d38ab119501a59df006341e59a13e46c28bf038b3c8b657e34f33fb',
    'K10b-odd5-f64-2-4096-7-0-0':
        'cd0d7dd770ae5c0e5ba1b26896f5eb22d9d56599428822720afd9881a73fe28a',
    'K10b-sym8-f32-2-4096-7-0-0':
        'c8567dae91b8bb939f3f1fdb263a6c6b3467f3540ed613a0ec6f6c112c38bc49',
    'K10b-sym8-f64-2-4096-7-0-0':
        'ee8e9769e4c5719248eb60f90bdd1f86f73f3b188d3dfc615edb3dacb875331c',
    'K10b-sym20-f32-2-4096-7-0-0':
        '892778efd9f715c4aef183d1fef781f9648af9b82609287fcae4cf807f5ddd1c',
    'K10b-sym20-f64-2-4096-7-0-0':
        '818cc2e6d3e71405dc7b977ed8fd21d73736c91e1b49facc603aea4869444a5d',
    'K10a-haar-f32-2-1000-8-1-0':
        '2ad2b64d7869b9da8962bd13469e886761912282f0744d4f44b09384b2637e7b',
    'K10a-haar-f64-2-1000-8-1-0':
        '8681ef8fe48efdf6b0c6f066845946b94e4f8ff47c85f3f50bda59061e3bda9c',
    'K10a-db2-f32-2-1000-8-1-0':
        '920716f001faf7386653576152f7d0e30845617d22569eb23f8b52ef55335e67',
    'K10a-db2-f64-2-1000-8-1-0':
        '4a340d0a2d6766366655328f96cb283819d91e1cf8745d1cb1de5a4fe3b08da3',
    'K10a-odd5-f32-2-1000-8-1-0':
        'c00a8b0438fd4950dc3e79dc915db037a09550e729d6313c76525937a06b025c',
    'K10a-odd5-f64-2-1000-8-1-0':
        'c111410615162c6c5196f521cbf3200b4a8b5e36dfb8891d4fffc4abc67ca3e8',
    'K10a-sym8-f32-2-1000-8-1-0':
        '867f71a7bf79bb6bb39601d89b8b81c1c76d510d92aaa9c5d213f99eb38b1189',
    'K10a-sym8-f64-2-1000-8-1-0':
        '8739a5d6efc91a013e9e6b57a1e508e82b230cb4bc0bef76d759a19dcbdb678e',
    'K10a-sym20-f32-2-1000-8-1-0':
        '3a062362d72b766425303bb79116d27efcf24d78253bafb452b6dcd4d6f374e3',
    'K10a-sym20-f64-2-1000-8-1-0':
        '415923971e2b98c88e1157c6c95df38610ff38b9047e28160d9c82bc52d83b95',
    'K10b-haar-f32-2-1000-8-1-0':
        'de2aeeba5152dfd4ba6be8e6dd01f7d4be842ca3d2827186e589e795edb1950b',
    'K10b-haar-f64-2-1000-8-1-0':
        'ec0c86fa5b071df126423e483360a879f0c1b560a9b4a5c18ed1c1b777993980',
    'K10b-db2-f32-2-1000-8-1-0':
        'f8b4ecd6bc77f71183b5e52622e051ee65b787008905f55aeff9151319970b70',
    'K10b-db2-f64-2-1000-8-1-0':
        'a6498a8cb6eac94a976f76d514eed25ae77ba20befa11a3b5b140f16c59e2251',
    'K10b-odd5-f32-2-1000-8-1-0':
        'c5bff382a653e443c2f76514f9abfd9bee3ddae9bedb975ed49a0c9d430386f7',
    'K10b-odd5-f64-2-1000-8-1-0':
        'e053bdc38c809f9222983f994217433543ec8165ed74c1d0579cd9337a16f082',
    'K10b-sym8-f32-2-1000-8-1-0':
        '2789b39005eae50b1f10fed071f39fd449141e7f5b6c9d751342cae02c7826de',
    'K10b-sym8-f64-2-1000-8-1-0':
        '588baba3e9d48c54ac2425aa886fddfc48025842235c6f7182863737fc27b987',
    'K10b-sym20-f32-2-1000-8-1-0':
        '7f5ab4444de046e4bd2e8a32efd137770340b7e419bef930d0aba62fe2c4fc8a',
    'K10b-sym20-f64-2-1000-8-1-0':
        '7f47aa8c605a141e2f240c82c5b55d2e2a20c14feb074c1ce7f1466bb5416e20',
    'K10a-haar-f32-2048-2048-1-0-0':
        '46d8271b4422136f3a5144521e1823a8accbb9092e4f611328233835662b6872',
    'K10a-haar-f64-2048-2048-1-0-0':
        '5dd15b2179e273b33fb944da3a44d857c534128f57d0f23d1a5c6d3b5afa494b',
    'K10a-db2-f32-2048-2048-1-0-0':
        '48381633ab49dd152fe449181382b88c493f4500ebca49919d3f55b50b28ed70',
    'K10a-db2-f64-2048-2048-1-0-0':
        '90c7369790819e45aa832b5252092335e35899bd318b9bf681994334dc234cae',
    'K10a-odd5-f32-2048-2048-1-0-0':
        'fccd8f96821716ad5b323fd7c511f68b07ea8870fe5c11d8c80c5dda01dcc652',
    'K10a-odd5-f64-2048-2048-1-0-0':
        'c59458eb047e8d46a8958735bed1e2e9e7bc4496369c3f1751a67871d8176e58',
    'K10a-sym8-f32-2048-2048-1-0-0':
        '1ffe17f30cfa7dac26040ecdde7926fff96ac54dcd1fb6426cfe7752b72963c4',
    'K10a-sym8-f64-2048-2048-1-0-0':
        '5abf4e27039fdace7e1f955e77b7d1a266666cf4ca3e600a0a2615dc87c0e931',
    'K10a-sym20-f32-2048-2048-1-0-0':
        '1bcc4c93dac9ddfbfe3c6665d2ca2245084e0ab21c54b0b149708400f66d8838',
    'K10a-sym20-f64-2048-2048-1-0-0':
        'a5527076d04f9098f722cc2c0088bb313513580d6e21e4d63240f40e5612d111',
    'K10b-haar-f32-2048-2048-1-0-0':
        'c6e145b40f28e81b88d1b55320c69d1aa196fcb29f689f607af8f96c0168cfa8',
    'K10b-haar-f64-2048-2048-1-0-0':
        'd404aaa3b60b5d5a136ed5e3a98ac591e376f8ea5b91c4e5a26b99c884365387',
    'K10b-db2-f32-2048-2048-1-0-0':
        'e10ba6c6a2024b83d7090b05c5a39b3c3a72c3c7320a226b55cbe3e059916a6e',
    'K10b-db2-f64-2048-2048-1-0-0':
        'fcd37f84dcde0a6d4242ed6f4da42d4dfa6b940c4ba6c33208286c91ab7032ee',
    'K10b-odd5-f32-2048-2048-1-0-0':
        '1906c6933f524206883a2bc3e13f8ee872ef2748a7225754df3b1fbfd1693d9d',
    'K10b-odd5-f64-2048-2048-1-0-0':
        '0f112124c56884864dbacfcf424ea9adbac61b27a0e9c9d26d03eb67de0348ad',
    'K10b-sym8-f32-2048-2048-1-0-0':
        '964854527a0a031483a08b2f56a126c096aa33100d5c4cb8eecd45d0747be8fa',
    'K10b-sym8-f64-2048-2048-1-0-0':
        '5d05ac877a4e7b64a9bfa1cfb4fa3ff12bfde84cc6ccdb146e80aa9324191966',
    'K10b-sym20-f32-2048-2048-1-0-0':
        '8846b3f37c030fa70e9f1e593a96a11d7a6226039977acebb50d3384e224eb40',
    'K10b-sym20-f64-2048-2048-1-0-0':
        'ae33c095eaa6ee92cdada8eb0f95c74f2ed1b978af26153fbb30de0e3172fd6c',
    'K10a-haar-f32-2048-2048-2-0-0':
        '88e157580b5db0b6ef1934157a4326c81f45855f87ac6435a17a2399c897e216',
    'K10a-haar-f64-2048-2048-2-0-0':
        'c72ed1e08ef8c934aafc4339ab94aa36d9a15d9761506c206b4e800505e4ab77',
    'K10a-db2-f32-2048-2048-2-0-0':
        'e49d71dab79ee4c9633e43dca6ea308f99f5478fd89f08c7524ad98c33f985c8',
    'K10a-db2-f64-2048-2048-2-0-0':
        'd9dd5c66245291ce05a3159b48b48a341e48fd487a007a312615c87234d58c67',
    'K10a-odd5-f32-2048-2048-2-0-0':
        '7768955b07c3b23df12130b00f2db47f215afdefece9c202e8d00c08339f6a41',
    'K10a-odd5-f64-2048-2048-2-0-0':
        '75bde84d0842dc7616f99e7f1c5bcb7bd1602affad1f1ed0969549d1244324a2',
    'K10a-sym8-f32-2048-2048-2-0-0':
        'a05c306526b2698cb2b7d714dafc2e1e2fdf739b57a9f0def0ac7f47cf64672e',
    'K10a-sym8-f64-2048-2048-2-0-0':
        '3a740d426d8617d935461502ebefb053df541af4346ed162b10ff72ce74ddac8',
    'K10a-sym20-f32-2048-2048-2-0-0':
        '4e63969e09fffdec1ec07cd8a2622f173ac545f8ec16e539801353c82821a526',
    'K10a-sym20-f64-2048-2048-2-0-0':
        '71a471e9b59ebcf0f07ce14c2cc0685b6f2ab0457e1bcacd7be0e1dcbcdf1262',
    'K10b-haar-f32-2048-2048-2-0-0':
        '1b15244d9351f17bd6e8f9595c0ec184e28e48bbbf8553a67e139d3a6fc89bff',
    'K10b-haar-f64-2048-2048-2-0-0':
        'faa3e8a7297e277338528127e19cd1a5f2265bf83ac80808dd80fe0120b4bced',
    'K10b-db2-f32-2048-2048-2-0-0':
        '3771e5b1793696f1d4697e4e2410c07fcfdf8bc0da548c87a1e9e2b4b12f61cd',
    'K10b-db2-f64-2048-2048-2-0-0':
        '80dd746d205034815f72e8ea9b7bc304ff11744573610ee8bbf6db5e724f10d3',
    'K10b-odd5-f32-2048-2048-2-0-0':
        '88d605a99f13c77889f6e390a7e836628eb2b64d473af2195043b5690bae6411',
    'K10b-odd5-f64-2048-2048-2-0-0':
        'daed9958dabbc0b9877b11956441bfaeb0e7130cd7bb75b5962fcfa26ebb1c95',
    'K10b-sym8-f32-2048-2048-2-0-0':
        '5a57747fc347270754a374b8c58bbc82a8db0125dce0d1ebbb92567668c99390',
    'K10b-sym8-f64-2048-2048-2-0-0':
        '2e1466cd19bd2b21396c134481230b8585b4a7bc6db7d7fa861287574783117f',
    'K10b-sym20-f32-2048-2048-2-0-0':
        '7809ee5dd9008c77c7e6c6521ce71d6a75d75b4672659cef5f40fac703a97537',
    'K10b-sym20-f64-2048-2048-2-0-0':
        '81ea653788a69e87a41f58e05d41f703b7e6d85a5342da75ccf6579ea9ec32f9',
    'K10a-haar-f32-2048-2048-3-0-0':
        '56d40a6674d7cfc4d93f6524f1cf091b97a04cb7aa80e524117f7614f4734878',
    'K10a-haar-f64-2048-2048-3-0-0':
        '20d2d87b36f72127d8c2c8328791583e5d7a87bcda77d10f070359d43eb7749c',
    'K10a-db2-f32-2048-2048-3-0-0':
        'b2e1160ea78617d3ec042f2ea63895905e363fece2d1df86a7ec3b5adad1fd57',
    'K10a-db2-f64-2048-2048-3-0-0':
        'd32c5fd1872761bc87b7bead7b35a090af814dcbf7e6e395728c4af770106ba4',
    'K10a-odd5-f32-2048-2048-3-0-0':
        'e125149dc61986c6fb9968f26d1c12176c7be3a782170fb9bc82beb903cf8b36',
    'K10a-odd5-f64-2048-2048-3-0-0':
        '4bbe26675fd3d1acf71483338a5e94ac6d732880490caa53a0dc00d99ecf9814',
    'K10a-sym8-f32-2048-2048-3-0-0':
        '6d346e880bc2da7457f8c7bf2888e5600c8b4fb36f00bd85d2ed6b0f839fecd5',
    'K10a-sym8-f64-2048-2048-3-0-0':
        'db6ecdc8010838f19dd8dbf378567a8bfff0fc9369e8fb36f8836e60796c25ea',
    'K10a-sym20-f32-2048-2048-3-0-0':
        'bfa1ec19e9a3016f1c73cbdfa0174bc259cc4dd2f683f986ab8e18424c86cdcf',
    'K10a-sym20-f64-2048-2048-3-0-0':
        '8b2bb45781e191a30a7cfb49aa019092771a5d83dcd184706e39a1243939a8aa',
    'K10b-haar-f32-2048-2048-3-0-0':
        '1209aa96fd8a70e9d3ab9ee0e5330d91389dbcdacdb073dc5a2c57e77a5d4dfe',
    'K10b-haar-f64-2048-2048-3-0-0':
        'a406195e0d882b93b93b7453c333c0b48edb6f27d88eb833b5760cebd75a8d67',
    'K10b-db2-f32-2048-2048-3-0-0':
        '8b7c7779bb201faa00443c41c1277d09401b413e45a3a16b516a2deed37b2430',
    'K10b-db2-f64-2048-2048-3-0-0':
        '649eeffaaa385686e87c78497283fe22183cfcb7f63bf5f42a3a214ef1247136',
    'K10b-odd5-f32-2048-2048-3-0-0':
        'c570404ee8e3dbd126fa1cceecd519e85949210b5035d541fe2f9b83185e83ec',
    'K10b-odd5-f64-2048-2048-3-0-0':
        '3caba5bb1c65ca77dea02960d1ae989968cad9f5ad07abe7e83c6fbe33633ca1',
    'K10b-sym8-f32-2048-2048-3-0-0':
        '4eb5ad0b5e8df7e30f874f386563ff28b1a38fcce1afd3de2bbc757f0811af3c',
    'K10b-sym8-f64-2048-2048-3-0-0':
        '157e4ef31146dc574e29114c2948b3f70007a8a989770bd5af5256c2b8e7c936',
    'K10b-sym20-f32-2048-2048-3-0-0':
        '5a52a5d27da351aaa6e6e33d77748f61274381c4eb266f8ceb6bf4717cc864dd',
    'K10b-sym20-f64-2048-2048-3-0-0':
        '4078b536f19118b96ef73c0dad3560b3d1b46b37d77ff86115ea114138e47497',
    'K10a-haar-f32-1-4194304-1-0-0':
        'e00ab98db61f8ed5f8151967b4b9793b6e78c0d2a1adb57306aac04f81f7b94e',
    'K10a-haar-f64-1-4194304-1-0-0':
        'f0fb4ad4953bc4c926c37c97db46f038c64eb9f89dff58da6c98f228e19b2bdb',
    'K10a-db2-f32-1-4194304-1-0-0':
        '1abec18327c11c00caacae6a80f9d0dc8483e3cd3ea77da82a610e71e0ea0239',
    'K10a-db2-f64-1-4194304-1-0-0':
        '3f9259ee05477f072d087f7aad7298b1eaf62c5340e1dddc2bd624d69c936944',
    'K10a-odd5-f32-1-4194304-1-0-0':
        '75fc452c2bcfbce47c7b351631df9020debfbbbbce87e6ad614745d27eff4cdf',
    'K10a-odd5-f64-1-4194304-1-0-0':
        'a56501ab59791cec612601e9a98092a093a559625144fc80402e462c1d3ad952',
    'K10a-sym8-f32-1-4194304-1-0-0':
        '1996f920829341f13a3e2da57719321e45d03e784552e7d161c08a53237fbc53',
    'K10a-sym8-f64-1-4194304-1-0-0':
        '41d509c8ffdaa4e5c31360c0d3000f61b20d17b7d4d9a8138cf9524af2310da0',
    'K10a-sym20-f32-1-4194304-1-0-0':
        '245ab25f4897590ebe2e9cba6d78ffa7dbaa78b26ab7f1d1a73ee6be91983891',
    'K10a-sym20-f64-1-4194304-1-0-0':
        '706917aa9bd9d680597936f7b797842051a7e8f45630819702bee3842be0a84a',
    'K10b-haar-f32-1-4194304-1-0-0':
        '894156422b8808df4fdcfd16275a77aaf331d29f1fd49f1b29c41c02af265646',
    'K10b-haar-f64-1-4194304-1-0-0':
        '46b70f7a7ab3a7d1ea36343af4698eee945deeefee3ac7a7494d3d9efad86b72',
    'K10b-db2-f32-1-4194304-1-0-0':
        'e591e0461a832f0dd3ce7b5ad19b1540b91048b06a0f5d7e3994ee6359f60d30',
    'K10b-db2-f64-1-4194304-1-0-0':
        '23ae0b72e698f6df150d93cbb4e403c0e7f717521d869844436f9f7909c1f125',
    'K10b-odd5-f32-1-4194304-1-0-0':
        '6a903eeb747ff99a53986b66641c5ad55c9f73b6121e34be55fa7b5b67950542',
    'K10b-odd5-f64-1-4194304-1-0-0':
        '4e865a79f8dd1405ca9e851827b0462eca51c9d15c4c33ec48f025baa354b3a4',
    'K10b-sym8-f32-1-4194304-1-0-0':
        'bac8966d9ee14c810e8aefdd690e941c05cb55d461b818e02350e0ed21070462',
    'K10b-sym8-f64-1-4194304-1-0-0':
        '61888c6aec1e0f2915f83b8fec1ffe10b79c028c514a82d876ffe0d4ed925ef2',
    'K10b-sym20-f32-1-4194304-1-0-0':
        '6dc95d2bf8ca6b3065cced781adf5fdeae4ca409947adf0938d134394810b2ac',
    'K10b-sym20-f64-1-4194304-1-0-0':
        '0c1627d20cb27f42a8270b280cb0ecb17993b491e94ca8a40905d6962a2ffb66',
    'K10a-haar-f32-1-4194304-2-0-0':
        'b9a4f976a9d3a5e75e1ee2c19763e729cd72d4c7b7a40e05602eb76f92f07d9a',
    'K10a-haar-f64-1-4194304-2-0-0':
        'f6e67536da00c7b284933eea0729cb30741baef2b2861174b37a107e09dc2d33',
    'K10a-db2-f32-1-4194304-2-0-0':
        'bbf95844625f78f671009a8b955b5ab45f5a92f05f14475a8de084fa685e02b2',
    'K10a-db2-f64-1-4194304-2-0-0':
        '4bc0bc58e08980a30139b020fe3be0ec388113066936bf49fbef5ca40b6a0457',
    'K10a-odd5-f32-1-4194304-2-0-0':
        'f33f72f33a5b6e07e1dd80c5d22318293f522783a4b68047dd76a18e0d1d8e90',
    'K10a-odd5-f64-1-4194304-2-0-0':
        '44e2ed6ee2f0e19c5634c62d446426f0a03dd39ff8d22792a581868d9ca5a47b',
    'K10a-sym8-f32-1-4194304-2-0-0':
        '4fb935377fc898f68bcc335bc9c020543b306baf936e121ae8515cdd6d0c7c8d',
    'K10a-sym8-f64-1-4194304-2-0-0':
        '7f07b624e8a267efae31da20611a7fd36e2c724e62537dee4bdbee9dcb1361f3',
    'K10a-sym20-f32-1-4194304-2-0-0':
        '063f45e3e80b234273a0c250aee33e4ffe59d57326af5ee6f9febbab7e8482a9',
    'K10a-sym20-f64-1-4194304-2-0-0':
        '301905bb86b3407e00eeac1906c105084d3e77b4d01b518881a78e637da68510',
    'K10b-haar-f32-1-4194304-2-0-0':
        '342078f8c4a572bff8d3a0d7098aebf0c680168bc0b638221da8d24f80086c41',
    'K10b-haar-f64-1-4194304-2-0-0':
        '663eb88a88316b572651a8824b00ec4131af2be7d641bf1a6a820607a915211a',
    'K10b-db2-f32-1-4194304-2-0-0':
        '18043ef22beaeb065f61713bca25065e84f19f21376b81ddb9564fb5441ce593',
    'K10b-db2-f64-1-4194304-2-0-0':
        '760e4d47d0b5c7f8353e3f15d855a81f003d2c9e0c3f2440cda408ee5e924451',
    'K10b-odd5-f32-1-4194304-2-0-0':
        '6f09d1c10b88ddb30838364e820a32f434cd0e340beed1b52a7abdea3179d3cb',
    'K10b-odd5-f64-1-4194304-2-0-0':
        'c0b83aec9f7033ec437a9f6dc075223260a51cd1594808bbb64e5a5dc0ce4084',
    'K10b-sym8-f32-1-4194304-2-0-0':
        'c9f44d734b1ffd7a1476923ddf7f1292c3ca280b95490e7576b860148a5ce7ba',
    'K10b-sym8-f64-1-4194304-2-0-0':
        'c4edad896ad16b8217bb9146e663fdc4dcc7f91ed425799e2b72661c94eefe2a',
    'K10b-sym20-f32-1-4194304-2-0-0':
        'bf58e567bd5a78697f19688bcfea54f0d26602680e30364407cdd3232c008f25',
    'K10b-sym20-f64-1-4194304-2-0-0':
        '85a3b722e3526655c4eec6d93a60118243be3bab4e451ee1aee10451180c1cc8',
    'K10a-haar-f32-1-4194304-3-0-0':
        'ca507f9c96c07af1aede077e3d4099ca1e0d91dd75a7ff6e7e2be11fc7dfcffe',
    'K10a-haar-f64-1-4194304-3-0-0':
        '27e3ee0e7c629b6f31a83e97d59a9f95c418b02a4ab773b0642367e236f895d6',
    'K10a-db2-f32-1-4194304-3-0-0':
        '0d69136556ea7d8c16425c06b24e8516b4cde6b648e83f846cf94a7de848a561',
    'K10a-db2-f64-1-4194304-3-0-0':
        '5064f44a28d390d7a4a0fbbbb4fd91b41a739d1ad97b4fee43e6d3ef964ac098',
    'K10a-odd5-f32-1-4194304-3-0-0':
        '21f32a6068b0fd75cac56f9c23a259023f686d5e4fdafa63fe8f67919d2668b1',
    'K10a-odd5-f64-1-4194304-3-0-0':
        '55458e35c62437fbca56f566302c216c8352b671de6d5b45b91cba2cbcb48970',
    'K10a-sym8-f32-1-4194304-3-0-0':
        '8844437aef631eb1df0f5f7c7e23ee3301d11b074cac288e2d1a269eed684cbd',
    'K10a-sym8-f64-1-4194304-3-0-0':
        '947ef58d0423a55d0cbeac7b6b454d1a9a32b7ff324bca13014128f24dc4bd4f',
    'K10a-sym20-f32-1-4194304-3-0-0':
        '235863cd6fc8df4d716070fd56c49780b672c3904729f842323f0fda109b19b5',
    'K10a-sym20-f64-1-4194304-3-0-0':
        '0f5253f42f7f9724c4b0ccd56f7f198acffcb9acae8190ffde37abd5f2c5a586',
    'K10b-haar-f32-1-4194304-3-0-0':
        '5f8df865f38ab7df1b54b5383e75693cf0289e0acfd3dc63a90a25bda6542761',
    'K10b-haar-f64-1-4194304-3-0-0':
        '493e19b2ce2fb9cb3351aa46a9053c5bd3c812f3e3fe238d2424bd86d75b35cd',
    'K10b-db2-f32-1-4194304-3-0-0':
        '281e42cf0ef61de368e321b8f110f082691e2a62c1fabe1e3fa70ad092763d0d',
    'K10b-db2-f64-1-4194304-3-0-0':
        '678c4596527006d311400997a05459bbcb95d15bf1e12b12beb02ec71892e052',
    'K10b-odd5-f32-1-4194304-3-0-0':
        '013fa565e9669b87f6ff0144e8e9f166d7d6bcffb5da9c73bef442aa1e8afb0a',
    'K10b-odd5-f64-1-4194304-3-0-0':
        'ea4eeea5e6b2a72b5081d12e9831569b15f359c394c97d1cad5a5d624189e440',
    'K10b-sym8-f32-1-4194304-3-0-0':
        '5f4e8cab74dbe4d5ef19379d61552ecdb6cffb374535b7d72957222f3a990ed3',
    'K10b-sym8-f64-1-4194304-3-0-0':
        '22caf7718b39b5b5bdf4fbd16cf7a9fcd58d53b3d3ae6de50c4032af657c31d4',
    'K10b-sym20-f32-1-4194304-3-0-0':
        'a8c3f71d1bc2e5edca1f710797c434c31a5d4a8d892dfd267cb35c5e8f169435',
    'K10b-sym20-f64-1-4194304-3-0-0':
        '78c564c2e32e832b4a8f8bc676ecbd8bb4bd95c54565a6d5de8f867051414059',
}

if __name__ == "__main__":
    import sys

    def _pair_lines(dev):
        for kind, case in PAIR_CASES:
            for wname in PAIR_BANKS:
                out, _ = _pair_output(kind, case, wname, dev)
                yield _pair_id(kind, case, wname), out

    def _ana_lines(dev):
        for kind, case in ANA_CASES:
            for wname in PAIR_BANKS:
                out, _ = _ana_output(kind, case, wname, dev)
                yield _pair_id(kind, case, wname), torch.stack(out)

    def _rows_lines(dev):
        for kind in ("K29g", "K29h"):
            for case in ROWS_CASES:
                for wname in ROWS_BANKS:
                    for prec in ("highest", "bf16"):
                        out, _ = _rows_output(kind, case, wname, prec, dev)
                        yield _rows_id(kind, case, wname, prec), out

    def _k29d_lines(dev):
        for case in K29D_CASES:
            for wname in K29D_BANKS:
                for dtype in (torch.float32, torch.float64):
                    out, _ = _k29d_output(case, wname, dtype, dev)
                    yield _k29d_id(case, wname, dtype), out

    def _k20_lines(dev):
        for case in K20_CASES:
            for wname in PAIR_BANKS:
                out, _ = _k20_output(case, wname, dev)
                yield _k20_id(case, wname), out

    def _k19_lines(dev):
        for case in K19_CASES:
            for wname in K19_BANKS:
                out, _, _ = _k19_output(case, wname, dev)
                yield _k19_id(case, wname), torch.stack(out)

    def _k18b_lines(dev):
        for case in K18B_CASES:
            for name in K18B_BANKS:
                out, _ = _k18b_output(case, name, dev)
                yield _k18b_id(case, name), out

    def _k18a_lines(dev):
        for case in K18B_CASES:
            for name in K18B_BANKS:
                out, _ = _k18a_output(case, name, dev)
                yield _k18a_id(case, name), torch.stack(out)

    def _k12_lines(dev):
        for kind, case, wname in K12_PARAMS:
            for prec in ("highest", "bf16"):
                out, _ = _k12_output(kind, case, wname, prec, dev)
                yield _k12_id(kind, case, wname, prec), out

    def _k10_lines(dev):
        for case in K10_CASES:
            for kind in ("K10a", "K10b"):
                for wname in K10_BANKS:
                    for dt in K10_TYPES:
                        out, _ = _k10_output(kind, case, wname, dt, dev)
                        yield _k10_id(kind, case, wname, dt), out

    tables = {"PAIR": _pair_lines, "ANA": _ana_lines, "ROWS": _rows_lines,
              "K29D": _k29d_lines, "K20": _k20_lines, "K19": _k19_lines, "K18B": _k18b_lines,
              "K18A": _k18a_lines, "K12": _k12_lines, "K10": _k10_lines}
    want = sys.argv[2:] or list(tables)
    if (sys.argv[1:2] != ["digests"] or not set(want) <= set(tables)
            or not torch.cuda.is_available()):
        sys.exit("usage, on a machine with a GPU: python "
                 "tests/test_torch_kernels_cuda.py digests [TABLE ...] "
                 f"(of {', '.join(tables)}; all by default)")
    for table in want:
        print(f"{table}_DIGESTS = {{")
        for key, out in tables[table](torch.device("cuda", 0)):
            print(f"    {key!r}:\n        {_sha256(out)!r},")
        print("}")
