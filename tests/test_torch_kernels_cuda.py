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
from pypwt_tpu_torch.core import dwt, nonsep, swt
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

    tables = {"PAIR": _pair_lines, "ANA": _ana_lines, "ROWS": _rows_lines,
              "K29D": _k29d_lines, "K20": _k20_lines, "K19": _k19_lines, "K18B": _k18b_lines,
              "K18A": _k18a_lines}
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
