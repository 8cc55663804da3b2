"""Float64 plans of the port against the JAX package's float64 plans on the
CPU, and the float64 routing onto the tap-loop kernels' float64 instances.

The reference runs a float64 plan (``Wavelets(..., dtype=np.float64)``;
the CUDA original's -DDOUBLEPRECISION build, JAX's jnp path,
tests/test_breadth.py): the port's float64 ``Wavelets`` -- 2D DWT db4 L3,
2D SWT, batched 1D, one signal (DWT and SWT), the non-separable plan of a
custom 2D bank, haar -- and ``pipeline.denoise2d`` against JAX's float64
ones: forward max-abs <= 1e-11, roundtrip < 1e-10, float64 outputs.  On a
CUDA tensor (a CPU tensor posing as one) a float64 level routes to the
float64 instance of K1-K4, K8-K10, K16-K18 (K19/K20 and the tensor-core
forms stay float32), with the bank's float64 values, unrounded, as taps.
"""

import numpy as np
import pytest
import torch

import pypwt_tpu
from pypwt_tpu import pipeline as jpipe
import pypwt_tpu_torch
from pypwt_tpu_torch import get_filter_bank, pipeline
from pypwt_tpu_torch.core import dwt, haar, nonsep, swt
from pypwt_tpu_torch.ops import fused_dwt as fd
from pypwt_tpu_torch.ops import nonsep as kn

torch.set_num_threads(1)

FWD_TOL = 1e-11
ROUNDTRIP_TOL = 1e-10


def _img(shape, seed=0):
    return np.random.default_rng(seed).random(shape)


def _cross():
    """db3 (rows) x coif1 (columns): a custom 2D bank that does not
    factor into one 1D bank."""
    fr, fc = get_filter_bank("db3"), get_filter_bank("coif1")
    parts = (("lo", "lo"), ("hi", "lo"), ("lo", "hi"), ("hi", "hi"))
    return nonsep.Filters2D(
        [np.outer(getattr(fr, "dec_" + p), getattr(fc, "dec_" + q))
         for p, q in parts],
        [np.outer(getattr(fr, "rec_" + p), getattr(fc, "rec_" + q))
         for p, q in parts], "db3xcoif1")


def _install(W, f2d):
    W.set_wavelets_filters(f2d.name, f2d.dec[0], f2d.dec[3], f2d.rec[0],
                           f2d.rec[3], LH=f2d.dec[1], HL=f2d.dec[2],
                           i_LH=f2d.rec[1], i_HL=f2d.rec[2])


PLANS = {
    "dwt2d": ((64, 96), "db4", {}),
    "swt2d": ((64, 96), "db4", dict(do_swt=1)),
    "batched-1d": ((8, 256), "db4", dict(ndim=1)),
    "batched-1d-swt": ((8, 256), "sym8", dict(ndim=1, do_swt=1)),
    "signal": ((4096,), "db4", {}),
    "signal-swt": ((4096,), "db4", dict(do_swt=1)),
    "nonsep-custom": ((64, 96), "db2", dict(do_separable=0)),
    "nonsep-custom-swt": ((64, 96), "db2", dict(do_separable=0, do_swt=1)),
    "haar": ((64, 96), "haar", {}),
    "odd": ((63, 95), "sym8", {}),
}


def _leaves(coeffs):
    for c in coeffs:
        if isinstance(c, (list, tuple)):
            yield from c
        else:
            yield c


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_float64_wavelets_match_jax(plan):
    shape, wname, kw = PLANS[plan]
    img = _img(shape)
    j = pypwt_tpu.Wavelets(img, wname, 3, dtype=np.float64, **kw)
    t = pypwt_tpu_torch.Wavelets(img, wname, 3, dtype=np.float64,
                                 device="cpu", **kw)
    if plan.startswith("nonsep-custom"):
        f2d = _cross()
        _install(j, f2d)
        _install(t, f2d)
    j.forward()
    t.forward()
    got, ref = list(_leaves(t.coeffs)), list(_leaves(j.coeffs))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.dtype == r.dtype == np.float64 and g.shape == r.shape
        assert np.abs(g - r).max() <= FWD_TOL
    j.inverse()
    t.inverse()
    assert t.image.dtype == np.float64
    assert np.abs(t.image.reshape(shape) - img).max() < ROUNDTRIP_TOL
    assert np.abs(t.image - np.asarray(j.image)).max() <= FWD_TOL


@pytest.mark.parametrize("do_swt", [False, True], ids=["dwt", "swt"])
def test_float64_denoise2d_matches_jax(do_swt):
    img = _img((64, 64), 4) * 255
    ref = np.asarray(jpipe.denoise2d(img, "db2", 3, 10.0, do_swt=do_swt))
    got = pipeline.denoise2d(img, "db2", 3, 10.0, do_swt=do_swt,
                             device="cpu")
    assert got.dtype == torch.float64 and ref.dtype == np.float64
    assert np.abs(got.numpy() - ref).max() <= FWD_TOL


def test_float64_taps_reach_the_kernels_unrounded():
    """A float64 level hands the kernel the bank's float64 values as they
    are (a float32 level: rounded once); the non-separable bank too."""
    fb = get_filter_bank("sym8")
    x64 = torch.zeros(4, 8, dtype=torch.float64)
    x32 = torch.zeros(4, 8)
    for f in (fb.dec_lo, fb.dec_hi, fb.rec_lo, fb.rec_hi):
        t64 = fd._taps(f, x64)
        assert t64.dtype == np.float64
        assert np.array_equal(t64, np.asarray(f, np.float64))
        t32 = fd._taps(f, x32)
        assert t32.dtype == np.float32
        assert np.array_equal(t32, np.asarray(f, np.float64).astype(
            np.float32))
        assert not np.array_equal(t32.astype(np.float64), t64)
    f2d = _cross()
    b64 = kn._host_bank(f2d.dec, np.float64)
    assert b64.dtype == np.float64
    assert np.array_equal(b64, np.stack(f2d.dec))
    assert kn._host_bank(f2d.dec).dtype == np.float32


def test_float64_launch_takes_the_f64_entry_point():
    """The wrappers pick each kernel's float64 C entry point for a float64
    level and the float32 one otherwise; every float64 instance has a
    ctypes signature (so its pointers are not cut to 32 bits)."""
    class Lib:
        def __getattr__(self, name):
            return name
    x64 = torch.zeros(2, dtype=torch.float64)
    assert fd._entry(Lib(), "pypwt_dwt2d", x64) == "pypwt_dwt2d_f64"
    assert fd._entry(Lib(), "pypwt_dwt2d", x64.float()) == "pypwt_dwt2d"
    from pypwt_tpu_torch.ops import _build
    for name in ("dwt2d", "idwt2d", "dwt1d", "idwt1d", "swt1d", "iswt1d",
                 "swt2d", "iswt2d", "ns_dwt2d", "ins_dwt2d", "ns_swt2d",
                 "ins_swt2d"):
        f32 = _build._SIGNATURES["pypwt_" + name]
        assert _build._SIGNATURES[f"pypwt_{name}_f64"] == f32
    assert "pypwt_ns_bank_f64" in _build._SIGNATURES
    for name in _build._SIGNATURES:  # K19/K20 and the tensor cores: float32
        if name.endswith("_f64"):
            assert not name.startswith("pypwt_tc_") and "shift" not in name


ROUTES = {
    "K1": lambda x, fb, f2d: dwt.use_k1(x, fb),
    "K2": lambda x, fb, f2d: dwt.use_k2(x, x, x, x, fb, (32, 48)),
    "K3": lambda x, fb, f2d: dwt.use_k3(x, fb),
    "K4": lambda x, fb, f2d: dwt.use_k4(x, x, fb, 48),
    "K10a": lambda x, fb, f2d: swt.use_k10a(x, fb, 3),
    "K10b": lambda x, fb, f2d: swt.use_k10b(x, x, fb, 3),
    "K8": lambda x, fb, f2d: swt.use_k8(x, fb, 2),
    "K9": lambda x, fb, f2d: swt.use_k9(x, x, x, x, fb, 2),
    "K16": lambda x, fb, f2d: nonsep.use_k16(x, f2d),
    "K17": lambda x, fb, f2d: nonsep.use_k17(x, x, x, x, f2d, (32, 48)),
    "K18a": lambda x, fb, f2d: nonsep.use_k18a(x, f2d, 2),
    "K18b": lambda x, fb, f2d: nonsep.use_k18b(x, x, x, x, f2d, 2),
    "haar": lambda x, fb, f2d: dwt.use_k1(x, haar._HAAR),
}


@pytest.mark.parametrize("mode", ["auto", "cuda", "mxu"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_float64_cuda_level_routes_to_its_kernel(monkeypatch, route, mode):
    """On a CUDA tensor (a CPU tensor posing as one) a float64 level goes
    to the tap-loop kernel's float64 instance in every kernel mode but
    "torch", never to a plain version; a float16 one raises."""
    fb, f2d = get_filter_bank("db2"), _cross()
    x = torch.zeros(16, 24, dtype=torch.float64)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    dwt.set_kernels(mode)
    try:
        assert ROUTES[route](x, fb, f2d) is True
        with pytest.raises(ValueError, match="float16"):
            ROUTES[route](x.half(), fb, f2d)
        dwt.set_kernels("torch")
        assert ROUTES[route](x, fb, f2d) is False
    finally:
        dwt.set_kernels("auto")
        monkeypatch.undo()


def test_float64_shifted_levels_stay_float32(monkeypatch):
    """K19/K20 have no float64 instance: a float64 spin takes the roll path
    (pipeline), and a float64 shifted level on a CUDA tensor raises."""
    fb = get_filter_bank("db2")
    x = torch.zeros(16, 24, dtype=torch.float64)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    try:
        with pytest.raises(ValueError, match="float64"):
            dwt.use_k19(x, fb)
    finally:
        monkeypatch.undo()
    assert not pipeline._Spins(x, "db2", 2, 1.0, False, False, False).fused


def test_float64_plan_runs_no_plain_version_on_cuda_levels(monkeypatch):
    """Every level of a float64 plan on a CUDA tensor goes to a kernel:
    with the float64 launches replaced by counting stand-ins that call the
    plain version, a 2D DWT, a batched-1D SWT and a custom non-separable
    plan count 3 + 3 launches each and reproduce the CPU plan."""
    counted = {}

    def stand_in(name, plain):
        def call(*args, **kw):
            counted[name] = counted.get(name, 0) + 1
            return plain(*args, **kw)
        return call

    for mod, name, plain in (
            (fd, "dwt2d_fused", fd.dwt2d_plain),
            (fd, "idwt2d_fused", fd.idwt2d_plain),
            (fd, "swt1d_fused", fd.swt1d_plain),
            (fd, "iswt1d_fused", fd.iswt1d_plain),
            (kn, "nsdwt2d_fused", kn.nsdwt2d_plain),
            (kn, "insdwt2d_fused", kn.insdwt2d_plain)):
        monkeypatch.setattr(mod, name, stand_in(name, plain))
    img = _img((64, 96), 2)
    runs = {"dwt2d": ({}, None), "batched-1d-swt": (dict(ndim=1, do_swt=1),
                                                    None),
            "nonsep-custom": (dict(do_separable=0), _cross())}
    for plan, (kw, f2d) in runs.items():
        ref = pypwt_tpu_torch.Wavelets(img, "db4", 3, dtype=np.float64,
                                       device="cpu", **kw)
        W = pypwt_tpu_torch.Wavelets(img, "db4", 3, dtype=np.float64,
                                     device="cpu", **kw)
        if f2d is not None:
            _install(ref, f2d)
            _install(W, f2d)
        ref.forward()
        counted.clear()
        monkeypatch.setattr(torch.Tensor, "is_cuda",
                            property(lambda t: True))
        try:
            W.forward()
            W.inverse()
        finally:
            monkeypatch.setattr(torch.Tensor, "is_cuda",
                                property(lambda t: t.device.type == "cuda"))
        assert sorted(counted.values()) == [3, 3], (plan, counted)
        assert W.image.dtype == np.float64
        assert np.abs(W.image - img).max() < ROUNDTRIP_TOL
