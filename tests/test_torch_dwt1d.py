"""The port's 1D and batched-1D DWT against the JAX package on the CPU.

K3/K4's plain versions against the JAX Pallas K3/K4 (``dwt1d_fused``,
``idwt1d_fused``, interpret mode on the CPU), max-abs 2e-5 on [0, 1)
float32 data; ``wavedec1``/``waverec1`` and haar 1D against
``pypwt_tpu.core.dwt``/``core.haar``, batched and single, coefficients
within 3e-4 * 2^level and roundtrips within 7e-4 on 0..255 data; a single
2^15-sample signal against the JAX long path (``conv.analysis_long1d`` and
its synthesis, the map of the folded TPU kernels K13); the coverage rules
of K3/K4 and the routing counts.  The kernels themselves run only on a
GPU: tests/test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import oracle
from pypwt_tpu.core import dwt as jdwt
from pypwt_tpu.core import haar as jhaar
from pypwt_tpu.filters import get_filter_bank as jbank
from pypwt_tpu.ops import pallas_dwt as pk
from pypwt_tpu_torch import ops
from pypwt_tpu_torch.core import dwt, haar
from pypwt_tpu_torch.filters import FilterBank, get_filter_bank
from pypwt_tpu_torch.ops import fused_dwt as fd

torch.set_num_threads(1)

KERNEL_TOL = 2e-5
COEFF_TOL = 3e-4
ROUNDTRIP_TOL = 7e-4
WAVELETS = ["haar", "db2", "db8", "sym5", "bior3.5", "sym20"]
SHAPES = [(8, 256), (16, 1024)]
LONG = 1 << 15


def _rand(shape, seed=42):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _sig(shape, seed=0):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.float32)


@pytest.mark.parametrize("wname", WAVELETS)
@pytest.mark.parametrize("shape", SHAPES)
def test_k3_plain_matches_pallas(wname, shape):
    x = _rand(shape)
    ref = pk.dwt1d_fused(jnp.asarray(x), jbank(wname))
    assert ref is not None
    got = fd.dwt1d_plain(torch.from_numpy(x), get_filter_bank(wname))
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == torch.float32
        assert np.abs(g.numpy() - np.asarray(r)).max() <= KERNEL_TOL


@pytest.mark.parametrize("wname", WAVELETS)
@pytest.mark.parametrize("shape", SHAPES)
def test_k4_plain_matches_pallas(wname, shape):
    cshape = (shape[0], shape[1] // 2)
    a, d = _rand(cshape, 1), _rand(cshape, 2)
    ref = pk.idwt1d_fused(jnp.asarray(a), jnp.asarray(d), jbank(wname),
                          shape[1])
    assert ref is not None
    got = fd.idwt1d_plain(torch.from_numpy(a), torch.from_numpy(d),
                          get_filter_bank(wname), shape[1])
    assert got.shape == shape
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= KERNEL_TOL


def test_k4_declines_odd_output_like_pallas():
    """The Pallas K4 declines an odd output (JAX runs it on its jnp path);
    the port's K4 takes it, and its plain version matches that path."""
    fb = get_filter_bank("db2")
    a, d = _rand((8, 64)), _rand((8, 64), 1)
    assert pk.idwt1d_fused(jnp.asarray(a), jnp.asarray(a), jbank("db2"),
                           127) is None
    assert fd.idwt1d_unsupported(torch.from_numpy(a), torch.from_numpy(a),
                                 fb, 127) is None
    ref = jdwt.idwt1d(jnp.asarray(a), jnp.asarray(d), jbank("db2"), 127)
    got = fd.idwt1d_fused(torch.from_numpy(a), torch.from_numpy(d), fb, 127)
    assert got.shape == (8, 127)
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= KERNEL_TOL


def _jax_pair(wname, levels):
    fb = jbank(wname)
    if fb.hlen == 2:
        return (lambda x: jhaar.haar_wavedec1(x, levels),
                lambda c, n: jhaar.haar_waverec1(c, n))
    return (lambda x: jdwt.wavedec1(x, fb, levels),
            lambda c, n: jdwt.waverec1(c, fb, n))


def _port_pair(wname, levels):
    fb = get_filter_bank(wname)
    if fb.hlen == 2:
        return (lambda x: haar.haar_wavedec1(x, levels),
                lambda c, n: haar.haar_waverec1(c, n))
    return (lambda x: dwt.wavedec1(x, fb, levels),
            lambda c, n: dwt.waverec1(c, fb, n))


def _assert_pyramid(got, ref, levels):
    assert len(got) == len(ref) == levels + 1
    pairs = [(got[0], ref[0], levels)] + [(got[lev], ref[lev], lev)
                                          for lev in range(1, levels + 1)]
    for g, r, lev in pairs:
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        r = np.asarray(r)
        assert g.shape == r.shape and g.dtype == r.dtype
        assert np.abs(g - r).max() <= COEFF_TOL * 2 ** lev


CASES = [("db2", (16, 256), 3), ("db2", (500,), 3), ("haar", (16, 256), 3),
         ("haar", (301,), 4), ("sym8", (4, 1000), 3), ("sym20", (2, 512), 2),
         ("bior3.5", (3, 257), 3), ("db4", (1024,), 5)]


@pytest.mark.parametrize("wname, shape, levels", CASES)
def test_wavedec1_matches_jax(wname, shape, levels):
    x = _sig(shape)
    jfwd, _ = _jax_pair(wname, levels)
    fwd, _ = _port_pair(wname, levels)
    _assert_pyramid(fwd(torch.from_numpy(x)), jfwd(jnp.asarray(x)), levels)


@pytest.mark.parametrize("wname, shape, levels", CASES)
def test_waverec1_crosses_with_jax(wname, shape, levels):
    x = _sig(shape, 1)
    n = shape[-1]
    jfwd, jinv = _jax_pair(wname, levels)
    fwd, inv = _port_pair(wname, levels)
    jc = [np.asarray(c) for c in jfwd(jnp.asarray(x))]
    rec = inv(dwt.pyramid_from_numpy(jc, "cpu"), n)
    assert rec.shape == x.shape
    assert np.abs(rec.numpy() - x).max() < ROUNDTRIP_TOL
    pc = dwt.pyramid_to_numpy(fwd(torch.from_numpy(x)))
    jrec = jinv([jnp.asarray(c) for c in pc], n)
    assert np.abs(np.asarray(jrec) - x).max() < ROUNDTRIP_TOL


@pytest.mark.parametrize("wname", ["db2", "sym8", "haar"])
def test_long_signal_matches_jax_long_path(wname):
    """A single 2^15-sample signal: JAX folds it into rows on the CPU
    (``conv.analysis_long1d``), the port takes it as one (1, n) row."""
    from pypwt_tpu.core import conv as jconv
    assert jconv.long1d_shape(LONG) is not None
    x = _sig((LONG,), 3)
    jfwd, jinv = _jax_pair(wname, 3)
    fwd, inv = _port_pair(wname, 3)
    got = fwd(torch.from_numpy(x))
    _assert_pyramid(got, jfwd(jnp.asarray(x)), 3)
    assert np.abs(inv(got, LONG).numpy() - x).max() < ROUNDTRIP_TOL
    jrec = jinv([jnp.asarray(c.numpy()) for c in got], LONG)
    assert np.abs(np.asarray(jrec) - x).max() < ROUNDTRIP_TOL


@pytest.mark.parametrize("wname", ["db2", "sym8"])
def test_long_level_matches_jax_long_level(wname):
    """One level of the map of K13 (``dwt.dwt1d``/``idwt1d`` on a 1D
    array of 2^15 samples) at the kernel tolerance."""
    x = _rand((LONG,), 4)
    jfb, fb = jbank(wname), get_filter_bank(wname)
    ja, jd = jdwt.dwt1d(jnp.asarray(x), jfb)
    a, d = dwt.dwt1d(torch.from_numpy(x), fb)
    assert a.shape == (LONG // 2,)
    assert np.abs(a.numpy() - np.asarray(ja)).max() <= KERNEL_TOL
    assert np.abs(d.numpy() - np.asarray(jd)).max() <= KERNEL_TOL
    jrec = jdwt.idwt1d(ja, jd, jfb, LONG)
    rec = dwt.idwt1d(a, d, fb, LONG)
    assert np.abs(rec.numpy() - np.asarray(jrec)).max() <= KERNEL_TOL


@pytest.mark.parametrize("wname", ["db2", "db8", "bior3.5"])
def test_dwt1d_matches_oracle(wname):
    fb = get_filter_bank(wname)
    x = _rand((3, 37), 5)
    a, d = dwt.dwt1d(torch.from_numpy(x), fb)
    for r in range(3):
        assert np.abs(a[r].numpy()
                      - oracle.ref_analysis_1d(x[r], fb.dec_lo)).max() <= 1e-5
        assert np.abs(d[r].numpy()
                      - oracle.ref_analysis_1d(x[r], fb.dec_hi)).max() <= 1e-5
    c = _rand((2, 20), 6), _rand((2, 20), 7)
    out = dwt.idwt1d(*map(torch.from_numpy, c), fb, 40)
    for r in range(2):
        o = oracle.ref_synthesis_1d(c[0][r], c[1][r], fb.rec_lo, fb.rec_hi,
                                    40)
        assert np.abs(out[r].numpy() - o).max() <= 1e-5


def test_float64_matches_jax_jnp_path():
    """float64 takes the plain path in both packages."""
    x = np.random.default_rng(2).random((4, 96)) * 255
    got = dwt.wavedec1(torch.from_numpy(x), get_filter_bank("db3"), 3)
    ref = jdwt.wavedec1(jnp.asarray(x), jbank("db3"), 3)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float64
        assert np.abs(g.numpy() - np.asarray(r)).max() < 1e-9


def test_auto_on_cpu_takes_plain_and_counts_nothing():
    fb = get_filter_bank("db2")
    x = torch.from_numpy(_rand((8, 128)))
    ops.reset_counts()
    assert dwt._KERNEL_MODE == "auto"
    a, d = dwt.dwt1d(x, fb)
    rec = dwt.idwt1d(a, d, fb, 128)
    wa, wd = fd.dwt1d_fused(x, fb)
    assert torch.equal(a, wa) and torch.equal(d, wd)
    assert torch.equal(rec, fd.idwt1d_fused(a, d, fb, 128))
    ha, hd = haar.haar_dwt1d(x)
    assert ha.shape == (8, 64)
    for k in fd.KERNELS:
        assert k.launches == 0


def test_cuda_mode_raises_on_cpu_tensor():
    fb = get_filter_bank("db2")
    x = torch.from_numpy(_rand((8, 128)))
    a, d = fd.dwt1d_plain(x, fb)
    dwt.set_kernels("cuda")
    try:
        with pytest.raises(ValueError, match="CUDA tensors only"):
            dwt.dwt1d(x, fb)
        with pytest.raises(ValueError, match="CUDA tensors only"):
            dwt.idwt1d(a, d, fb, 128)
        with pytest.raises(ValueError, match="CUDA tensors only"):
            haar.haar_dwt1d(x)
    finally:
        dwt.set_kernels("auto")


def test_torch_mode_takes_plain():
    fb = get_filter_bank("db2")
    x = torch.from_numpy(_rand((128,)))
    dwt.set_kernels("torch")
    try:
        got = dwt.dwt1d(x, fb)
    finally:
        dwt.set_kernels("auto")
    for g, p in zip(got, fd.dwt1d_plain(x, fb)):
        assert torch.equal(g, p)


def test_k3_coverage_rules():
    fb = get_filter_bank("db2")
    ok = torch.zeros(8, 128)
    assert fd.dwt1d_unsupported(ok, fb) is None
    assert fd.dwt1d_unsupported(torch.zeros(LONG), fb) is None
    assert fd.dwt1d_unsupported(torch.zeros(2), get_filter_bank("sym20")) \
        is None
    assert fd.dwt1d_unsupported(ok.double(), fb) is None
    assert "float32" in fd.dwt1d_unsupported(ok.half(), fb)
    assert fd.dwt1d_unsupported(torch.zeros(8, 127), fb) is None
    assert fd.dwt1d_unsupported(torch.zeros(1), fb) is None
    assert "rank" in fd.dwt1d_unsupported(torch.zeros(2, 8, 128), fb)
    assert "empty" in fd.dwt1d_unsupported(torch.zeros(0, 128), fb)
    odd = FilterBank("odd", *(np.ones(3) for _ in range(4)))
    assert fd.dwt1d_unsupported(ok, odd) is None
    wide = FilterBank("wide", *(np.ones(41) for _ in range(4)))
    assert "filter length" in fd.dwt1d_unsupported(ok, wide)


def test_k4_coverage_rules():
    fb = get_filter_bank("sym20")
    a, d = torch.zeros(8, 64), torch.zeros(8, 64)
    assert fd.idwt1d_unsupported(a, d, fb, 128) is None
    assert fd.idwt1d_unsupported(torch.zeros(1), torch.zeros(1), fb, 2) \
        is None
    assert fd.idwt1d_unsupported(a, d, fb, 127) is None
    assert "empty" in fd.idwt1d_unsupported(a, d, fb, 0)
    assert "shapes" in fd.idwt1d_unsupported(a, torch.zeros(8, 63), fb, 128)
    assert "dtypes" in fd.idwt1d_unsupported(a, d.double(), fb, 128)
    assert fd.idwt1d_unsupported(a.double(), d.double(), fb, 128) is None
    assert "float32" in fd.idwt1d_unsupported(a.half(), d.half(), fb, 128)
