"""The port's 1D and batched-1D stationary transform against the JAX
package on the CPU.

K10a/K10b's plain versions against the JAX Pallas K10
(``swt1d_level_fused``, ``iswt1d_level_fused``, interpret mode on the
CPU) and ``conv.swt_analysis_last``/``swt_synthesis_last`` against JAX's
and the float64 oracle (``tests/oracle.py``), odd filter lengths and wraps
wider than the signal included, max-abs 2e-5 on [0, 1) float32 data;
``swt1d``/``iswt1d`` against ``pypwt_tpu.core.swt``, batched and single,
within 3e-4 * 2^level (coefficients) and 7e-4 (roundtrip) on 0..255 data;
a single 2^15-sample signal against the JAX long path (the map of the
folded TPU kernels K14); the coverage rules of K10 and the routing counts.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import oracle
from pypwt_tpu.core import conv as jconv
from pypwt_tpu.core import swt as jswt
from pypwt_tpu.filters import FilterBank as JBank
from pypwt_tpu.filters import get_filter_bank as jbank
from pypwt_tpu.ops import pallas_dwt as pk
from pypwt_tpu_torch import ops
from pypwt_tpu_torch.core import conv, dwt, swt
from pypwt_tpu_torch.filters import FilterBank, get_filter_bank
from pypwt_tpu_torch.ops import fused_dwt as fd

torch.set_num_threads(1)

KERNEL_TOL = 2e-5
COEFF_TOL = 3e-4
ROUNDTRIP_TOL = 7e-4
LONG = 1 << 15
# an odd-length bank (any values: the a-trous map takes every hlen)
ODD = ([0.1, -0.3, 0.7, 0.25, -0.05], [0.2, 0.5, -0.6, 0.1, 0.3],
       [-0.15, 0.35, 0.6, 0.2, 0.05], [0.4, -0.2, 0.1, 0.55, -0.3])


def _banks(wname):
    """(JAX bank, port bank) of a built-in name or of 'odd5'."""
    if wname == "odd5":
        arrs = [np.asarray(a, np.float64) for a in ODD]
        return JBank("odd5", *arrs), FilterBank("odd5", *arrs)
    return jbank(wname), get_filter_bank(wname)


def _rand(shape, seed=42):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _sig(shape, seed=0):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.float32)


def _err(got, ref):
    return float(np.abs(got.numpy() - np.asarray(ref)).max())


@pytest.mark.parametrize("wname", ["haar", "db2", "sym8", "odd5"])
@pytest.mark.parametrize("level", [1, 2, 3])
def test_k10_plain_matches_pallas(wname, level):
    jfb, fb = _banks(wname)
    x = _rand((8, 256))
    ref = pk.swt1d_level_fused(jnp.asarray(x), jfb, level)
    assert ref is not None
    got = fd.swt1d_plain(torch.from_numpy(x), fb, level)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and _err(g, r) <= KERNEL_TOL
    a, d = _rand((8, 256), 1), _rand((8, 256), 2)
    ref = pk.iswt1d_level_fused(jnp.asarray(a), jnp.asarray(d), jfb, level)
    assert ref is not None
    got = fd.iswt1d_plain(torch.from_numpy(a), torch.from_numpy(d), fb,
                          level)
    assert _err(got, ref) <= KERNEL_TOL


# The edge shapes of K10's window body: rows shorter than a tile (40
# samples, several rows an item), a dilation that does not divide the row
# (75 at level 2, 130 at level 3), one equal to it (haar, 16 at level 5
# and 8 at level 4: JAX's kernel takes a wrap no wider than the row), odd
# hlen and the widest bank.
@pytest.mark.parametrize("wname, n, level", [
    ("db2", 40, 1), ("sym8", 40, 2), ("odd5", 40, 3), ("odd5", 75, 2),
    ("sym8", 130, 3), ("odd5", 130, 3), ("sym20", 130, 2), ("haar", 16, 5),
    ("haar", 8, 4)])
def test_k10_plain_matches_pallas_at_edge_shapes(wname, n, level):
    jfb, fb = _banks(wname)
    x = _rand((8, n), 6)
    ref = pk.swt1d_level_fused(jnp.asarray(x), jfb, level)
    assert ref is not None
    got = fd.swt1d_plain(torch.from_numpy(x), fb, level)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and _err(g, r) <= KERNEL_TOL
    a, d = _rand((8, n), 7), _rand((8, n), 8)
    ref = pk.iswt1d_level_fused(jnp.asarray(a), jnp.asarray(d), jfb, level)
    assert ref is not None
    got = fd.iswt1d_plain(torch.from_numpy(a), torch.from_numpy(d), fb,
                          level)
    assert _err(got, ref) <= KERNEL_TOL


# (n, level): (16, 3) with sym8 and sym20 wraps wider than the signal
@pytest.mark.parametrize("wname", ["haar", "db2", "sym8", "sym20", "bior3.5",
                                   "odd5"])
@pytest.mark.parametrize("n, level", [(64, 1), (37, 2), (16, 3), (5, 4)])
def test_swt_conv_matches_jax_and_oracle(wname, n, level):
    jfb, fb = _banks(wname)
    x = _rand((2, n), 3)
    lo, hi = conv.swt_analysis_last(torch.from_numpy(x), fb.dec_lo,
                                    fb.dec_hi, level)
    jlo, jhi = jconv.swt_analysis_last(jnp.asarray(x), jfb.dec_lo,
                                       jfb.dec_hi, level)
    assert lo.dtype == torch.float32 and lo.shape == (2, n)
    assert _err(lo, jlo) <= KERNEL_TOL and _err(hi, jhi) <= KERNEL_TOL
    a, d = _rand((2, n), 4), _rand((2, n), 5)
    out = conv.swt_synthesis_last(torch.from_numpy(a), torch.from_numpy(d),
                                  fb.rec_lo, fb.rec_hi, level)
    ref = jconv.swt_synthesis_last(jnp.asarray(a), jnp.asarray(d),
                                   jfb.rec_lo, jfb.rec_hi, level)
    assert _err(out, ref) <= KERNEL_TOL
    for r in range(2):
        assert _err(lo[r], oracle.ref_swt_analysis_1d(x[r], fb.dec_lo,
                                                      level)) <= KERNEL_TOL
        assert _err(hi[r], oracle.ref_swt_analysis_1d(x[r], fb.dec_hi,
                                                      level)) <= KERNEL_TOL
        o = oracle.ref_swt_synthesis_1d(a[r], d[r], fb.rec_lo, fb.rec_hi,
                                        level)
        assert _err(out[r], o) <= KERNEL_TOL


def _assert_pyramid(got, ref, levels):
    assert len(got) == len(ref) == levels + 1
    pairs = [(got[0], ref[0], levels)] + [(got[lev], ref[lev], lev)
                                          for lev in range(1, levels + 1)]
    for g, r, lev in pairs:
        assert g.shape == r.shape
        assert _err(g, r) <= COEFF_TOL * 2 ** lev


CASES = [("db2", (16, 256), 3), ("haar", (16, 256), 3), ("haar", (301,), 4),
         ("sym8", (4, 1000), 3), ("sym20", (2, 512), 2),
         ("bior3.5", (3, 257), 3), ("db2", (513,), 5), ("odd5", (4, 96), 3)]


@pytest.mark.parametrize("wname, shape, levels", CASES)
def test_swt1d_matches_jax(wname, shape, levels):
    jfb, fb = _banks(wname)
    x = _sig(shape)
    got = swt.swt1d(torch.from_numpy(x), fb, levels)
    ref = jswt.swt1d(jnp.asarray(x), jfb, levels)
    _assert_pyramid(got, ref, levels)
    rec = swt.iswt1d(got, fb)
    assert rec.shape == x.shape
    jrec = jswt.iswt1d([jnp.asarray(c.numpy()) for c in got], jfb)
    assert _err(rec, jrec) <= ROUNDTRIP_TOL
    if wname != "odd5":  # an arbitrary bank does not reconstruct
        assert np.abs(rec.numpy() - x).max() < ROUNDTRIP_TOL


@pytest.mark.parametrize("wname", ["db2", "sym8", "haar"])
def test_long_signal_matches_jax_long_path(wname):
    """A single 2^15-sample signal: JAX folds it into rows on the CPU
    (``conv.swt_analysis_long1d``), the port takes it as one (1, n) row."""
    assert jconv.long1d_shape(LONG) is not None
    jfb, fb = _banks(wname)
    x = _sig((LONG,), 3)
    got = swt.swt1d(torch.from_numpy(x), fb, 3)
    _assert_pyramid(got, jswt.swt1d(jnp.asarray(x), jfb, 3), 3)
    rec = swt.iswt1d(got, fb)
    assert np.abs(rec.numpy() - x).max() < ROUNDTRIP_TOL
    jrec = jswt.iswt1d([jnp.asarray(c.numpy()) for c in got], jfb)
    assert _err(rec, jrec) <= ROUNDTRIP_TOL


@pytest.mark.parametrize("level", [1, 4])
def test_long_level_matches_jax_long_level(level):
    """One level of the map of K14 at the kernel tolerance."""
    jfb, fb = _banks("sym8")
    x = _rand((LONG,), 4)
    ja, jd = jswt.swt1d_level(jnp.asarray(x), jfb, level)
    a, d = swt.swt1d_level(torch.from_numpy(x), fb, level)
    assert _err(a, ja) <= KERNEL_TOL and _err(d, jd) <= KERNEL_TOL
    jrec = jswt.iswt1d_level(ja, jd, jfb, level)
    assert _err(swt.iswt1d_level(a, d, fb, level), jrec) <= KERNEL_TOL


def test_float64_matches_jax_jnp_path():
    x = np.random.default_rng(2).random((4, 96)) * 255
    got = swt.swt1d(torch.from_numpy(x), get_filter_bank("db3"), 3)
    ref = jswt.swt1d(jnp.asarray(x), jbank("db3"), 3)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float64 and _err(g, r) < 1e-9


def test_auto_on_cpu_takes_plain_and_counts_nothing():
    fb = get_filter_bank("db2")
    x = torch.from_numpy(_rand((8, 128)))
    ops.reset_counts()
    a, d = swt.swt1d_level(x, fb, 2)
    wa, wd = fd.swt1d_fused(x, fb, 2)
    assert torch.equal(a, wa) and torch.equal(d, wd)
    assert torch.equal(swt.iswt1d_level(a, d, fb, 2),
                       fd.iswt1d_fused(a, d, fb, 2))
    for k in fd.KERNELS:
        assert k.launches == 0


def test_cuda_mode_raises_on_cpu_tensor():
    fb = get_filter_bank("db2")
    x = torch.from_numpy(_rand((8, 128)))
    dwt.set_kernels("cuda")
    try:
        with pytest.raises(ValueError, match="CUDA tensors only"):
            swt.swt1d_level(x, fb, 1)
        with pytest.raises(ValueError, match="CUDA tensors only"):
            swt.iswt1d_level(x, x, fb, 1)
    finally:
        dwt.set_kernels("auto")


def test_k10_coverage_rules():
    fb = get_filter_bank("sym20")
    x = torch.zeros(4, 16)
    # every level, odd lengths and wraps wider than the row are covered
    for level in (1, 5, 12):
        assert fd.swt1d_unsupported(x, fb, level) is None
        assert fd.iswt1d_unsupported(x, x, fb, level) is None
    _, odd = _banks("odd5")
    assert fd.swt1d_unsupported(torch.zeros(7), odd, 3) is None
    assert fd.swt1d_unsupported(torch.zeros(LONG), fb, 3) is None
    assert "level" in fd.swt1d_unsupported(x, fb, 0)
    assert fd.swt1d_unsupported(x.double(), fb, 1) is None
    assert fd.iswt1d_unsupported(x.double(), x.double(), fb, 1) is None
    assert "float32" in fd.swt1d_unsupported(x.half(), fb, 1)
    assert "rank" in fd.swt1d_unsupported(torch.zeros(2, 4, 16), fb, 1)
    assert "shapes" in fd.iswt1d_unsupported(x, torch.zeros(4, 15), fb, 1)
    wide = FilterBank("wide", *(np.ones(42) for _ in range(4)))
    assert "filter length" in fd.swt1d_unsupported(x, wide, 1)
