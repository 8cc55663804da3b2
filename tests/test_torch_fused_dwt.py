"""K1/K2's plain versions against the JAX Pallas K1/K2 (interpret mode on
the CPU), max-abs 2e-5 on [0, 1) float32 data, and the routing rules of
the port's wrappers on CPU tensors (the kernels themselves run only on a
GPU: tests/test_torch_kernels_cuda.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pypwt_tpu.filters import get_filter_bank as jbank
from pypwt_tpu.ops import pallas_dwt as pk
from pypwt_tpu_torch import ops
from pypwt_tpu_torch.core import dwt
from pypwt_tpu_torch.filters import FilterBank, get_filter_bank
from pypwt_tpu_torch.ops import fused_dwt as fd

torch.set_num_threads(1)

TOL = 2e-5
WAVELETS = ["haar", "db2", "db8", "sym5", "bior3.5"]
SHAPES = [(64, 128), (128, 64), (3, 64, 128)]


def _rand(shape, seed=42):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


@pytest.mark.parametrize("wname", WAVELETS)
@pytest.mark.parametrize("shape", SHAPES)
def test_k1_plain_matches_pallas(wname, shape):
    x = _rand(shape)
    ref = pk.dwt2d_fused(jnp.asarray(x), jbank(wname))
    assert ref is not None
    got = fd.dwt2d_plain(torch.from_numpy(x), get_filter_bank(wname))
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == torch.float32
        assert np.abs(g.numpy() - np.asarray(r)).max() <= TOL


@pytest.mark.parametrize("wname", WAVELETS)
@pytest.mark.parametrize("shape", SHAPES)
def test_k2_plain_matches_pallas(wname, shape):
    cshape = (*shape[:-2], shape[-2] // 2, shape[-1] // 2)
    c = [_rand(cshape, seed) for seed in range(4)]
    ref = pk.idwt2d_fused(*(jnp.asarray(s) for s in c), jbank(wname), shape)
    assert ref is not None
    got = fd.idwt2d_plain(*(torch.from_numpy(s) for s in c),
                          get_filter_bank(wname), shape)
    assert got.shape == shape
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= TOL


def test_auto_on_cpu_takes_plain_and_counts_nothing():
    fb = get_filter_bank("db2")
    x = torch.from_numpy(_rand((64, 128)))
    ops.reset_counts()
    assert dwt._KERNEL_MODE == "auto"
    got = dwt.dwt2d(x, fb)
    rec = dwt.idwt2d(*got, fb, x.shape)
    # the wrappers themselves take the plain version on a CPU tensor
    got_w = fd.dwt2d_fused(x, fb)
    rec_w = fd.idwt2d_fused(*got_w, fb, x.shape)
    for g, p, w in zip(got, fd.dwt2d_plain(x, fb), got_w):
        assert torch.equal(g, p) and torch.equal(g, w)
    assert torch.equal(rec, rec_w)
    for k in fd.KERNELS:
        assert k.launches == 0


def test_cuda_mode_raises_on_cpu_tensor():
    fb = get_filter_bank("db2")
    x = torch.from_numpy(_rand((64, 128)))
    a, h, v, d = fd.dwt2d_plain(x, fb)
    dwt.set_kernels("cuda")
    try:
        with pytest.raises(ValueError, match="CUDA tensors only"):
            dwt.dwt2d(x, fb)
        with pytest.raises(ValueError, match="CUDA tensors only"):
            dwt.idwt2d(a, h, v, d, fb, x.shape)
    finally:
        dwt.set_kernels("auto")


def test_torch_mode_takes_plain():
    fb = get_filter_bank("db2")
    x = torch.from_numpy(_rand((64, 128)))
    dwt.set_kernels("torch")
    try:
        got = dwt.dwt2d(x, fb)
    finally:
        dwt.set_kernels("auto")
    for g, p in zip(got, fd.dwt2d_plain(x, fb)):
        assert torch.equal(g, p)


def test_set_kernels_rejects_unknown():
    with pytest.raises(ValueError):
        dwt.set_kernels("pallas")
    assert dwt._KERNEL_MODE == "auto"


def test_k1_coverage_rules():
    """K1 takes every float32 or float64 level its plain version takes:
    odd sizes and odd filter lengths included, no grid limit; only dtype,
    rank, an empty plane and an over-long filter refuse."""
    fb = get_filter_bank("db2")
    ok = torch.zeros(64, 128)
    assert fd.dwt2d_unsupported(ok, fb) is None
    assert fd.dwt2d_unsupported(torch.zeros(3, 64, 128), fb) is None
    assert fd.dwt2d_unsupported(ok.double(), fb) is None
    assert "float32 or float64" in fd.dwt2d_unsupported(ok.half(), fb)
    assert fd.dwt2d_unsupported(torch.zeros(63, 128), fb) is None
    assert fd.dwt2d_unsupported(torch.zeros(64, 127), fb) is None
    assert fd.dwt2d_unsupported(torch.zeros(1, 1), fb) is None
    assert fd.dwt2d_unsupported(torch.zeros(70000, 2, 2), fb) is None
    assert "rank" in fd.dwt2d_unsupported(torch.zeros(2, 2, 64, 128), fb)
    assert "empty" in fd.dwt2d_unsupported(torch.zeros(0, 8, 8), fb)
    odd = FilterBank("odd", *(np.ones(3) for _ in range(4)))
    assert fd.dwt2d_unsupported(ok, odd) is None
    wide = FilterBank("wide", *(np.ones(41) for _ in range(4)))
    assert "filter length" in fd.dwt2d_unsupported(ok, wide)


def test_k2_coverage_rules():
    fb = get_filter_bank("sym20")
    c = [torch.zeros(32, 64) for _ in range(4)]
    assert fd.idwt2d_unsupported(*c, fb, (64, 128)) is None
    assert fd.idwt2d_unsupported(*c, fb, (63, 128)) is None
    assert fd.idwt2d_unsupported(*c, fb, (64, 127)) is None
    assert "shapes" in fd.idwt2d_unsupported(*c[:3], torch.zeros(32, 63), fb,
                                             (64, 128))
    assert fd.idwt2d_unsupported(*(s.double() for s in c), fb,
                                 (64, 128)) is None
    assert "float32" in fd.idwt2d_unsupported(
        *(s.half() for s in c), fb, (64, 128))
    assert "dtypes" in fd.idwt2d_unsupported(*c[:3], c[3].double(), fb,
                                             (64, 128))
    one = FilterBank("one", *(np.ones(1) for _ in range(4)))
    assert "filter length" in fd.idwt2d_unsupported(*c, one, (64, 128))


@pytest.mark.parametrize("wname", ["db2", "bior3.5", "odd3"])
@pytest.mark.parametrize("shape", [(63, 47), (2, 33, 64), (1, 5)], ids=str)
def test_odd_levels_plain_match_jax(wname, shape):
    """The odd levels K1/K2 now take (odd sizes, an odd filter length)
    against the JAX package's jnp path, which the Pallas kernels leave
    them to."""
    from pypwt_tpu.core import dwt as jdwt
    from pypwt_tpu.filters import FilterBank as JBank
    if wname == "odd3":
        taps = [np.asarray(v) for v in ([0.3, 0.6, 0.1], [0.2, -0.7, 0.5],
                                        [0.4, 0.5, 0.1], [-0.3, 0.6, -0.2])]
        jfb, tfb = JBank("odd3", *taps), FilterBank("odd3", *taps)
    else:
        jfb, tfb = jbank(wname), get_filter_bank(wname)
    x = _rand(shape)
    jdwt.set_kernels("jnp")
    try:
        ref = jdwt.dwt2d(jnp.asarray(x), jfb)
        c = [np.array(r) for r in ref]
        jrec = jdwt.idwt2d(*(jnp.asarray(s) for s in c), jfb, shape)
    finally:
        jdwt.set_kernels("auto")
    got = fd.dwt2d_fused(torch.from_numpy(x), tfb)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert np.abs(g.numpy() - np.asarray(r)).max() <= TOL
    rec = fd.idwt2d_fused(*(torch.from_numpy(s) for s in c), tfb, shape)
    assert rec.shape == shape
    assert np.abs(rec.numpy() - np.asarray(jrec)).max() <= TOL
