"""The port's separable 2D stationary transform against the JAX package on
the CPU.

K8/K9's plain versions (``swt2d_plain``, ``iswt2d_plain``) against the JAX
Pallas K8/K9 (``swt2d_level_fused``, ``iswt2d_level_fused``, interpret mode
on the CPU) and against ``pypwt_tpu.core.swt.swt2d_level``/``iswt2d_level``
on its jnp path, odd filter lengths, odd plane sizes, stacks, every level
the clamp allows and wraps wider than the plane included, max-abs 2e-5 on
[0, 1) float32 data; ``swt2d``/``iswt2d`` against ``pypwt_tpu.core.swt``
within 3e-4 * 2^level (coefficients) and 7e-4 (roundtrip) on 0..255 data;
the H/V naming on a non-square plane; pyramids carried across from numpy;
the coverage rules of K8/K9 and the routing counts.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pypwt_tpu.core import dwt as jdwt
from pypwt_tpu.core import swt as jswt
from pypwt_tpu.filters import FilterBank as JBank
from pypwt_tpu.filters import get_filter_bank as jbank
from pypwt_tpu.ops import pallas_dwt as pk
from pypwt_tpu_torch import ops
from pypwt_tpu_torch.core import dwt, swt
from pypwt_tpu_torch.core.shapes import clamp_levels
from pypwt_tpu_torch.filters import FilterBank, get_filter_bank
from pypwt_tpu_torch.ops import fused_dwt as fd

torch.set_num_threads(1)

KERNEL_TOL = 2e-5
COEFF_TOL = 3e-4
ROUNDTRIP_TOL = 7e-4
# an odd-length bank (any values: the a-trous map takes every hlen)
ODD = ([0.1, -0.3, 0.7, 0.25, -0.05], [0.2, 0.5, -0.6, 0.1, 0.3],
       [-0.15, 0.35, 0.6, 0.2, 0.05], [0.4, -0.2, 0.1, 0.55, -0.3])
BANKS = ["haar", "db2", "db8", "sym20", "bior3.5", "odd5"]
PLANES = [(8, 8), (64, 128), (33, 47), (2, 32, 48)]


def _banks(wname):
    """(JAX bank, port bank) of a built-in name or of 'odd5'."""
    if wname == "odd5":
        arrs = [np.asarray(a, np.float64) for a in ODD]
        return JBank("odd5", *arrs), FilterBank("odd5", *arrs)
    return jbank(wname), get_filter_bank(wname)


def _rand(shape, seed=42):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _img(shape, seed=0):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.float32)


def _err(got, ref):
    return float(np.abs(got.numpy() - np.asarray(ref)).max())


def _jnp_levels(fn, *args):
    """A JAX level function on its jnp path (the fallback the port's
    plain versions restate)."""
    jdwt.set_kernels("jnp")
    try:
        return fn(*args)
    finally:
        jdwt.set_kernels("auto")


# (wname, shape, level) at which the Pallas K8/K9 take the call
PALLAS_CASES = [(w, (64, 128), lev) for w in ("haar", "db2", "db8", "bior3.5",
                                              "odd5") for lev in (1, 2, 3)]
PALLAS_CASES += [("sym20", (64, 128), 1), ("db2", (2, 32, 48), 1),
                 ("db2", (2, 32, 48), 2)]


@pytest.mark.parametrize("wname, shape, level", PALLAS_CASES)
def test_k8_k9_plain_match_pallas(wname, shape, level):
    jfb, fb = _banks(wname)
    x = _rand(shape)
    ref = pk.swt2d_level_fused(jnp.asarray(x), jfb, level)
    assert ref is not None
    got = fd.swt2d_plain(torch.from_numpy(x), fb, level)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == torch.float32
        assert _err(g, r) <= KERNEL_TOL
    c = [_rand(shape, s) for s in range(4)]
    ref = pk.iswt2d_level_fused(*(jnp.asarray(s) for s in c), jfb, level)
    assert ref is not None
    got = fd.iswt2d_plain(*(torch.from_numpy(s) for s in c), fb, level)
    assert got.shape == shape and _err(got, ref) <= KERNEL_TOL


@pytest.mark.parametrize("wname", BANKS)
@pytest.mark.parametrize("shape", PLANES, ids=str)
def test_levels_match_jax_jnp_path(wname, shape):
    """Every level the clamp allows, both directions (sym20 on 8x8 and
    33x47 wraps wider than the plane)."""
    jfb, fb = _banks(wname)
    top = clamp_levels(99, shape[-2:], fb.hlen, 2)
    for level in range(1, top + 1):
        x = _rand(shape, level)
        ref = _jnp_levels(jswt.swt2d_level, jnp.asarray(x), jfb, level)
        got = swt.swt2d_level(torch.from_numpy(x), fb, level)
        for g, r in zip(got, ref):
            assert g.shape == r.shape and _err(g, r) <= KERNEL_TOL, level
        c = [_rand(shape, 10 * level + s) for s in range(4)]
        ref = _jnp_levels(jswt.iswt2d_level, *(jnp.asarray(s) for s in c),
                          jfb, level)
        got = swt.iswt2d_level(*(torch.from_numpy(s) for s in c), fb, level)
        assert got.shape == shape and _err(got, ref) <= KERNEL_TOL, level


def test_wrap_wider_than_the_plane():
    """sym8 at level 3 spans 60 samples of a 16 x 16 plane: the Pallas
    kernels decline it, the jnp path and the port wrap it."""
    jfb, fb = _banks("sym8")
    x = _rand((16, 16), 5)
    assert pk.swt2d_level_fused(jnp.asarray(x), jfb, 3) is None
    ref = _jnp_levels(jswt.swt2d_level, jnp.asarray(x), jfb, 3)
    got = swt.swt2d_level(torch.from_numpy(x), fb, 3)
    for g, r in zip(got, ref):
        assert _err(g, r) <= KERNEL_TOL
    ref = _jnp_levels(jswt.iswt2d_level, *ref, jfb, 3)
    assert _err(swt.iswt2d_level(*got, fb, 3), ref) <= KERNEL_TOL
    assert fd.swt2d_unsupported(torch.from_numpy(x), fb, 3) is None


def _assert_pyramid(got, ref, levels):
    assert len(got) == len(ref) == levels + 1
    assert got[0].shape == ref[0].shape
    assert _err(got[0], ref[0]) <= COEFF_TOL * 2 ** levels
    for lev in range(1, levels + 1):
        assert len(got[lev]) == 3
        for g, r in zip(got[lev], ref[lev]):
            assert g.shape == r.shape == got[0].shape
            assert _err(g, r) <= COEFF_TOL * 2 ** lev


CASES = [("db2", (64, 64), 3), ("haar", (48, 80), 3), ("sym8", (64, 96), 2),
         ("bior3.5", (33, 47), 2), ("db4", (2, 40, 56), 2),
         ("odd5", (32, 40), 3)]


@pytest.mark.parametrize("wname, shape, levels", CASES)
def test_swt2d_matches_jax(wname, shape, levels):
    jfb, fb = _banks(wname)
    x = _img(shape)
    got = swt.swt2d(torch.from_numpy(x), fb, levels)
    _assert_pyramid(got, jswt.swt2d(jnp.asarray(x), jfb, levels), levels)
    rec = swt.iswt2d(got, fb)
    assert rec.shape == x.shape
    jrec = jswt.iswt2d(dwt.pyramid_to_numpy(got), jfb)
    assert _err(rec, jrec) <= ROUNDTRIP_TOL
    if wname != "odd5":  # an arbitrary bank does not reconstruct
        assert np.abs(rec.numpy() - x).max() < ROUNDTRIP_TOL


@pytest.mark.parametrize("wname", ["db2", "haar", "sym5"])
def test_subband_names_on_a_non_square_plane(wname):
    """H is the high-pass along axis -2: on a plane that varies along the
    last axis only, H and D vanish and V does not; the same holds for the
    JAX fallback's names, which the port follows."""
    jfb, fb = _banks(wname)
    row = np.random.default_rng(1).random(80).astype(np.float32)
    x = np.tile(row, (48, 1))
    a, h, v, d = swt.swt2d_level(torch.from_numpy(x), fb, 1)
    assert float(h.abs().max()) < 1e-5 and float(d.abs().max()) < 1e-5
    assert float(v.abs().max()) > 1e-2
    ref = jswt.swt2d_level(jnp.asarray(x), jfb, 1)
    for g, r in zip((a, h, v, d), ref):
        assert _err(g, r) <= KERNEL_TOL
    # and the transpose swaps them
    at, ht, vt, dt = swt.swt2d_level(torch.from_numpy(x.T.copy()), fb, 1)
    assert float(vt.abs().max()) < 1e-5
    assert torch.allclose(ht, v.T, atol=KERNEL_TOL)


def test_pyramid_carried_from_numpy():
    jfb, fb = _banks("db3")
    x = _img((40, 56), 2)
    jpyr = jswt.swt2d(jnp.asarray(x), jfb, 3)
    pyr = dwt.pyramid_from_numpy(
        [np.asarray(jpyr[0])] + [tuple(np.asarray(s) for s in c)
                                 for c in jpyr[1:]], "cpu")
    assert len(pyr) == 4 and all(len(c) == 3 for c in pyr[1:])
    assert all(s.shape == x.shape for c in pyr[1:] for s in c)
    rec = swt.iswt2d(pyr, fb)
    assert _err(rec, jswt.iswt2d(jpyr, jfb)) <= ROUNDTRIP_TOL
    back = dwt.pyramid_to_numpy(pyr)
    np.testing.assert_array_equal(back[0], np.asarray(jpyr[0]))
    for c, jc in zip(back[1:], jpyr[1:]):
        assert isinstance(c, tuple)
        for s, js in zip(c, jc):
            np.testing.assert_array_equal(s, np.asarray(js))


def test_float64_matches_jax_jnp_path():
    x = np.random.default_rng(2).random((24, 40)) * 255
    got = swt.swt2d(torch.from_numpy(x), get_filter_bank("db3"), 2)
    ref = jswt.swt2d(jnp.asarray(x), jbank("db3"), 2)
    assert got[0].dtype == torch.float64 and _err(got[0], ref[0]) < 1e-9
    for c, jc in zip(got[1:], ref[1:]):
        for g, r in zip(c, jc):
            assert g.dtype == torch.float64 and _err(g, r) < 1e-9


def test_auto_on_cpu_takes_plain_and_counts_nothing():
    fb = get_filter_bank("db2")
    x = torch.from_numpy(_rand((32, 48)))
    ops.reset_counts()
    got = swt.swt2d_level(x, fb, 2)
    for g, w in zip(got, fd.swt2d_fused(x, fb, 2)):
        assert torch.equal(g, w)
    assert torch.equal(swt.iswt2d_level(*got, fb, 2),
                       fd.iswt2d_fused(*got, fb, 2))
    for k in fd.KERNELS:
        assert k.launches == 0


def test_cuda_mode_raises_on_cpu_tensor():
    fb = get_filter_bank("db2")
    x = torch.from_numpy(_rand((16, 16)))
    dwt.set_kernels("cuda")
    try:
        with pytest.raises(ValueError, match="CUDA tensors only"):
            swt.swt2d_level(x, fb, 1)
        with pytest.raises(ValueError, match="CUDA tensors only"):
            swt.iswt2d_level(x, x, x, x, fb, 1)
    finally:
        dwt.set_kernels("auto")


def test_k8_k9_coverage_rules():
    fb = get_filter_bank("sym20")
    x = torch.zeros(33, 47)
    # every level, odd sizes, odd hlen, stacks and wraps wider than the
    # plane are covered
    for level in (1, 5, 12, 40):
        assert fd.swt2d_unsupported(x, fb, level) is None
        assert fd.iswt2d_unsupported(x, x, x, x, fb, level) is None
    _, odd = _banks("odd5")
    assert fd.swt2d_unsupported(torch.zeros(7, 5), odd, 3) is None
    assert fd.swt2d_unsupported(torch.zeros(3, 8, 8), fb, 2) is None
    assert "level" in fd.swt2d_unsupported(x, fb, 0)
    assert fd.swt2d_unsupported(x.double(), fb, 1) is None
    assert "float32" in fd.swt2d_unsupported(x.half(), fb, 1)
    assert "rank" in fd.swt2d_unsupported(torch.zeros(16), fb, 1)
    assert "shapes" in fd.iswt2d_unsupported(x, x, x, torch.zeros(33, 46),
                                             fb, 1)
    assert "dtypes" in fd.iswt2d_unsupported(x, x.double(), x, x, fb, 1)
    wide = FilterBank("wide", *(np.ones(42) for _ in range(4)))
    assert "filter length" in fd.swt2d_unsupported(x, wide, 1)
    # a level past the grid's limits goes in chunks: no limit on rows,
    # level or batch
    assert fd.swt2d_unsupported(torch.zeros(70000, 1), fb, 18) is None
    assert fd.swt2d_unsupported(torch.zeros(70000, 1, 2), fb, 2) is None
    y = torch.zeros(70000, 1, 2)
    assert fd.iswt2d_unsupported(y, y, y, y, fb, 18) is None
    assert "empty" in fd.swt2d_unsupported(torch.zeros(0, 8, 8), fb, 1)


@pytest.mark.parametrize("direction", ["analysis", "synthesis"])
def test_k8_k9_route_raises_on_uncovered_cuda_level(monkeypatch, direction):
    """K8/K9 never decline: a level they do not cover on a CUDA tensor
    (float16: their instances are float32 and float64) raises, and kernel
    mode "torch" runs the plain version.  A CPU tensor poses as a CUDA one,
    so that the routing runs without a card."""
    fb = get_filter_bank("db2")
    x = torch.from_numpy(_rand((16, 24))).half()
    if direction == "analysis":
        def call():
            return swt.swt2d_level(x, fb, 2)
    else:
        def call():
            return swt.iswt2d_level(x, x, x, x, fb, 2)
    want = call()
    ops.reset_counts()
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    with pytest.raises(ValueError, match=r"float16.*set_kernels\('torch'\)"):
        call()
    dwt.set_kernels("torch")
    try:
        got = call()
    finally:
        dwt.set_kernels("auto")
        monkeypatch.undo()
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, w)
    for k in ops.KERNELS:
        assert k.launches == 0
