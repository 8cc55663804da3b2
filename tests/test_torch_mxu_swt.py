"""The port's tensor-core 2D SWT (K11a/K11b, ``ops.mxu_swt``) against the
JAX package on the CPU.

The dilated matrix functions bit-identical to JAX's (levels 1-3);
K11a/K11b's plain versions (``swt2d_mxu_plain``, ``iswt2d_mxu_plain``,
the banded products) against JAX's MXU kernels ``swt2d_level_fused_mxu``/
``iswt2d_level_fused_mxu`` run in interpret mode on the CPU, or JAX's jnp
path where those return None (a dilated support wider than the plane),
max-abs 2e-5 on [0, 1) float32 data (as tests/test_mxu_swt.py);
``Wavelets`` sym8 L3 SWT under ``set_kernels("mxu")`` in both packages
within 5e-5; "bf16" within JAX's loose gate (RMS error <= 1 % of the
reference's RMS per subband at level 1, doubling per level, as in
tests/test_torch_mxu_dwt.py); and the routing of mode "mxu", which sends a
level whose support passes the plane to K8/K9, as JAX sends it to its
VPU kernel.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pypwt_tpu
from pypwt_tpu.core import dwt as jdwt
from pypwt_tpu.core import swt as jswt
from pypwt_tpu.filters import get_filter_bank as jbank
from pypwt_tpu.ops import mxu_swt as jms
from pypwt_tpu.ops import pallas_dwt as jpk
import pypwt_tpu_torch
from pypwt_tpu_torch import ops
from pypwt_tpu_torch.core import dwt, swt
from pypwt_tpu_torch.filters import get_filter_bank
from pypwt_tpu_torch.ops import fused_dwt as fd
from pypwt_tpu_torch.ops import mxu_swt as kms

torch.set_num_threads(1)

KERNEL_TOL = 2e-5
PLAN_TOL = 5e-5
BF16_RMS = 0.01
WIDE = ["db4", "sym8", "coif3", "bior4.4", "db10"]
SHAPES = [(64, 128), (128, 64), (3, 64, 128)]


def _rand(shape, seed=7):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _err(got, ref):
    return float(np.abs(got.numpy() - np.asarray(ref)).max())


def _rel_rms(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((got - ref) ** 2) / np.mean(ref ** 2)))


def _jnp(fn, *args):
    jdwt.set_kernels("jnp")
    try:
        return fn(*args)
    finally:
        jdwt.set_kernels("auto")


@pytest.mark.parametrize("wname", ["db2", "sym8", "bior4.4", "db10", "sym20"])
@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("b", [kms._BLOCK, 5, 1])
@pytest.mark.parametrize("kind", ["analysis", "synthesis"])
def test_matrices_bit_identical_to_jax(wname, level, b, kind):
    fb, jfb = get_filter_bank(wname), jbank(wname)
    if kind == "analysis":
        got = kms.swt_analysis_matrix(fb.dec_lo, fb.dec_hi, b, level)
        ref = jms.swt_analysis_matrix(jfb.dec_lo, jfb.dec_hi, b, level)
    else:
        got = kms.swt_synthesis_matrix(fb.rec_lo, fb.rec_hi, b, level)
        ref = jms.swt_synthesis_matrix(jfb.rec_lo, jfb.rec_hi, b, level)
    assert got[1] == ref[1]
    assert got[0].dtype == ref[0].dtype == np.float32
    assert np.array_equal(got[0], ref[0])


@pytest.mark.parametrize("wname", WIDE)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("level", [1, 2, 3])
def test_k11a_plain_matches_jax_mxu_kernel(wname, shape, level):
    fb, jfb = get_filter_bank(wname), jbank(wname)
    x = _rand(shape, level)
    ref = jms.swt2d_level_fused_mxu(jnp.asarray(x), jfb, level)
    assert (ref is None) == (kms.swt2d_mxu_unsupported(
        torch.from_numpy(x), fb, level) is not None)
    if ref is None:  # support wider than the plane: JAX's jnp path
        ref = _jnp(jswt.swt2d_level, jnp.asarray(x), jfb, level)
    got = kms.swt2d_mxu_plain(torch.from_numpy(x), fb, level)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == torch.float32
        assert _err(g, r) <= KERNEL_TOL


@pytest.mark.parametrize("wname", WIDE)
# and a plane under one 32 x 32 tile of the kernel, and level 4
@pytest.mark.parametrize("shape", SHAPES + [(20, 24)], ids=str)
@pytest.mark.parametrize("level", [1, 2, 3, 4])
def test_k11b_plain_matches_jax_mxu_kernel(wname, shape, level):
    fb, jfb = get_filter_bank(wname), jbank(wname)
    c = [_rand(shape, 10 * level + s) for s in range(4)]
    ref = jms.iswt2d_level_fused_mxu(*(jnp.asarray(s) for s in c), jfb, level)
    if ref is None:
        ref = _jnp(jswt.iswt2d_level, *(jnp.asarray(s) for s in c), jfb,
                   level)
    got = kms.iswt2d_mxu_plain(*(torch.from_numpy(s) for s in c), fb, level)
    assert got.shape == shape and _err(got, ref) <= KERNEL_TOL


@pytest.mark.parametrize("wname", ["haar", "sym8", "sym20"])
@pytest.mark.parametrize("shape", [(33, 47), (2, 40, 24)], ids=str)
def test_plain_matches_k8_k9_plain_on_odd_planes(wname, shape):
    """The banded level against K8/K9's plain versions (the tap loops) on
    odd and small planes, every level whose support fits."""
    fb = get_filter_bank(wname)
    x = torch.from_numpy(_rand(shape))
    for level in (1, 2, 3):
        if kms.swt2d_mxu_unsupported(x, fb, level):
            continue
        for g, r in zip(kms.swt2d_mxu_plain(x, fb, level),
                        fd.swt2d_plain(x, fb, level)):
            assert float((g - r).abs().max()) <= KERNEL_TOL
        back = kms.iswt2d_mxu_plain(x, x, x, x, fb, level)
        assert float((back - fd.iswt2d_plain(x, x, x, x, fb, level))
                     .abs().max()) <= KERNEL_TOL


def _modes(mode, prec="highest"):
    pypwt_tpu.core.dwt.set_kernels(mode)
    pypwt_tpu.core.dwt.set_mxu_precision(prec)
    dwt.set_kernels(mode)
    dwt.set_mxu_precision(prec)


@pytest.mark.parametrize("threshold", [False, True], ids=["plain", "soft"])
def test_wavelets_swt_mxu_mode_matches_jax(threshold):
    """Wavelets sym8 L3 SWT under set_kernels("mxu") in both packages."""
    img = _rand((128, 128), 4)
    try:
        _modes("mxu")
        j = pypwt_tpu.Wavelets(img, "sym8", 3, do_swt=1)
        t = pypwt_tpu_torch.Wavelets(img, "sym8", 3, do_swt=1, device="cpu")
        j.forward()
        t.forward()
        if threshold:
            j.soft_threshold(0.05)
            t.soft_threshold(0.05)
        jc, tc = j.coeffs, t.coeffs
        j.inverse()
        t.inverse()
    finally:
        _modes("auto")
    assert t.levels == j.levels == 3
    assert np.abs(tc[0] - jc[0]).max() <= PLAN_TOL
    for lev in range(1, 4):
        for a, b in zip(tc[lev], jc[lev]):
            assert a.shape == b.shape and np.abs(a - b).max() <= PLAN_TOL
    assert np.abs(t.image - j.image).max() <= PLAN_TOL


@pytest.mark.parametrize("wname", ["db4", "sym8", "db10"])
def test_bf16_within_loose_gate(wname):
    """"bf16": RMS error <= 1 % of the reference's RMS (JAX's float32
    levels) per subband at level 1, doubling per level; the roundtrip at
    its depth."""
    fb, jfb = get_filter_bank(wname), jbank(wname)
    x = (_rand((2, 96, 128), 5) * 255).astype(np.float32)
    ref = _jnp(jswt.swt2d, jnp.asarray(x), jfb, 3)
    try:
        _modes("mxu", "bf16")
        got = swt.swt2d(torch.from_numpy(x), fb, 3)
        back = swt.iswt2d(got, fb)
    finally:
        _modes("auto")
    assert _rel_rms(got[0], ref[0]) <= BF16_RMS * 4
    for lev in range(1, 4):
        for g, r in zip(got[lev], ref[lev]):
            assert _rel_rms(g, r) <= BF16_RMS * 2 ** (lev - 1)
    assert 0 < _rel_rms(back, x) <= BF16_RMS * 4


# (bank, plane, level): supports that fit and supports wider than the
# plane (sym8 L4 spans 56 rows; db10 L4 on 32^2, tests/test_mxu_swt.py)
ROUTES = [("sym8", (64, 128), 1), ("sym8", (64, 128), 3),
          ("sym8", (32, 48), 4), ("db10", (32, 32), 4), ("haar", (16, 16), 4),
          ("haar", (16, 16), 6), ("db2", (33, 47), 2)]


@pytest.mark.parametrize("wname, shape, level", ROUTES, ids=str)
def test_routing_picks_jax_route(wname, shape, level):
    """In mode "mxu" a level goes to K11a/K11b by JAX's coverage rule (a
    dilated support that fits in the plane; a wider one goes to K8/K9), so
    wherever JAX's MXU kernels take it; K11 also takes planes whose band
    geometry JAX's TPU tiling declines (33 x 47).  Never in mode "auto"."""
    fb, jfb = get_filter_bank(wname), jbank(wname)
    x = _rand(shape)
    lp, rp, _, _ = jpk._swt_pads(fb.hlen, level, inverse=False)
    ilp, irp, _, _ = jpk._swt_pads(fb.hlen, level, inverse=True)
    fits = max(lp, rp) <= min(shape), max(ilp, irp) <= min(shape)
    jax_ana = jms.swt2d_level_fused_mxu(jnp.asarray(x), jfb, level) is not None
    jax_syn = jms.iswt2d_level_fused_mxu(*(jnp.asarray(x),) * 4, jfb,
                                         level) is not None
    t = torch.from_numpy(x)
    for mode in ("auto", "torch", "cuda"):
        dwt.set_kernels(mode)
        try:
            assert not swt.use_k11a(t, fb, level)
            assert not swt.use_k11b(t, t, t, t, fb, level)
        finally:
            dwt.set_kernels("auto")
    dwt.set_kernels("mxu")
    try:
        assert swt.use_k11a(t, fb, level) == fits[0]
        assert swt.use_k11b(t, t, t, t, fb, level) == fits[1]
        assert fits[0] or not jax_ana
        assert fits[1] or not jax_syn
        assert not swt.use_k11a(t.double(), fb, level)
    finally:
        dwt.set_kernels("auto")


def test_mxu_mode_on_cpu_runs_the_banded_plain_versions():
    """On a CPU tensor mode "mxu" runs K11a/K11b's plain versions and, for
    a support wider than the plane, K8/K9's; no launch."""
    fb = get_filter_bank("sym8")
    x = torch.from_numpy(_rand((32, 48)))
    ops.reset_counts()
    dwt.set_kernels("mxu")
    try:
        near = swt.swt2d_level(x, fb, 2)
        back = swt.iswt2d_level(*near, fb, 2)
        wide = swt.swt2d_level(x, fb, 4)
    finally:
        dwt.set_kernels("auto")
    for g, r in zip(near, kms.swt2d_mxu_plain(x, fb, 2)):
        assert torch.equal(g, r)
    assert torch.equal(back, kms.iswt2d_mxu_plain(*near, fb, 2))
    for g, r in zip(wide, fd.swt2d_plain(x, fb, 4)):
        assert torch.equal(g, r)
    assert sum(k.launches for k in ops.KERNELS) == 0


@pytest.mark.parametrize("direction", ["analysis", "synthesis"])
def test_mxu_route_raises_on_float64_cuda_level(monkeypatch, direction):
    """A float64 level on a CUDA tensor in mode "mxu" goes to K8/K9's
    float64 instances (K11 takes float32 only), and a level no kernel
    covers (float16) raises (a CPU tensor poses as a CUDA one)."""
    fb = get_filter_bank("sym8")
    x = torch.from_numpy(_rand((32, 48))).double()
    h = x.half()
    if direction == "analysis":
        def routes(t):
            return swt.use_k11a(t, fb, 1), swt.use_k8(t, fb, 1)

        def call():
            return swt.swt2d_level(h, fb, 1)
    else:
        def routes(t):
            return (swt.use_k11b(t, t, t, t, fb, 1),
                    swt.use_k9(t, t, t, t, fb, 1))

        def call():
            return swt.iswt2d_level(h, h, h, h, fb, 1)
    ops.reset_counts()
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    dwt.set_kernels("mxu")
    try:
        assert routes(x) == (False, True)
        assert routes(x.float()) == (True, True)
        with pytest.raises(ValueError, match="float16"):
            call()
    finally:
        dwt.set_kernels("auto")
        monkeypatch.undo()
    assert sum(k.launches for k in ops.KERNELS) == 0


def test_coverage_rules():
    fb = get_filter_bank("sym8")
    x = torch.zeros(2, 33, 47)
    assert kms.swt2d_mxu_unsupported(x, fb, 2) is None
    assert "wider than the plane" in kms.swt2d_mxu_unsupported(x, fb, 4)
    assert "level 0" in kms.swt2d_mxu_unsupported(x, fb, 0)
    assert "float64" in kms.swt2d_mxu_unsupported(x.double(), fb, 1)
    assert kms.iswt2d_mxu_unsupported(x, x, x, x, fb, 2) is None
    assert "wider than the plane" in kms.iswt2d_mxu_unsupported(
        x, x, x, x, fb, 4)
    assert "different shapes" in kms.iswt2d_mxu_unsupported(
        x, x, x, torch.zeros(2, 33, 46), fb, 1)
