"""The port's tensor-core 2D DWT (K5/K6, ``ops.mxu_dwt``) against the JAX
package on the CPU.

The matrix functions bit-identical to JAX's; K5/K6's plain versions
(``dwt2d_mxu_plain``, ``idwt2d_mxu_plain``, the banded products) against
JAX's MXU kernels ``dwt2d_fused_mxu``/``idwt2d_fused_mxu`` run in
interpret mode on the CPU, or JAX's jnp path where those return None,
max-abs 2e-5 on [0, 1) float32 data (as tests/test_mxu.py); ``Wavelets``
sym8 L3 under ``set_kernels("mxu")`` in both packages within 5e-5;
"bf16" within JAX's loose gate (RMS error <= 1 % of the reference's RMS
per subband at level 1, doubling per level as the reference's envelope
3e-4 * 2^level does: bf16 taps leave part of the approximation's mean,
which doubles per level on 0..255 data, in the detail subbands; a
roundtrip at its depth); the
precision knob; and the routing of mode "mxu", which picks JAX's route.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pypwt_tpu
from pypwt_tpu.core import dwt as jdwt
from pypwt_tpu.filters import get_filter_bank as jbank
from pypwt_tpu.ops import mxu_dwt as jmx
import pypwt_tpu_torch
from pypwt_tpu_torch import ops
from pypwt_tpu_torch.core import dwt
from pypwt_tpu_torch.filters import get_filter_bank
from pypwt_tpu_torch.ops import fused_dwt as fd
from pypwt_tpu_torch.ops import mxu_dwt as km

torch.set_num_threads(1)

KERNEL_TOL = 2e-5
PLAN_TOL = 5e-5
BF16_RMS = 0.01
WIDE = ["db4", "sym8", "coif3", "bior4.4", "db10"]
SHAPES = [(64, 128), (128, 64), (3, 64, 128)]
# K5's odd output widths (lc = 65, 19; scalar stores on the card) and a
# batch whose later planes start at odd offsets
K5_SHAPES = SHAPES + [(66, 130), (3, 22, 38)]


def _rand(shape, seed=7):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _err(got, ref):
    return float(np.abs(got.numpy() - np.asarray(ref)).max())


def _rel_rms(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((got - ref) ** 2) / np.mean(ref ** 2)))


def _jnp(fn, *args):
    """A JAX level function on its jnp path."""
    jdwt.set_kernels("jnp")
    try:
        return fn(*args)
    finally:
        jdwt.set_kernels("auto")


@pytest.mark.parametrize("wname", ["db2", "sym8", "bior4.4", "db10", "sym20"])
@pytest.mark.parametrize("size", ["blocks", 5, 1])
@pytest.mark.parametrize("kind", ["analysis", "synthesis"])
def test_matrices_bit_identical_to_jax(wname, size, kind):
    fb, jfb = get_filter_bank(wname), jbank(wname)
    if kind == "analysis":
        b = km._ana_blocks(fb.hlen) if size == "blocks" else size
        assert km._ana_blocks(fb.hlen) == jmx._ana_blocks(fb.hlen)
        got = km.analysis_matrix(fb.dec_lo, fb.dec_hi, b)
        ref = jmx.analysis_matrix(jfb.dec_lo, jfb.dec_hi, b)
    else:
        b = km._syn_blocks(fb.hlen) if size == "blocks" else size
        assert km._syn_blocks(fb.hlen) == jmx._syn_blocks(fb.hlen)
        got = km.synthesis_matrix(fb.rec_lo, fb.rec_hi, b)
        ref = jmx.synthesis_matrix(jfb.rec_lo, jfb.rec_hi, b)
    assert got[1] == ref[1]
    assert got[0].dtype == ref[0].dtype == np.float32
    assert np.array_equal(got[0], ref[0])


@pytest.mark.parametrize("wname", WIDE)
@pytest.mark.parametrize("shape", K5_SHAPES, ids=str)
def test_k5_plain_matches_jax_mxu_kernel(wname, shape):
    fb, jfb = get_filter_bank(wname), jbank(wname)
    x = _rand(shape)
    ref = jmx.dwt2d_fused_mxu(jnp.asarray(x), jfb)
    if ref is None:  # JAX declines the geometry: its jnp path
        ref = _jnp(jdwt.dwt2d, jnp.asarray(x), jfb)
    got = km.dwt2d_mxu_plain(torch.from_numpy(x), fb)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == torch.float32
        assert _err(g, r) <= KERNEL_TOL


@pytest.mark.parametrize("wname", WIDE)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_k6_plain_matches_jax_mxu_kernel(wname, shape):
    fb, jfb = get_filter_bank(wname), jbank(wname)
    half = (*shape[:-2], shape[-2] // 2, shape[-1] // 2)
    c = [_rand(half, s) for s in range(4)]
    ref = jmx.idwt2d_fused_mxu(*(jnp.asarray(s) for s in c), jfb, shape)
    if ref is None:
        ref = _jnp(jdwt.idwt2d, *(jnp.asarray(s) for s in c), jfb, shape)
    got = km.idwt2d_mxu_plain(*(torch.from_numpy(s) for s in c), fb, shape)
    assert got.shape == shape and _err(got, ref) <= KERNEL_TOL


@pytest.mark.parametrize("wname", ["sym8", "db10"])
def test_plain_roundtrip_and_tap_path(wname):
    """The banded level against K1/K2's plain versions (the tap loops) and
    its own inverse."""
    fb = get_filter_bank(wname)
    x = torch.from_numpy(_rand((2, 96, 160)))
    got = km.dwt2d_mxu_plain(x, fb)
    for g, r in zip(got, fd.dwt2d_plain(x, fb)):
        assert float((g - r).abs().max()) <= KERNEL_TOL
    back = km.idwt2d_mxu_plain(*got, fb, x.shape)
    assert float((back - fd.idwt2d_plain(*got, fb, x.shape)).abs().max()) \
        <= KERNEL_TOL
    assert float((back - x).abs().max()) <= KERNEL_TOL


def _mxu_modes(prec="highest"):
    pypwt_tpu.core.dwt.set_kernels("mxu")
    pypwt_tpu.core.dwt.set_mxu_precision(prec)
    dwt.set_kernels("mxu")
    dwt.set_mxu_precision(prec)


def _reset_modes():
    pypwt_tpu.core.dwt.set_kernels("auto")
    pypwt_tpu.core.dwt.set_mxu_precision("highest")
    dwt.set_kernels("auto")
    dwt.set_mxu_precision("highest")


@pytest.mark.parametrize("threshold", [False, True], ids=["plain", "soft"])
def test_wavelets_mxu_mode_matches_jax(threshold):
    """Wavelets sym8 L3 under set_kernels("mxu") in both packages (JAX's
    MXU kernels in interpret mode, the port's banded plain versions)."""
    img = _rand((256, 256), 3)
    try:
        _mxu_modes()
        j = pypwt_tpu.Wavelets(img, "sym8", 3)
        t = pypwt_tpu_torch.Wavelets(img, "sym8", 3, device="cpu")
        j.forward()
        t.forward()
        if threshold:
            j.soft_threshold(0.05)
            t.soft_threshold(0.05)
        jc, tc = j.coeffs, t.coeffs
        j.inverse()
        t.inverse()
    finally:
        _reset_modes()
    assert t.levels == j.levels == 3
    assert np.abs(tc[0] - jc[0]).max() <= PLAN_TOL
    for lev in range(1, 4):
        for a, b in zip(tc[lev], jc[lev]):
            assert a.shape == b.shape and np.abs(a - b).max() <= PLAN_TOL
    assert np.abs(t.image - j.image).max() <= PLAN_TOL


@pytest.mark.parametrize("wname", ["db4", "sym8", "db10"])
def test_bf16_within_loose_gate(wname):
    """"bf16" rounds both operands of each pass to bfloat16 (JAX's DEFAULT
    dots; JAX's CPU backend keeps float32, so the reference is JAX's
    float32 level): RMS error <= 1 % of the reference's RMS per subband at
    level 1, doubling per level; the roundtrip, which carries the mean's
    error down and back up, at its depth (db4 L3 here: 1.38 %)."""
    fb, jfb = get_filter_bank(wname), jbank(wname)
    x = (_rand((2, 128, 128), 5) * 255).astype(np.float32)
    ref = _jnp(jdwt.wavedec2, jnp.asarray(x), jfb, 3)
    try:
        _mxu_modes("bf16")
        got = dwt.wavedec2(torch.from_numpy(x), fb, 3)
        back = dwt.waverec2(got, fb, x.shape)
    finally:
        _reset_modes()
    assert _rel_rms(got[0], ref[0]) <= BF16_RMS * 4
    for lev in range(1, 4):
        for g, r in zip(got[lev], ref[lev]):
            assert _rel_rms(g, r) <= BF16_RMS * 2 ** (lev - 1)
    assert 0 < _rel_rms(back, x) <= BF16_RMS * 4  # 3 levels down and back
    level1 = km.dwt2d_mxu_plain(torch.from_numpy(x), fb, "bf16")
    assert not torch.equal(level1[0], km.dwt2d_mxu_plain(
        torch.from_numpy(x), fb)[0])


@pytest.mark.parametrize("bad", ["fp8", "HIGHEST", "tf32", ""])
def test_set_mxu_precision_rejects(bad):
    with pytest.raises(ValueError, match="highest|bf16"):
        dwt.set_mxu_precision(bad)
    assert dwt.mxu_precision() == "highest"
    with pytest.raises(ValueError):
        km.dwt2d_mxu_fused(torch.zeros(8, 8), get_filter_bank("sym8"), bad)


def test_set_kernels_takes_mxu():
    dwt.set_kernels("mxu")
    try:
        assert dwt._KERNEL_MODE == "mxu"
    finally:
        dwt.set_kernels("auto")
    with pytest.raises(ValueError, match="auto|torch|cuda|mxu"):
        dwt.set_kernels("pallas")


# (bank, plane): hlen 2, odd planes, and planes K5/K6 take
ROUTES = [("haar", (64, 128)), ("db1", (32, 32)), ("sym8", (63, 128)),
          ("sym8", (64, 127)), ("sym8", (64, 128)), ("db4", (3, 64, 128)),
          ("db2", (64, 64)), ("sym20", (64, 64))]


@pytest.mark.parametrize("wname, shape", ROUTES, ids=str)
def test_routing_picks_jax_route(wname, shape):
    """In mode "mxu" a level goes to K5/K6 by JAX's coverage rule (even
    sizes, an even bank of 4 or more taps: hlen 2 and odd planes go to
    K1/K2), so wherever JAX's MXU kernels take a level; K6 also takes
    levels whose band geometry JAX's TPU tiling declines.  Never in mode
    "auto"."""
    fb, jfb = get_filter_bank(wname), jbank(wname)
    x = _rand(shape)
    jax_takes = jmx.dwt2d_fused_mxu(jnp.asarray(x), jfb) is not None
    rule = (jmx._covers(jfb, *shape[-2:]) and fb.hlen >= 4)
    t = torch.from_numpy(x)
    half = (*shape[:-2], shape[-2] // 2, shape[-1] // 2)
    c = torch.zeros(half)
    for mode in ("auto", "torch", "cuda"):
        dwt.set_kernels(mode)
        try:
            assert not dwt.use_k5(t, fb)
            assert not dwt.use_k6(c, c, c, c, fb, shape)
        finally:
            dwt.set_kernels("auto")
    dwt.set_kernels("mxu")
    try:
        assert dwt.use_k5(t, fb) == jax_takes == rule
        if shape[-1] % 2 == 0 and shape[-2] % 2 == 0:
            jax_inv = jmx.idwt2d_fused_mxu(*(jnp.zeros(half),) * 4, jfb,
                                           shape) is not None
            assert dwt.use_k6(c, c, c, c, fb, shape) == rule
            assert rule or not jax_inv
        assert not dwt.use_k5(t.double(), fb)
    finally:
        dwt.set_kernels("auto")


def test_mxu_mode_on_cpu_runs_the_banded_plain_versions():
    """On a CPU tensor mode "mxu" runs K5/K6's plain versions (no launch),
    and K1/K2's where K5/K6 do not take the level."""
    fb = get_filter_bank("sym8")
    x = torch.from_numpy(_rand((64, 96)))
    odd = torch.from_numpy(_rand((63, 96)))
    ops.reset_counts()
    dwt.set_kernels("mxu")
    try:
        got = dwt.dwt2d(x, fb)
        back = dwt.idwt2d(*got, fb, x.shape)
        got_odd = dwt.dwt2d(odd, fb)
    finally:
        dwt.set_kernels("auto")
    for g, r in zip(got, km.dwt2d_mxu_plain(x, fb)):
        assert torch.equal(g, r)
    assert torch.equal(back, km.idwt2d_mxu_plain(*got, fb, x.shape))
    for g, r in zip(got_odd, fd.dwt2d_plain(odd, fb)):
        assert torch.equal(g, r)
    assert sum(k.launches for k in ops.KERNELS) == 0


@pytest.mark.parametrize("direction", ["analysis", "synthesis"])
def test_mxu_route_raises_on_float64_cuda_level(monkeypatch, direction):
    """Mode "mxu" never falls back: a float64 level on a CUDA tensor goes to
    K1/K2's float64 instances (K5/K6 take float32 only), and a level no
    kernel covers (float16) raises.  A CPU tensor poses as a CUDA one, so
    that the routing runs without a card."""
    fb = get_filter_bank("sym8")
    x = torch.from_numpy(_rand((16, 24))).double()
    h = x.half()
    if direction == "analysis":
        def routes(t):
            return dwt.use_k5(t, fb), dwt.use_k1(t, fb)

        def call():
            return dwt.dwt2d(h, fb)
    else:
        def routes(t):
            return (dwt.use_k6(t, t, t, t, fb, (32, 48)),
                    dwt.use_k2(t, t, t, t, fb, (32, 48)))

        def call():
            return dwt.idwt2d(h, h, h, h, fb, (32, 48))
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
    assert km.dwt2d_mxu_unsupported(torch.zeros(2, 64, 32), fb) is None
    assert "even sizes" in km.dwt2d_mxu_unsupported(torch.zeros(63, 64), fb)
    assert "float64" in km.dwt2d_mxu_unsupported(
        torch.zeros(64, 64, dtype=torch.float64), fb)
    assert "rank" in km.dwt2d_mxu_unsupported(torch.zeros(1, 2, 8, 8), fb)
    assert "filter length 2" in km.dwt2d_mxu_unsupported(
        torch.zeros(8, 8), get_filter_bank("haar"))
    c = torch.zeros(4, 6)
    assert km.idwt2d_mxu_unsupported(c, c, c, c, fb, (8, 12)) is None
    assert "twice" in km.idwt2d_mxu_unsupported(c, c, c, c, fb, (7, 12))
    assert "different shapes" in km.idwt2d_mxu_unsupported(
        c, c, c, torch.zeros(4, 7), fb, (8, 12))
