"""The port's 1D tensor-core forms (K7a/K7b in ``ops.mxu_dwt``, K12a/K12b in
``ops.mxu_swt``) against the JAX package on the CPU.

K7a/K7b's and K12a/K12b's plain versions (the banded products on rows)
against JAX's MXU kernels ``dwt1d_fused_mxu``/``idwt1d_fused_mxu``/
``swt1d_level_fused_mxu``/``iswt1d_level_fused_mxu`` run in interpret mode
on the CPU, or JAX's jnp path where those return None (a row count its TPU
tiling declines, a support wider than the row), max-abs 2e-5 on [0, 1)
float32 data (as tests/test_torch_mxu_dwt.py); whole ``Wavelets(...,
ndim=1)`` and single-signal plans, DWT and SWT, sym8 L3, under
``set_kernels("mxu")`` in both packages within 5e-5 (one signal runs as a
``(1, n)`` row in the port, folded in JAX: the same map); "bf16" within
JAX's loose gate (RMS error <= 1 % of the reference's RMS per subband at
level 1, doubling per level, as in tests/test_torch_mxu_dwt.py); and the
routing of mode "mxu": which levels go to K7/K12 and which to K3/K4/K10
(odd rows, an output other than twice the coefficients, odd banks, a
support wider than the row, float64), and that mode "auto" never takes
K7/K12.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pypwt_tpu
from pypwt_tpu.core import dwt as jdwt
from pypwt_tpu.core import swt as jswt
from pypwt_tpu.filters import get_filter_bank as jbank
from pypwt_tpu.ops import mxu_dwt as jmx
from pypwt_tpu.ops import mxu_swt as jms
import pypwt_tpu_torch
from pypwt_tpu_torch import FilterBank, ops
from pypwt_tpu_torch.core import conv, dwt, swt
from pypwt_tpu_torch.filters import get_filter_bank
from pypwt_tpu_torch.ops import fused_dwt as fd
from pypwt_tpu_torch.ops import mxu_dwt as km
from pypwt_tpu_torch.ops import mxu_swt as kms

torch.set_num_threads(1)

KERNEL_TOL = 2e-5
PLAN_TOL = 5e-5
BF16_RMS = 0.01
WIDE = ["db4", "sym8", "bior4.4", "db10"]
ROWS = [(8, 256), (3, 130), (1, 4096)]


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


@pytest.mark.parametrize("wname", WIDE)
@pytest.mark.parametrize("shape", ROWS, ids=str)
def test_k7a_plain_matches_jax_mxu_kernel(wname, shape):
    fb, jfb = get_filter_bank(wname), jbank(wname)
    x = _rand(shape)
    ref = jmx.dwt1d_fused_mxu(jnp.asarray(x), jfb)
    if ref is None:  # JAX's TPU tiling declines the rows: its jnp path
        ref = _jnp(jdwt.dwt1d, jnp.asarray(x), jfb)
    got = km.dwt1d_mxu_plain(torch.from_numpy(x), fb)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == torch.float32
        assert _err(g, r) <= KERNEL_TOL


@pytest.mark.parametrize("wname", WIDE)
@pytest.mark.parametrize("shape", ROWS, ids=str)
def test_k7b_plain_matches_jax_mxu_kernel(wname, shape):
    fb, jfb = get_filter_bank(wname), jbank(wname)
    half = (shape[0], shape[1] // 2)
    a, d = _rand(half, 1), _rand(half, 2)
    ref = jmx.idwt1d_fused_mxu(jnp.asarray(a), jnp.asarray(d), jfb, shape[1])
    if ref is None:
        ref = _jnp(jdwt.idwt1d, jnp.asarray(a), jnp.asarray(d), jfb, shape[1])
    got = km.idwt1d_mxu_plain(torch.from_numpy(a), torch.from_numpy(d), fb,
                              shape[1])
    assert got.shape == shape and _err(got, ref) <= KERNEL_TOL


@pytest.mark.parametrize("wname", ["haar", "db2", "sym8", "db10"])
@pytest.mark.parametrize("shape", ROWS, ids=str)
@pytest.mark.parametrize("level", [1, 2, 3])
def test_k12_plain_matches_jax_mxu_kernel(wname, shape, level):
    fb, jfb = get_filter_bank(wname), jbank(wname)
    x, a, d = _rand(shape, level), _rand(shape, 10), _rand(shape, 11)
    ref = jms.swt1d_level_fused_mxu(jnp.asarray(x), jfb, level)
    if ref is None:
        ref = _jnp(jswt.swt1d_level, jnp.asarray(x), jfb, level)
    got = kms.swt1d_mxu_plain(torch.from_numpy(x), fb, level)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and _err(g, r) <= KERNEL_TOL
    ref = jms.iswt1d_level_fused_mxu(jnp.asarray(a), jnp.asarray(d), jfb,
                                     level)
    if ref is None:
        ref = _jnp(jswt.iswt1d_level, jnp.asarray(a), jnp.asarray(d), jfb,
                   level)
    got = kms.iswt1d_mxu_plain(torch.from_numpy(a), torch.from_numpy(d), fb,
                               level)
    assert got.shape == shape and _err(got, ref) <= KERNEL_TOL


@pytest.mark.parametrize("wname", ["sym8", "db10"])
def test_plain_roundtrip_and_tap_path(wname):
    """The banded levels against K3/K4's and K10's plain versions (the tap
    loops) and their own inverses."""
    fb = get_filter_bank(wname)
    x = torch.from_numpy(_rand((5, 288)))
    got = km.dwt1d_mxu_plain(x, fb)
    for g, r in zip(got, fd.dwt1d_plain(x, fb)):
        assert float((g - r).abs().max()) <= KERNEL_TOL
    back = km.idwt1d_mxu_plain(*got, fb, 288)
    assert float((back - x).abs().max()) <= KERNEL_TOL
    for level in (1, 2, 3):
        got = kms.swt1d_mxu_plain(x, fb, level)
        for g, r in zip(got, fd.swt1d_plain(x, fb, level)):
            assert float((g - r).abs().max()) <= KERNEL_TOL
        back = kms.iswt1d_mxu_plain(*got, fb, level)
        assert float((back - x).abs().max()) <= KERNEL_TOL


@pytest.mark.parametrize("kind", ["batched", "signal"])
@pytest.mark.parametrize("do_swt", [0, 1], ids=["dwt", "swt"])
def test_wavelets_mxu_mode_1d_matches_jax(kind, do_swt):
    """Wavelets sym8 L3 in 1D under set_kernels("mxu") in both packages
    (JAX's MXU kernels in interpret mode, the port's banded plain
    versions): a (16, 512) sinogram as batched 1D, and one signal of 4096
    samples."""
    img = _rand((16, 512) if kind == "batched" else (4096,), 3)
    kw = dict(ndim=1, do_swt=do_swt) if kind == "batched" else dict(
        do_swt=do_swt)
    try:
        _mxu_modes()
        j = pypwt_tpu.Wavelets(img, "sym8", 3, **kw)
        t = pypwt_tpu_torch.Wavelets(img, "sym8", 3, device="cpu", **kw)
        j.forward()
        t.forward()
        jc, tc = j.coeffs, t.coeffs
        j.inverse()
        t.inverse()
    finally:
        _reset_modes()
    assert t.levels == j.levels == 3
    for a, b in zip(tc, jc):
        assert a.shape == np.asarray(b).shape
        assert np.abs(a - np.asarray(b)).max() <= PLAN_TOL
    assert np.abs(t.image - j.image).max() <= PLAN_TOL
    assert np.abs(t.image.reshape(img.shape) - img).max() <= PLAN_TOL


@pytest.mark.parametrize("wname", ["db4", "sym8"])
@pytest.mark.parametrize("do_swt", [0, 1], ids=["dwt", "swt"])
def test_bf16_within_loose_gate(wname, do_swt):
    """"bf16" rounds both operands to bfloat16 (JAX's DEFAULT dots; JAX's
    CPU backend keeps float32, so the reference is JAX's float32 level):
    RMS error <= 1 % of the reference's RMS per subband at level 1,
    doubling per level; the roundtrip at its depth."""
    fb, jfb = get_filter_bank(wname), jbank(wname)
    x = (_rand((8, 512), 5) * 255).astype(np.float32)
    if do_swt:
        ref = _jnp(jswt.swt1d, jnp.asarray(x), jfb, 3)
    else:
        ref = _jnp(jdwt.wavedec1, jnp.asarray(x), jfb, 3)
    try:
        _mxu_modes("bf16")
        t = torch.from_numpy(x)
        if do_swt:
            got = swt.swt1d(t, fb, 3)
            back = swt.iswt1d(got, fb)
        else:
            got = dwt.wavedec1(t, fb, 3)
            back = dwt.waverec1(got, fb, x.shape[-1])
    finally:
        _reset_modes()
    assert _rel_rms(got[0], ref[0]) <= BF16_RMS * 4
    for lev in range(1, 4):
        assert _rel_rms(got[lev], ref[lev]) <= BF16_RMS * 2 ** (lev - 1)
    assert 0 < _rel_rms(back, x) <= BF16_RMS * 4
    level1 = km.dwt1d_mxu_plain(t, fb, "bf16")
    assert not torch.equal(level1[0], km.dwt1d_mxu_plain(t, fb)[0])


ODD = FilterBank("odd5", *(np.asarray(v) for v in (
    [0.1, -0.3, 0.7, 0.25, -0.05], [0.2, 0.5, -0.6, 0.1, 0.3],
    [-0.15, 0.35, 0.6, 0.2, 0.05], [0.4, -0.2, 0.1, 0.55, -0.3])))

# (bank, rows, level): odd rows, hlen 2, odd banks, supports wider than
# the row, and rows K7/K12 take
ROUTES = [("sym8", (8, 256), 1), ("sym8", (8, 255), 1), ("haar", (4, 64), 1),
          ("db2", (4, 64), 2), ("odd5", (4, 64), 2), ("sym8", (4, 16), 3),
          ("sym8", (1, 4096), 3), ("db10", (3, 40), 2), ("sym20", (2, 30), 1)]


def _banks(wname):
    if wname == "odd5":
        return ODD, None
    return get_filter_bank(wname), jbank(wname)


@pytest.mark.parametrize("wname, shape, level", ROUTES, ids=str)
def test_routing_picks_jax_route(wname, shape, level):
    """In mode "mxu" a 1D level goes to K7a/K7b by JAX's coverage rule
    (float32, an even row, an even bank of 4 or more taps; a synthesis of
    exactly twice the coefficients) and to K12a/K12b where the dilated
    support fits in the row (JAX's ``swt1d_level_fused_mxu`` rule), so
    wherever JAX's MXU kernels take a level; every other level goes to
    K3/K4/K10.  Never in mode "auto", "torch" or "cuda", and never for
    float64."""
    fb, jfb = _banks(wname)
    x = torch.from_numpy(_rand(shape))
    n = shape[-1]
    c = torch.zeros(shape[0], n // 2)
    k7 = fb.hlen % 2 == 0 and fb.hlen >= 4 and n % 2 == 0
    lp, rp = conv.swt_pads(fb.hlen, level, False)
    lq, rq = conv.swt_pads(fb.hlen, level, True)
    k12a, k12b = max(lp, rp) <= n, max(lq, rq) <= n
    if jfb is not None:  # JAX's own rule, where its bank exists
        assert k12a == (max(jms.pk._swt_pads(fb.hlen, level, False)[:2])
                        <= n)
    for mode in ("auto", "torch", "cuda"):
        dwt.set_kernels(mode)
        try:
            assert not dwt.use_k7a(x, fb)
            assert not dwt.use_k7b(c, c, fb, 2 * c.shape[-1])
            assert not swt.use_k12a(x, fb, level)
            assert not swt.use_k12b(x, x, fb, level)
        finally:
            dwt.set_kernels("auto")
    dwt.set_kernels("mxu")
    try:
        assert dwt.use_k7a(x, fb) == k7
        assert dwt.use_k7b(c, c, fb, 2 * c.shape[-1]) == (
            fb.hlen % 2 == 0 and fb.hlen >= 4)
        assert not dwt.use_k7b(c, c, fb, 2 * c.shape[-1] - 1)
        assert swt.use_k12a(x, fb, level) == k12a
        assert swt.use_k12b(x, x, fb, level) == k12b
        xd = x.double()
        assert not dwt.use_k7a(xd, fb)
        assert not swt.use_k12a(xd, fb, level)
        assert not swt.use_k12b(xd, xd, fb, level)
    finally:
        dwt.set_kernels("auto")
    if jfb is not None and k7 and shape[0] % 8 == 0:
        # JAX takes the level too (its TPU tiling wants 8-row blocks)
        assert jmx.dwt1d_fused_mxu(jnp.asarray(x.numpy()), jfb) is not None


def test_mxu_mode_on_cpu_runs_the_banded_plain_versions():
    """On a CPU tensor mode "mxu" runs K7/K12's plain versions (no launch),
    and K3/K4/K10's where K7/K12 do not take the level; one signal
    ``(n,)`` as the same row."""
    fb = get_filter_bank("sym8")
    x = torch.from_numpy(_rand((4, 256)))
    sig = x[0].clone()
    odd = torch.from_numpy(_rand((4, 255)))
    ops.reset_counts()
    dwt.set_kernels("mxu")
    try:
        got = dwt.dwt1d(x, fb)
        back = dwt.idwt1d(*got, fb, 256)
        one = dwt.dwt1d(sig, fb)
        s = swt.swt1d_level(x, fb, 2)
        sback = swt.iswt1d_level(*s, fb, 2)
        got_odd = dwt.dwt1d(odd, fb)
        wide = swt.swt1d_level(x[:, :16], fb, 3)
    finally:
        dwt.set_kernels("auto")
    for g, r in zip(got, km.dwt1d_mxu_plain(x, fb)):
        assert torch.equal(g, r)
    for g, r in zip(one, got):  # the same row (other product shapes)
        assert float((g - r[0]).abs().max()) <= KERNEL_TOL
    assert torch.equal(back, km.idwt1d_mxu_plain(*got, fb, 256))
    for g, r in zip(s, kms.swt1d_mxu_plain(x, fb, 2)):
        assert torch.equal(g, r)
    assert torch.equal(sback, kms.iswt1d_mxu_plain(*s, fb, 2))
    for g, r in zip(got_odd, fd.dwt1d_plain(odd, fb)):
        assert torch.equal(g, r)
    for g, r in zip(wide, fd.swt1d_plain(x[:, :16], fb, 3)):
        assert torch.equal(g, r)
    assert sum(k.launches for k in ops.KERNELS) == 0


@pytest.mark.parametrize("kernel", ["K7a", "K7b", "K12a", "K12b"])
def test_mxu_1d_route_takes_cuda_levels_before_the_tap_loops(monkeypatch,
                                                             kernel):
    """On a CUDA tensor (a CPU tensor posing as one) mode "mxu" sends a
    covered float32 level to the tensor-core wrapper, never to K3/K4/K10:
    without a card the wrapper's launch fails (no nvcc here), and the tap
    loops' counts stay 0."""
    fb = get_filter_bank("sym8")
    x = torch.from_numpy(_rand((4, 256)))
    c = x[:, :128].contiguous()
    calls = {"K7a": lambda: dwt.dwt1d(x, fb),
             "K7b": lambda: dwt.idwt1d(c, c, fb, 256),
             "K12a": lambda: swt.swt1d_level(x, fb, 2),
             "K12b": lambda: swt.iswt1d_level(x, x, fb, 2)}
    seen = []

    def launch(name):
        def fake(*args, **kw):
            seen.append(name)
            raise RuntimeError("no card")
        return fake

    for name in ("dwt1d_mxu_fused", "idwt1d_mxu_fused"):
        monkeypatch.setattr(km, name, launch(name))
    for name in ("swt1d_mxu_fused", "iswt1d_mxu_fused"):
        monkeypatch.setattr(kms, name, launch(name))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    ops.reset_counts()
    dwt.set_kernels("mxu")
    try:
        with pytest.raises(RuntimeError, match="no card"):
            calls[kernel]()
    finally:
        dwt.set_kernels("auto")
        monkeypatch.undo()
    assert seen == [{"K7a": "dwt1d_mxu_fused", "K7b": "idwt1d_mxu_fused",
                     "K12a": "swt1d_mxu_fused",
                     "K12b": "iswt1d_mxu_fused"}[kernel]]
    assert sum(k.launches for k in ops.KERNELS) == 0


def test_coverage_rules():
    fb = get_filter_bank("sym8")
    assert km.dwt1d_mxu_unsupported(torch.zeros(3, 130), fb) is None
    assert km.dwt1d_mxu_unsupported(torch.zeros(4096), fb) is None
    assert "even length" in km.dwt1d_mxu_unsupported(torch.zeros(3, 129), fb)
    assert "float64" in km.dwt1d_mxu_unsupported(
        torch.zeros(4, 64, dtype=torch.float64), fb)
    assert "rank" in km.dwt1d_mxu_unsupported(torch.zeros(2, 2, 64), fb)
    assert "filter length 2" in km.dwt1d_mxu_unsupported(
        torch.zeros(4, 64), get_filter_bank("haar"))
    assert "filter length 5" in km.dwt1d_mxu_unsupported(
        torch.zeros(4, 64), ODD)
    c = torch.zeros(4, 32)
    assert km.idwt1d_mxu_unsupported(c, c, fb, 64) is None
    assert "twice" in km.idwt1d_mxu_unsupported(c, c, fb, 63)
    assert "different shapes" in km.idwt1d_mxu_unsupported(
        c, torch.zeros(4, 31), fb, 64)
    x = torch.zeros(2, 64)
    assert kms.swt1d_mxu_unsupported(x, fb, 3) is None
    assert "wider than the row" in kms.swt1d_mxu_unsupported(x, fb, 5)
    assert kms.swt1d_mxu_unsupported(x, ODD, 4) is None
    assert "level 0" in kms.swt1d_mxu_unsupported(x, fb, 0)
    assert "float64" in kms.swt1d_mxu_unsupported(x.double(), fb, 1)
    assert kms.iswt1d_mxu_unsupported(x, x, fb, 3) is None
    assert "wider than the row" in kms.iswt1d_mxu_unsupported(x, x, fb, 5)
    assert "shapes" in kms.iswt1d_mxu_unsupported(x, torch.zeros(2, 63),
                                                  fb, 1)
