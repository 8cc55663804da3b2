"""The port's non-separable 2D transforms against the JAX package on the
CPU.

``Filters2D.from_bank``/``separable_bank`` array for array (the factored
bank bit-identical); the plain non-separable levels against JAX's jnp path
(its slice form up to 12 taps, its ``lax.conv`` form above: db8 x sym8),
odd sizes, odd filter sizes and stacks included; K16/K17's and
K18a/K18b's plain versions against the JAX Pallas
``nonsep_pallas.nsdwt2d_fused``/``insdwt2d_fused`` and
``ns_swt2d_fused``/``ins_swt2d_fused`` (interpret mode on the CPU) where
those cover the level; max-abs 2e-5 on [0, 1) float32 data.  The drivers
route a bank that factors to the separable path; the level functions route
every bank to K16/K17 and K18a/K18b on a CUDA tensor, and raise on a level
those do not cover (float64).  The kernels themselves run in
tests/test_torch_kernels_cuda.py, which imports no JAX.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pypwt_tpu.core import dwt as jdwt
from pypwt_tpu.core import nonsep as jns
from pypwt_tpu.filters import get_filter_bank as jbank
from pypwt_tpu.ops import nonsep_pallas as nsp
from pypwt_tpu_torch import ops
from pypwt_tpu_torch.core import dwt, nonsep, swt
from pypwt_tpu_torch.filters import get_filter_bank
from pypwt_tpu_torch.ops import fused_dwt as fd
from pypwt_tpu_torch.ops import nonsep as kn

torch.set_num_threads(1)

KERNEL_TOL = 2e-5
COEFF_TOL = 3e-4
ROUNDTRIP_TOL = 7e-4
PARTS = (("lo", "lo"), ("hi", "lo"), ("lo", "hi"), ("hi", "hi"))


def _cross(rows, cols):
    """The anisotropic bank rows(axis -2) x cols(last axis): four outer
    products of two different 1D banks (tests/test_nonsep.py:146-152)."""
    fr, fc = jbank(rows), jbank(cols)
    dec = [np.outer(getattr(fr, "dec_" + p), getattr(fc, "dec_" + q))
           for p, q in PARTS]
    rec = [np.outer(getattr(fr, "rec_" + p), getattr(fc, "rec_" + q))
           for p, q in PARTS]
    return dec, rec


def _rank2():
    """The rank-2 mix of tests/test_nonsep.py:197-204 (synthesis = dec)."""
    f = jbank("db2")
    lo, hi = np.asarray(f.dec_lo), np.asarray(f.dec_hi)
    dec = [0.8 * np.outer(lo, lo) + 0.2 * np.outer(hi, hi),
           0.8 * np.outer(hi, lo) + 0.2 * np.outer(lo, hi),
           0.8 * np.outer(lo, hi) + 0.2 * np.outer(hi, lo),
           0.8 * np.outer(hi, hi) + 0.2 * np.outer(lo, lo)]
    return dec, dec


def _dense(n, seed=5):
    rng = np.random.default_rng(seed)
    return list(rng.standard_normal((4, n, n)) / n), \
        list(rng.standard_normal((4, n, n)) / n)


BANKS_2D = {"db3xcoif1": lambda: _cross("db3", "coif1"),
            "rank2mix": _rank2,
            "db8xsym8": lambda: _cross("db8", "sym8"),
            "dense5": lambda: _dense(5)}


def _pair(name):
    dec, rec = BANKS_2D[name]()
    return (jns.Filters2D(dec, rec, name=name),
            nonsep.Filters2D(dec, rec, name=name))


def _rand(shape, seed=42):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _err(got, ref):
    return float(np.abs(got.numpy() - np.asarray(ref)).max())


def _jnp(fn, *args):
    jdwt.set_kernels("jnp")
    try:
        return fn(*args)
    finally:
        jdwt.set_kernels("auto")


@pytest.mark.parametrize("wname", ["haar", "db2", "db8", "sym20", "bior3.5",
                                   "coif5", "rbio2.4"])
def test_from_bank_and_separable_bank_match_jax(wname):
    jf = jns.Filters2D.from_bank(jbank(wname))
    tf = nonsep.Filters2D.from_bank(get_filter_bank(wname))
    assert (tf.name, tf.hlen) == (jf.name, jf.hlen)
    for a, b in zip(tf.dec + tf.rec, jf.dec + jf.rec):
        np.testing.assert_array_equal(a, b)
    jsb, tsb = jf.separable_bank(), tf.separable_bank()
    assert tsb is not None and tsb.name == jsb.name
    for f in ("dec_lo", "dec_hi", "rec_lo", "rec_hi"):
        np.testing.assert_array_equal(getattr(tsb, f), getattr(jsb, f))
    assert tf.separable_bank() is tsb  # cached


@pytest.mark.parametrize("name", ["db3xcoif1", "rank2mix", "dense5"])
def test_non_factorable_banks_have_no_separable_bank(name):
    jf, tf = _pair(name)
    assert tf.separable_bank() is None and jf.separable_bank() is None


def test_filters2d_refusals_and_from_numpy():
    with pytest.raises(ValueError, match="square"):
        nonsep.Filters2D([np.ones((4, 4))] * 3 + [np.ones((4, 5))],
                         [np.ones((4, 4))] * 4)
    jf, _ = _pair("db3xcoif1")
    tf = nonsep.filters2d_from_numpy(jf.name, jf.dec, jf.rec)
    assert (tf.name, tf.hlen) == ("db3xcoif1", 6)
    for a, b in zip(tf.dec + tf.rec, jf.dec + jf.rec):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["db3xcoif1", "db8xsym8", "dense5"])
@pytest.mark.parametrize("shape", [(32, 48), (31, 33), (2, 16, 24)],
                         ids=str)
def test_nsdwt_levels_match_jax(name, shape):
    jf, tf = _pair(name)
    x = _rand(shape)
    ref = _jnp(jns.nsdwt2d, jnp.asarray(x), jf)
    got = nonsep.nsdwt2d(torch.from_numpy(x), tf)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and _err(g, r) <= KERNEL_TOL
    c = [_rand(got[0].shape, s) for s in range(4)]
    ref = _jnp(jns.insdwt2d, *(jnp.asarray(s) for s in c), jf, shape)
    out = nonsep.insdwt2d(*(torch.from_numpy(s) for s in c), tf, shape)
    assert out.shape == shape and _err(out, ref) <= KERNEL_TOL


@pytest.mark.parametrize("name", ["db3xcoif1", "db8xsym8", "dense5"])
@pytest.mark.parametrize("shape", [(32, 48), (31, 33), (2, 16, 24)],
                         ids=str)
def test_ns_swt_levels_match_jax(name, shape):
    jf, tf = _pair(name)
    for level in (1, 2, 3):
        x = _rand(shape, level)
        ref = _jnp(jns.ns_swt2d_level, jnp.asarray(x), jf, level)
        got = nonsep.ns_swt2d_level(torch.from_numpy(x), tf, level)
        for g, r in zip(got, ref):
            assert g.shape == r.shape and _err(g, r) <= KERNEL_TOL, level
        c = [_rand(shape, 10 * level + s) for s in range(4)]
        ref = _jnp(jns.ins_swt2d_level, *(jnp.asarray(s) for s in c), jf,
                   level)
        out = nonsep.ins_swt2d_level(*(torch.from_numpy(s) for s in c), tf,
                                     level)
        assert out.shape == shape and _err(out, ref) <= KERNEL_TOL, level


def _dense8():
    """The dense random 8 x 8 bank of chip_smoke.banks_2d."""
    rng = np.random.default_rng(1234)
    return list(rng.random((4, 8, 8)) / 8), list(rng.random((4, 8, 8)) / 8)


BANKS_2D["dense8"] = _dense8


@pytest.mark.parametrize("name", ["db3xcoif1", "rank2mix", "dense8"])
@pytest.mark.parametrize("shape", [(64, 128), (2, 32, 64)], ids=str)
def test_k16_k17_plain_match_pallas(name, shape):
    jf, tf = _pair(name)
    x = _rand(shape, 31)
    ref = nsp.nsdwt2d_fused(jnp.asarray(x), jf)
    assert ref is not None
    got = kn.nsdwt2d_plain(torch.from_numpy(x), tf)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and _err(g, r) <= KERNEL_TOL
    half = (*shape[:-2], shape[-2] // 2, shape[-1] // 2)
    c = [_rand(half, 40 + s) for s in range(4)]
    ref = nsp.insdwt2d_fused(*(jnp.asarray(s) for s in c), jf, shape)
    assert ref is not None
    got = kn.insdwt2d_plain(*(torch.from_numpy(s) for s in c), tf, shape)
    assert got.shape == shape and _err(got, ref) <= KERNEL_TOL


@pytest.mark.parametrize("name", ["dense5", "dense8", "rank2mix"])
@pytest.mark.parametrize("shape", [(33, 47), (1, 7), (2, 15, 16)], ids=str)
def test_k16_k17_plain_odd_levels_match_jax(name, shape):
    """Odd planes and an odd filter size, which the Pallas kernels
    decline, against JAX's jnp path."""
    jf, tf = _pair(name)
    x = _rand(shape, 32)
    ref = _jnp(jns.nsdwt2d, jnp.asarray(x), jf)
    got = kn.nsdwt2d_plain(torch.from_numpy(x), tf)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and _err(g, r) <= KERNEL_TOL
    c = [_rand(got[0].shape, 50 + s) for s in range(4)]
    ref = _jnp(jns.insdwt2d, *(jnp.asarray(s) for s in c), jf, shape)
    out = kn.insdwt2d_plain(*(torch.from_numpy(s) for s in c), tf, shape)
    assert out.shape == shape and _err(out, ref) <= KERNEL_TOL


def test_k16_k17_coverage_rules():
    _, tf = _pair("db3xcoif1")
    x = torch.zeros(33, 47)
    assert kn.nsdwt2d_unsupported(x, tf) is None
    assert kn.nsdwt2d_unsupported(torch.zeros(70000, 1, 2), tf) is None
    c = [torch.zeros(17, 24) for _ in range(4)]
    assert kn.insdwt2d_unsupported(*c, tf, (33, 47)) is None
    assert kn.insdwt2d_unsupported(*c, tf, (34, 48)) is None
    _, odd = _pair("dense5")
    assert kn.nsdwt2d_unsupported(x, odd) is None
    assert kn.insdwt2d_unsupported(*c, odd, (33, 47)) is None
    assert kn.nsdwt2d_unsupported(x.double(), tf) is None
    assert "float32" in kn.nsdwt2d_unsupported(x.half(), tf)
    assert "rank" in kn.nsdwt2d_unsupported(torch.zeros(4), tf)
    assert "empty" in kn.nsdwt2d_unsupported(torch.zeros(0, 4), tf)
    assert "shapes" in kn.insdwt2d_unsupported(*c[:3], torch.zeros(17, 23),
                                               tf, (33, 47))
    wide = nonsep.Filters2D([np.ones((41, 41))] * 4, [np.ones((41, 41))] * 4)
    assert "filter size" in kn.nsdwt2d_unsupported(x, wide)


def test_cuda_mode_raises_on_cpu_tensor():
    """Kernel mode "cuda" on a CPU tensor raises for the non-separable DWT
    levels, which have their kernels now (they raised NotImplementedError
    on a CUDA tensor before K16/K17 were ported)."""
    _, tf = _pair("db3xcoif1")
    x = torch.from_numpy(_rand((16, 24)))
    dwt.set_kernels("cuda")
    try:
        with pytest.raises(ValueError, match="CUDA tensors only"):
            nonsep.nsdwt2d(x, tf)
        with pytest.raises(ValueError, match="CUDA tensors only"):
            nonsep.insdwt2d(x, x, x, x, tf, (32, 48))
    finally:
        dwt.set_kernels("auto")


@pytest.mark.parametrize("name", ["db3xcoif1", "rank2mix"])
@pytest.mark.parametrize("level", [1, 2])
def test_k18_plain_matches_pallas(name, level):
    jf, tf = _pair(name)
    x = _rand((64, 128), 21)
    ref = nsp.ns_swt2d_fused(jnp.asarray(x), jf, level)
    assert ref is not None
    got = kn.ns_swt2d_plain(torch.from_numpy(x), tf, level)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and _err(g, r) <= KERNEL_TOL
    c = [_rand((64, 128), s) for s in range(4)]
    ref = nsp.ins_swt2d_fused(*(jnp.asarray(s) for s in c), jf, level)
    assert ref is not None
    got = kn.ins_swt2d_plain(*(torch.from_numpy(s) for s in c), tf, level)
    assert _err(got, ref) <= KERNEL_TOL


def _assert_pyramid(got, ref, levels):
    assert len(got) == len(ref) == levels + 1
    assert _err(got[0], ref[0]) <= COEFF_TOL * 2 ** levels
    for lev in range(1, levels + 1):
        for g, r in zip(got[lev], ref[lev]):
            assert g.shape == r.shape and _err(g, r) <= COEFF_TOL * 2 ** lev


@pytest.mark.parametrize("swt_mode", [0, 1], ids=["dwt", "swt"])
@pytest.mark.parametrize("name", ["db3xcoif1", "db8xsym8"])
def test_drivers_match_jax(name, swt_mode):
    jf, tf = _pair(name)
    x = (_rand((40, 48), 3) * 255).astype(np.float32)
    fwd, inv = ((nonsep.ns_swt2d, nonsep.ins_swt2d) if swt_mode
                else (nonsep.ns_wavedec2, nonsep.ns_waverec2))
    jfwd, jinv = ((jns.ns_swt2d, jns.ins_swt2d) if swt_mode
                  else (jns.ns_wavedec2, jns.ns_waverec2))
    extra = () if swt_mode else (x.shape,)
    got = fwd(torch.from_numpy(x), tf, 2)
    _assert_pyramid(got, jfwd(jnp.asarray(x), jf, 2), 2)
    rec = inv(got, tf, *extra)
    jrec = jinv(dwt.pyramid_to_numpy(got), jf, *extra)
    assert rec.shape == x.shape and _err(rec, jrec) <= ROUNDTRIP_TOL
    assert np.abs(rec.numpy() - x).max() < ROUNDTRIP_TOL  # a PR bank


@pytest.mark.parametrize("wname", ["db2", "sym8"])
def test_drivers_route_a_factorable_bank_to_the_separable_path(wname):
    fb = get_filter_bank(wname)
    tf = nonsep.Filters2D.from_bank(fb)
    sb = tf.separable_bank()
    x = torch.from_numpy(_rand((32, 40)))
    ops.reset_counts()
    for got, ref in ((nonsep.ns_swt2d(x, tf, 2), swt.swt2d(x, sb, 2)),
                     (nonsep.ns_wavedec2(x, tf, 2), dwt.wavedec2(x, sb, 2))):
        assert torch.equal(got[0], ref[0])
        for c, rc in zip(got[1:], ref[1:]):
            assert all(torch.equal(g, r) for g, r in zip(c, rc))
    pyr = swt.swt2d(x, sb, 2)
    assert torch.equal(nonsep.ins_swt2d(pyr, tf), swt.iswt2d(pyr, sb))
    pyr = dwt.wavedec2(x, sb, 2)
    assert torch.equal(nonsep.ns_waverec2(pyr, tf, x.shape),
                       dwt.waverec2(pyr, sb, x.shape))
    # and the factored path agrees with the true 2D levels
    a, h, v, d = nonsep.nsdwt2d(x, tf)
    for g, r in zip((a, h, v, d), dwt.dwt2d(x, sb)):
        assert float((g - r).abs().max()) <= KERNEL_TOL


def test_auto_on_cpu_takes_plain_and_counts_nothing():
    _, tf = _pair("db3xcoif1")
    x = torch.from_numpy(_rand((16, 24)))
    ops.reset_counts()
    got = nonsep.ns_swt2d_level(x, tf, 2)
    for g, w in zip(got, kn.ns_swt2d_fused(x, tf, 2)):
        assert torch.equal(g, w)
    assert torch.equal(nonsep.ins_swt2d_level(*got, tf, 2),
                       kn.ins_swt2d_fused(*got, tf, 2))
    for k in kn.KERNELS:
        assert k.launches == 0


def test_k18_coverage_rules():
    _, tf = _pair("db3xcoif1")
    x = torch.zeros(33, 47)
    for level in (1, 7, 30):
        assert kn.ns_swt2d_unsupported(x, tf, level) is None
        assert kn.ins_swt2d_unsupported(x, x, x, x, tf, level) is None
    _, odd = _pair("dense5")
    assert kn.ins_swt2d_unsupported(x, x, x, x, odd, 2) is None
    assert kn.ns_swt2d_unsupported(torch.zeros(2, 8, 8), tf, 1) is None
    assert "level" in kn.ns_swt2d_unsupported(x, tf, 0)
    assert kn.ns_swt2d_unsupported(x.double(), tf, 1) is None
    assert "float32" in kn.ns_swt2d_unsupported(x.half(), tf, 1)
    assert "rank" in kn.ns_swt2d_unsupported(torch.zeros(4), tf, 1)
    assert "shapes" in kn.ins_swt2d_unsupported(x, x, torch.zeros(3, 3), x,
                                                tf, 1)
    wide = nonsep.Filters2D([np.ones((41, 41))] * 4, [np.ones((41, 41))] * 4)
    assert "filter size" in kn.ns_swt2d_unsupported(x, wide, 1)
    # a level past the grid's limits goes in chunks: no limit on rows or
    # batch
    assert kn.ns_swt2d_unsupported(torch.zeros(600000, 1), tf, 1) is None
    y = torch.zeros(70000, 2, 1)
    assert kn.ins_swt2d_unsupported(y, y, y, y, tf, 3) is None
    assert "empty" in kn.ns_swt2d_unsupported(torch.zeros(4, 0), tf, 1)


@pytest.mark.parametrize("direction", ["analysis", "synthesis",
                                       "dwt-analysis", "dwt-synthesis"])
def test_k18_route_raises_on_uncovered_cuda_level(monkeypatch, direction):
    """K18a/K18b and K16/K17 never decline: a level they do not cover on a
    CUDA tensor (float16: their instances are float32 and float64) raises,
    and kernel mode "torch" runs the plain version.  A CPU tensor poses as
    a CUDA one, so that the routing runs without a card."""
    _, tf = _pair("db3xcoif1")
    x = torch.from_numpy(_rand((16, 24))).half()
    calls = {
        "analysis": lambda: nonsep.ns_swt2d_level(x, tf, 2),
        "synthesis": lambda: nonsep.ins_swt2d_level(x, x, x, x, tf, 2),
        "dwt-analysis": lambda: nonsep.nsdwt2d(x, tf),
        "dwt-synthesis": lambda: nonsep.insdwt2d(x, x, x, x, tf, (31, 48)),
    }
    call = calls[direction]
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


# K18b's tiles hold output rows of one residue class mod the dilation f
# and stage column windows kTC + (hlen - 1) (f mod Nc) samples wide. The
# geometries where that tiling is hard: a dilation at or past Nr (every row
# its own class), odd planes, a width that is not a multiple of four
# samples (no 16-byte copies), an odd hlen (the other synthesis centre),
# and a column window wider than the plane (taps wrapping more than once).
K18B_GEOMETRIES = [((16, 64), 5), ((16, 64), 6), ((33, 47), 2),
                   ((31, 17), 3), ((40, 70), 1), ((2, 20, 9), 4),
                   ((6, 5), 3)]


@pytest.mark.parametrize("name", ["db3xcoif1", "dense5", "dense8"])
@pytest.mark.parametrize("shape, level", K18B_GEOMETRIES, ids=str)
def test_k18b_plain_matches_jax_at_hard_geometries(name, shape, level):
    """K18b's plain version against JAX's jnp level, and against the JAX
    Pallas kernel in interpret mode where that covers the level (an even
    hlen, its dilated pads within the plane, row bands that divide it)."""
    jf, tf = _pair(name)
    c = [_rand(shape, 7 * level + s) for s in range(4)]
    got = kn.ins_swt2d_plain(*(torch.from_numpy(s) for s in c), tf, level)
    ref = _jnp(jns.ins_swt2d_level, *(jnp.asarray(s) for s in c), jf, level)
    assert got.shape == shape and _err(got, ref) <= KERNEL_TOL
    if tf.hlen % 2 == 0:
        fused = nsp.ins_swt2d_fused(*(jnp.asarray(s) for s in c), jf, level)
        if fused is not None:
            assert _err(got, fused) <= KERNEL_TOL


@pytest.mark.parametrize("name", ["db3xcoif1", "dense5", "dense8"])
@pytest.mark.parametrize("shape, level", K18B_GEOMETRIES, ids=str)
def test_k18a_plain_matches_jax_at_hard_geometries(name, shape, level):
    """K18a's plain version against JAX's jnp level, and against the JAX
    Pallas kernel in interpret mode where that covers the level (an even
    hlen, its dilated pads within the plane, row bands that divide it), on
    K18b's geometries: K18a runs the same tiling, with the analysis centre
    hlen/2."""
    jf, tf = _pair(name)
    x = _rand(shape, 7 * level + 5)
    got = kn.ns_swt2d_plain(torch.from_numpy(x), tf, level)
    ref = _jnp(jns.ns_swt2d_level, jnp.asarray(x), jf, level)
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert g.shape == shape and _err(g, r) <= KERNEL_TOL
    if tf.hlen % 2 == 0:
        fused = nsp.ns_swt2d_fused(jnp.asarray(x), jf, level)
        if fused is not None:
            for g, r in zip(got, fused):
                assert _err(g, r) <= KERNEL_TOL
