"""K19/K20's plain versions (``ops.shifted``) against the JAX package's
shifted Pallas kernels (interpret mode on the CPU) and against roll +
``pypwt_tpu.core.dwt``: the statically shifted analysis with and without
its threshold epilogue, the unshifting synthesis with and without the
accumulator and scale, the phase-bit (phase-select) levels, shifts wider
than the plane or than a tile of the pair bodies, every column shift mod
4, odd axes beside even ones, rows of 130 samples and an odd plane.
Tolerance 3e-5 on standard-normal float32 data, the JAX package's own
(tests/test_shifted_kernels.py); the routing of the shifted levels on CPU
tensors."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pypwt_tpu.core import dwt as jdwt
from pypwt_tpu.filters import get_filter_bank as jbank
from pypwt_tpu.ops import pallas_dwt as pk
from pypwt_tpu_torch import ops
from pypwt_tpu_torch.core import dwt
from pypwt_tpu_torch.filters import get_filter_bank
from pypwt_tpu_torch.ops import shifted as ks

torch.set_num_threads(1)

TOL = 3e-5
# JAX's SHIFTS (test_shifted_kernels.py:28) and a row shift its kernels
# decline (beyond their halo)
SHIFTS = [(0, 0), (1, 1), (2, 3), (7, 5), (8, 8), (1, 127), (6, 77),
          (127, 1)]


def _f32(shape, seed=9):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _err(got, ref):
    return float(np.abs(got.numpy() - np.asarray(ref)).max())


def _jnp(fn, *args):
    jdwt.set_kernels("jnp")
    try:
        return fn(*args)
    finally:
        jdwt.set_kernels("auto")


def _soft(t, beta):
    return jnp.sign(t) * jnp.maximum(jnp.abs(t) - beta, 0)


def _hard(t, beta):
    return jnp.where(jnp.abs(t) > beta, t, jnp.zeros_like(t))


@pytest.mark.parametrize("shift", SHIFTS, ids=str)
@pytest.mark.parametrize("mode", [None, "soft", "hard"])
def test_k19_plain_matches_jax(shift, mode):
    """Against the Pallas kernel where it covers the shift, and against
    roll + the jnp level everywhere."""
    sr, sc = shift
    x = _f32((128, 128))
    beta = 0.7
    got = ks.dwt2d_shifted_plain(torch.from_numpy(x), get_filter_bank("db2"),
                                 sr, sc, mode, beta)
    a, h, v, d = _jnp(jdwt.dwt2d, jnp.roll(jnp.asarray(x), (sr, sc), (-2, -1)),
                      jbank("db2"))
    th = {None: lambda t, b: t, "soft": _soft, "hard": _hard}[mode]
    for g, r in zip(got, (a, th(h, beta), th(v, beta), th(d, beta))):
        assert g.shape == r.shape and _err(g, r) <= TOL
    ref = pk.dwt2d_fused_shifted(jnp.asarray(x), jbank("db2"), sr, sc,
                                 thresh_mode=mode, beta=beta)
    if shift == (127, 1):
        assert ref is None  # the TPU kernel's halo; K19 takes any shift
        return
    for g, r in zip(got, ref):
        assert _err(g, r) <= TOL


@pytest.mark.parametrize("shift", SHIFTS, ids=str)
@pytest.mark.parametrize("acc", [False, True], ids=["store", "acc"])
def test_k20_plain_matches_jax(shift, acc):
    sr, sc = shift
    c = [_f32((64, 64), s) for s in range(4)]
    fb, jfb = get_filter_bank("db4"), jbank("db4")
    accum = _f32((128, 128), 7) if acc else None
    scale = 0.25 if acc else 1.0
    got = ks.idwt2d_unshift_plain(
        *(torch.from_numpy(s) for s in c), fb, (128, 128), sr, sc,
        None if accum is None else torch.from_numpy(accum), scale)
    y = jnp.roll(_jnp(jdwt.idwt2d, *(jnp.asarray(s) for s in c), jfb,
                      (128, 128)), (-sr, -sc), (-2, -1))
    want = y if accum is None else (jnp.asarray(accum) + y) * scale
    assert got.shape == (128, 128) and _err(got, want) <= TOL
    ref = pk.idwt2d_fused_unshift(
        *(jnp.asarray(s) for s in c), jfb, (128, 128), sr, sc,
        acc=None if accum is None else jnp.asarray(accum), scale=scale)
    if ref is not None:
        assert _err(got, ref) <= TOL


def _k20_against_jax(shape, sr, sc, acc, wname):
    """K20's plain version on coefficients of a level of ``shape`` against
    roll + JAX's jnp level, and against JAX's Pallas kernel (interpret
    mode) where it covers the shift and the plane."""
    half = ((shape[0] + 1) // 2, (shape[1] + 1) // 2)
    c = [_f32(half, 30 + s) for s in range(4)]
    fb, jfb = get_filter_bank(wname), jbank(wname)
    accum = _f32(shape, 40) if acc else None
    scale = 0.25 if acc else 1.0
    got = ks.idwt2d_unshift_plain(
        *(torch.from_numpy(s) for s in c), fb, shape, sr, sc,
        None if accum is None else torch.from_numpy(accum), scale)
    y = jnp.roll(_jnp(jdwt.idwt2d, *(jnp.asarray(s) for s in c), jfb,
                      shape), (-sr, -sc), (-2, -1))
    want = y if accum is None else (jnp.asarray(accum) + y) * scale
    assert got.shape == shape and _err(got, want) <= TOL
    ref = pk.idwt2d_fused_unshift(
        *(jnp.asarray(s) for s in c), jfb, shape, sr, sc,
        acc=None if accum is None else jnp.asarray(accum), scale=scale)
    if ref is not None:
        assert _err(got, ref) <= TOL


# shifts wider than one 16 x 64-coefficient tile of K20's pair body (32 x
# 128 outputs), on a plane of 3 x 3 such tiles; the last two past it
WIDE_SHIFTS = [(70, 131), (33, 257), (95, 383), (101, 400)]


@pytest.mark.parametrize("shift", WIDE_SHIFTS, ids=str)
@pytest.mark.parametrize("acc", [False, True], ids=["store", "acc"])
def test_k20_plain_matches_jax_at_shifts_wider_than_a_tile(shift, acc):
    _k20_against_jax((96, 384), *shift, acc, "db4")


@pytest.mark.parametrize("shape, shift", [((65, 128), (0, 3)),
                                          ((65, 128), (0, 131)),
                                          ((64, 129), (70, 0))], ids=str)
@pytest.mark.parametrize("wname", ["db2", "sym4"])
def test_k20_plain_matches_jax_on_an_odd_unshifted_axis(shape, shift,
                                                         wname):
    """An axis of odd length that is not shifted, beside a shifted even
    one: the pair body's crop on the card."""
    _k20_against_jax(shape, *shift, True, wname)


def _k19_against_jax(shape, sr, sc, mode, wname):
    """K19's plain version on a plane of ``shape`` against roll + JAX's jnp
    level and threshold, and against JAX's Pallas kernel (interpret mode)
    where it covers the shift and the plane."""
    x = _f32(shape, 50)
    fb, jfb = get_filter_bank(wname), jbank(wname)
    beta = 0.7
    got = ks.dwt2d_shifted_plain(torch.from_numpy(x), fb, sr, sc, mode, beta)
    a, h, v, d = _jnp(jdwt.dwt2d, jnp.roll(jnp.asarray(x), (sr, sc),
                                           (-2, -1)), jfb)
    th = {None: lambda t, b: t, "soft": _soft, "hard": _hard}[mode]
    half = ((shape[0] + 1) // 2, (shape[1] + 1) // 2)
    for g, r in zip(got, (a, th(h, beta), th(v, beta), th(d, beta))):
        assert g.shape == half and _err(g, r) <= TOL
    ref = pk.dwt2d_fused_shifted(jnp.asarray(x), jfb, sr, sc,
                                 thresh_mode=mode, beta=beta)
    if ref is not None:
        for g, r in zip(got, ref):
            assert _err(g, r) <= TOL


@pytest.mark.parametrize("shift", WIDE_SHIFTS, ids=str)
@pytest.mark.parametrize("mode", [None, "soft", "hard"])
def test_k19_plain_matches_jax_at_shifts_wider_than_a_tile(shift, mode):
    """Shifts wider than one 16 x 64-output tile of K19's pair body (32 x
    128 input samples), on a plane of 3 x 3 such tiles."""
    _k19_against_jax((96, 384), *shift, mode, "db4")


# every column shift mod 4 (the pair body's four read shifts on rows of a
# multiple of 4 samples) beside both parities of the row shift
PHASE_SHIFTS = [(sr, sc) for sr in (2, 5) for sc in (4, 5, 6, 7)]


@pytest.mark.parametrize("shift", PHASE_SHIFTS, ids=str)
@pytest.mark.parametrize("wname", ["db2", "sym4"])
def test_k19_plain_matches_jax_at_every_column_phase(shift, wname):
    _k19_against_jax((64, 128), *shift, "soft", wname)


@pytest.mark.parametrize("shape, shift", [((65, 128), (3, 0)),
                                          ((65, 128), (0, 6)),
                                          ((64, 129), (0, 5)),
                                          ((64, 129), (70, 0))], ids=str)
@pytest.mark.parametrize("wname", ["db2", "sym4"])
def test_k19_plain_matches_jax_beside_an_odd_axis(shape, shift, wname):
    """A shifted odd axis beside an unshifted even one, and an unshifted
    odd axis beside a shifted even one: the odd extension after the roll."""
    _k19_against_jax(shape, *shift, "hard", wname)


@pytest.mark.parametrize("shift", [(1, 1), (0, 3), (5, 129)], ids=str)
@pytest.mark.parametrize("mode", [None, "soft", "hard"])
def test_k19_plain_matches_jax_on_rows_of_130(shift, mode):
    """Rows of 130 samples, not a multiple of 4: the pair body's sample
    copies on the card."""
    _k19_against_jax((66, 130), *shift, mode, "sym4")


@pytest.mark.parametrize("idx", [0, 1, 2, 3])
def test_phase_bits_match_phase_switch(idx):
    """A phase-select level is K19/K20 shifted by its phase bits."""
    pr, pc = idx // 2, idx % 2
    x = _f32((128, 128), 3)
    fb, jfb = get_filter_bank("db2"), jbank("db2")
    ref = pk.dwt2d_fused_phase_switch(jnp.asarray(x), jfb, jnp.int32(idx),
                                      thresh_mode="soft", beta=0.5)
    got = ks.dwt2d_shifted_plain(torch.from_numpy(x), fb, pr, pc, "soft",
                                 0.5)
    for g, r in zip(got, ref):
        assert _err(g, r) <= TOL
    c = [_f32((64, 64), 10 + s) for s in range(4)]
    acc = _f32((128, 128), 20)
    ref = pk.idwt2d_fused_phase_switch(
        *(jnp.asarray(s) for s in c), jfb, (128, 128), jnp.int32(idx),
        acc=jnp.asarray(acc), scale=0.5)
    got = ks.idwt2d_unshift_plain(*(torch.from_numpy(s) for s in c), fb,
                                  (128, 128), pr, pc, torch.from_numpy(acc),
                                  0.5)
    assert _err(got, ref) <= TOL


@pytest.mark.parametrize("wname", ["db2", "sym4", "haar"])
@pytest.mark.parametrize("shift", [(3, 4), (64, 46), (130, 1)], ids=str)
def test_odd_plane_matches_roll(wname, shift):
    """65 x 47: an odd plane, which the TPU kernels decline, against roll +
    the jnp level (odd extension after the roll), and a roundtrip."""
    sr, sc = shift
    x = _f32((65, 47), 4)
    fb, jfb = get_filter_bank(wname), jbank(wname)
    got = ks.dwt2d_shifted_plain(torch.from_numpy(x), fb, sr, sc, "soft",
                                 0.2)
    a, h, v, d = _jnp(jdwt.dwt2d, jnp.roll(jnp.asarray(x), (sr, sc),
                                           (-2, -1)), jfb)
    for g, r in zip(got, (a, _soft(h, 0.2), _soft(v, 0.2), _soft(d, 0.2))):
        assert g.shape == (33, 24) and _err(g, r) <= TOL
    c = ks.dwt2d_shifted_plain(torch.from_numpy(x), fb, sr, sc)
    back = ks.idwt2d_unshift_plain(*c, fb, x.shape, sr, sc)
    assert _err(back, x) <= 1e-4


def test_shifted_routes_on_cpu_take_plain_and_count_nothing():
    fb = get_filter_bank("db2")
    x = torch.from_numpy(_f32((32, 48)))
    ops.reset_counts()
    got = dwt.dwt2d_shifted(x, fb, 3, 5, "hard", 0.4)
    for g, w in zip(got, ks.dwt2d_shifted_fused(x, fb, 3, 5, "hard", 0.4)):
        assert torch.equal(g, w)
    acc = torch.ones(32, 48)
    assert torch.equal(dwt.idwt2d_unshift(*got, fb, x.shape, 3, 5, acc, 0.5),
                       ks.idwt2d_unshift_fused(*got, fb, x.shape, 3, 5, acc,
                                               0.5))
    assert sum(k.launches for k in ops.KERNELS) == 0


def test_k19_k20_coverage_rules():
    fb = get_filter_bank("db2")
    x = torch.zeros(65, 47)
    assert ks.dwt2d_shifted_unsupported(x, fb) is None
    assert ks.dwt2d_shifted_unsupported(torch.zeros(3, 8, 8), fb,
                                        "soft") is None
    assert "float32" in ks.dwt2d_shifted_unsupported(x.double(), fb)
    assert "threshold mode" in ks.dwt2d_shifted_unsupported(x, fb, "garrote")
    c = [torch.zeros(33, 24) for _ in range(4)]
    assert ks.idwt2d_unshift_unsupported(*c, fb, (65, 47)) is None
    assert ks.idwt2d_unshift_unsupported(*c, fb, (65, 47),
                                         torch.zeros(65, 47)) is None
    assert "accumulator" in ks.idwt2d_unshift_unsupported(
        *c, fb, (65, 47), torch.zeros(64, 47))
    assert "accumulator" in ks.idwt2d_unshift_unsupported(
        *c, fb, (65, 47), torch.zeros(65, 47, dtype=torch.float64))


@pytest.mark.parametrize("direction", ["analysis", "synthesis"])
def test_shifted_routes_raise_on_uncovered_cuda_level(monkeypatch,
                                                      direction):
    """K19/K20 never decline: a float64 level on a CUDA tensor raises, and
    kernel mode "torch" runs the plain version.  A CPU tensor poses as a
    CUDA one, so that the routing runs without a card."""
    fb = get_filter_bank("db2")
    x = torch.from_numpy(_f32((16, 24))).double()
    if direction == "analysis":
        def call():
            return dwt.dwt2d_shifted(x, fb, 1, 2, "soft", 0.1)
    else:
        def call():
            return dwt.idwt2d_unshift(x, x, x, x, fb, (32, 48), 1, 2)
    want = call()
    ops.reset_counts()
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    with pytest.raises(ValueError, match=r"float64.*set_kernels\('torch'\)"):
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
    assert sum(k.launches for k in ops.KERNELS) == 0
