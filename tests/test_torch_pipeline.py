"""The port's denoising pipelines (``pypwt_tpu_torch.pipeline``) against
``pypwt_tpu.pipeline`` on the CPU.

``denoise2d`` (DWT, SWT, a stack, haar) and ``denoise2d_cycle_spinning``:
static shifts (default, hard, normalize, threshold_appcoeffs, and haar on
the roll path) against the JAX package in both its kernel modes (its fused
Pallas spins in interpret mode, and its roll path), and random mode shift
for shift (the JAX shifts drawn from one key, fed to the port's random
spins).  Tolerance 3e-4 on 0..255 float32 images of 32^2 to 128^2: the
two packages' float32 transforms differ by rounding only, which reaches
1.5e-4 here (10 ulp of pixels in [128, 256), carried up from level-3
coefficients near 2000, whose ulp is 1.2e-4); the roundtrip envelope,
7e-4, is wider still.  Soft thresholding is continuous, so rounding stays
rounding; a hard threshold is not, so the hard cases use a beta that the
test first shows lies at least 1e-3 from every coefficient it
thresholds."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pypwt_tpu import pipeline as jpipe
from pypwt_tpu.core import dwt as jdwt
from pypwt_tpu_torch import ops, pipeline
from pypwt_tpu_torch.core import dwt
from pypwt_tpu_torch.core.shapes import clamp_levels
from pypwt_tpu_torch.filters import get_filter_bank

torch.set_num_threads(1)

TOL = 3e-4
MARGIN = 1e-3
SPINS = ((0, 0), (1, 1), (2, 2), (3, 3))


def _img(shape, seed=0):
    return (np.random.default_rng(seed).random(shape) * 255).astype(
        np.float32)


def _err(got, ref):
    return float(np.abs(got.numpy() - np.asarray(ref)).max())


def _jax_cs(mode, x, *args, **kw):
    """pypwt_tpu's cycle spinning in kernel mode ``mode`` ("pallas": the
    fused shifted spins, interpret mode on the CPU; "jnp": the roll
    path), with its jit cache cleared around the call so that the mode
    takes effect."""
    jpipe.denoise2d_cycle_spinning.clear_cache()
    jdwt.set_kernels(mode)
    try:
        return np.asarray(jpipe.denoise2d_cycle_spinning(
            jnp.asarray(x), *args, **kw))
    finally:
        jdwt.set_kernels("auto")
        jpipe.denoise2d_cycle_spinning.clear_cache()


def _thresholds(beta, levels, normalize):
    """Every threshold a (sub-)pyramid meets: the per-level detail
    thresholds and the approximation's, with and without normalize's
    1/sqrt(2) factors (the fused spins threshold their sub-pyramid at
    beta/sqrt(2))."""
    out = {beta, beta / math.sqrt(2)}
    if normalize:
        out |= {beta / math.sqrt(2) ** k for k in range(levels + 2)}
    return out


def _safe_beta(img, wname, levels, shifts, normalize, candidates):
    """The first beta of ``candidates`` that lies at least MARGIN from
    every coefficient of every spin's pyramid, at every threshold it
    meets; the search shows the margin, so a hard threshold decides each
    coefficient the same way in both packages."""
    fb = get_filter_bank(wname)
    levels = clamp_levels(levels, img.shape, fb.hlen, 2)
    values = []
    for sr, sc in shifts:
        pyr = dwt.wavedec2(torch.roll(torch.from_numpy(img), (sr, sc),
                                      (-2, -1)), fb, levels)
        values.append(pyr[0].abs().flatten())
        values += [s.abs().flatten() for c in pyr[1:] for s in c]
    mags = torch.cat(values).double()
    for beta in candidates:
        if all(float((mags - t).abs().min()) >= MARGIN
               for t in _thresholds(beta, levels, normalize)):
            return beta
    raise AssertionError("no candidate beta clears the margin")


@pytest.mark.parametrize("case", ["dwt", "swt", "stack", "haar"])
def test_denoise2d_matches_jax(case):
    shape = (3, 64, 64) if case == "stack" else (96, 128)
    x = _img(shape, 1)
    wname = "haar" if case == "haar" else "db3"
    kw = dict(do_swt=case == "swt")
    ref = jpipe.denoise2d(jnp.asarray(x), wname, 3, 12.0, **kw)
    got = pipeline.denoise2d(torch.from_numpy(x), wname, 3, 12.0, **kw)
    assert got.shape == x.shape and _err(got, ref) <= TOL


@pytest.mark.parametrize("opts", [{}, {"normalize": True},
                                  {"threshold_appcoeffs": True},
                                  {"threshold_appcoeffs": True,
                                   "normalize": True}], ids=str)
@pytest.mark.parametrize("jmode", ["pallas", "jnp"])
def test_static_cycle_spinning_matches_jax(opts, jmode):
    x = _img((64, 64), 2)
    ref = _jax_cs(jmode, x, "db2", 3, 10.0, shifts=SPINS, **opts)
    got = pipeline.denoise2d_cycle_spinning(torch.from_numpy(x), "db2", 3,
                                            10.0, shifts=SPINS, **opts)
    assert got.shape == x.shape and _err(got, ref) <= TOL


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("jmode", ["pallas", "jnp"])
def test_static_cycle_spinning_hard_matches_jax(normalize, jmode):
    x = _img((32, 32), 3)
    shifts = ((1, 2), (3, 0))
    beta = _safe_beta(x, "db3", 2, shifts, normalize,
                      np.arange(6.0, 9.0, 0.0625))
    ref = _jax_cs(jmode, x, "db3", 2, beta, shifts=shifts, hard=True,
                  normalize=normalize)
    got = pipeline.denoise2d_cycle_spinning(
        torch.from_numpy(x), "db3", 2, beta, shifts=shifts, hard=True,
        normalize=normalize)
    assert _err(got, ref) <= TOL


def test_static_cycle_spinning_haar_takes_the_roll_path():
    x = _img((64, 64), 4)
    ref = _jax_cs("pallas", x, "haar", 3, 10.0, shifts=SPINS)
    ops.reset_counts()
    got = pipeline.denoise2d_cycle_spinning(torch.from_numpy(x), "haar", 3,
                                            10.0, shifts=SPINS)
    assert _err(got, ref) <= TOL


def _jax_shifts(key, n_spins, nr, nc):
    """The shifts pypwt_tpu.pipeline draws from ``key`` (its
    pipeline.py:244-254), before the reduction mod 2^levels."""
    out = []
    for k in jax.random.split(key, n_spins):
        sr = jax.random.randint(k, (), 0, nr)
        sc = jax.random.randint(jax.random.fold_in(k, 1), (), 0, nc)
        out.append((int(sr), int(sc)))
    return out


@pytest.mark.parametrize("jmode", ["pallas", "jnp"])
@pytest.mark.parametrize("wname, levels", [("db2", 2), ("sym4", 3)])
def test_random_cycle_spinning_matches_jax_shift_for_shift(jmode, wname,
                                                           levels):
    x = _img((64, 64), 5)
    key = jax.random.key(42)
    ref = _jax_cs(jmode, x, wname, levels, 10.0, key=key, n_spins=3)
    shifts = _jax_shifts(key, 3, 64, 64)
    got = pipeline.random_spins(torch.from_numpy(x), wname, levels, 10.0,
                                shifts)
    assert _err(got, ref) <= TOL


def test_random_cycle_spinning_odd_plane_matches_jax_roll_path():
    """On a plane that 2^levels does not divide, the JAX package runs its
    roll path with the unreduced shifts; so does the port's K19/K20 spin
    with the whole shift."""
    x = _img((45, 38), 6)
    key = jax.random.key(3)
    ref = _jax_cs("pallas", x, "db2", 2, 10.0, key=key, n_spins=2)
    got = pipeline.random_spins(torch.from_numpy(x), "db2", 2, 10.0,
                                _jax_shifts(key, 2, 45, 38))
    assert _err(got, ref) <= TOL


def test_generator_is_reproducible_and_seeds_differ():
    x = torch.from_numpy(_img((64, 64), 7))

    def run(seed):
        return pipeline.denoise2d_cycle_spinning(
            x, "db2", 3, 10.0, generator=torch.Generator().manual_seed(seed),
            n_spins=3)
    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b)
    assert float((a - c).abs().max()) > 1e-3


def test_generator_draws_row_then_column_shifts():
    x = torch.from_numpy(_img((64, 48), 8))
    g = torch.Generator().manual_seed(11)
    got = pipeline.denoise2d_cycle_spinning(x, "db2", 2, 10.0, generator=g,
                                            n_spins=2)
    g = torch.Generator().manual_seed(11)
    shifts = [(int(torch.randint(0, 64, (), generator=g)),
               int(torch.randint(0, 48, (), generator=g))) for _ in range(2)]
    assert torch.equal(got, pipeline.random_spins(x, "db2", 2, 10.0, shifts))


def test_neither_generator_nor_shifts_raises():
    with pytest.raises(ValueError, match="random key or static shifts"):
        pipeline.denoise2d_cycle_spinning(torch.zeros(16, 16), "db2", 2, 1.0)


def test_cpu_pipeline_counts_no_launch_and_keeps_the_device():
    ops.reset_counts()
    out = pipeline.denoise2d_cycle_spinning(_img((32, 32)), "db2", 2, 5.0,
                                            shifts=SPINS, device="cpu")
    assert out.device.type == "cpu" and out.shape == (32, 32)
    assert sum(k.launches for k in ops.KERNELS) == 0
