"""The port's conv primitives against pypwt_tpu.core.conv and the float64
scalar oracle (tests/oracle.py), float32 inputs on [0, 1), max-abs 2e-5:
odd lengths (virtual extension) and pads wider than the signal included."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import oracle
from pypwt_tpu.core import conv as jconv
from pypwt_tpu.filters import get_filter_bank
from pypwt_tpu_torch.core import conv as tconv
from pypwt_tpu_torch.core.shapes import div2

torch.set_num_threads(1)

TOL = 2e-5
WAVELETS = ["haar", "db2", "db8", "sym5", "bior3.5", "sym20"]
# n=4 with db8 (pads 7/8) and sym20 (pads 19/20): pads >= N
LENGTHS = [4, 7, 16, 33]


def _rand(shape, seed=0):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


@pytest.mark.parametrize("wname", WAVELETS)
@pytest.mark.parametrize("n", LENGTHS)
def test_analysis_last(wname, n):
    fb = get_filter_bank(wname)
    x = _rand((3, n))
    lo, hi = tconv.analysis_last(torch.from_numpy(x), fb.dec_lo, fb.dec_hi)
    jlo, jhi = jconv.analysis_last(jnp.asarray(x), fb.dec_lo, fb.dec_hi)
    assert lo.dtype == torch.float32 and lo.shape == (3, div2(n))
    assert np.abs(lo.numpy() - np.asarray(jlo)).max() <= TOL
    assert np.abs(hi.numpy() - np.asarray(jhi)).max() <= TOL
    for r in range(3):
        assert np.abs(lo[r].numpy()
                      - oracle.ref_analysis_1d(x[r], fb.dec_lo)).max() <= TOL
        assert np.abs(hi[r].numpy()
                      - oracle.ref_analysis_1d(x[r], fb.dec_hi)).max() <= TOL


@pytest.mark.parametrize("wname", WAVELETS)
@pytest.mark.parametrize("n_out", LENGTHS)
def test_synthesis_last(wname, n_out):
    fb = get_filter_bank(wname)
    L = div2(n_out)
    lo, hi = _rand((3, L), 1), _rand((3, L), 2)
    out = tconv.synthesis_last(torch.from_numpy(lo), torch.from_numpy(hi),
                               fb.rec_lo, fb.rec_hi, n_out)
    ref = jconv.synthesis_last(jnp.asarray(lo), jnp.asarray(hi), fb.rec_lo,
                               fb.rec_hi, n_out)
    assert out.shape == (3, n_out)
    assert np.abs(out.numpy() - np.asarray(ref)).max() <= TOL
    if n_out % 2 == 0:
        for r in range(3):
            o = oracle.ref_synthesis_1d(lo[r], hi[r], fb.rec_lo, fb.rec_hi,
                                        n_out)
            assert np.abs(out[r].numpy() - o).max() <= TOL


@pytest.mark.parametrize("n, lpad, rpad", [(4, 9, 11), (5, 2, 3), (3, 0, 7),
                                           (6, 0, 0)])
def test_periodic_pad_last(n, lpad, rpad):
    x = _rand((2, n))
    got = tconv.periodic_pad_last(torch.from_numpy(x), lpad, rpad)
    ref = jconv.periodic_pad_last(jnp.asarray(x), lpad, rpad)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_odd_extend_last():
    x = _rand((2, 5))
    got = tconv._odd_extend_last(torch.from_numpy(x))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jconv._odd_extend_last(jnp.asarray(x))))


@pytest.mark.parametrize("hlen", range(2, 42, 2))
def test_pads_match(hlen):
    assert tconv.analysis_pads(hlen) == jconv.analysis_pads(hlen)
    for L, n_out in [(1, 2), (2, 3), (8, 16), (50, 100), (51, 101)]:
        assert (tconv.synthesis_pads(hlen, L, n_out)
                == jconv.synthesis_pads(hlen, L, n_out))


def test_taps_round_like_jax():
    fb = get_filter_bank("sym20")
    t32 = tconv._as_taps(fb.dec_lo, torch.float32)
    j32 = jconv._as_taps(fb.dec_lo, np.float32)
    assert [np.float32(v) for v in t32] == [np.float32(v) for v in j32]
    assert tconv._as_taps(fb.dec_lo, torch.float64) == list(fb.dec_lo)
