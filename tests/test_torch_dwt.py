"""The port's multi-level 2D DWT against pypwt_tpu.core.dwt / core.haar on
0..255 float32 data: the same pyramid structure, coefficients within the
reference envelope 3e-4 * 2^level, and each side's coefficients inverted
by the other within 7e-4 (carried across with pyramid_from_numpy /
pyramid_to_numpy)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pypwt_tpu.core import dwt as jdwt
from pypwt_tpu.core import haar as jhaar
from pypwt_tpu.filters import get_filter_bank as jbank
from pypwt_tpu_torch.core import dwt, haar
from pypwt_tpu_torch.filters import get_filter_bank

torch.set_num_threads(1)

COEFF_TOL = 3e-4
ROUNDTRIP_TOL = 7e-4
CASES = [("db2", (128, 128), 3), ("db2", (100, 90), 3), ("haar", (128, 128), 3),
         ("haar", (100, 90), 3), ("sym8", (2, 64, 96), 2),
         ("bior3.5", (70, 64), 2)]


def _img(shape, seed=0):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.float32)


def _jax_pair(wname, levels):
    fb = jbank(wname)
    if fb.hlen == 2:
        return (lambda x: jhaar.haar_wavedec2(x, levels),
                lambda c, s: jhaar.haar_waverec2(c, s))
    return (lambda x: jdwt.wavedec2(x, fb, levels),
            lambda c, s: jdwt.waverec2(c, fb, s))


def _port_pair(wname, levels):
    fb = get_filter_bank(wname)
    if fb.hlen == 2:
        return (lambda x: haar.haar_wavedec2(x, levels),
                lambda c, s: haar.haar_waverec2(c, s))
    return (lambda x: dwt.wavedec2(x, fb, levels),
            lambda c, s: dwt.waverec2(c, fb, s))


@pytest.mark.parametrize("wname, shape, levels", CASES)
def test_wavedec2_matches_jax(wname, shape, levels):
    x = _img(shape)
    jfwd, _ = _jax_pair(wname, levels)
    fwd, _ = _port_pair(wname, levels)
    jc = jfwd(jnp.asarray(x))
    ref = [np.asarray(jc[0])] + [tuple(np.asarray(s) for s in c)
                                 for c in jc[1:]]
    got = dwt.pyramid_to_numpy(fwd(torch.from_numpy(x)))
    assert len(got) == len(ref) == levels + 1
    assert got[0].shape == ref[0].shape and got[0].dtype == np.float32
    assert np.abs(got[0] - ref[0]).max() <= COEFF_TOL * 2 ** levels
    for lev in range(1, levels + 1):
        assert isinstance(got[lev], tuple) and len(got[lev]) == 3
        for g, r in zip(got[lev], ref[lev]):
            assert g.shape == r.shape
            assert np.abs(g - r).max() <= COEFF_TOL * 2 ** lev


@pytest.mark.parametrize("wname, shape, levels", CASES)
def test_waverec2_crosses_with_jax(wname, shape, levels):
    x = _img(shape, 1)
    jfwd, jinv = _jax_pair(wname, levels)
    fwd, inv = _port_pair(wname, levels)
    jc = jfwd(jnp.asarray(x))
    jc_np = [np.asarray(jc[0])] + [tuple(np.asarray(s) for s in c)
                                   for c in jc[1:]]
    rec = inv(dwt.pyramid_from_numpy(jc_np, "cpu"), x.shape)
    assert rec.shape == x.shape
    assert np.abs(rec.numpy() - x).max() < ROUNDTRIP_TOL
    pc = dwt.pyramid_to_numpy(fwd(torch.from_numpy(x)))
    jrec = jinv([jnp.asarray(pc[0])]
                + [tuple(jnp.asarray(s) for s in c) for c in pc[1:]],
                x.shape)
    assert np.abs(np.asarray(jrec) - x).max() < ROUNDTRIP_TOL


def test_pyramid_numpy_roundtrip_keeps_structure_and_dtype():
    fb = get_filter_bank("db2")
    c = dwt.wavedec2(torch.from_numpy(_img((32, 48))).double(), fb, 2)
    back = dwt.pyramid_from_numpy(dwt.pyramid_to_numpy(c), "cpu")
    assert back[0].dtype == torch.float64 and torch.equal(back[0], c[0])
    for lev in (1, 2):
        assert isinstance(back[lev], tuple)
        for b, s in zip(back[lev], c[lev]):
            assert torch.equal(b, s)


def test_float64_matches_jax_jnp_path():
    """float64 takes the plain path in both packages."""
    x = np.random.default_rng(2).random((64, 48)) * 255
    got = dwt.wavedec2(torch.from_numpy(x), get_filter_bank("db3"), 2)
    ref = jdwt.wavedec2(jnp.asarray(x), jbank("db3"), 2)
    assert got[0].dtype == torch.float64
    assert np.abs(got[0].numpy() - np.asarray(ref[0])).max() < 1e-9
    for g, r in zip(got[2], ref[2]):
        assert np.abs(g.numpy() - np.asarray(r)).max() < 1e-9
