"""The port's threshold operators, norms and shifts against
pypwt_tpu.core.thresh on the same float32 pyramid (2D and 1D layouts),
with normalize and the approximation-coefficient flag on and off."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pypwt_tpu.core import thresh as jthresh
from pypwt_tpu_torch.core import thresh

torch.set_num_threads(1)

TOL = 1e-5  # elementwise operators: the same formula in both packages


def _pyramid(two_d, seed=0):
    rng = np.random.default_rng(seed)

    def r(shape):
        return (rng.standard_normal(shape) * 20).astype(np.float32)
    if two_d:
        return [r((8, 8))] + [tuple(r((n, n)) for _ in range(3))
                              for n in (32, 16, 8)]
    return [r((3, 8))] + [r((3, n)) for n in (32, 16, 8)]


def _to_jax(p):
    return [jnp.asarray(p[0])] + [
        tuple(jnp.asarray(s) for s in c) if isinstance(c, tuple)
        else jnp.asarray(c) for c in p[1:]]


def _to_torch(p):
    return [torch.from_numpy(p[0])] + [
        tuple(torch.from_numpy(s) for s in c) if isinstance(c, tuple)
        else torch.from_numpy(c) for c in p[1:]]


def _flat(p):
    """Every subband of a torch or JAX pyramid as a numpy array."""
    out = []
    for c in p:
        out += [np.asarray(s) for s in (c if isinstance(c, tuple) else (c,))]
    return out


def _assert_close(got, ref):
    g, r = _flat(got), _flat(ref)
    assert len(g) == len(r)
    for a, b in zip(g, r):
        assert a.shape == b.shape and a.dtype == np.float32
        assert np.abs(a - b).max() <= TOL


OPS = ["soft_threshold", "hard_threshold", "group_soft_threshold"]


@pytest.mark.parametrize("two_d", [True, False])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("app", [False, True])
@pytest.mark.parametrize("normalize", [False, True])
def test_thresholds_match(two_d, op, app, normalize):
    p = _pyramid(two_d)
    got = getattr(thresh, op)(_to_torch(p), 15.0, app, normalize)
    ref = getattr(jthresh, op)(_to_jax(p), 15.0, app, normalize)
    _assert_close(got, ref)


@pytest.mark.parametrize("two_d", [True, False])
@pytest.mark.parametrize("app", [False, True])
def test_proj_linf_and_shrink_match(two_d, app):
    p = _pyramid(two_d, 1)
    _assert_close(thresh.proj_linf(_to_torch(p), 7.5, app),
                  jthresh.proj_linf(_to_jax(p), 7.5, app))
    _assert_close(thresh.shrink(_to_torch(p), 0.3, app),
                  jthresh.shrink(_to_jax(p), 0.3, app))


def test_hard_threshold_zeroes_ties():
    t = 2.0
    x = np.array([[-2.0, 2.0, 2.5, -1.0]], np.float32)
    p = [x, (x, x, x)]
    got = thresh.hard_threshold(_to_torch(p), t, True)
    ref = jthresh.hard_threshold(_to_jax(p), t, True)
    _assert_close(got, ref)
    np.testing.assert_array_equal(got[0].numpy(), [[0, 0, 2.5, 0]])


@pytest.mark.parametrize("nlevels", range(1, 6))
def test_app_beta_schedule(nlevels):
    for normalize in (False, True):
        assert (thresh._app_beta(10.0, nlevels, normalize)
                == jthresh._app_beta(10.0, nlevels, normalize))


@pytest.mark.parametrize("two_d", [True, False])
def test_norms_match(two_d):
    p = _pyramid(two_d, 2)
    for name in ("norm1", "norm2sq"):
        got = float(getattr(thresh, name)(_to_torch(p)))
        ref = float(getattr(jthresh, name)(_to_jax(p)))
        assert got == pytest.approx(ref, rel=1e-5)


def test_add_coeffs_matches():
    a, b = _pyramid(True, 3), _pyramid(True, 4)
    _assert_close(thresh.add_coeffs(_to_torch(a), _to_torch(b), 0.5),
                  jthresh.add_coeffs(_to_jax(a), _to_jax(b), 0.5))


@pytest.mark.parametrize("shape, sr, sc", [((6, 10), 2, -3), ((10,), 0, 4),
                                           ((2, 5, 7), -1, 9)])
def test_circshift_matches(shape, sr, sc):
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    got = thresh.circshift(torch.from_numpy(x), sr, sc)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jthresh.circshift(jnp.asarray(x), sr, sc)))


def test_inputs_unchanged():
    p = _pyramid(True, 5)
    t = _to_torch(p)
    thresh.soft_threshold(t, 5.0, True, True)
    np.testing.assert_array_equal(t[0].numpy(), p[0])
