"""The port's filter registry against pypwt_tpu.filters: every built-in bank
bit-identical, the same aliases, names and refusals, and banks carried
across with bank_from_numpy."""

import numpy as np
import pytest
import torch

from pypwt_tpu import filters as jf
from pypwt_tpu.filters import _tables as jtables
from pypwt_tpu_torch import filters as tf
from pypwt_tpu_torch.filters import _tables as ttables

torch.set_num_threads(1)

_ARRAYS = ("dec_lo", "dec_hi", "rec_lo", "rec_hi")


def _same_bank(t, j):
    for attr in _ARRAYS:
        a, b = getattr(t, attr), getattr(j, attr)
        assert a.dtype == b.dtype == np.float64
        assert a.tobytes() == b.tobytes(), attr
    assert t.hlen == j.hlen


def test_tables_identical():
    assert ttables.TABLES == jtables.TABLES
    assert len(ttables.TABLES) == 72


@pytest.mark.parametrize("name", jf.wavelist())
def test_bank_bit_identical(name):
    t, j = tf.get_filter_bank(name), jf.get_filter_bank(name)
    _same_bank(t, j)
    assert (t.name, t.orthogonal) == (j.name, j.orthogonal)


@pytest.mark.parametrize("alias", ["db1", "bior1.1", "rbior1.1", "rbio1.1",
                                   "DB2", " Sym8 ", "rbior2.2"])
def test_aliases(alias):
    t, j = tf.get_filter_bank(alias), jf.get_filter_bank(alias)
    assert t.name == j.name
    _same_bank(t, j)


def test_wavelist_and_width():
    assert tf.wavelist() == jf.wavelist()
    assert tf.MAX_FILTER_WIDTH == jf.MAX_FILTER_WIDTH == 40


def test_unknown_wavelet_raises():
    with pytest.raises(ValueError, match="unknown wavelet"):
        tf.get_filter_bank("db99")


@pytest.mark.parametrize("n, match", [(5, "odd"), (42, "MAX_FILTER_WIDTH")])
def test_custom_refusals(n, match):
    f = np.ones(n)
    with pytest.raises(ValueError, match=match):
        tf.FilterBank.custom("x", f, f, f, f)
    with pytest.raises(ValueError, match=match):
        jf.FilterBank.custom("x", f, f, f, f)


def test_custom_unequal_lengths_refused():
    with pytest.raises(ValueError, match="equal length"):
        tf.FilterBank.custom("x", np.ones(4), np.ones(4), np.ones(4),
                             np.ones(6))


@pytest.mark.parametrize("source", ["custom", "sym20", "bior3.5"])
def test_bank_from_numpy_roundtrip(source):
    if source == "custom":
        rng = np.random.default_rng(3)
        j = jf.FilterBank.custom("mine", *(rng.standard_normal(6)
                                           for _ in range(4)))
    else:
        j = jf.get_filter_bank(source)
    t = tf.bank_from_numpy(j.name, j.dec_lo, j.dec_hi, j.rec_lo, j.rec_hi)
    assert t.name == j.name
    _same_bank(t, j)
