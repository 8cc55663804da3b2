"""K5/K6 and K7a/K7b: one separable 2D DWT level and one batched-1D DWT
level as banded products on the tensor cores (the port of
``pypwt_tpu.ops.mxu_dwt``'s kernels).

* K5 ``dwt2d_mxu_fused`` (``csrc/tc_dwt2d.cu``) replaces
  ``pypwt_tpu/ops/mxu_dwt.py::dwt2d_fused_mxu`` (``_build_dwt2d_mxu``): one
  analysis level, ``(B?, Nr, Nc)`` -> a, h, v, d of ``(B?, Nr/2, Nc/2)``;
* K6 ``idwt2d_mxu_fused`` (same source) replaces ``::idwt2d_fused_mxu``
  (``_build_idwt2d_mxu``): one polyphase synthesis level -> ``(B?, 2Lr,
  2Lc)``;
* K7a ``dwt1d_mxu_fused`` (``csrc/tc_dwt1d.cu``) replaces
  ``::dwt1d_fused_mxu`` (``_build_dwt1d_mxu``): one analysis level of rows
  ``(R, n)`` or one signal ``(n,)`` -> a, d of ``(R?, n/2)``; K7b
  ``idwt1d_mxu_fused`` (same source) replaces ``::idwt1d_fused_mxu``
  (``_build_idwt1d_mxu``): its synthesis -> ``(R?, 2L)``.  One signal is a
  ``(1, n)`` row, which covers JAX's folded long-signal forms
  ``::dwt1d_long_fused_mxu`` / ``::idwt1d_long_fused_mxu`` (K15): their
  fold fixed the TPU's lane layout;
* K28's DWT half (same source as K5/K6): ``dwt2d_sharded_mxu_fused`` and
  ``idwt2d_sharded_mxu_fused`` replace ``::build_dwt2d_sharded_mxu`` and
  ``::build_idwt2d_sharded_mxu``, K5/K6's levels of one row shard with its
  edge rows from exchanged halo tensors (``parallel.spatial``; the halo
  layout of ``ops.fused_dwt``'s K26), axis -2 unwrapped on the
  halo-extended rows;
* K29e-K29h, the one-axis passes of the grid and sequence layouts in mode
  "mxu" (``parallel.spatial``; the halo layout of ``ops.fused_dwt``'s
  K29a-K29d): K29e ``ana_lanes_mxu_fused`` and K29f ``syn_lanes_mxu_fused``
  (``csrc/tc_dwt1d.cu``), K7a/K7b on the rows' halo source, replace
  ``::build_ana_padded_lanes_mxu`` and ``::build_syn_padded_lanes_mxu``;
  K29g ``ana_rows_mxu_fused`` and K29h ``syn_rows_mxu_fused``
  (``csrc/tc_dwt2d.cu``), K5/K6's axis -2 pass alone on a grid shard's halo
  rows, replace ``::build_ana_padded_rows_mxu`` and
  ``::build_syn_padded_rows_mxu``.

Each pass is the banded map of the JAX kernels: a block of ``b`` outputs
of (lo, hi) is ``D (2b, K) @ xp[2bk : 2bk + K]`` (analysis) and of ``2m``
outputs ``S (2m, 2Kp) @ [lop; hip]`` (synthesis), on planes padded by
``core.conv`` (``periodic_pad_last``, ``analysis_pads``,
``synthesis_pads``), first along axis -2, then along the last axis, as
JAX's kernels order them.  The matrices are built in float64 numpy from
the reference index algebra and cast once to float32, as in JAX
(``analysis_matrix``, ``synthesis_matrix`` and the block sizes are copies).

Two precisions (``core.dwt.set_mxu_precision``):

* ``"highest"``: float32 products (the kernels: 3xTF32, ~21 bits);
* ``"bf16"``: both operands of each pass rounded to bfloat16, products
  summed in float32 (the kernels: one bf16 tensor-core product), JAX's
  DEFAULT dots; about 1 % RMS error.

The plain versions (``*_plain``) need full float32 matrix products
(PyTorch's default, ``torch.backends.cuda.matmul.allow_tf32`` False).
``*_unsupported`` is JAX's coverage as shape and dtype logic: float32
planes or stacks of even sizes (rows of even length in 1D; a synthesis
output of twice the coefficients) and an even bank of 4..40 taps; the
router (``core.dwt``) sends every other level to K1/K2 or K3/K4.  A
wrapper given a CPU tensor runs the plain version; given a CUDA tensor it
launches the kernel or raises; ``launches`` counts its launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..core import conv
from ..filters import MAX_FILTER_WIDTH
from . import _build
from .fused_dwt import (_batch, _check_inputs, _check_launch,
                        _even_rows_unsupported, _extend,
                        _halo_count_unsupported, _host_taps,
                        _pair_unsupported, _plane_unsupported, _rows,
                        _rows_unsupported, _stream, halo_array, halo_heights,
                        halos_unsupported, lane_halos_unsupported,
                        one_axis_pads, shard_plane_unsupported,
                        subbands_unsupported)

PRECISIONS = ("highest", "bf16")


# -- banded block matrices (float64 numpy, cast once to float32) ----------


def analysis_matrix(dec_lo, dec_hi, b):
    """D (2b, K), K = 2b + hlen - 2: rows [lo_b; hi_b] of the decimating
    analysis map out[i] = sum_j f[hlen-1-j] xp[2i+j] (conv.analysis_core /
    separable.cu:91-131)."""
    flo = np.asarray(dec_lo, np.float64)
    fhi = np.asarray(dec_hi, np.float64)
    hlen = len(flo)
    K = 2 * b + hlen - 2
    D = np.zeros((2 * b, K), np.float64)
    for i in range(b):
        for j in range(hlen):
            D[i, 2 * i + j] += flo[hlen - 1 - j]
            D[b + i, 2 * i + j] += fhi[hlen - 1 - j]
    return np.ascontiguousarray(D, np.float32), K


def synthesis_matrix(rec_lo, rec_hi, m):
    """S (2m, 2*Kp), Kp = m + hlen//2: the polyphase synthesis map from
    stacked [lop_slice; hip_slice] to 2m interleaved outputs
    (conv.synthesis_core / separable.cu:246-328).  Input slices start at
    coefficient q0 of planes padded with lpad = c on the left."""
    flo = np.asarray(rec_lo, np.float64)
    fhi = np.asarray(rec_hi, np.float64)
    hlen = len(flo)
    h2 = hlen // 2
    sigma = 1 if h2 % 2 == 0 else 0
    # slice indices r = delta + j + q reach m + h2 - 2 + max(delta), and
    # max(delta) = sigma (conv.synthesis_core phase rules)
    Kp = m + h2 - 1 + sigma
    S = np.zeros((2 * m, 2 * Kp), np.float64)
    for p in (0, 1):
        pp = (p + sigma) & 1
        delta = (p + sigma) >> 1
        off = 1 - pp
        for q in range(m):
            for j in range(h2):
                tap = hlen - 1 - 2 * j - off
                r = delta + j + q
                S[2 * q + p, r] += flo[tap]
                S[2 * q + p, Kp + r] += fhi[tap]
    return np.ascontiguousarray(S, np.float32), Kp


def _ana_blocks(hlen):
    """Full-block size b with K = 2b + hlen - 2 = 128 (one MXU K-tile)."""
    return (130 - hlen) // 2


def _syn_blocks(hlen):
    """Full-block size m with 2*Kp <= 128 (one MXU K-tile when the two
    plane slices are stacked)."""
    h2 = hlen // 2
    sigma = 1 if h2 % 2 == 0 else 0
    return 64 - (h2 - 1 + sigma)


# -- plain versions ---------------------------------------------------------


def check_precision(prec):
    if prec not in PRECISIONS:
        raise ValueError("mxu precision must be highest|bf16")


@functools.lru_cache(maxsize=256)
def _matrix(build, lo, hi, args, device, dtype, prec):
    m, k = build(np.asarray(lo), np.asarray(hi), *args)
    return operand(torch.from_numpy(m).to(device, dtype), prec), k


def matrix(like, prec, build, lo, hi, *args):
    """``build(lo, hi, *args)``, float32 values, as a tensor of ``like``'s
    device and dtype (rounded to bf16 in "bf16"), and its K.  Kept per
    device: a host-to-device copy in each call would wait for the device."""
    return _matrix(build, tuple(float(v) for v in lo),
                   tuple(float(v) for v in hi), args, like.device,
                   like.dtype, prec)


def operand(t, prec):
    """A product's operand: as it is ("highest"), or rounded to bfloat16."""
    return t.to(torch.bfloat16).to(t.dtype) if prec == "bf16" else t


def _ana_last(x, fb, prec):
    """Banded analysis along the last axis (ops/mxu_dwt.py::_ana_dots on the
    padded plane) -> lo, hi, each (..., n/2)."""
    xp = conv.periodic_pad_last(x, *conv.analysis_pads(fb.hlen))
    return _ana_core(xp, fb, prec, x.shape[-1] // 2)


def _ana_core(xp, fb, prec, L):
    """Banded analysis of a padded signal (``conv.analysis_pads``) along
    the last axis -> lo, hi, each (..., L)."""
    xp = operand(xp, prec)
    b = _ana_blocks(fb.hlen)
    nfull, r = divmod(L, b)
    los, his = [], []
    if nfull:
        D, K = matrix(xp, prec, analysis_matrix, fb.dec_lo, fb.dec_hi, b)
        y = xp.unfold(-1, K, 2 * b) @ D.T        # (..., nfull, 2b)
        los.append(y[..., :b].flatten(-2))
        his.append(y[..., b:].flatten(-2))
    if r:
        D, K = matrix(xp, prec, analysis_matrix, fb.dec_lo, fb.dec_hi, r)
        y = xp[..., 2 * b * nfull: 2 * b * nfull + K] @ D.T
        los.append(y[..., :r])
        his.append(y[..., r:])
    return torch.cat(los, -1), torch.cat(his, -1)


def _syn_last(lo, hi, fb, prec):
    """Banded polyphase synthesis along the last axis (ops/mxu_dwt.py::
    _syn_dots) -> (..., 2L)."""
    L = lo.shape[-1]
    pads = conv.synthesis_pads(fb.hlen, L, 2 * L)
    return _syn_core(conv.periodic_pad_last(lo, *pads),
                     conv.periodic_pad_last(hi, *pads), fb, prec, L)


def _syn_core(lop, hip, fb, prec, L):
    """Banded polyphase synthesis of padded coefficient signals
    (``conv.synthesis_pads`` with n_out = 2L) along the last axis ->
    (..., 2L)."""
    lop, hip = operand(lop, prec), operand(hip, prec)
    m = _syn_blocks(fb.hlen)
    nfull, r = divmod(L, m)
    outs = []
    if nfull:
        S, Kp = matrix(lop, prec, synthesis_matrix, fb.rec_lo, fb.rec_hi, m)
        z = torch.cat([lop.unfold(-1, Kp, m), hip.unfold(-1, Kp, m)], -1)
        outs.append((z @ S.T).flatten(-2))
    if r:
        S, Kp = matrix(lop, prec, synthesis_matrix, fb.rec_lo, fb.rec_hi, r)
        s0 = m * nfull
        z = torch.cat([lop[..., s0: s0 + Kp], hip[..., s0: s0 + Kp]], -1)
        outs.append(z @ S.T)
    return torch.cat(outs, -1)


def dwt2d_mxu_plain(x, fb, prec="highest"):
    """One analysis level as banded products -> (a, h, v, d): along axis
    -2 (lo_r, hi_r), then the last axis; a = lo(lo_r), v = hi(lo_r),
    h = lo(hi_r), d = hi(hi_r), K1's subbands."""
    check_precision(prec)
    lo_r, hi_r = (t.transpose(-1, -2)
                  for t in _ana_last(x.transpose(-1, -2), fb, prec))
    a, v = _ana_last(lo_r, fb, prec)
    h, d = _ana_last(hi_r, fb, prec)
    return a, h, v, d


def idwt2d_mxu_plain(a, h, v, d, fb, out_shape, prec="highest"):
    """One synthesis level as banded products -> (B?, *out_shape[-2:]):
    along axis -2 t1 = syn(a, h), t2 = syn(v, d), then the last axis."""
    check_precision(prec)
    del out_shape  # (2 Lr, 2 Lc): the coverage rule holds it
    t1, t2 = (_syn_last(p.transpose(-1, -2), q.transpose(-1, -2), fb,
                        prec).transpose(-1, -2) for p, q in ((a, h), (v, d)))
    return _syn_last(t1, t2, fb, prec)


def dwt2d_sharded_mxu_plain(x, top, bot, fb, prec="highest"):
    """K28's analysis map: ``dwt2d_mxu_plain`` on a row shard, axis -2 on
    the rows extended by its halos (unwrapped), then the last axis
    periodically -> (a, h, v, d), each (B?, nr/2, nc/2)."""
    check_precision(prec)
    xp = torch.cat([top, x, bot], -2).transpose(-1, -2)
    lo_r, hi_r = (t.transpose(-1, -2)
                  for t in _ana_core(xp, fb, prec, x.shape[-2] // 2))
    a, v = _ana_last(lo_r, fb, prec)
    h, d = _ana_last(hi_r, fb, prec)
    return a, h, v, d


def idwt2d_sharded_mxu_plain(a, h, v, d, halos, fb, prec="highest"):
    """K28's synthesis map: ``idwt2d_mxu_plain`` on a row shard's planes,
    axis -2 on the rows extended by each plane's halos, then the last axis
    -> (B?, 2Lr, 2Lc)."""
    check_precision(prec)
    ext = [torch.cat([halos[2 * i], p, halos[2 * i + 1]], -2).transpose(-1, -2)
           for i, p in enumerate((a, h, v, d))]
    L = a.shape[-2]
    t1, t2 = (_syn_core(lo, hi, fb, prec, L).transpose(-1, -2)
              for lo, hi in ((ext[0], ext[1]), (ext[2], ext[3])))
    return _syn_last(t1, t2, fb, prec)


def dwt1d_mxu_plain(x, fb, prec="highest"):
    """K7a's map: one batched-1D analysis level as banded products along
    the last axis -> (a, d), each ``(R?, n/2)``."""
    check_precision(prec)
    return _ana_last(x, fb, prec)


def idwt1d_mxu_plain(a, d, fb, n_out, prec="highest"):
    """K7b's map: one batched-1D polyphase synthesis level as banded
    products -> ``(R?, 2L)``."""
    check_precision(prec)
    del n_out  # 2L: the coverage rule holds it
    return _syn_last(a, d, fb, prec)


# -- coverage and wrappers ---------------------------------------------------


def _even_bank_unsupported(fb):
    if fb.hlen % 2 or not 4 <= fb.hlen <= MAX_FILTER_WIDTH:
        return (f"filter length {fb.hlen} (an even length of "
                f"4..{MAX_FILTER_WIDTH})")
    return None


def dwt2d_mxu_unsupported(x, fb):
    """Why K5 cannot take ``x`` with bank ``fb``, or None if it can (JAX's
    ``_covers`` and ``_build_dwt2d_mxu``: float32, even sizes, an even bank
    of 4 or more taps)."""
    why = _plane_unsupported(x, "input") or _even_bank_unsupported(fb)
    if why:
        return why
    nr, nc = x.shape[-2:]
    if nr % 2 or nc % 2:
        return f"plane {nr} x {nc} (even sizes only)"
    return None


def idwt2d_mxu_unsupported(a, h, v, d, fb, out_shape):
    """Why K6 cannot take these coefficients, or None if it can (JAX's
    ``idwt2d_fused_mxu``: an output of exactly twice their size, an even
    bank of 4 or more taps)."""
    why = (subbands_unsupported(a, h, v, d, out_shape)
           or _even_bank_unsupported(fb))
    if why:
        return why
    want = (2 * a.shape[-2], 2 * a.shape[-1])
    if tuple(out_shape[-2:]) != want:
        return f"output {tuple(out_shape[-2:])} (twice the coefficients: {want})"
    return None


def dwt1d_mxu_unsupported(x, fb):
    """Why K7a cannot take ``x`` with bank ``fb``, or None if it can (JAX's
    ``_build_dwt1d_mxu``: float32, an even row length, an even bank of 4 or
    more taps)."""
    why = _rows_unsupported(x, "input") or _even_bank_unsupported(fb)
    if why:
        return why
    if x.shape[-1] % 2:
        return f"{x.shape[-1]} samples per row (an even length only)"
    return None


def idwt1d_mxu_unsupported(a, d, fb, n_out):
    """Why K7b cannot take these coefficients, or None if it can (JAX's
    ``_build_idwt1d_mxu``: an output of exactly twice their length)."""
    why = (_rows_unsupported(a, "coefficient") or _pair_unsupported(a, d)
           or _even_bank_unsupported(fb))
    if why:
        return why
    if n_out != 2 * a.shape[-1]:
        return f"output of {n_out} samples (twice the coefficients: " \
               f"{2 * a.shape[-1]})"
    return None


def dwt2d_mxu_fused(x, fb, prec="highest"):
    """K5: one analysis level on the tensor cores -> (a, h, v, d), each
    ``(B?, Nr/2, Nc/2)``.  CPU tensor: the plain version."""
    check_precision(prec)
    if x.device.type == "cpu":
        return dwt2d_mxu_plain(x, fb, prec)
    _check_inputs("K5 (dwt2d_mxu)", dwt2d_mxu_unsupported(x, fb), x)
    lib = _build.load_library()
    nr, nc = x.shape[-2:]
    shape = (*x.shape[:-2], nr // 2, nc // 2)
    a, h, v, d = (torch.empty(shape, dtype=x.dtype, device=x.device)
                  for _ in range(4))
    lo, hi = _host_taps(fb.dec_lo), _host_taps(fb.dec_hi)
    err = lib.pypwt_tc_dwt2d(
        x.data_ptr(), a.data_ptr(), h.data_ptr(), v.data_ptr(), d.data_ptr(),
        _batch(x), nr, nc, lo.ctypes.data, hi.ctypes.data, fb.hlen,
        int(prec == "bf16"), x.device.index, _stream(x))
    _check_launch(lib, err, "K5 (dwt2d_mxu)")
    dwt2d_mxu_fused.launches += 1
    return a, h, v, d


def idwt2d_mxu_fused(a, h, v, d, fb, out_shape, prec="highest"):
    """K6: one synthesis level on the tensor cores -> ``(B?, 2Lr, 2Lc)``.
    CPU tensors: the plain version."""
    check_precision(prec)
    if a.device.type == "cpu":
        return idwt2d_mxu_plain(a, h, v, d, fb, out_shape, prec)
    _check_inputs("K6 (idwt2d_mxu)",
                  idwt2d_mxu_unsupported(a, h, v, d, fb, out_shape),
                  a, h, v, d)
    lib = _build.load_library()
    lr, lc = a.shape[-2:]
    out = torch.empty((*a.shape[:-2], 2 * lr, 2 * lc), dtype=a.dtype,
                      device=a.device)
    lo, hi = _host_taps(fb.rec_lo), _host_taps(fb.rec_hi)
    err = lib.pypwt_tc_idwt2d(
        a.data_ptr(), h.data_ptr(), v.data_ptr(), d.data_ptr(),
        out.data_ptr(), _batch(a), lr, lc, lo.ctypes.data, hi.ctypes.data,
        fb.hlen, int(prec == "bf16"), a.device.index, _stream(a))
    _check_launch(lib, err, "K6 (idwt2d_mxu)")
    idwt2d_mxu_fused.launches += 1
    return out


def dwt1d_mxu_fused(x, fb, prec="highest"):
    """K7a: one batched-1D analysis level on the tensor cores -> (a, d),
    each ``(R?, n/2)``.  CPU tensor: the plain version."""
    check_precision(prec)
    if x.device.type == "cpu":
        return dwt1d_mxu_plain(x, fb, prec)
    _check_inputs("K7a (dwt1d_mxu)", dwt1d_mxu_unsupported(x, fb), x)
    lib = _build.load_library()
    n = x.shape[-1]
    shape = (*x.shape[:-1], n // 2)
    a, d = (torch.empty(shape, dtype=x.dtype, device=x.device)
            for _ in range(2))
    lo, hi = _host_taps(fb.dec_lo), _host_taps(fb.dec_hi)
    err = lib.pypwt_tc_dwt1d(
        x.data_ptr(), a.data_ptr(), d.data_ptr(), _rows(x), n,
        lo.ctypes.data, hi.ctypes.data, fb.hlen, int(prec == "bf16"),
        x.device.index, _stream(x))
    _check_launch(lib, err, "K7a (dwt1d_mxu)")
    dwt1d_mxu_fused.launches += 1
    return a, d


def idwt1d_mxu_fused(a, d, fb, n_out, prec="highest"):
    """K7b: one batched-1D synthesis level on the tensor cores ->
    ``(R?, 2L)``.  CPU tensors: the plain version."""
    check_precision(prec)
    if a.device.type == "cpu":
        return idwt1d_mxu_plain(a, d, fb, n_out, prec)
    _check_inputs("K7b (idwt1d_mxu)",
                  idwt1d_mxu_unsupported(a, d, fb, n_out), a, d)
    lib = _build.load_library()
    length = a.shape[-1]
    out = torch.empty((*a.shape[:-1], 2 * length), dtype=a.dtype,
                      device=a.device)
    lo, hi = _host_taps(fb.rec_lo), _host_taps(fb.rec_hi)
    err = lib.pypwt_tc_idwt1d(
        a.data_ptr(), d.data_ptr(), out.data_ptr(), _rows(a), length,
        lo.ctypes.data, hi.ctypes.data, fb.hlen, int(prec == "bf16"),
        a.device.index, _stream(a))
    _check_launch(lib, err, "K7b (idwt1d_mxu)")
    idwt1d_mxu_fused.launches += 1
    return out


def dwt2d_sharded_mxu_unsupported(x, top, bot, fb):
    """Why K28's analysis cannot take shard ``x`` and its halos, or None
    (K5's coverage, the rows from the halos)."""
    return (dwt2d_mxu_unsupported(x, fb)
            or halos_unsupported(x, (top, bot),
                                 halo_heights("dwt", fb, x.shape[-2])))


def idwt2d_sharded_mxu_unsupported(a, h, v, d, halos, fb):
    """Why K28's synthesis cannot take these planes and halos, or None."""
    out = (2 * a.shape[-2], 2 * a.shape[-1])
    return (idwt2d_mxu_unsupported(a, h, v, d, fb, out)
            or (len(halos) != 8 and f"{len(halos)} halos (8)")
            or halos_unsupported(a, halos,
                                 halo_heights("idwt", fb, a.shape[-2])))


def dwt2d_sharded_mxu_fused(x, top, bot, fb, prec="highest"):
    """K28, analysis: K5's level of a row shard -> (a, h, v, d), each
    (B?, nr/2, nc/2).  CPU tensors: the plain version."""
    check_precision(prec)
    if x.device.type == "cpu":
        return dwt2d_sharded_mxu_plain(x, top, bot, fb, prec)
    name = "K28 (dwt2d_sharded_mxu)"
    _check_inputs(name, dwt2d_sharded_mxu_unsupported(x, top, bot, fb), x,
                  top, bot)
    lib = _build.load_library()
    nr, nc = x.shape[-2:]
    a, h, v, d = (torch.empty((*x.shape[:-2], nr // 2, nc // 2),
                              dtype=x.dtype, device=x.device)
                  for _ in range(4))
    lo, hi = _host_taps(fb.dec_lo), _host_taps(fb.dec_hi)
    err = lib.pypwt_tc_dwt2d_sharded(
        x.data_ptr(), top.data_ptr(), bot.data_ptr(), a.data_ptr(),
        h.data_ptr(), v.data_ptr(), d.data_ptr(), _batch(x), nr, nc,
        top.shape[-2], bot.shape[-2], lo.ctypes.data, hi.ctypes.data,
        fb.hlen, int(prec == "bf16"), x.device.index, _stream(x))
    _check_launch(lib, err, name)
    dwt2d_sharded_mxu_fused.launches += 1
    return a, h, v, d


def idwt2d_sharded_mxu_fused(a, h, v, d, halos, fb, prec="highest"):
    """K28, synthesis: K6's level of a row shard's planes and their eight
    halos -> (B?, 2Lr, 2Lc).  CPU tensors: the plain version."""
    check_precision(prec)
    if a.device.type == "cpu":
        return idwt2d_sharded_mxu_plain(a, h, v, d, halos, fb, prec)
    name = "K28 (idwt2d_sharded_mxu)"
    _check_inputs(name,
                  idwt2d_sharded_mxu_unsupported(a, h, v, d, halos, fb),
                  a, h, v, d, *halos)
    lib = _build.load_library()
    lr, lc = a.shape[-2:]
    out = torch.empty((*a.shape[:-2], 2 * lr, 2 * lc), dtype=a.dtype,
                      device=a.device)
    lo, hi = _host_taps(fb.rec_lo), _host_taps(fb.rec_hi)
    ptrs = halo_array(halos)
    err = lib.pypwt_tc_idwt2d_sharded(
        a.data_ptr(), h.data_ptr(), v.data_ptr(), d.data_ptr(),
        ctypes.addressof(ptrs), out.data_ptr(), _batch(a), lr, lc,
        halos[0].shape[-2], halos[1].shape[-2], lo.ctypes.data,
        hi.ctypes.data, fb.hlen, int(prec == "bf16"), a.device.index,
        _stream(a))
    _check_launch(lib, err, name)
    idwt2d_sharded_mxu_fused.launches += 1
    return out


# -- one-axis passes of a grid or signal shard: K29e-K29h -------------------


def ana_lanes_mxu_plain(x, left, right, fb, prec="highest"):
    """K29e's map: the banded analysis of the halo-extended rows -> (lo,
    hi), each (R?, n/2)."""
    check_precision(prec)
    return _ana_core(_extend(left, x, right, -1), fb, prec, x.shape[-1] // 2)


def syn_lanes_mxu_plain(a, d, halos, fb, prec="highest"):
    """K29f's map: the banded synthesis of the halo-extended coefficient
    rows -> (R?, 2L)."""
    check_precision(prec)
    return _syn_core(_extend(halos[0], a, halos[1], -1),
                     _extend(halos[2], d, halos[3], -1), fb, prec,
                     a.shape[-1])


def ana_rows_mxu_plain(x, top, bot, fb, prec="highest"):
    """K29g's map: the banded analysis along axis -2 of the halo-extended
    rows -> (lo, hi), each (nr/2, nc)."""
    check_precision(prec)
    lo, hi = _ana_core(_extend(top, x, bot, -2).transpose(-1, -2), fb, prec,
                       x.shape[-2] // 2)
    return lo.transpose(-1, -2).contiguous(), hi.transpose(-1, -2).contiguous()


def syn_rows_mxu_plain(a, d, halos, fb, prec="highest"):
    """K29h's map: the banded synthesis along axis -2 of the halo-extended
    coefficient rows -> (2L, nc)."""
    check_precision(prec)
    out = _syn_core(_extend(halos[0], a, halos[1], -2).transpose(-1, -2),
                    _extend(halos[2], d, halos[3], -2).transpose(-1, -2), fb,
                    prec, a.shape[-2])
    return out.transpose(-1, -2).contiguous()


def ana_lanes_mxu_unsupported(x, left, right, fb):
    """Why K29e cannot take the rows ``x`` and their halos, or None (JAX's
    ``build_ana_padded_lanes_mxu``: K7a's coverage and exact pads)."""
    return (dwt1d_mxu_unsupported(x, fb)
            or lane_halos_unsupported(x, (left, right),
                                      one_axis_pads("ana", fb, 0)))


def syn_lanes_mxu_unsupported(a, d, halos, fb):
    """Why K29f cannot take the coefficient rows and their four halos
    (``_syn_padded_cover``: K7b's coverage and exact pads)."""
    L = a.shape[-1]
    return (idwt1d_mxu_unsupported(a, d, fb, 2 * L)
            or _halo_count_unsupported(halos, 4)
            or lane_halos_unsupported(a, halos, one_axis_pads("syn", fb, L)))


def ana_rows_mxu_unsupported(x, top, bot, fb):
    """Why K29g cannot take the grid shard ``x`` and its halo rows, or None
    (``build_ana_padded_rows_mxu``: float32, an even row count, an even bank
    of 4 or more taps, exact pads)."""
    return (shard_plane_unsupported(x, "input", (torch.float32,))
            or _even_bank_unsupported(fb) or _even_rows_unsupported(x)
            or halos_unsupported(x, (top, bot), one_axis_pads("ana", fb, 0)))


def syn_rows_mxu_unsupported(a, d, halos, fb):
    """Why K29h cannot take the coefficient planes and their four halos."""
    L = a.shape[-2]
    return (shard_plane_unsupported(a, "coefficient", (torch.float32,))
            or _pair_unsupported(a, d) or _even_bank_unsupported(fb)
            or _halo_count_unsupported(halos, 4)
            or halos_unsupported(a, halos, one_axis_pads("syn", fb, L)))


def ana_lanes_mxu_fused(x, left, right, fb, prec="highest"):
    """K29e: K7a's level of rows whose samples before and after come from
    ``left`` and ``right`` -> (lo, hi), each ``(R?, n/2)``.  CPU tensors:
    the plain version."""
    check_precision(prec)
    if x.device.type == "cpu":
        return ana_lanes_mxu_plain(x, left, right, fb, prec)
    name = "K29e (ana_lanes_mxu)"
    _check_inputs(name, ana_lanes_mxu_unsupported(x, left, right, fb), x,
                  left, right)
    lib = _build.load_library()
    n = x.shape[-1]
    lo, hi = (torch.empty((*x.shape[:-1], n // 2), dtype=x.dtype,
                          device=x.device) for _ in range(2))
    flo, fhi = _host_taps(fb.dec_lo), _host_taps(fb.dec_hi)
    err = lib.pypwt_tc_ana_lanes(
        x.data_ptr(), left.data_ptr(), right.data_ptr(), lo.data_ptr(),
        hi.data_ptr(), _rows(x), n, left.shape[-1], right.shape[-1],
        flo.ctypes.data, fhi.ctypes.data, fb.hlen, int(prec == "bf16"),
        x.device.index, _stream(x))
    _check_launch(lib, err, name)
    ana_lanes_mxu_fused.launches += 1
    return lo, hi


def syn_lanes_mxu_fused(a, d, halos, fb, prec="highest"):
    """K29f: K7b's level of coefficient rows and their four halos ->
    ``(R?, 2L)``.  CPU tensors: the plain version."""
    check_precision(prec)
    if a.device.type == "cpu":
        return syn_lanes_mxu_plain(a, d, halos, fb, prec)
    name = "K29f (syn_lanes_mxu)"
    _check_inputs(name, syn_lanes_mxu_unsupported(a, d, halos, fb), a, d,
                  *halos)
    lib = _build.load_library()
    L = a.shape[-1]
    out = torch.empty((*a.shape[:-1], 2 * L), dtype=a.dtype, device=a.device)
    flo, fhi = _host_taps(fb.rec_lo), _host_taps(fb.rec_hi)
    ptrs = halo_array(halos)
    err = lib.pypwt_tc_syn_lanes(
        a.data_ptr(), d.data_ptr(), ctypes.addressof(ptrs), out.data_ptr(),
        _rows(a), L, halos[0].shape[-1], halos[1].shape[-1],
        flo.ctypes.data, fhi.ctypes.data, fb.hlen, int(prec == "bf16"),
        a.device.index, _stream(a))
    _check_launch(lib, err, name)
    syn_lanes_mxu_fused.launches += 1
    return out


def ana_rows_mxu_fused(x, top, bot, fb, prec="highest"):
    """K29g: K5's axis -2 pass of a grid shard ``(nr, nc)`` and its halo
    rows -> (lo, hi), each ``(nr/2, nc)``.  CPU tensors: the plain
    version."""
    check_precision(prec)
    if x.device.type == "cpu":
        return ana_rows_mxu_plain(x, top, bot, fb, prec)
    name = "K29g (ana_rows_mxu)"
    _check_inputs(name, ana_rows_mxu_unsupported(x, top, bot, fb), x, top,
                  bot)
    lib = _build.load_library()
    nr, nc = x.shape
    lo, hi = (torch.empty((nr // 2, nc), dtype=x.dtype, device=x.device)
              for _ in range(2))
    flo, fhi = _host_taps(fb.dec_lo), _host_taps(fb.dec_hi)
    err = lib.pypwt_tc_ana_rows(
        x.data_ptr(), top.data_ptr(), bot.data_ptr(), lo.data_ptr(),
        hi.data_ptr(), nr, nc, top.shape[-2], bot.shape[-2],
        flo.ctypes.data, fhi.ctypes.data, fb.hlen, int(prec == "bf16"),
        x.device.index, _stream(x))
    _check_launch(lib, err, name)
    ana_rows_mxu_fused.launches += 1
    return lo, hi


def syn_rows_mxu_fused(a, d, halos, fb, prec="highest"):
    """K29h: K6's axis -2 pass of a grid shard's coefficient planes
    ``(L, nc)`` and their four halos -> ``(2L, nc)``.  CPU tensors: the
    plain version."""
    check_precision(prec)
    if a.device.type == "cpu":
        return syn_rows_mxu_plain(a, d, halos, fb, prec)
    name = "K29h (syn_rows_mxu)"
    _check_inputs(name, syn_rows_mxu_unsupported(a, d, halos, fb), a, d,
                  *halos)
    lib = _build.load_library()
    L, nc = a.shape
    out = torch.empty((2 * L, nc), dtype=a.dtype, device=a.device)
    flo, fhi = _host_taps(fb.rec_lo), _host_taps(fb.rec_hi)
    ptrs = halo_array(halos)
    err = lib.pypwt_tc_syn_rows(
        a.data_ptr(), d.data_ptr(), ctypes.addressof(ptrs), out.data_ptr(),
        L, nc, halos[0].shape[-2], halos[1].shape[-2], flo.ctypes.data,
        fhi.ctypes.data, fb.hlen, int(prec == "bf16"), a.device.index,
        _stream(a))
    _check_launch(lib, err, name)
    syn_rows_mxu_fused.launches += 1
    return out


KERNELS = (dwt2d_mxu_fused, idwt2d_mxu_fused, dwt1d_mxu_fused,
           idwt1d_mxu_fused, dwt2d_sharded_mxu_fused,
           idwt2d_sharded_mxu_fused, ana_lanes_mxu_fused,
           syn_lanes_mxu_fused, ana_rows_mxu_fused, syn_rows_mxu_fused)

# counts start at 0; ``ops.reset_counts`` zeroes them with the others
for _k in KERNELS:
    _k.launches = 0
