"""Build and load the hand-written CUDA level kernels.

The sources in ``pypwt_tpu_torch/csrc/`` are compiled by ``nvcc`` for
Hopper (``sm_90a``), one process per source, all started together, and
linked into one shared library with a plain C interface, loaded with
``ctypes``.  No PyTorch headers are involved, so a build takes seconds.
The library lands in the git-ignored ``pypwt_tpu_torch/_build/``
under a name keyed on a hash of the sources and flags; a later process
with the same sources loads it without compiling.

Nothing is built at import: the first kernel launch calls
``load_library()``.  A missing ``nvcc`` or a failed compile raises, with
the command that was tried.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC",
              # register / shared-memory report of each kernel, kept in
              # build_log (no effect on the code generated)
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C interface of csrc/*.cu: every pointer and the stream as c_void_p, so
# that ctypes does not cut them to 32 bits.
_SIGNATURES = {
    # x, a, h, v, d, batch, nr, nc, dec_lo, dec_hi, hlen, device, stream
    "pypwt_dwt2d": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _I, _I, _P],
    # x, a, h, v, d, batch, nr, nc, sr, sc, mode, beta, dec_lo, dec_hi,
    # hlen, device, stream
    "pypwt_dwt2d_shifted": [_P] * 5 + [_I] * 6 + [_F, _P, _P, _I, _I, _P],
    # a, h, v, d, out, batch, lr, lc, nr, nc, rec_lo, rec_hi, hlen, device,
    # stream
    "pypwt_idwt2d": [_P] * 5 + [_I] * 5 + [_P, _P, _I, _I, _P],
    # a, h, v, d, acc, out, batch, lr, lc, nr, nc, sr, sc, scale, rec_lo,
    # rec_hi, hlen, device, stream
    "pypwt_idwt2d_unshift": [_P] * 6 + [_I] * 7 + [_F, _P, _P, _I, _I, _P],
    # x, a, d, rows, n, dec_lo, dec_hi, hlen, device, stream
    "pypwt_dwt1d": [_P, _P, _P, _I, _I, _P, _P, _I, _I, _P],
    # a, d, out, rows, len, n_out, rec_lo, rec_hi, hlen, device, stream
    "pypwt_idwt1d": [_P] * 3 + [_I] * 3 + [_P, _P, _I, _I, _P],
    # x, a, d, rows, n, level, dec_lo, dec_hi, hlen, device, stream
    "pypwt_swt1d": [_P, _P, _P, _I, _I, _I, _P, _P, _I, _I, _P],
    # a, d, out, rows, n, level, rec_lo, rec_hi, hlen, device, stream
    "pypwt_iswt1d": [_P, _P, _P, _I, _I, _I, _P, _P, _I, _I, _P],
    # x, a, h, v, d, batch, nr, nc, level, centre, dec_lo, dec_hi, hlen,
    # device, stream
    "pypwt_swt2d": [_P] * 5 + [_I] * 5 + [_P, _P, _I, _I, _P],
    # a, h, v, d, out, batch, nr, nc, level, centre, rec_lo, rec_hi, hlen,
    # device, stream
    "pypwt_iswt2d": [_P] * 5 + [_I] * 5 + [_P, _P, _I, _I, _P],
    # x, a, h, v, d, batch, nr, nc, level, centre, dec (4 hlen^2), hlen,
    # device, stream
    "pypwt_ns_swt2d": [_P] * 5 + [_I] * 5 + [_P, _I, _I, _P],
    # a, h, v, d, out, batch, nr, nc, level, centre, rec (4 hlen^2), hlen,
    # device, stream
    "pypwt_ins_swt2d": [_P] * 5 + [_I] * 5 + [_P, _I, _I, _P],
    # x, a, h, v, d, batch, nr, nc, dec (4 hlen^2), hlen, device, stream
    "pypwt_ns_dwt2d": [_P] * 5 + [_I] * 3 + [_P, _I, _I, _P],
    # a, h, v, d, out, batch, lr, lc, nr, nc, rec (4 hlen^2), hlen, device,
    # stream
    "pypwt_ins_dwt2d": [_P] * 5 + [_I] * 5 + [_P, _I, _I, _P],
    # x, a, h, v, d, batch, nr, nc, dec_lo, dec_hi, hlen, bf16, device,
    # stream
    "pypwt_tc_dwt2d": [_P] * 5 + [_I] * 3 + [_P, _P, _I, _I, _I, _P],
    # a, h, v, d, out, batch, lr, lc, rec_lo, rec_hi, hlen, bf16, device,
    # stream
    "pypwt_tc_idwt2d": [_P] * 5 + [_I] * 3 + [_P, _P, _I, _I, _I, _P],
    # x, a, h, v, d, batch, nr, nc, level, centre, dec_lo, dec_hi, hlen,
    # bf16, device, stream
    "pypwt_tc_swt2d": [_P] * 5 + [_I] * 5 + [_P, _P, _I, _I, _I, _P],
    # a, h, v, d, out, batch, nr, nc, level, centre, rec_lo, rec_hi, hlen,
    # bf16, device, stream
    "pypwt_tc_iswt2d": [_P] * 5 + [_I] * 5 + [_P, _P, _I, _I, _I, _P],
    # x, lo, hi, rows, n, dec_lo, dec_hi, hlen, bf16, device, stream
    "pypwt_tc_dwt1d": [_P] * 3 + [_I] * 2 + [_P, _P, _I, _I, _I, _P],
    # a, d, out, rows, len, rec_lo, rec_hi, hlen, bf16, device, stream
    "pypwt_tc_idwt1d": [_P] * 3 + [_I] * 2 + [_P, _P, _I, _I, _I, _P],
    # x, lo, hi, rows, n, level, centre, dec_lo, dec_hi, hlen, bf16, device,
    # stream
    "pypwt_tc_swt1d": [_P] * 3 + [_I] * 4 + [_P, _P, _I, _I, _I, _P],
    # a, d, out, rows, n, level, centre, rec_lo, rec_hi, hlen, bf16, device,
    # stream
    "pypwt_tc_iswt1d": [_P] * 3 + [_I] * 4 + [_P, _P, _I, _I, _I, _P],
    # filters, hlen, layout, out (host arrays of float64)
    "pypwt_ns_bank_f64": [_P, _I, _I, _P],
    # x, approx (host array of levels pointers), detail (host array of
    # 3 levels pointers), batch, nr, nc, levels, dec_lo, dec_hi, hlen,
    # device, stream
    "pypwt_wavedec2_pyramid": [_P] * 3 + [_I] * 4 + [_P, _P, _I, _I, _P],
    # out, approx, detail, batch, nr, nc, levels, rec_lo, rec_hi, hlen,
    # device, stream
    "pypwt_waverec2_pyramid": [_P] * 3 + [_I] * 4 + [_P, _P, _I, _I, _P],
    # the row-sharded levels (K26-K28); halos: host array of the eight
    # halo pointers (a_top, a_bot, h_top, h_bot, v_top, v_bot, d_top, d_bot)
    # x, top, bot, a, h, v, d, batch, nr, nc, lp, rp, dec_lo, dec_hi, hlen,
    # device, stream
    "pypwt_dwt2d_sharded": [_P] * 7 + [_I] * 5 + [_P, _P, _I, _I, _P],
    # a, h, v, d, halos, out, batch, lr, lc, lp, rp, rec_lo, rec_hi, hlen,
    # device, stream
    "pypwt_idwt2d_sharded": [_P] * 6 + [_I] * 5 + [_P, _P, _I, _I, _P],
    # x, top, bot, a, h, v, d, batch, nr, nc, level, centre, lp, rp, dec_lo,
    # dec_hi, hlen, device, stream
    "pypwt_swt2d_sharded": [_P] * 7 + [_I] * 7 + [_P, _P, _I, _I, _P],
    # a, h, v, d, halos, out, batch, nr, nc, level, centre, lp, rp, rec_lo,
    # rec_hi, hlen, device, stream
    "pypwt_iswt2d_sharded": [_P] * 6 + [_I] * 7 + [_P, _P, _I, _I, _P],
    # as pypwt_dwt2d_sharded, with bf16 before device
    "pypwt_tc_dwt2d_sharded": [_P] * 7 + [_I] * 5 + [_P, _P, _I, _I, _I, _P],
    "pypwt_tc_idwt2d_sharded": [_P] * 6 + [_I] * 5 + [_P, _P, _I, _I, _I, _P],
    "pypwt_tc_swt2d_sharded": [_P] * 7 + [_I] * 7 + [_P, _P, _I, _I, _I, _P],
    "pypwt_tc_iswt2d_sharded": [_P] * 6 + [_I] * 7 + [_P, _P, _I, _I, _I, _P],
    # hlen, bf16, halo, device, blocks (int*), smem (int*)
    "pypwt_tc_swt2d_occupancy": [_I] * 4 + [_P, _P],
    "pypwt_tc_iswt2d_occupancy": [_I] * 4 + [_P, _P],
    "pypwt_tc_dwt2d_occupancy": [_I] * 4 + [_P, _P],
    "pypwt_tc_idwt2d_occupancy": [_I] * 4 + [_P, _P],
    # nr, nc, level, centre, hlen, f64, halo, device, blocks (int*),
    # smem (int*), staged (int*)
    "pypwt_iswt2d_occupancy": [_I] * 8 + [_P] * 3,
    # nr, nc, level, centre, hlen, f64, device, blocks (int*), smem (int*),
    # tile rows (int*), tile columns (int*), staged (int*) (K18a, K18b)
    "pypwt_ns_swt2d_occupancy": [_I] * 7 + [_P] * 5,
    "pypwt_ins_swt2d_occupancy": [_I] * 7 + [_P] * 5,
    # nr, nc, hlen, f64, halo, device, blocks (int*), smem (int*), tile
    # rows (int*), tile columns (int*)
    "pypwt_idwt2d_occupancy": [_I] * 6 + [_P] * 4,
    "pypwt_dwt2d_occupancy": [_I] * 6 + [_P] * 4,
    # nr, nc, hlen, sr, sc, device, blocks (int*), smem (int*), tile rows
    # (int*), tile columns (int*) (K20)
    "pypwt_idwt2d_unshift_occupancy": [_I] * 6 + [_P] * 4,
    # the same for K19: nr, nc, hlen, sr, sc, device, then the four int
    # pointers
    "pypwt_dwt2d_shifted_occupancy": [_I] * 6 + [_P] * 4,
    # synthesis, rows, n, hlen, bf16, halo, device, blocks (int*),
    # smem (int*), grid (int*)
    "pypwt_tc_dwt1d_occupancy": [_I] * 7 + [_P] * 3,
    # synthesis, rows, n, level, hlen, bf16, device, blocks (int*), smem
    # (int*), grid (int*) (K12a / K12b)
    "pypwt_tc_swt1d_occupancy": [_I] * 7 + [_P] * 3,
    # synthesis, rows, n, level, hlen, f64, device, blocks (int*), smem
    # (int*), grid (int*) (K10a / K10b)
    "pypwt_swt1d_occupancy": [_I] * 7 + [_P] * 3,
    # synthesis, hlen, bf16, device, blocks (int*), smem (int*), tile rows
    # (int*), tile columns (int*) (K29g / K29h)
    "pypwt_tc_rows_occupancy": [_I] * 4 + [_P] * 4,
    # hlen, f64, device, blocks (int*), smem (int*), tile rows (int*), tile
    # columns (int*) (K29d)
    "pypwt_syn_rows_occupancy": [_I] * 3 + [_P] * 4,
    # the one-axis passes of the grid and sequence layouts (K29); halos:
    # host array of the four halo pointers (lo_before, lo_after, hi_before,
    # hi_after)
    # x, left, right, a, d, rows, n, lp, rp, dec_lo, dec_hi, hlen, device,
    # stream
    "pypwt_ana_lanes": [_P] * 5 + [_I] * 4 + [_P, _P, _I, _I, _P],
    # a, d, halos, out, rows, len, lp, rp, rec_lo, rec_hi, hlen, device,
    # stream
    "pypwt_syn_lanes": [_P] * 4 + [_I] * 4 + [_P, _P, _I, _I, _P],
    # x, top, bot, lo, hi, nr, nc, lp, rp, dec_lo, dec_hi, hlen, device,
    # stream
    "pypwt_ana_rows": [_P] * 5 + [_I] * 4 + [_P, _P, _I, _I, _P],
    # a, d, halos, out, len, nc, lp, rp, rec_lo, rec_hi, hlen, device,
    # stream
    "pypwt_syn_rows": [_P] * 4 + [_I] * 4 + [_P, _P, _I, _I, _P],
    # the same with bf16 before device (K29e-K29h)
    "pypwt_tc_ana_lanes": [_P] * 5 + [_I] * 4 + [_P, _P, _I, _I, _I, _P],
    "pypwt_tc_syn_lanes": [_P] * 4 + [_I] * 4 + [_P, _P, _I, _I, _I, _P],
    "pypwt_tc_ana_rows": [_P] * 5 + [_I] * 4 + [_P, _P, _I, _I, _I, _P],
    "pypwt_tc_syn_rows": [_P] * 4 + [_I] * 4 + [_P, _P, _I, _I, _I, _P],
}
# The float64 instances of the tap-loop kernels take the same arguments,
# with pointers to float64 data and taps (the non-separable ones: to the
# device copy of their bank's layout).
for _name in ("pypwt_dwt2d", "pypwt_idwt2d", "pypwt_dwt1d", "pypwt_idwt1d",
              "pypwt_swt1d", "pypwt_iswt1d", "pypwt_swt2d", "pypwt_iswt2d",
              "pypwt_ns_dwt2d", "pypwt_ins_dwt2d", "pypwt_ns_swt2d",
              "pypwt_ins_swt2d", "pypwt_dwt2d_sharded",
              "pypwt_idwt2d_sharded", "pypwt_swt2d_sharded",
              "pypwt_iswt2d_sharded", "pypwt_ana_lanes", "pypwt_syn_lanes",
              "pypwt_ana_rows", "pypwt_syn_rows"):
    _SIGNATURES[_name + "_f64"] = _SIGNATURES[_name]

_lib = None
# Wall seconds of the compile this process ran (None: loaded a cached
# build) and the compiler's output, for chip_smoke.py's report.
build_seconds = None
build_log = ""


def sources():
    return sorted(CSRC.glob("*.cu"))


def _source_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    return None


def library_path() -> Path:
    return BUILD_DIR / f"libpypwt_kernels-{_source_key()}.so"


def _compile(out: Path):
    global build_seconds, build_log
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    nvcc = _nvcc() or "nvcc"
    objs = [tmp.with_name(f"{tmp.name}.{s.stem}.o") for s in sources()]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                for s, o in zip(sources(), objs)]
    link = [nvcc, "-shared", "-o", str(tmp), *(str(o) for o in objs)]
    if _nvcc() is None:
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME): cannot build the CUDA "
            "kernels; tried: " + " ".join(compiles[0]))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in compiles]
        logs = [p.communicate()[0] for p in procs]
        build_log = "".join(logs)
        runs = [(cmd, p.returncode, log)
                for cmd, p, log in zip(compiles, procs, logs)]
        res = subprocess.run(link, capture_output=True, text=True)
        runs.append((link, res.returncode, res.stdout + res.stderr))
        for cmd, rc, log in runs:
            if rc != 0:
                raise RuntimeError(
                    f"nvcc failed (exit {rc}): {' '.join(cmd)}\n{log}")
        os.replace(tmp, out)
    finally:
        for o in (tmp, *objs):
            o.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0


def load_library():
    """The kernels' shared library, compiled first if no build of these
    sources exists."""
    global _lib
    if _lib is not None:
        return _lib
    out = library_path()
    if not out.exists():
        _compile(out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.pypwt_error_string.argtypes = [ctypes.c_int]
    lib.pypwt_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib
