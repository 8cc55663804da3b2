"""Build and load the hand-written CUDA level kernels.

The sources in ``pypwt_tpu_torch/csrc/`` are compiled by ``nvcc`` for
Hopper (``sm_90a``) into one shared library with a plain C interface,
loaded with ``ctypes``.  No PyTorch headers are involved, so a build takes
seconds.  The library lands in the git-ignored ``pypwt_tpu_torch/_build/``
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
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              # register / shared-memory report of each kernel, kept in
              # build_log (no effect on the code generated)
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C interface of csrc/*.cu: every pointer and the stream as c_void_p, so
# that ctypes does not cut them to 32 bits.
_SIGNATURES = {
    # x, a, h, v, d, batch, nr, nc, dec_lo, dec_hi, hlen, device, stream
    "pypwt_dwt2d": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _I, _I, _P],
    # a, h, v, d, out, batch, lr, lc, rec_lo, rec_hi, hlen, device, stream
    "pypwt_idwt2d": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _I, _I, _P],
}

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
    nvcc = _nvcc()
    cmd = [nvcc or "nvcc", *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in sources())]
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME): cannot build the CUDA "
            "kernels; tried: " + " ".join(cmd))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    build_log = res.stdout + res.stderr
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {res.returncode}): {' '.join(cmd)}\n"
            + build_log)
    os.replace(tmp, out)
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
