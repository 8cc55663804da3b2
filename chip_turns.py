"""Time the tensor-core 2D DWT analysis and synthesis, the tap-loop 2D
DWT synthesis or analysis, the row passes of the grid layout, or the
cycle-spin synthesis or analysis, of several source trees in turns, in one
process, on one NVIDIA GPU, or compare their kernels' machine code:

    python3 chip_turns.py [--only dwt|idwt|syn2d|ana2d|rows|spin|shift|nsswt|
        swt1d] [--banks B,...] [--levels L,...] PARENT_TREE TREE [TREE ...]
    python3 chip_turns.py --sass PARENT_TREE TREE [TREE ...]

A tree is a directory holding a ``pypwt_tpu_torch`` package: an unpacked
commit, or a copy whose ``csrc/`` holds a variant of a kernel. Each tree is
built by its own ``ops/_build.py`` (in a process of its own, all at once),
and its C entries are called through ctypes, so the timed code differs only
in the trees' sources. Timed (``--only dwt``: the analysis alone,
``idwt``: the synthesis alone): K5 (``pypwt_tc_dwt2d``) at levels 0-2 of a
2048^2 frame and K28's analysis (``pypwt_tc_dwt2d_sharded``) on shard 1 of
4 of an 8192^2 image (a 2048 x 8192 input); K6 (``pypwt_tc_idwt2d``) at
levels 0-2 of a 2048^2 frame and K28's synthesis
(``pypwt_tc_idwt2d_sharded``) on the same shard (a 2048 x 8192 output);
sym8, "highest" and "bf16". ``--only syn2d`` (not in the default run):
K2 (``pypwt_idwt2d``) at levels 0-2 of a 2048^2 frame and K26b
(``pypwt_idwt2d_sharded``) on the same shard, db2 and sym20, float32 and
float64. ``--only ana2d`` (not in the default run): K1 (``pypwt_dwt2d``)
at levels 0-2 of a 2048^2 frame and K26a (``pypwt_dwt2d_sharded``) on
the same shard (a 2048 x 8192 input), db2 and sym20, float32 and float64
(``--banks``: these banks instead, comma-separated). ``--only rows`` (not
in the default run): K29g (``pypwt_tc_ana_rows``) at levels 0-2 of one
4096^2 block of an 8192^2 image on a 2 x 2 grid (its column pass's
outputs, inputs of 4096 x 2048, 2048 x 1024 and 1024 x 512, with their
halo rows) and K29h (``pypwt_tc_syn_rows``) on the matching coefficients
(2048^2, 1024^2 and 512^2 of each plane), sym8 (``--banks``: these banks
instead), "highest" and "bf16", and the tap-loop K29d (``pypwt_syn_rows``)
on K29h's inputs, at the same banks and sym20, and at db4 in float64
(``pypwt_syn_rows_f64``); then, on every tree, K12a and K12b
(``pypwt_tc_swt1d``, ``pypwt_tc_iswt1d``) at levels 1-3 of the 2048 x 2048
sinogram, sym8, "highest" and "bf16". ``--only spin`` (not in the default run):
K20 (``pypwt_idwt2d_unshift``) at the levels of a 2048^2 frame that the
cycle spins give it (SPIN_LEVELS: the random spin's level 0 at shift (1,
1) with the accumulator and scale 0.25, its levels 1 and 2 at each pair of
phase bits, a static spin's level 0 at (5, 3) with the accumulator), db2,
sym8 and sym20 (``--banks``: these banks instead). ``--only shift`` (not
in the default run): K19 (``pypwt_dwt2d_shifted``) at the levels of a
2048^2 frame that the cycle spins give it (SHIFT_LEVELS: the random
spin's level 0 at shift (1, 1), soft-thresholded, its levels 1 and 2 at
each pair of phase bits but (0, 0), which is K1's, with no epilogue, a
static spin's level 0 at (3, 3), soft), db2, sym8 and sym20
(``--banks``: these banks instead). ``--only nsswt``
(not in the default run): K18a (``pypwt_ns_swt2d``,
``pypwt_ns_swt2d_f64``) and K18b (``pypwt_ins_swt2d``,
``pypwt_ins_swt2d_f64``) at levels 1-3 of a 2048^2 frame, float32 and
float64, on the custom 2D banks db3xcoif1 (db3 rows x coif1 columns, hlen
6) and dense8 (``--banks``: these instead; ``denseN`` is a dense random
N x N bank; ``--levels``: these levels instead), and the L3
non-separable SWT roundtrip of the frame on the first bank (3 K18a, then
3 K18b, float32). ``--only swt1d`` (not in the default run): K12a
(``pypwt_tc_swt1d``) and K12b (``pypwt_tc_iswt1d``) at levels 1-4 of the
2048 x 2048 sinogram (``--levels``: these levels instead), haar, db2,
sym8 and sym20 (``--banks``: these banks instead), and at levels 1-3 of
the (1, 4 Mi) signal, sym8, "highest" and "bf16", with each tree's
``pypwt_tc_swt1d_occupancy`` at those rows; first, the sinogram's sym8
L3 SWT roundtrip of mode "mxu" (3 K12a, then 3 K12b).
Device time by CUDA events behind a sleep kernel, the median of 21
samples of 10 launches, and the host time of one call (entry to return,
the device idle before it), the median of 21; the trees in order, then
in reverse, each the mean of its two medians. Each line also says
whether every tree's output is bit for bit the first tree's, and the
trees that report it print their
instances' occupancy (``pypwt_tc_dwt2d_occupancy``,
``pypwt_tc_idwt2d_occupancy``, ``pypwt_idwt2d_occupancy``,
``pypwt_dwt2d_occupancy``, ``pypwt_tc_rows_occupancy``,
``pypwt_syn_rows_occupancy``,
``pypwt_idwt2d_unshift_occupancy``, ``pypwt_dwt2d_shifted_occupancy``,
``pypwt_ns_swt2d_occupancy``,
``pypwt_ins_swt2d_occupancy``, ``pypwt_tc_swt1d_occupancy``: blocks per
SM, dynamic shared memory and,
for the tap loop, the row passes, K18a and K18b, the tile shape; K18a
and K18b also whether their windows are staged).

``--sass`` times nothing: it disassembles each tree's library
(``cuobjdump -sass``) and prints, for every kernel of the first tree,
whether its SASS is the same in every other tree (kernel names with the
anonymous namespace's per-file tag removed), and the kernels that only
the later trees have, each with the first tree's kernel whose SASS it
has where one of those lacking from its tree has it (a kernel whose
parameter types were renamed).
"""

import ctypes
import hashlib
import itertools
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 1234
FRAME = 2048                 # K6: coefficients of (FRAME >> level + 1)^2
SHARD = (1024, 4096)         # K28, K26b: coefficient rows and columns of a
                             # shard
N_SHARDS = 4
SAMPLES, REPS = 21, 10
SLEEP_CYCLES = 2_000_000
SYN2D_BANKS = ["db2", "sym20"]  # also the tap-loop analysis's (--banks)
ROWS_BANKS = ["sym8"]           # the row passes' (--banks)
SPIN_BANKS = ["db2", "sym8", "sym20"]  # K20's (--banks)
SHIFT_BANKS = ["db2", "sym8", "sym20"]  # K19's (--banks)
# K20's timed levels: (level of the 2048^2 frame, shift, accumulator): the
# random spin's level 0 (its phase bits (1, 1), accumulating) and levels
# 1-2 (each pair of phase bits, no accumulator), and a static spin's level
# 0 (its whole shift, accumulating)
SPIN_LEVELS = ([(0, (1, 1), True)]
               + [(lev, s, False) for lev in (1, 2)
                  for s in ((1, 0), (0, 1), (0, 0), (1, 1))]
               + [(0, (5, 3), True)])
# K19's timed levels: (level of the 2048^2 frame, shift, threshold mode):
# the random spin's level 0 (its phase bits (1, 1), soft) and levels 1-2
# (each pair of phase bits but (0, 0), which runs K1; no epilogue), and a
# static spin's level 0 (its whole shift, soft)
SHIFT_LEVELS = ([(0, (1, 1), 1)]
                + [(lev, s, 0) for lev in (1, 2)
                   for s in ((1, 0), (0, 1), (1, 1))]
                + [(0, (3, 3), 1)])
NSSWT_BANKS = ["db3xcoif1", "dense8"]  # K18a/K18b's (--banks)
NSSWT_LEVELS = [1, 2, 3]                # their levels (--levels)
ROWS_BLOCK = (4096, 4096)       # one block of an 8192^2 image on a 2 x 2 grid
K29D_BANKS = ["sym20"]          # K29d's rows beside ROWS_BANKS
ROWS_F64_BANKS = ["db4"]        # K29d's float64 rows
SINOGRAM = (2048, 2048)         # K12a/K12b's rows
SIGNAL = (1, 4 << 20)           # K12a/K12b's signal (K15's map)
SWT1D_BANKS = ["haar", "db2", "sym8", "sym20"]  # K12a/K12b's (--banks)
SWT1D_LEVELS = [1, 2, 3, 4]     # their sinogram levels (--levels)
SIGNAL_LEVELS = [1, 2, 3]       # their signal levels
SYN2D_TYPES = (torch.float32, torch.float64)
# entries that a parent tree's _build may not declare
ENTRY_TYPES = {
    "pypwt_idwt2d_occupancy": [ctypes.c_int] * 6 + [ctypes.c_void_p] * 4,
    "pypwt_dwt2d_occupancy": [ctypes.c_int] * 6 + [ctypes.c_void_p] * 4,
    "pypwt_idwt2d_unshift_occupancy": [ctypes.c_int] * 6
    + [ctypes.c_void_p] * 4,
    "pypwt_dwt2d_shifted_occupancy": [ctypes.c_int] * 6
    + [ctypes.c_void_p] * 4,
    "pypwt_tc_rows_occupancy": [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4,
    "pypwt_syn_rows_occupancy": [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4,
    "pypwt_ns_swt2d_occupancy": [ctypes.c_int] * 7 + [ctypes.c_void_p] * 5,
    "pypwt_tc_swt1d_occupancy": [ctypes.c_int] * 7 + [ctypes.c_void_p] * 3,
    "pypwt_ins_swt2d_occupancy": [ctypes.c_int] * 7
    + [ctypes.c_void_p] * 5}


def load(trees):
    """Each tree's built library, with the argument types of its entries."""
    build = ("import sys; sys.path.insert(0, '.'); "
             "from pypwt_tpu_torch.ops import _build; "
             "print(_build.load_library()._name)")
    procs = [subprocess.Popen([sys.executable, "-c", build], cwd=t,
                              stdout=subprocess.PIPE, text=True)
             for t in trees]
    outs = [p.communicate()[0] for p in procs]
    sys.path.insert(0, str(Path(trees[0]).resolve()))
    from pypwt_tpu_torch.ops import _build
    libs = []
    for tree, proc, out in zip(trees, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"the build of {tree} failed")
        lib = ctypes.CDLL(out.strip().splitlines()[-1])
        for name in ("pypwt_tc_dwt2d", "pypwt_tc_dwt2d_sharded",
                     "pypwt_tc_idwt2d", "pypwt_tc_idwt2d_sharded",
                     "pypwt_tc_dwt2d_occupancy",
                     "pypwt_tc_idwt2d_occupancy", "pypwt_idwt2d",
                     "pypwt_idwt2d_f64", "pypwt_idwt2d_sharded",
                     "pypwt_idwt2d_sharded_f64", "pypwt_idwt2d_occupancy",
                     "pypwt_dwt2d", "pypwt_dwt2d_f64",
                     "pypwt_dwt2d_sharded", "pypwt_dwt2d_sharded_f64",
                     "pypwt_dwt2d_occupancy", "pypwt_tc_ana_rows",
                     "pypwt_tc_syn_rows", "pypwt_tc_rows_occupancy",
                     "pypwt_idwt2d_unshift",
                     "pypwt_idwt2d_unshift_occupancy", "pypwt_dwt2d_shifted",
                     "pypwt_dwt2d_shifted_occupancy", "pypwt_syn_rows",
                     "pypwt_syn_rows_f64", "pypwt_syn_rows_occupancy",
                     "pypwt_tc_swt1d", "pypwt_tc_iswt1d",
                     "pypwt_tc_swt1d_occupancy",
                     "pypwt_ns_swt2d",
                     "pypwt_ns_swt2d_f64", "pypwt_ns_swt2d_occupancy",
                     "pypwt_ins_swt2d", "pypwt_ins_swt2d_f64",
                     "pypwt_ins_swt2d_occupancy"):
            if hasattr(lib, name):
                getattr(lib, name).argtypes = _build._SIGNATURES.get(
                    name, ENTRY_TYPES.get(
                        name, [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2))
                getattr(lib, name).restype = ctypes.c_int
        libs.append(lib)
    return libs


def cases(port, dev, only):
    """name -> (call(lib, i, variant), variants): one launch on input set
    i, which returns its output (a list of the four subbands of an
    analysis); the variants are the precisions ("highest" 0, "bf16" 1) of
    a tensor-core case, none (None) of a tap-loop one."""
    fd = port.ops.fused_dwt
    fb = port.get_filter_bank("sym8")
    lo, hi = fd._host_taps(fb.rec_lo), fd._host_taps(fb.rec_hi)
    dlo, dhi = fd._host_taps(fb.dec_lo), fd._host_taps(fb.dec_hi)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def rand(shape, dtype=torch.float32):
        return torch.rand(shape, generator=gen, device=dev, dtype=dtype) * 255

    def k5(level):
        n = FRAME >> level
        sets = [rand((n, n)) for _ in range(4)]
        out = [torch.empty((n // 2, n // 2), device=dev) for _ in range(4)]

        def call(lib, i, bf16):
            err = lib.pypwt_tc_dwt2d(
                sets[i % 4].data_ptr(), *(o.data_ptr() for o in out), 1, n,
                n, dlo.ctypes.data, dhi.ctypes.data, fb.hlen, bf16,
                dev.index, stream)
            if err:
                raise RuntimeError(f"K5 level {level}: error {err}")
            return out
        return call

    def k28_dwt():
        nr, nc = 2 * SHARD[0], 2 * SHARD[1]
        top, bot = fd.halo_heights("dwt", fb, 0)
        rows = torch.arange(nr - top, 2 * nr + bot, device=dev) % (
            N_SHARDS * nr)
        sets = []
        for _ in range(2):
            ext = rand((N_SHARDS * nr, nc)).index_select(0, rows)
            sets.append([ext[top:top + nr].contiguous(),
                         ext[:top].contiguous(),
                         ext[top + nr:].contiguous()])
            del ext
        out = [torch.empty(SHARD, device=dev) for _ in range(4)]

        def call(lib, i, bf16):
            body, up, down = sets[i % 2]
            err = lib.pypwt_tc_dwt2d_sharded(
                body.data_ptr(), up.data_ptr(), down.data_ptr(),
                *(o.data_ptr() for o in out), 1, nr, nc, top, bot,
                dlo.ctypes.data, dhi.ctypes.data, fb.hlen, bf16, dev.index,
                stream)
            if err:
                raise RuntimeError(f"K28 dwt: error {err}")
            return out
        return call

    def k6(level):
        n = FRAME >> (level + 1)
        sets = [[rand((n, n)) for _ in range(4)] for _ in range(4)]
        out = torch.empty((2 * n, 2 * n), device=dev)

        def call(lib, i, bf16):
            err = lib.pypwt_tc_idwt2d(
                *(p.data_ptr() for p in sets[i % 4]), out.data_ptr(), 1, n,
                n, lo.ctypes.data, hi.ctypes.data, fb.hlen, bf16, dev.index,
                stream)
            if err:
                raise RuntimeError(f"K6 level {level}: error {err}")
            return out
        return call

    def k28():
        lr, lc = SHARD
        top, bot = fd.halo_heights("idwt", fb, lr)
        rows = torch.arange(lr - top, 2 * lr + bot, device=dev) % (
            N_SHARDS * lr)
        sets = []
        for _ in range(2):
            body, halos = [], []
            for _ in range(4):
                ext = rand((N_SHARDS * lr, lc)).index_select(0, rows)
                body.append(ext[top:top + lr].contiguous())
                halos += [ext[:top].contiguous(),
                          ext[top + lr:].contiguous()]
            sets.append((body, halos, fd.halo_array(halos)))
        out = torch.empty((2 * lr, 2 * lc), device=dev)

        def call(lib, i, bf16):
            body, _, ptrs = sets[i % 2]
            err = lib.pypwt_tc_idwt2d_sharded(
                *(p.data_ptr() for p in body), ctypes.addressof(ptrs),
                out.data_ptr(), 1, lr, lc, top, bot, lo.ctypes.data,
                hi.ctypes.data, fb.hlen, bf16, dev.index, stream)
            if err:
                raise RuntimeError(f"K28 idwt: error {err}")
            return out
        return call

    def entry(lib, name, dtype):
        return getattr(lib, name + ("_f64" if dtype == torch.float64
                                    else ""))

    def host_taps(f, dtype):
        return fd._host_taps(f, "float64" if dtype == torch.float64
                             else "float32")

    def k2(wname, level, dtype):
        fbw = port.get_filter_bank(wname)
        lo2, hi2 = host_taps(fbw.rec_lo, dtype), host_taps(fbw.rec_hi, dtype)
        n = FRAME >> (level + 1)
        sets = [[rand((n, n), dtype) for _ in range(4)] for _ in range(4)]
        out = torch.empty((2 * n, 2 * n), device=dev, dtype=dtype)

        def call(lib, i, _):
            err = entry(lib, "pypwt_idwt2d", dtype)(
                *(p.data_ptr() for p in sets[i % 4]), out.data_ptr(), 1, n,
                n, 2 * n, 2 * n, lo2.ctypes.data, hi2.ctypes.data, fbw.hlen,
                dev.index, stream)
            if err:
                raise RuntimeError(f"K2 level {level}: error {err}")
            return out
        return call

    def k26b(wname, dtype):
        fbw = port.get_filter_bank(wname)
        lo2, hi2 = host_taps(fbw.rec_lo, dtype), host_taps(fbw.rec_hi, dtype)
        lr, lc = SHARD
        top, bot = fd.halo_heights("idwt", fbw, lr)
        rows = torch.arange(lr - top, 2 * lr + bot, device=dev) % (
            N_SHARDS * lr)
        sets = []
        for _ in range(2):
            body, halos = [], []
            for _ in range(4):
                ext = rand((N_SHARDS * lr, lc), dtype).index_select(0, rows)
                body.append(ext[top:top + lr].contiguous())
                halos += [ext[:top].contiguous(),
                          ext[top + lr:].contiguous()]
            sets.append((body, halos, fd.halo_array(halos)))
        out = torch.empty((2 * lr, 2 * lc), device=dev, dtype=dtype)

        def call(lib, i, _):
            body, _, ptrs = sets[i % 2]
            err = entry(lib, "pypwt_idwt2d_sharded", dtype)(
                *(p.data_ptr() for p in body), ctypes.addressof(ptrs),
                out.data_ptr(), 1, lr, lc, top, bot, lo2.ctypes.data,
                hi2.ctypes.data, fbw.hlen, dev.index, stream)
            if err:
                raise RuntimeError(f"K26b: error {err}")
            return out
        return call

    def k1(wname, level, dtype):
        fbw = port.get_filter_bank(wname)
        lo2, hi2 = host_taps(fbw.dec_lo, dtype), host_taps(fbw.dec_hi, dtype)
        n = FRAME >> level
        sets = [rand((n, n), dtype) for _ in range(4)]
        out = [torch.empty((n // 2, n // 2), device=dev, dtype=dtype)
               for _ in range(4)]

        def call(lib, i, _):
            err = entry(lib, "pypwt_dwt2d", dtype)(
                sets[i % 4].data_ptr(), *(o.data_ptr() for o in out), 1, n,
                n, lo2.ctypes.data, hi2.ctypes.data, fbw.hlen, dev.index,
                stream)
            if err:
                raise RuntimeError(f"K1 level {level}: error {err}")
            return out
        return call

    def k26a(wname, dtype):
        fbw = port.get_filter_bank(wname)
        lo2, hi2 = host_taps(fbw.dec_lo, dtype), host_taps(fbw.dec_hi, dtype)
        nr, nc = 2 * SHARD[0], 2 * SHARD[1]
        top, bot = fd.halo_heights("dwt", fbw, 0)
        rows = torch.arange(nr - top, 2 * nr + bot, device=dev) % (
            N_SHARDS * nr)
        sets = []
        for _ in range(2):
            ext = rand((N_SHARDS * nr, nc), dtype).index_select(0, rows)
            sets.append([ext[top:top + nr].contiguous(),
                         ext[:top].contiguous(),
                         ext[top + nr:].contiguous()])
            del ext
        out = [torch.empty(SHARD, device=dev, dtype=dtype) for _ in range(4)]

        def call(lib, i, _):
            body, up, down = sets[i % 2]
            err = entry(lib, "pypwt_dwt2d_sharded", dtype)(
                body.data_ptr(), up.data_ptr(), down.data_ptr(),
                *(o.data_ptr() for o in out), 1, nr, nc, top, bot,
                lo2.ctypes.data, hi2.ctypes.data, fbw.hlen, dev.index,
                stream)
            if err:
                raise RuntimeError(f"K26a: error {err}")
            return out
        return call

    def block_halos(planes, before, after):
        """Each (rows, nc) plane as the middle of three blocks along axis
        -2 of a 2-block column (the blocks above and below it wrap to the
        other block): (plane, its rows above, its rows below)."""
        out = []
        for g in planes:
            n = g.shape[0]
            rows = torch.arange(n - before, 2 * n + after, device=dev) % (
                2 * n)
            ext = torch.cat([g, rand(g.shape)]).index_select(0, rows)
            out.append([ext[before:before + n].contiguous(),
                        ext[:before].contiguous(),
                        ext[before + n:].contiguous()])
        return out

    def k29g(wname, level):
        fbw = port.get_filter_bank(wname)
        lo2, hi2 = fd._host_taps(fbw.dec_lo), fd._host_taps(fbw.dec_hi)
        nr, nc = ROWS_BLOCK[0] >> level, ROWS_BLOCK[1] >> (level + 1)
        top, bot = fd.one_axis_pads("ana", fbw, 0)
        sets = block_halos([rand((nr, nc)) for _ in range(2)], top, bot)
        out = [torch.empty((nr // 2, nc), device=dev) for _ in range(2)]

        def call(lib, i, bf16):
            body, up, down = sets[i % 2]
            err = lib.pypwt_tc_ana_rows(
                body.data_ptr(), up.data_ptr(), down.data_ptr(),
                *(o.data_ptr() for o in out), nr, nc, top, bot,
                lo2.ctypes.data, hi2.ctypes.data, fbw.hlen, bf16, dev.index,
                stream)
            if err:
                raise RuntimeError(f"K29g level {level}: error {err}")
            return out
        return call

    def k29h(wname, level):
        fbw = port.get_filter_bank(wname)
        lo2, hi2 = fd._host_taps(fbw.rec_lo), fd._host_taps(fbw.rec_hi)
        n, nc = ROWS_BLOCK[0] >> (level + 1), ROWS_BLOCK[1] >> (level + 1)
        top, bot = fd.one_axis_pads("syn", fbw, n)
        sets = []
        for _ in range(2):
            (a, at, ab), (d, dt, db) = block_halos(
                [rand((n, nc)) for _ in range(2)], top, bot)
            sets.append((a, d, (at, ab, dt, db),
                         fd.halo_array((at, ab, dt, db))))
        out = torch.empty((2 * n, nc), device=dev)

        def call(lib, i, bf16):
            a, d, _, ptrs = sets[i % 2]
            err = lib.pypwt_tc_syn_rows(
                a.data_ptr(), d.data_ptr(), ctypes.addressof(ptrs),
                out.data_ptr(), n, nc, top, bot, lo2.ctypes.data,
                hi2.ctypes.data, fbw.hlen, bf16, dev.index, stream)
            if err:
                raise RuntimeError(f"K29h level {level}: error {err}")
            return out
        return call

    def k29d(wname, level, dtype=torch.float32):
        fbw = port.get_filter_bank(wname)
        lo2, hi2 = (fd._host_taps(f, np.float64 if dtype == torch.float64
                                  else np.float32)
                    for f in (fbw.rec_lo, fbw.rec_hi))
        n, nc = ROWS_BLOCK[0] >> (level + 1), ROWS_BLOCK[1] >> (level + 1)
        top, bot = fd.one_axis_pads("syn", fbw, n)
        sets = []
        for _ in range(2):
            (a, at, ab), (d, dt, db) = (
                [t.to(dtype) for t in part] for part in block_halos(
                    [rand((n, nc)) for _ in range(2)], top, bot))
            sets.append((a, d, fd.halo_array((at, ab, dt, db)),
                         (at, ab, dt, db)))
        out = torch.empty((2 * n, nc), device=dev, dtype=dtype)
        entry = ("pypwt_syn_rows" if dtype == torch.float32
                 else "pypwt_syn_rows_f64")

        def call(lib, i, _):
            a, d, ptrs, _ = sets[i % 2]
            err = getattr(lib, entry)(
                a.data_ptr(), d.data_ptr(), ctypes.addressof(ptrs),
                out.data_ptr(), n, nc, top, bot, lo2.ctypes.data,
                hi2.ctypes.data, fbw.hlen, dev.index, stream)
            if err:
                raise RuntimeError(f"K29d level {level}: error {err}")
            return out
        return call

    def k12a(wname, level, shape=SINOGRAM):
        fbw = port.get_filter_bank(wname)
        lo2, hi2 = fd._host_taps(fbw.dec_lo), fd._host_taps(fbw.dec_hi)
        xs = [rand(shape) for _ in range(2)]
        out = [torch.empty(shape, device=dev) for _ in range(2)]

        def call(lib, i, bf16):
            err = lib.pypwt_tc_swt1d(
                xs[i % 2].data_ptr(), *(o.data_ptr() for o in out),
                shape[0], shape[1], level,
                port.conv.swt_centre(fbw.hlen, False), lo2.ctypes.data,
                hi2.ctypes.data, fbw.hlen, bf16, dev.index, stream)
            if err:
                raise RuntimeError(f"K12a level {level}: error {err}")
            return out
        return call

    def k12b(wname, level, shape=SINOGRAM):
        fbw = port.get_filter_bank(wname)
        lo2, hi2 = fd._host_taps(fbw.rec_lo), fd._host_taps(fbw.rec_hi)
        sets = [[rand(shape) for _ in range(2)] for _ in range(2)]
        out = torch.empty(shape, device=dev)

        def call(lib, i, bf16):
            a, d = sets[i % 2]
            err = lib.pypwt_tc_iswt1d(
                a.data_ptr(), d.data_ptr(), out.data_ptr(), shape[0],
                shape[1], level, port.conv.swt_centre(fbw.hlen, True),
                lo2.ctypes.data, hi2.ctypes.data, fbw.hlen, bf16, dev.index,
                stream)
            if err:
                raise RuntimeError(f"K12b level {level}: error {err}")
            return out
        return call

    def k12_roundtrip():
        """The sym8 L3 SWT roundtrip of the sinogram in mode "mxu": K12a at
        levels 1-3, each on the approximation before, then K12b at levels
        3-1 (3 + 3 launches)."""
        fbw = port.get_filter_bank("sym8")
        dec = [fd._host_taps(f) for f in (fbw.dec_lo, fbw.dec_hi)]
        rec = [fd._host_taps(f) for f in (fbw.rec_lo, fbw.rec_hi)]
        xs = [rand(SINOGRAM) for _ in range(2)]
        levels = [[torch.empty(SINOGRAM, device=dev) for _ in range(2)]
                  for _ in range(3)]
        outs = [torch.empty(SINOGRAM, device=dev) for _ in range(3)]

        def call(lib, i, bf16):
            x, err = xs[i % 2], 0
            for lev, (a, d) in enumerate(levels, 1):
                err = err or lib.pypwt_tc_swt1d(
                    x.data_ptr(), a.data_ptr(), d.data_ptr(), *SINOGRAM, lev,
                    port.conv.swt_centre(fbw.hlen, False),
                    *(t.ctypes.data for t in dec), fbw.hlen, bf16, dev.index,
                    stream)
                x = a
            for lev in (3, 2, 1):
                err = err or lib.pypwt_tc_iswt1d(
                    x.data_ptr(), levels[lev - 1][1].data_ptr(),
                    outs[lev - 1].data_ptr(), *SINOGRAM, lev,
                    port.conv.swt_centre(fbw.hlen, True),
                    *(t.ctypes.data for t in rec), fbw.hlen, bf16, dev.index,
                    stream)
                x = outs[lev - 1]
            if err:
                raise RuntimeError(f"K12 roundtrip: error {err}")
            return x
        return call

    def k19(wname, level, shift, mode):
        fbw = port.get_filter_bank(wname)
        lo2, hi2 = fd._host_taps(fbw.dec_lo), fd._host_taps(fbw.dec_hi)
        n = FRAME >> level
        sets = [rand((n, n)) for _ in range(4)]
        out = [torch.empty((n // 2, n // 2), device=dev) for _ in range(4)]
        sr, sc = shift

        def call(lib, i, _):
            err = lib.pypwt_dwt2d_shifted(
                sets[i % 4].data_ptr(), *(o.data_ptr() for o in out), 1, n,
                n, sr, sc, mode, 0.3 * 255, lo2.ctypes.data,
                hi2.ctypes.data, fbw.hlen, dev.index, stream)
            if err:
                raise RuntimeError(f"K19 level {level}: error {err}")
            return out
        return call

    def k20(wname, level, shift, acc):
        fbw = port.get_filter_bank(wname)
        lo2, hi2 = fd._host_taps(fbw.rec_lo), fd._host_taps(fbw.rec_hi)
        n = FRAME >> (level + 1)
        sets = [[rand((n, n)) for _ in range(4)] for _ in range(4)]
        accs = [rand((2 * n, 2 * n)) for _ in range(2)] if acc else [None]
        out = torch.empty((2 * n, 2 * n), device=dev)
        sr, sc = shift

        def call(lib, i, _):
            a = accs[i % len(accs)]
            err = lib.pypwt_idwt2d_unshift(
                *(p.data_ptr() for p in sets[i % 4]),
                None if a is None else a.data_ptr(), out.data_ptr(), 1, n, n,
                2 * n, 2 * n, sr, sc, 0.25 if acc else 1.0, lo2.ctypes.data,
                hi2.ctypes.data, fbw.hlen, dev.index, stream)
            if err:
                raise RuntimeError(f"K20 level {level}: error {err}")
            return out
        return call

    def k18(bname, level, dtype, synthesis):
        dec, rec = ns_bank(port, bname)
        hlen = dec.shape[-1]
        centre = port.conv.swt_centre(hlen, synthesis)
        n = FRAME
        if dtype == torch.float64:
            # pypwt_ns_bank_f64's layout 3 ([k][l][b], x 1/4) or 2 (K18a,
            # [k][l][b]) on the device
            scaled = 0.25 * rec if synthesis else dec
            keep = torch.from_numpy(np.ascontiguousarray(
                scaled.reshape(4, -1).T.reshape(-1))).to(dev)
            ptr = keep.data_ptr()
        else:
            keep = np.ascontiguousarray(
                (rec if synthesis else dec).astype(np.float32))
            ptr = keep.ctypes.data
        sets = [[rand((n, n), dtype) for _ in range(4 if synthesis else 1)]
                for _ in range(2)]
        outs = [torch.empty((n, n), device=dev, dtype=dtype)
                for _ in range(1 if synthesis else 4)]

        def call(lib, i, _):
            if synthesis:
                err = entry(lib, "pypwt_ins_swt2d", dtype)(
                    *(p.data_ptr() for p in sets[i % 2]),
                    outs[0].data_ptr(), 1, n, n, level, centre, ptr, hlen,
                    dev.index, stream)
            else:
                err = entry(lib, "pypwt_ns_swt2d", dtype)(
                    sets[i % 2][0].data_ptr(), *(o.data_ptr() for o in outs),
                    1, n, n, level, centre, ptr, hlen, dev.index, stream)
            if err:
                raise RuntimeError(f"K18 level {level}: error {err}")
            return outs[0] if synthesis else outs
        call.bank = keep  # alive as long as the call
        return call

    def k18_roundtrip(bname):
        """The L3 non-separable SWT roundtrip of a frame: K18a at levels
        1-3, each on the approximation before, then K18b at levels 3-1."""
        dec, rec = ns_bank(port, bname)
        hlen = dec.shape[-1]
        dec32, rec32 = (np.ascontiguousarray(f.astype(np.float32))
                        for f in (dec, rec))
        frames = [rand((FRAME, FRAME)) for _ in range(2)]
        levels = [[torch.empty((FRAME, FRAME), device=dev) for _ in range(4)]
                  for _ in range(3)]
        outs = [torch.empty((FRAME, FRAME), device=dev) for _ in range(3)]

        def call(lib, i, _):
            x, err = frames[i % 2], 0
            for lev, planes in enumerate(levels, 1):
                err = err or lib.pypwt_ns_swt2d(
                    x.data_ptr(), *(p.data_ptr() for p in planes), 1, FRAME,
                    FRAME, lev, port.conv.swt_centre(hlen, False),
                    dec32.ctypes.data, hlen, dev.index, stream)
                x = planes[0]
            for lev in (3, 2, 1):
                _, h, v, d = levels[lev - 1]
                err = err or lib.pypwt_ins_swt2d(
                    x.data_ptr(), h.data_ptr(), v.data_ptr(), d.data_ptr(),
                    outs[lev - 1].data_ptr(), 1, FRAME, FRAME, lev,
                    port.conv.swt_centre(hlen, True), rec32.ctypes.data,
                    hlen, dev.index, stream)
                x = outs[lev - 1]
            if err:
                raise RuntimeError(f"K18 roundtrip: error {err}")
            return x
        call.banks = (dec32, rec32)  # alive as long as the call
        return call

    got = {}
    precisions = (0, 1)
    if only in (None, "dwt"):
        got.update({f"K5 level {lev} sym8": (k5(lev), precisions)
                    for lev in (0, 1, 2)})
        got["K28 dwt shard sym8"] = (k28_dwt(), precisions)
    if only in (None, "idwt"):
        got.update({f"K6 level {lev} sym8": (k6(lev), precisions)
                    for lev in (0, 1, 2)})
        got["K28 idwt shard sym8"] = (k28(), precisions)
    if only == "syn2d":
        for wname in SYN2D_BANKS:
            for dtype in SYN2D_TYPES:
                kind = str(dtype)[6:]
                got.update({f"K2 level {lev} {wname} {kind}":
                            (k2(wname, lev, dtype), (None,))
                            for lev in (0, 1, 2)})
                got[f"K26b shard {wname} {kind}"] = (k26b(wname, dtype),
                                                     (None,))
    if only == "ana2d":
        for wname in SYN2D_BANKS:
            for dtype in SYN2D_TYPES:
                kind = str(dtype)[6:]
                got.update({f"K1 level {lev} {wname} {kind}":
                            (k1(wname, lev, dtype), (None,))
                            for lev in (0, 1, 2)})
                got[f"K26a shard {wname} {kind}"] = (k26a(wname, dtype),
                                                     (None,))
    if only == "rows":
        for wname in ROWS_BANKS:
            for key, make in (("K29g", k29g), ("K29h", k29h)):
                got.update({f"{key} level {lev} {wname}":
                            (make(wname, lev), precisions)
                            for lev in (0, 1, 2)})
        for wname in dict.fromkeys(ROWS_BANKS + K29D_BANKS):
            got.update({f"K29d level {lev} {wname}": (k29d(wname, lev),
                                                      (None,))
                        for lev in (0, 1, 2)})
        for wname in ROWS_F64_BANKS:
            got.update({f"K29d level {lev} {wname} float64": (
                k29d(wname, lev, torch.float64), (None,))
                for lev in (0, 1, 2)})
        for lev in (1, 2, 3):
            for key, make in (("K12a", k12a), ("K12b", k12b)):
                got[f"{key} sinogram level {lev} sym8"] = (make("sym8", lev),
                                                           precisions)
    if only == "swt1d":
        got["K12 sinogram SWT L3 roundtrip sym8"] = (k12_roundtrip(),
                                                     precisions)
        for wname in SWT1D_BANKS:
            for lev in SWT1D_LEVELS:
                for key, make in (("K12a", k12a), ("K12b", k12b)):
                    got[f"{key} sinogram level {lev} {wname}"] = (
                        make(wname, lev), precisions)
        for lev in SIGNAL_LEVELS:
            for key, make in (("K12a", k12a), ("K12b", k12b)):
                got[f"{key} signal level {lev} sym8"] = (
                    make("sym8", lev, SIGNAL), precisions)
    if only == "spin":
        for wname in SPIN_BANKS:
            for lev, shift, acc in SPIN_LEVELS:
                got[f"K20 level {lev} {wname} {shift}"
                    + (" acc" if acc else "")] = (k20(wname, lev, shift, acc),
                                                  (None,))
    if only == "shift":
        for wname in SHIFT_BANKS:
            for lev, shift, mode in SHIFT_LEVELS:
                got[f"K19 level {lev} {wname} {shift}"
                    + (" soft" if mode else "")] = (
                        k19(wname, lev, shift, mode), (None,))
    if only == "nsswt":
        got[f"K18 L3 roundtrip {NSSWT_BANKS[0]} float32"] = (
            k18_roundtrip(NSSWT_BANKS[0]), (None,))
        for bname in NSSWT_BANKS:
            for lev in NSSWT_LEVELS:
                for dtype in SYN2D_TYPES:
                    got[f"K18a level {lev} {bname} {str(dtype)[6:]}"] = (
                        k18(bname, lev, dtype, False), (None,))
                    got[f"K18b level {lev} {bname} {str(dtype)[6:]}"] = (
                        k18(bname, lev, dtype, True), (None,))
    return got, fb.hlen


def ns_bank(port, name):
    """(dec, rec) of a custom 2D bank, each (4, hlen, hlen) float64:
    db3xcoif1 (db3 along axis -2 x coif1 along the last axis, the a, h, v,
    d outer products) or denseN (dense random taps, seeded)."""
    if name == "db3xcoif1":
        fr, fc = port.get_filter_bank("db3"), port.get_filter_bank("coif1")
        parts = (("lo", "lo"), ("hi", "lo"), ("lo", "hi"), ("hi", "hi"))
        return tuple(np.stack([np.outer(getattr(fr, f"{kind}_{p}"),
                                        getattr(fc, f"{kind}_{q}"))
                               for p, q in parts])
                     for kind in ("dec", "rec"))
    n = int(name.removeprefix("dense"))
    rng = np.random.default_rng(SEED + n)
    return tuple(rng.random((4, n, n)) / (n * n) for _ in range(2))


def flat(out):
    """One tensor of a call's output or outputs."""
    return torch.stack(out) if isinstance(out, list) else out


def ms(call, lib, bf16):
    for i in range(3):
        call(lib, i, bf16)
    torch.cuda.synchronize()
    times = []
    for _ in range(SAMPLES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for i in range(REPS):
            call(lib, i, bf16)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / REPS)
    return statistics.median(times)


def host_ms(call, lib, bf16):
    """Host time (ms) of one call from entry to return, the device idle
    before it: what a launch costs the host. The median of SAMPLES."""
    times = []
    for i in range(SAMPLES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call(lib, i, bf16)
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e3


def strip_anonymous(name):
    """A mangled name with each anonymous namespace component (whose tag
    differs from build to build) replaced by the component "anon"."""
    while m := re.search(r"(\d+)_GLOBAL__N_", name):
        end = m.start() + len(m.group(1)) + int(m.group(1))
        name = name[:m.start()] + "4anon" + name[end:]
    return name


def sass_of(path):
    """{kernel name: SASS text} of a shared library, each line's runs of
    blanks made one (cuobjdump pads its columns to the widest instruction
    of the whole library)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    kernels = {}
    for part in text.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        body = body.split("Fatbin ")[0]  # the next cubin's header
        kernels[strip_anonymous(name.strip())] = "\n".join(
            " ".join(line.split()) for line in body.strip().splitlines())
    return kernels


def demangle(names):
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    if tool is None:
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True).stdout.splitlines()
    return out if len(out) == len(names) else list(names)


def print_sass(trees, libs):
    """Each kernel of the first tree: the same SASS in every later tree, or
    which trees differ or lack it; then the later trees' new kernels."""
    sass = [sass_of(lib._name) for lib in libs]
    names = sorted(sass[0])
    same = 0
    for name, shown in zip(names, demangle(names)):
        differ = [t for t, k in zip(trees[1:], sass[1:])
                  if name in k and k[name] != sass[0][name]]
        missing = [t for t, k in zip(trees[1:], sass[1:]) if name not in k]
        state = ("same" if not differ and not missing else
                 "; ".join(s for s in (
                     differ and "differs in " + ", ".join(differ),
                     missing and "missing in " + ", ".join(missing)) if s))
        same += state == "same"
        print(f"sass {shown}: {state}")
    renamed = 0
    for tree, k in zip(trees[1:], sass[1:]):
        new = sorted(set(k) - set(sass[0]))
        gone = {sass[0][n]: n for n in names if n not in k}
        for name, shown in zip(new, demangle(new)):
            old = gone.get(k[name])
            if old is None:
                print(f"sass {shown}: only in {tree}")
            else:
                renamed += 1
                print(f"sass {shown}: only in {tree}, the SASS of the first "
                      f"tree's {demangle([old])[0]}")
    print(f"sass: {same} of the first tree's {len(names)} kernels the same "
          f"in every tree; {renamed} of the later trees' kernels the SASS of "
          "one of its kernels under another name")


def main():
    trees, only = sys.argv[1:], None
    if trees[:1] == ["--sass"]:
        trees = trees[1:]
        if len(trees) < 2:
            print("usage: python3 chip_turns.py --sass PARENT_TREE TREE "
                  "[TREE ...]", file=sys.stderr)
            sys.exit(2)
        print_sass(trees, load(trees))
        return
    if trees[:1] == ["--only"]:
        only, trees = (trees[1:2] or [""])[0], trees[2:]
    if trees[:1] == ["--banks"] and only in ("syn2d", "ana2d", "rows",
                                             "spin", "shift", "nsswt",
                                             "swt1d"):
        banks = {"rows": ROWS_BANKS, "spin": SPIN_BANKS,
                 "shift": SHIFT_BANKS, "nsswt": NSSWT_BANKS,
                 "swt1d": SWT1D_BANKS}.get(only, SYN2D_BANKS)
        banks[:] = (trees[1:2] or [""])[0].split(",")
        trees = trees[2:]
    if trees[:1] == ["--levels"] and only in ("nsswt", "swt1d"):
        levels = NSSWT_LEVELS if only == "nsswt" else SWT1D_LEVELS
        levels[:] = [int(v) for v in (trees[1:2] or [""])[0].split(",")]
        trees = trees[2:]
    if len(trees) < 2 or only not in (None, "dwt", "idwt", "syn2d",
                                      "ana2d", "rows", "spin", "shift",
                                      "nsswt", "swt1d"):
        print("usage: python3 chip_turns.py [--only dwt|idwt|syn2d|ana2d|"
              "rows|spin|shift|nsswt|swt1d] [--banks B,...] "
              "[--levels L,... (nsswt, swt1d)] "
              "PARENT_TREE TREE [TREE ...]", file=sys.stderr)
        sys.exit(2)
    if not torch.cuda.is_available():
        print("chip_turns: torch.cuda.is_available() is False: this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(1)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    libs = load(trees)
    import pypwt_tpu_torch as port
    dev = torch.device("cuda", 0)
    calls, hlen = cases(port, dev, only)
    queries = [(entry, key) for entry, key, kind in (
        ("pypwt_tc_dwt2d_occupancy", ("K5", "K28 dwt"), "dwt"),
        ("pypwt_tc_idwt2d_occupancy", ("K6", "K28 idwt"), "idwt"))
        if only in (None, kind)]
    for tree, lib in zip(trees, libs):
        for entry, key in queries:
            if not hasattr(lib, entry):
                continue
            for halo in (0, 1):
                for bf16 in (0, 1):
                    blocks, smem = ctypes.c_int(), ctypes.c_int()
                    err = getattr(lib, entry)(
                        hlen, bf16, halo, dev.index, ctypes.byref(blocks),
                        ctypes.byref(smem))
                    if err:
                        raise RuntimeError(f"occupancy query: error {err}")
                    print(f"occupancy {tree} {key[halo]} "
                          f"{'bf16' if bf16 else 'highest'}: {blocks.value} "
                          f"blocks per SM, {smem.value} bytes")
    if only in ("syn2d", "ana2d"):
        print_tap2d_occupancy(trees, libs, port, dev, only)
    if only == "rows":
        print_rows_occupancy(trees, libs, port, dev)
        print_syn_rows_occupancy(trees, libs, port, dev)
    if only in ("spin", "shift"):
        print_spin_occupancy(trees, libs, port, dev, only)
    if only == "nsswt":
        print_nsswt_occupancy(trees, libs, port, dev)
    if only == "swt1d":
        print_swt1d_occupancy(trees, libs, port, dev)
    for name, (call, variants) in calls.items():
        for bf16 in variants:
            digests = {hashlib.sha256(flat(call(lib, 0, bf16)).cpu()
                                      .numpy().tobytes()).hexdigest()
                       for lib in libs}
            seen = {t: [] for t in trees}
            host = {t: [] for t in trees}
            order = list(range(len(trees)))
            for k in order + order[::-1]:
                seen[trees[k]].append(ms(call, libs[k], bf16))
                host[trees[k]].append(host_ms(call, libs[k], bf16))
            row, hrow = ("  ".join(f"{t} {sum(v) / 2 * 1e3:.1f}"
                                   for t, v in d.items())
                         for d in (seen, host))
            same = "bit-equal" if len(digests) == 1 else "DIFFER"
            prec = ("" if bf16 is None
                    else " bf16" if bf16 else " highest")
            print(f"{name}{prec}, device us: {row}  (outputs {same}); host "
                  f"us per call: {hrow}  [{card}]", flush=True)


def print_tap2d_occupancy(trees, libs, port, dev, only):
    """Blocks per SM, dynamic shared memory and tile shape of each tree's
    K2 and K26b instances (syn2d) or K1 and K26a instances (ana2d) at the
    timed banks, where the tree reports them."""
    query, keys, unit = (
        ("pypwt_idwt2d_occupancy", ("K2", "K26b"), "coefficients")
        if only == "syn2d" else
        ("pypwt_dwt2d_occupancy", ("K1", "K26a"), "outputs"))
    for tree, lib in zip(trees, libs):
        if not hasattr(lib, query):
            print(f"occupancy {tree} {', '.join(keys)}: not reported by "
                  "this tree")
            continue
        levels = [(keys[0], 0, FRAME >> lev, FRAME >> lev)
                  for lev in range(3)]
        levels.append((keys[1], 1, 2 * SHARD[0], 2 * SHARD[1]))
        for (key, halo, nr, nc), wname, dtype in itertools.product(
                levels, SYN2D_BANKS, SYN2D_TYPES):
            out = [ctypes.c_int() for _ in range(4)]
            err = getattr(lib, query)(
                nr, nc, port.get_filter_bank(wname).hlen,
                int(dtype == torch.float64), halo, dev.index,
                *(ctypes.byref(o) for o in out))
            if err:
                raise RuntimeError(f"occupancy query: error {err}")
            blocks, smem, tr, tc = (o.value for o in out)
            print(f"occupancy {tree} {key} ({nr}, {nc}) {wname} "
                  f"{str(dtype)[6:]}: {blocks} blocks per SM, {smem} bytes, "
                  f"tiles of {tr} x {tc} {unit}")


def print_rows_occupancy(trees, libs, port, dev):
    """Blocks per SM, dynamic shared memory and tile shape of each tree's
    K29g and K29h instances at the timed banks, where the tree reports
    them."""
    query = "pypwt_tc_rows_occupancy"
    for tree, lib in zip(trees, libs):
        if not hasattr(lib, query):
            print(f"occupancy {tree} K29g, K29h: not reported by this tree")
            continue
        for (syn, key), wname, bf16 in itertools.product(
                ((0, "K29g"), (1, "K29h")), ROWS_BANKS, (0, 1)):
            out = [ctypes.c_int() for _ in range(4)]
            err = getattr(lib, query)(
                syn, port.get_filter_bank(wname).hlen, bf16, dev.index,
                *(ctypes.byref(o) for o in out))
            if err:
                raise RuntimeError(f"occupancy query: error {err}")
            blocks, smem, tr, tc = (o.value for o in out)
            print(f"occupancy {tree} {key} {wname} "
                  f"{'bf16' if bf16 else 'highest'}: {blocks} blocks per SM, "
                  f"{smem} bytes, tiles of {tr} x {tc} "
                  f"{'coefficients' if syn else 'outputs'}")


def print_syn_rows_occupancy(trees, libs, port, dev):
    """Blocks per SM, dynamic shared memory and tile shape of each tree's
    K29d instances at the timed banks and types, where the tree reports
    them."""
    query = "pypwt_syn_rows_occupancy"
    timed = ([(w, torch.float32)
              for w in dict.fromkeys(ROWS_BANKS + K29D_BANKS)]
             + [(w, torch.float64) for w in ROWS_F64_BANKS])
    for tree, lib in zip(trees, libs):
        if not hasattr(lib, query):
            print(f"occupancy {tree} K29d: not reported by this tree")
            continue
        for wname, dtype in timed:
            out = [ctypes.c_int() for _ in range(4)]
            err = getattr(lib, query)(
                port.get_filter_bank(wname).hlen,
                int(dtype == torch.float64), dev.index,
                *(ctypes.byref(o) for o in out))
            if err:
                raise RuntimeError(f"occupancy query: error {err}")
            blocks, smem, tr, tc = (o.value for o in out)
            print(f"occupancy {tree} K29d {wname} {str(dtype)[6:]}: "
                  f"{blocks} blocks per SM, {smem} bytes, tiles of {tr} x "
                  f"{tc} coefficients")


def print_spin_occupancy(trees, libs, port, dev, only):
    """Blocks per SM, dynamic shared memory and tile shape of each tree's
    K20 (spin) or K19 (shift) instances at the timed levels, shifts and
    banks, where the tree reports them."""
    key, query, levels, banks, unit = (
        ("K20", "pypwt_idwt2d_unshift_occupancy", SPIN_LEVELS, SPIN_BANKS,
         "coefficients") if only == "spin" else
        ("K19", "pypwt_dwt2d_shifted_occupancy", SHIFT_LEVELS, SHIFT_BANKS,
         "outputs"))
    for tree, lib in zip(trees, libs):
        if not hasattr(lib, query):
            print(f"occupancy {tree} {key}: not reported by this tree")
            continue
        for (lev, (sr, sc), _), wname in itertools.product(levels, banks):
            n = FRAME >> lev
            out = [ctypes.c_int() for _ in range(4)]
            err = getattr(lib, query)(
                n, n, port.get_filter_bank(wname).hlen, sr, sc, dev.index,
                *(ctypes.byref(o) for o in out))
            if err:
                raise RuntimeError(f"occupancy query: error {err}")
            blocks, smem, tr, tc = (o.value for o in out)
            print(f"occupancy {tree} {key} ({n}, {n}) {wname} ({sr}, {sc}): "
                  f"{blocks} blocks per SM, {smem} bytes, tiles of {tr} x "
                  f"{tc} {unit}")


def print_nsswt_occupancy(trees, libs, port, dev):
    """Blocks per SM, dynamic shared memory, tile shape and window path of
    each tree's K18a and K18b instances at the timed levels, banks and
    types, where the tree reports them."""
    for key, query, synthesis in (
            ("K18a", "pypwt_ns_swt2d_occupancy", False),
            ("K18b", "pypwt_ins_swt2d_occupancy", True)):
        for tree, lib in zip(trees, libs):
            if not hasattr(lib, query):
                print(f"occupancy {tree} {key}: not reported by this tree")
                continue
            for bname, lev, dtype in itertools.product(
                    NSSWT_BANKS, NSSWT_LEVELS, SYN2D_TYPES):
                hlen = ns_bank(port, bname)[1].shape[-1]
                out = [ctypes.c_int() for _ in range(5)]
                err = getattr(lib, query)(
                    FRAME, FRAME, lev, port.conv.swt_centre(hlen, synthesis),
                    hlen, int(dtype == torch.float64), dev.index,
                    *(ctypes.byref(o) for o in out))
                if err:
                    raise RuntimeError(f"occupancy query: error {err}")
                blocks, smem, tr, tc, staged = (o.value for o in out)
                print(f"occupancy {tree} {key} ({FRAME}, {FRAME}) level "
                      f"{lev} {bname} {str(dtype)[6:]}: {blocks} blocks per "
                      f"SM, {smem} bytes, tiles of {tr} x {tc} outputs, "
                      f"{'staged' if staged else 'direct'}")


def print_swt1d_occupancy(trees, libs, port, dev):
    """Blocks per SM, dynamic shared memory and grid of each tree's K12a
    and K12b instances at the timed banks, levels and rows, both
    precisions, where the tree reports them."""
    query = "pypwt_tc_swt1d_occupancy"
    launches = ([(SINOGRAM, lev) for lev in SWT1D_LEVELS]
                + [(SIGNAL, lev) for lev in SIGNAL_LEVELS])
    for tree, lib in zip(trees, libs):
        if not hasattr(lib, query):
            print(f"occupancy {tree} K12a, K12b: not reported by this tree")
            continue
        for (syn, key), wname, ((rows, n), lev), bf16 in itertools.product(
                ((0, "K12a"), (1, "K12b")), SWT1D_BANKS, launches, (0, 1)):
            out = [ctypes.c_int() for _ in range(3)]
            err = getattr(lib, query)(
                syn, rows, n, lev, port.get_filter_bank(wname).hlen, bf16,
                dev.index, *(ctypes.byref(o) for o in out))
            if err:
                raise RuntimeError(f"occupancy query: error {err}")
            blocks, smem, grid = (o.value for o in out)
            print(f"occupancy {tree} {key} ({rows}, {n}) level {lev} "
                  f"{wname} {'bf16' if bf16 else 'highest'}: {blocks} blocks "
                  f"per SM, {smem} bytes, grid {grid}")


if __name__ == "__main__":
    main()
