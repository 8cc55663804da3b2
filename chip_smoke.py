#!/usr/bin/env python3
"""Smoke run of the PyTorch port (pypwt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py           # the smoke run below
    python3 chip_smoke.py --sweep   # build, then only the sweeps
    python3 chip_smoke.py --only K11b,K28   # build, then only these rows

Run from the root of a checkout.  Phases, in order; any failure raises,
prints its traceback and exits non-zero without the final ok line:

1. device: needs CUDA (exits 1 without it); prints torch/CUDA versions,
   ``nvcc --version`` and the card's name and power limit;
2. build: compiles every kernel (K1/K2, K3/K4, K10a/K10b, K8/K9,
   K16/K17, K18a/K18b, K19/K20, the float64 instances of the tap loops,
   the tensor-core forms K5/K6, K7a/K7b, K11a/K11b, K12a/K12b, the
   whole-pyramid kernels K24/K25, the row-sharded K26-K28 and the grid and
   sequence passes K29a-K29h) from
   pypwt_tpu_torch/csrc/ with nvcc, one process per source, and prints
   each kernel's registers and spills;
3. K1/K2 against their plain torch versions on the card, over banks hlen
   2..40 and an odd 5-tap bank, even and odd shapes up to 4096^2 (max-abs
   <= 2e-5 on uniform [0,1) data: the two differ only in summation order
   and FMA contraction), and against the float64 numpy oracle
   tests/oracle.py on a small plane; then K3/K4/K10a/K10b the same way,
   over the banks and the odd one, rows from (1, 8) to (2048, 2048), odd
   lengths and one 4 Mi-sample signal, every SWT level the signal allows,
   and a wrap wider than the signal; then K8/K9 over the banks and the odd
   one, planes (8, 8), (33, 47), (2, 256, 512) and 2048^2, every level the
   clamp allows (at 2048^2 for db2 and sym20), a wrap wider than the plane
   and the oracle; then K16/K17 and K18a/K18b on three custom 2D banks that
   do not factor, levels 1-3, at (64, 128), an odd plane and 2048^2; then
   K19/K20 over the banks, shifts (0, 0), odd, (127, 1) and one wider than
   the plane, with and without the threshold epilogue and the
   accumulator, at 2048^2 and an odd plane, and K23's map (K19 once per
   spin, K20 accumulating); then the tensor-core forms K5/K6 and K11a/K11b
   in both precisions ("highest": within 2e-5 of their plain versions;
   "bf16": the rule of mxu_close) over banks db2..sym20, planes 2048^2,
   1024 x 4096, 4096 x 1024, (3, 256, 512) and 64 x 128, SWT levels 1-4
   (a level whose support passes the plane goes to K8/K9 through the
   router, in mode "mxu"), and against the oracle; then K7a/K7b and
   K12a/K12b (levels 1-4) in both precisions on 2048 rows of 2048 and a
   (1, 4 Mi) row at db2, sym8 and sym20, and against the oracle; then the
   float64 instance of every tap-loop kernel (K1-K4, K10, K8/K9, K16-K18)
   against its float64 plain version (<= 1e-12) on 2048^2 and an odd
   plane, and against the FFT oracle tests/fft_oracle.py; then K24/K25
   against their plain versions on 0..255 data (each level within
   3e-4 * 2^level, roundtrip within 7e-4, one launch each) over db2, sym8,
   bior4.4 and sym20, L 2, 3 and 5, 2048^2 and 256 x 512, and the stack at
   db2 L3, and against the oracle level by level; then the row-sharded
   kernels K26a/K26b, K27a/K27b (float32, and float64 at db4) and K28's
   four entries (both precisions) on 4 virtual shards of cuda:0, against
   their plain versions on the halos the ring exchanged (db2, sym8,
   bior4.4, sym20; DWT L1-3, SWT L1-4; 8192^2, 256 x 512, 64 x 96 with
   multi-hop halos, a stack) and, gathered, against the oracle; then the
   one-axis passes of the grid and sequence layouts, K29a-K29d (float32,
   and float64 at db4) and K29e-K29h (both precisions, even banks of 4+
   taps), pass by pass on the halos the rings exchanged (a 2 x 2 grid of
   8192^2, 256 x 512 and 64 x 96 at L3; a 2^26-sample signal and an
   (8, 2^24) batch on 4 shards and a 4096-sample signal on 8 at L5; haar,
   db2, db4, sym8, sym20) and, gathered, against the oracle;
4. main paths, each held against the same calls on the CPU plain path
   (coefficients within 3e-4 * 2^level, image within 7e-4) and counted
   (exact launches of every kernel): Wavelets(img, "db2", 3,
   device="cuda") forward -> soft_threshold(10) -> inverse on a 2048^2
   0..255 frame (3 K1, 3 K2), then the plain roundtrip, the (8, 2048, 2048)
   stack through wavedec2/waverec2, and haar; then the 1D plans: a 2048 x
   2048 sinogram as batched 1D (ndim=1), DWT (3 K3, 3 K4) and SWT (3 K10a,
   3 K10b), one 4 Mi-sample signal (DWT L5, SWT L3), and haar batched 1D;
   then the 2D SWT (3 K8, 3 K9), the stack through swt2d/iswt2d (its first
   and last frames against the CPU), do_separable=0 with db2, DWT (on
   K1/K2) and SWT (on K8/K9), and do_separable=0, do_swt=1 with the custom
   db3 x coif1 bank (3 K18a, 3 K18b); then the denoising pipelines on the
   frame (db2, L3, beta 10, soft): the 4-spin static cycle spinning (4
   K19, 4 K20, 8 K1, 8 K2), the 8-spin random one from a seeded generator
   (24 K19, 24 K20), denoise2d (3 K1, 3 K2) and with do_swt (3 K8, 3 K9),
   do_separable=0 with the db3 x coif1 bank, DWT (3 K16, 3 K17), and a
   2047^2 frame through Wavelets (3 K1, 3 K2); then, under
   set_kernels("mxu") and in both precisions, Wavelets(img, "sym8", 3) on
   the frame, DWT (3 K5, 3 K6, no K1/K2) and SWT (3 K11a, 3 K11b), and the
   stack through wavedec2/waverec2 and swt2d/iswt2d ("bf16" held to JAX's
   loose gate, RMS error <= 1 % of the reference's RMS per subband, at
   level 1, doubling per level, images at the pyramid's depth: rms_gate);
   then, in mode "mxu" and both precisions, the sinogram as batched 1D at
   sym8 L3, DWT (3 K7a, 3 K7b) and SWT (3 K12a, 3 K12b), and the signal,
   DWT L5 (5 + 5) and SWT L3 (3 + 3), against the CPU plans; then float64
   plans in mode "auto" (db4 L3: the 2D DWT and SWT, batched 1D DWT and
   SWT, the non-separable DWT and SWT of the db3 x coif1 bank, each 3 + 3
   launches of the float64 instances, roundtrip < 1e-10) and denoise2d on
   a float64 frame; then, with tail fusion on (set_tail_fuse(True), reset
   in finally), Wavelets(img, "db2", 3) on the frame (K1 + K24, K25 + K2),
   in mode "mxu" at sym8 (K5 + K24, K25 + K6), on the 2047^2 frame (its
   1024^2 level-0 approximation is covered, as in JAX: K1 + K24, K25 + K2),
   on a 2046^2 frame and a float64 plan (refused: 3 + 3 per level), and
   denoise2d; and the all-levels entries wavedec2_pyramid/waverec2_pyramid
   on the frame and the stack (1 + 1); then the row-sharded layer on 4
   virtual shards of cuda:0 against the unsharded plans on the card:
   ShardedWavelets on an 8192^2 image, db2 L3 DWT (12 K26a + 12 K26b) and
   SWT (12 K27a + 12 K27b), sym8 L3 in mode "mxu" in both precisions (12 +
   12 of K28's entries), an 8190 x 8191 image (padded, cropped) and its
   denoise(10, spins=4) against the unsharded denoise of the same shifts,
   BatchedWavelets on the stack data-parallel (K1/K2, no exchange) and
   hybrid 2 x 2 (K26), one all-reduce per norm; and the counted exchange
   schedule of the 8192^2 DWT and SWT against audit.predict_rowsharded;
   then the grid and sequence layouts on virtual shards of cuda:0:
   ShardedWavelets on the 8192^2 image on a 2 x 2 grid, db2 L3 DWT (12
   K29a + 24 K29c, 12 K29b + 24 K29d: 3 per shard and level each way) and
   SWT (torch ops, as JAX), sym8 L3 in mode "mxu" in both precisions
   (K29e-K29h), the
   8190 x 8191 image and its 4-spin denoise; a 2^26-sample signal on 4
   shards, db2 L5 DWT (20 + 20), db2 L3 SWT, sym8 L5 "mxu"; the (8, 2^24)
   batch; one all-reduce per norm; and the counted exchange schedules
   against audit.predict_gridsharded(_swt) and predict_seqsharded(_swt);
5. times (CUDA events, warm-up, median of 21 samples): level-0 K1/K2
   against their plain versions at 2048^2 (device time), and the L3
   roundtrip in frames/s, kernel path against plain path, at 2048^2 and on
   the stack, both as device time and as wall time (host launch overhead
   included); then level 0 of K3/K4/K10a/K10b at 2048 x 2048 against their
   plain versions, and the batched-1D and 4 Mi-signal roundtrips; then
   K8/K9 at levels 1 and 3 and K18a/K18b at level 1, 2048^2, the 2D SWT
   L3 roundtrip and the L3 non-separable SWT roundtrip (db3 x coif1: 3
   K18a + 3 K18b), device and wall; then K16/K17 (db3 x coif1) and K19 (soft epilogue) /
   K20 (accumulating) at level 0 of 2048^2, and the 4-spin static and
   8-spin random cycle spinning in frames/s, kernel path against plain
   path; then K5 against K1 and K6 against K2 at sym8 level 0, K11a against
   K8 and K11b against K9 at sym8 level 1, each with its plain version and
   its "bf16" time; K7a/K7b against K3/K4 and K12a/K12b against K10 at
   sym8, levels 1-3 of the sinogram and levels 1-5 (DWT, K7a/K7b in both
   precisions) and 1-3 (SWT) of the signal; the float64 instances of K1-K4 against their float32 ones;
   K24/K25 against their plain versions and K1/K2 once per level, and the
   two-level tail of tail fusion; the L3 roundtrip per level, tail-fused
   and all-levels, device and wall, in turns, and the per-level roundtrip
   replayed from a CUDA graph; last, beside each kernel, one PyTorch call
   that computes the same function (library_ms: a strided, transposed or
   dilated convolution in full float32, on an input padded outside the
   timed window), checked against the kernel's output; none computes a
   multi-level pyramid, so K24/K25 have none; then each K26-K28 entry on
   one 2048 x 8192 shard of the 8192^2 image against its plain version,
   its unsharded kernel on the same block and one convolution, and the
   8192^2 db2 L3 roundtrip on 4 virtual shards against the unsharded one,
   device and wall; then each K29 entry at level 0 of one 4096^2 block of
   the 8192^2 grid against its plain version and one convolution, K29a on
   a 2^24-sample sequence shard against K3, and the 8192^2 db2 L3
   roundtrip on the 2 x 2 grid, on 4 row shards and unsharded, beside the
   sym8 L3 roundtrip on the grid in mode "mxu" (K29e-K29h).

The line before the last is one JSON object with each kernel's route,
source, the TPU kernel it replaces, its launches in the main-path run, its
worst error in phase 3, its times, the library call's time and its bound
(the larger of its bytes over 3.35 TB/s and its flops over 67 TFLOP/s
fp32, from the timed call's shapes); before it, the card's name and power
limit.  The last line is {"ok": true, "device": {...}}.

``--sweep`` times the 2D stationary kernels on a 2048^2 frame by level
(K8/K9), by filter size (K18a/K18b on dense random banks) and by bank
width (K8/K9 against their plain versions), then the crossover of the
tensor-core forms: K5/K6 against K1/K2 (level l on a (2048 / 2^(l-1))^2
plane) and K11a/K11b against K8/K9 (level l of 2048^2) by hlen (4, 8, 16,
20, 40) and level (1-4), both precisions, and the same for the 1D forms:
K7a/K7b against K3/K4 (level l: 2048 rows of 2048 / 2^(l-1)) and
K12a/K12b against K10 (level l of 2048 x 2048); it prints no ok line.

``--only KEYS`` is the loop of a kernel redesign: KEYS, comma-separated,
name rows of the kernels line (a family such as K7, K10, K12, K28 or K29
names all of its rows); the tap-loop DWT analysis K1 and synthesis K2, the
cycle-spin analysis K19 and synthesis K20, the tap-loop SWT synthesis K9,
the tap-loop 1D SWT pair K10a/K10b, the non-separable SWT pair K18a/K18b,
the tensor-core forms K5/K6/K11a/K11b, K7a/K7b and K12a/K12b, the
row-sharded K26-K28 and the grid and sequence passes K29 are selectable.
It builds every kernel, then runs only those rows' phases: their
kernel-against-plain checks over the cases above (both precisions),
their main paths with exact launch counts, and their times at the
table's shapes (K9 at levels 1 and 3 of 2048^2; K9 and K27b also print
the occupancy and phase-1 path of their synthesis levels and a SHA-256
digest of their outputs on seeded cases, equal from two builds that are
bit-identical; K11a and K11b also at levels 1-3 of 2048^2 beside K8 and
K9, and the occupancy of the tc_swt2d.cu instances that K11a, K28 swt,
K11b and K28 iswt run; K6 also at levels 0-2 of 2048^2 beside K2, and K6
and K28 idwt the occupancy of their tc_dwt2d.cu instances and digests of
their outputs on seeded cases; K2 at levels 0-2 of 2048^2, db2 and
sym20, float32 and float64, and K2 and K26b the occupancy and tile shape
of their idwt2d.cu instances and digests of their outputs on seeded
cases; K1 and K26a the same for dwt2d.cu's analysis; K20 runs phase 3's
shifted checks, the spins of phase 4 with their launches and phase 5's
slice times, and prints the occupancy and tile shape of its idwt2d.cu
instances at levels 0-2 of 2048^2 for each parity of the shift and
digests of its outputs on seeded cases; K19 the same phases, and the
same of its dwt2d.cu instances (tiles in outputs) and digests of its
outputs on seeded cases;
K18a/K18b run phase 3's K18
checks, the non-separable SWT of phase 4 (db3 x coif1 L3, 3 + 3
launches) and their times at levels 1-3 of 2048^2 (db3 x coif1 and
dense8; float32 and float64), and print the occupancy, tile shape and
window path of their nonsep_swt2d.cu instances at levels 1-8 of 2048^2
(hlen 6, 8, 40) and digests of their outputs on seeded cases;
K7a/K7b at levels
1-3 of the sinogram and 1-5 of the signal beside K3/K4, and the
occupancy of the tc_dwt1d.cu instances that K7a/K7b and K29e/K29f run;
K12a/K12b at levels 1-3 of the sinogram and of the signal beside K10,
the occupancy and grid of their tc_swt1d.cu instances at sym8 on those
rows, and digests of their outputs on seeded rows, K12_DIGEST_CASES;
K10a/K10b run phase 3's 1D SWT checks and the 1D main paths (3 + 3
launches), and time both at levels 1-3 of the sinogram and of the signal
(haar, db2, sym8 and sym20 in float32, db4 in float64; db2 level 1 also
against the plain versions, and the sum of launches x (time - bound)
over the sinogram's sym8 L3 roundtrip), and print the occupancy and grid
of their swt1d.cu instances on those rows and digests of their outputs
on seeded rows, K10_DIGEST_CASES, both types);
a K29 row runs
all of the grid and sequence checks and main paths, but times only the
selected rows (K29e-K29h in both precisions, K29e/K29f also on a
sequence shard) and no roundtrip; K29g and K29h also print the occupancy
and tile shape of their tc_dwt2d.cu instances and digests of their
outputs on seeded cases (banks of hlen 4-40, rows of 2048, 33 and 4094
samples, inputs and outputs one float past a 16-byte boundary, shards
with multi-hop halos, both precisions).  It prints the kernels line of
those rows and no ok line.
"""

import ctypes
import hashlib
import importlib.util
import itertools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
SEED = 1234
BANKS = ("haar", "db2", "db8", "sym20", "bior3.5")
SHAPES = ((8, 8), (64, 128), (2, 256, 512), (2048, 2048), (4096, 4096),
          (33, 47), (3, 255, 257), (2047, 2047))
KERNEL_TOL = 2e-5      # kernel vs plain, uniform [0,1) data
COEFF_TOL = 3e-4       # x 2^level, 0..255 data (BASELINE.md envelope)
ROUNDTRIP_TOL = 7e-4   # bench.py:64 envelope
ORACLE_TOL = 1e-5      # float32 kernel vs float64 oracle, [0,1) data
FRAME = (2048, 2048)
STACK = 8
SAMPLES = 21
SLEEP_CYCLES = 20_000_000  # ~10 ms at the H100's 1.98 GHz boost clock
SHAPES_1D = ((1, 8), (3, 64), (64, 1024), FRAME, (1, 4 * 1024 * 1024),
             (5, 2047), (1, 4 * 1024 * 1024 - 1))
SIGNAL = 4 * 1024 * 1024   # one 16 MiB signal
SHAPES_SWT2D = ((8, 8), (33, 47), (2, 256, 512), FRAME)
SWEEP_WIDTHS = ("haar", "db2", "db4", "db8", "coif5", "sym20")
SWEEP_LEVELS = (("db2", 11), ("sym8", 7), ("sym20", 6))  # bank, top level
SWEEP_HLENS = (2, 4, 6, 8, 12, 16)
ODD_FRAME = (2047, 2047)
ODD_PLANE = (1023, 777)
# K19/K20: no shift, odd ones, a row shift the TPU kernel declined, and
# one wider than the plane (reduced mod its size by the wrapper)
SHIFTS = ((0, 0), (3, 5), (127, 1), (4101, 4099))
THRESH_BETA = 0.3     # K19's epilogue on [0,1) data
HARD_MARGIN = 1e-5    # |coefficient| this close to beta: either side is right
LIBRARY_TOL = 1e-3    # library call vs kernel, 0..255 data
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s
PEAK_FLOPS = 67e12    # H100 SXM float32 outside the tensor cores, flop/s
MXU_BANKS = ("db2", "db4", "sym8", "coif3", "bior4.4", "db10", "sym20")
SHAPES_MXU = (FRAME, (1024, 4096), (4096, 1024), (3, 256, 512), (64, 128))
PRECISIONS = ("highest", "bf16")
BF16_RMS = 0.01       # the "bf16" gate at level 1 (rms_gate)
SWEEP_MXU = ("db2", "db4", "sym8", "db10", "sym20")  # hlen 4, 8, 16, 20, 40
MXU1D_BANKS = ("db2", "sym8", "sym20")  # hlen 4, 16, 40
SHAPES_MXU1D = (FRAME, (1, SIGNAL))     # sinogram rows, one signal
F64_TOL = 1e-12       # float64 kernel vs float64 plain or oracle, [0,1) data
F64_PLAN_TOL = 1e-10  # float64 plans, 0..255 data (JAX's float64 gate)
# an odd-length bank for every kernel
ODD_TAPS = ([0.1, -0.3, 0.7, 0.25, -0.05], [0.2, 0.5, -0.6, 0.1, 0.3],
            [-0.15, 0.35, 0.6, 0.2, 0.05], [0.4, -0.2, 0.1, 0.55, -0.3])


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(1)
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  devices {torch.cuda.device_count()}")
    # the plain versions use no matmul or convolution; pin full float32
    # anyway so that no TF32 path can enter a reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    return card


def import_port():
    sys.path.insert(0, str(ROOT))
    import pypwt_tpu_torch
    pkg = Path(pypwt_tpu_torch.__file__).resolve().parent
    if pkg.parent != ROOT:
        raise RuntimeError(f"pypwt_tpu_torch imported from {pkg}, not "
                           f"from this checkout ({ROOT})")
    return pypwt_tpu_torch


def phase_build(build):
    nvcc = build._nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    ver = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, check=True).stdout.strip()
    for line in ver.splitlines():
        print("nvcc: " + line)
    build.load_library()
    if build.build_seconds is None:
        print(f"build: loaded {build.library_path().name}, an earlier build "
              "of these sources")
    else:
        print(f"build: {len(build.sources())} sources -> "
              f"{build.library_path().name} in {build.build_seconds:.2f} s")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas: " + line.strip())


def max_err(got, ref):
    if isinstance(got, torch.Tensor):
        got, ref = (got,), (ref,)
    return max(float((g - r).abs().max()) for g, r in zip(got, ref))


def half(shape):
    """The coefficient shape of a decimating level of ``shape``."""
    return (*shape[:-2], (shape[-2] + 1) // 2, (shape[-1] + 1) // 2)


def phase_kernels(port, dev, keys=None):
    """K1/K2 against their plain versions and the float64 oracle; ``keys``:
    only those rows' errors returned (--only)."""
    fd = port.ops.fused_dwt
    k1, k2 = fd.dwt2d_fused, fd.idwt2d_fused
    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst = {"K1": 0.0, "K2": 0.0}
    for fb in banks_1d(port):
        name = fb.name
        for shape in SHAPES:
            x = torch.rand(shape, generator=gen, device=dev)
            got = launched_once(k1, lambda: k1(x, fb))
            e1 = max_err(got, fd.dwt2d_plain(x, fb))
            c = [torch.rand(half(shape), generator=gen, device=dev)
                 for _ in range(4)]
            out = launched_once(k2, lambda: k2(*c, fb, shape))
            e2 = max_err(out, fd.idwt2d_plain(*c, fb, shape))
            torch.cuda.synchronize()
            print(f"kernel-vs-plain {name:8s} hlen={fb.hlen:2d} "
                  f"{str(shape):18s} K1 {e1:.3e}  K2 {e2:.3e}")
            if max(e1, e2) > KERNEL_TOL:
                raise AssertionError(
                    f"{name} {shape}: kernel vs plain {max(e1, e2):.3e} > "
                    f"{KERNEL_TOL}")
            worst["K1"] = max(worst["K1"], e1)
            worst["K2"] = max(worst["K2"], e2)
    # the float64 scalar oracle of the reference kernels, small plane
    oracle = load_oracle()
    rng = np.random.default_rng(SEED)
    for name in BANKS:
        fb = port.get_filter_bank(name)
        x = rng.random((16, 24), dtype=np.float32)
        got = k1(torch.from_numpy(x).to(dev), fb)
        ref = oracle.ref_analysis_2d(x, fb.dec_lo, fb.dec_hi)
        e1 = max(float(np.abs(g.cpu().numpy() - r).max())
                 for g, r in zip(got, ref))
        c = [rng.random((8, 12), dtype=np.float32) for _ in range(4)]
        out = k2(*(torch.from_numpy(s).to(dev) for s in c), fb, (16, 24))
        ref = oracle.ref_synthesis_2d(*c, fb.rec_lo, fb.rec_hi, 16, 24)
        e2 = float(np.abs(out.cpu().numpy() - ref).max())
        print(f"kernel-vs-oracle {name:8s} K1 {e1:.3e}  K2 {e2:.3e}")
        if max(e1, e2) > ORACLE_TOL:
            raise AssertionError(f"{name}: kernel vs oracle "
                                 f"{max(e1, e2):.3e} > {ORACLE_TOL}")
    return {k: e for k, e in worst.items() if wanted(keys, k)}


def load_oracle():
    spec = importlib.util.spec_from_file_location(
        "oracle", ROOT / "tests" / "oracle.py")
    oracle = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(oracle)
    return oracle


def banks_1d(port):
    """The banks of phase 3, and an odd-length one."""
    odd = port.FilterBank("odd5", *(np.asarray(t, np.float64)
                                    for t in ODD_TAPS))
    return [port.get_filter_bank(n) for n in BANKS] + [odd]


def launched_one(kernels, call, what):
    """call(), which must launch exactly one of ``kernels``."""
    before = sum(k.launches for k in kernels)
    got = call()
    if sum(k.launches for k in kernels) != before + 1:
        raise AssertionError(f"{what}: not one launch")
    return got


def launched_once(kernel, call):
    n = kernel.launches
    got = call()
    if kernel.launches != n + 1:
        raise AssertionError(f"{kernel.__name__}: launch count did not move")
    return got


def phase_kernels_1d(port, dev, keys=None):
    """K3/K4 and K10a/K10b against their plain versions and the oracle;
    ``keys``: K10a/K10b's checks alone unless K3 or K4 is among them
    (--only)."""
    fd = port.ops.fused_dwt
    k34 = wanted(keys, "K3", "K4")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst = {"K3": 0.0, "K4": 0.0, "K10a": 0.0, "K10b": 0.0}

    def note(key, err, what):
        if not err <= KERNEL_TOL:
            raise AssertionError(f"{key} {what}: kernel vs plain {err:.3e} "
                                 f"> {KERNEL_TOL}")
        worst[key] = max(worst[key], err)

    for fb in banks_1d(port):
        for shape in SHAPES_1D:
            x = torch.rand(shape, generator=gen, device=dev)
            a, d = (torch.rand(shape, generator=gen, device=dev)
                    for _ in range(2))
            if k34:
                got = launched_once(fd.dwt1d_fused,
                                    lambda: fd.dwt1d_fused(x, fb))
                note("K3", max_err(got, fd.dwt1d_plain(x, fb)),
                     (fb.name, shape))
                m = (shape[1] + 1) // 2
                ca, cd = a[:, :m].contiguous(), d[:, :m].contiguous()
                got = launched_once(fd.idwt1d_fused, lambda: fd.idwt1d_fused(
                    ca, cd, fb, shape[1]))
                note("K4", max_err(got, fd.idwt1d_plain(ca, cd, fb,
                                                        shape[1])),
                     (fb.name, shape))
            top = port.shapes.clamp_levels(99, shape, fb.hlen, 1)
            for level in range(1, top + 1):
                got = launched_once(fd.swt1d_fused,
                                    lambda: fd.swt1d_fused(x, fb, level))
                note("K10a", max_err(got, fd.swt1d_plain(x, fb, level)),
                     (fb.name, shape, level))
                got = launched_once(fd.iswt1d_fused, lambda: fd.iswt1d_fused(
                    a, d, fb, level))
                note("K10b", max_err(got, fd.iswt1d_plain(a, d, fb, level)),
                     (fb.name, shape, level))
            torch.cuda.synchronize()
            print(f"kernel-vs-plain 1D {fb.name:8s} hlen={fb.hlen:2d} "
                  f"{str(shape):14s} SWT levels 1..{top:2d}  worst so far "
                  + "  ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    # a wrap wider than the signal, through the routed level function:
    # sym8 at level 3 spans 60 samples of a 16-sample row
    fb = port.get_filter_bank("sym8")
    x = torch.rand((4, 16), generator=gen, device=dev)
    got = launched_once(fd.swt1d_fused, lambda: port.swt.swt1d_level(x, fb, 3))
    note("K10a", max_err(got, fd.swt1d_plain(x, fb, 3)), "sym8 (4, 16) L3")
    back = launched_once(fd.iswt1d_fused,
                         lambda: port.swt.iswt1d_level(*got, fb, 3))
    note("K10b", max_err(back, fd.iswt1d_plain(*got, fb, 3)),
         "sym8 (4, 16) L3")
    print(f"wrap wider than the row: sym8 level 3 on (4, 16) through "
          f"swt1d_level/iswt1d_level")

    oracle = load_oracle()
    rng = np.random.default_rng(SEED)
    for fb in banks_1d(port):
        x = rng.random((3, 24), dtype=np.float32)
        c = [rng.random((3, 12), dtype=np.float32) for _ in range(2)]
        xt = torch.from_numpy(x).to(dev)
        errs = {}
        if fb.hlen % 2 == 0 and k34:
            a, d = (t.cpu().numpy() for t in fd.dwt1d_fused(xt, fb))
            out = fd.idwt1d_fused(*(torch.from_numpy(s).to(dev) for s in c),
                                  fb, 24).cpu().numpy()
            errs["K3"] = max(
                float(np.abs(a[r] - oracle.ref_analysis_1d(x[r], fb.dec_lo))
                      .max()) for r in range(3))
            errs["K3"] = max(errs["K3"], max(
                float(np.abs(d[r] - oracle.ref_analysis_1d(x[r], fb.dec_hi))
                      .max()) for r in range(3)))
            errs["K4"] = max(float(np.abs(out[r] - oracle.ref_synthesis_1d(
                c[0][r], c[1][r], fb.rec_lo, fb.rec_hi, 24)).max())
                for r in range(3))
        a, d = (t.cpu().numpy() for t in fd.swt1d_fused(xt, fb, 2))
        errs["K10a"] = max(max(
            float(np.abs(a[r] - oracle.ref_swt_analysis_1d(x[r], fb.dec_lo, 2))
                  .max()),
            float(np.abs(d[r] - oracle.ref_swt_analysis_1d(x[r], fb.dec_hi, 2))
                  .max())) for r in range(3))
        sa, sd = (rng.random((3, 24), dtype=np.float32) for _ in range(2))
        out = fd.iswt1d_fused(torch.from_numpy(sa).to(dev),
                              torch.from_numpy(sd).to(dev), fb, 2).cpu().numpy()
        errs["K10b"] = max(float(np.abs(out[r] - oracle.ref_swt_synthesis_1d(
            sa[r], sd[r], fb.rec_lo, fb.rec_hi, 2)).max()) for r in range(3))
        print(f"kernel-vs-oracle 1D {fb.name:8s} "
              + "  ".join(f"{k} {v:.3e}" for k, v in errs.items()))
        if max(errs.values()) > ORACLE_TOL:
            raise AssertionError(f"{fb.name}: 1D kernel vs oracle "
                                 f"{max(errs.values()):.3e} > {ORACLE_TOL}")
    return worst


def swt2d_oracle(oracle, x, fb, level):
    """K8's map in float64 from the 1D a-trous oracle: the last axis, then
    axis -2."""
    def rows(t, f):
        return np.stack([oracle.ref_swt_analysis_1d(r, f, level) for r in t])

    def cols(t, f):
        return rows(t.T, f).T
    lo, hi = rows(x, fb.dec_lo), rows(x, fb.dec_hi)
    return (cols(lo, fb.dec_lo), cols(lo, fb.dec_hi), cols(hi, fb.dec_lo),
            cols(hi, fb.dec_hi))


def iswt2d_oracle(oracle, a, h, v, d, fb, level):
    """K9's map in float64: axis -2, then the last axis."""
    def syn(p, q):  # along the last axis, row by row
        return np.stack([oracle.ref_swt_synthesis_1d(
            pr, qr, fb.rec_lo, fb.rec_hi, level) for pr, qr in zip(p, q)])
    t1 = syn(a.T, h.T).T
    t2 = syn(v.T, d.T).T
    return syn(t1, t2)


def phase_kernels_swt2d(port, dev, keys=None):
    """K8/K9 against their plain versions over the banks (the odd 5-tap one
    included), every level the clamp allows (at 2048^2 for db2 and sym20;
    levels 1-2 for the others there), a wrap wider than the plane, and the
    float64 oracle.  ``keys``: K8's sweep only where K8 is selected
    (--only)."""
    fd = port.ops.fused_dwt
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    worst = {"K8": 0.0, "K9": 0.0}

    def note(key, err, what):
        if not err <= KERNEL_TOL:
            raise AssertionError(f"{key} {what}: kernel vs plain {err:.3e} "
                                 f"> {KERNEL_TOL}")
        worst[key] = max(worst[key], err)

    for fb in banks_1d(port):
        for shape in SHAPES_SWT2D:
            top = port.shapes.clamp_levels(99, shape[-2:], fb.hlen, 2)
            if shape == FRAME and fb.name not in ("db2", "sym20"):
                top = min(top, 2)
            for level in range(1, top + 1):
                if wanted(keys, "K8"):
                    x = torch.rand(shape, generator=gen, device=dev)
                    got = launched_once(fd.swt2d_fused,
                                        lambda: fd.swt2d_fused(x, fb, level))
                    note("K8", max_err(got, fd.swt2d_plain(x, fb, level)),
                         (fb.name, shape, level))
                    del x, got
                c = [torch.rand(shape, generator=gen, device=dev)
                     for _ in range(4)]
                got = launched_once(fd.iswt2d_fused,
                                    lambda: fd.iswt2d_fused(*c, fb, level))
                note("K9", max_err(got, fd.iswt2d_plain(*c, fb, level)),
                     (fb.name, shape, level))
                del c, got
            torch.cuda.synchronize()
            print(f"kernel-vs-plain 2D SWT {fb.name:8s} hlen={fb.hlen:2d} "
                  f"{str(shape):16s} levels 1..{top}  worst so far K8 "
                  f"{worst['K8']:.3e}  K9 {worst['K9']:.3e}")
    # a wrap wider than the plane, through the routed level functions:
    # sym8 at level 3 spans 60 samples of a 16 x 16 plane
    fb = port.get_filter_bank("sym8")
    x = torch.rand((16, 16), generator=gen, device=dev)
    got = launched_once(fd.swt2d_fused, lambda: port.swt.swt2d_level(x, fb, 3))
    note("K8", max_err(got, fd.swt2d_plain(x, fb, 3)), "sym8 (16, 16) L3")
    back = launched_once(fd.iswt2d_fused,
                         lambda: port.swt.iswt2d_level(*got, fb, 3))
    note("K9", max_err(back, fd.iswt2d_plain(*got, fb, 3)), "sym8 (16, 16) L3")
    print("wrap wider than the plane: sym8 level 3 on (16, 16) through "
          "swt2d_level/iswt2d_level")

    oracle = load_oracle()
    rng = np.random.default_rng(SEED)
    for fb in banks_1d(port):
        x = rng.random((12, 20), dtype=np.float32)
        got = fd.swt2d_fused(torch.from_numpy(x).to(dev), fb, 2)
        e8 = max(float(np.abs(g.cpu().numpy() - r).max())
                 for g, r in zip(got, swt2d_oracle(oracle, x, fb, 2)))
        c = [rng.random((12, 20), dtype=np.float32) for _ in range(4)]
        out = fd.iswt2d_fused(*(torch.from_numpy(s).to(dev) for s in c), fb,
                              2).cpu().numpy()
        e9 = float(np.abs(out - iswt2d_oracle(oracle, *c, fb, 2)).max())
        print(f"kernel-vs-oracle 2D SWT {fb.name:8s} K8 {e8:.3e}  K9 {e9:.3e}")
        if max(e8, e9) > ORACLE_TOL:
            raise AssertionError(f"{fb.name}: 2D SWT kernel vs oracle "
                                 f"{max(e8, e9):.3e} > {ORACLE_TOL}")
    return {k: e for k, e in worst.items() if wanted(keys, k)}


def banks_2d(port):
    """The custom 2D banks of phase 3: db3(rows) x coif1(cols), the rank-2
    mix of tests/test_nonsep.py, and a dense random 8 x 8 bank; none
    factors into one 1D bank."""
    f2d = port.nonsep.Filters2D
    fr, fc = port.get_filter_bank("db3"), port.get_filter_bank("coif1")
    parts = (("lo", "lo"), ("hi", "lo"), ("lo", "hi"), ("hi", "hi"))
    cross = f2d([np.outer(getattr(fr, "dec_" + p), getattr(fc, "dec_" + q))
                 for p, q in parts],
                [np.outer(getattr(fr, "rec_" + p), getattr(fc, "rec_" + q))
                 for p, q in parts], "db3xcoif1")
    f = port.get_filter_bank("db2")
    lo, hi = f.dec_lo, f.dec_hi
    mix = [0.8 * np.outer(lo, lo) + 0.2 * np.outer(hi, hi),
           0.8 * np.outer(hi, lo) + 0.2 * np.outer(lo, hi),
           0.8 * np.outer(lo, hi) + 0.2 * np.outer(hi, lo),
           0.8 * np.outer(hi, hi) + 0.2 * np.outer(lo, lo)]
    rng = np.random.default_rng(SEED)
    dense = f2d(list(rng.random((4, 8, 8)) / 8), list(rng.random((4, 8, 8))
                                                      / 8), "dense8")
    return [cross, f2d(mix, mix, "rank2mix"), dense]


def phase_kernels_nonsep(port, dev, keys=None):
    """K16/K17 and K18a/K18b against their plain versions on the custom
    2D banks; ``keys``: only K18a/K18b's checks (--only)."""
    kn = port.ops.nonsep
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    worst = {"K16": 0.0, "K17": 0.0, "K18a": 0.0, "K18b": 0.0}
    # K16/K17: three levels down from each plane, every level's analysis
    # of the last one's approximation and a synthesis back to its shape
    for f2d in banks_2d(port) if keys is None else ():
        for shape in ((64, 128), ODD_PLANE, FRAME):
            x = torch.rand(shape, generator=gen, device=dev)
            for level in (1, 2, 3):
                got = launched_once(kn.nsdwt2d_fused,
                                    lambda: kn.nsdwt2d_fused(x, f2d))
                e16 = max_err(got, kn.nsdwt2d_plain(x, f2d))
                c = [torch.rand(got[0].shape, generator=gen, device=dev)
                     for _ in range(4)]
                out = launched_once(kn.insdwt2d_fused, lambda: (
                    kn.insdwt2d_fused(*c, f2d, x.shape)))
                e17 = max_err(out, kn.insdwt2d_plain(*c, f2d, x.shape))
                torch.cuda.synchronize()
                print(f"kernel-vs-plain non-separable DWT {f2d.name:9s} "
                      f"{str(tuple(x.shape)):12s} L{level}  K16 {e16:.3e}  "
                      f"K17 {e17:.3e}")
                if max(e16, e17) > KERNEL_TOL:
                    raise AssertionError(
                        f"{f2d.name} {tuple(x.shape)} L{level}: K16/K17 vs "
                        f"plain {max(e16, e17):.3e} > {KERNEL_TOL}")
                worst["K16"] = max(worst["K16"], e16)
                worst["K17"] = max(worst["K17"], e17)
                x = got[0]
    for f2d in banks_2d(port):
        for shape in ((64, 128), FRAME):
            for level in (1, 2, 3):
                x = torch.rand(shape, generator=gen, device=dev)
                got = launched_once(kn.ns_swt2d_fused,
                                    lambda: kn.ns_swt2d_fused(x, f2d, level))
                ea = max_err(got, kn.ns_swt2d_plain(x, f2d, level))
                c = [torch.rand(shape, generator=gen, device=dev)
                     for _ in range(4)]
                out = launched_once(kn.ins_swt2d_fused, lambda: (
                    kn.ins_swt2d_fused(*c, f2d, level)))
                eb = max_err(out, kn.ins_swt2d_plain(*c, f2d, level))
                torch.cuda.synchronize()
                print(f"kernel-vs-plain non-separable SWT {f2d.name:9s} "
                      f"{str(shape):12s} L{level}  K18a {ea:.3e}  K18b "
                      f"{eb:.3e}")
                if max(ea, eb) > KERNEL_TOL:
                    raise AssertionError(
                        f"{f2d.name} {shape} L{level}: K18 vs plain "
                        f"{max(ea, eb):.3e} > {KERNEL_TOL}")
                worst["K18a"] = max(worst["K18a"], ea)
                worst["K18b"] = max(worst["K18b"], eb)
    return {k: e for k, e in worst.items() if wanted(keys, k)}


def thresh_err(got, ref, bare, beta):
    """max-abs of a thresholded subband against its plain version, over
    the coefficients not within HARD_MARGIN of beta (``bare``: the plain
    coefficients before the threshold), where a hard threshold may fall
    on either side in float32."""
    keep = ((bare.abs() - beta).abs() > HARD_MARGIN)
    return float(((got - ref).abs() * keep).max())


def phase_kernels_shifted(port, dev):
    """K19/K20 against their plain versions over the banks, the shifts of
    SHIFTS, the three epilogues (none, soft, hard), with and without the
    accumulator, at 2048^2 and an odd plane; then K23's map."""
    ks, fd = port.ops.shifted, port.ops.fused_dwt
    k19, k20 = ks.dwt2d_shifted_fused, ks.idwt2d_unshift_fused
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    worst = {"K19": 0.0, "K20": 0.0}

    def note(key, err, what):
        if not err <= KERNEL_TOL:
            raise AssertionError(f"{key} {what}: kernel vs plain {err:.3e} "
                                 f"> {KERNEL_TOL}")
        worst[key] = max(worst[key], err)

    for name in BANKS:
        fb = port.get_filter_bank(name)
        for shape in (FRAME, ODD_PLANE):
            x = torch.rand(shape, generator=gen, device=dev)
            c = [torch.rand(half(shape), generator=gen, device=dev)
                 for _ in range(4)]
            acc = torch.rand(shape, generator=gen, device=dev)
            for sr, sc in SHIFTS:
                what = (name, shape, (sr, sc))
                bare = ks.dwt2d_shifted_plain(x, fb, sr, sc)
                got = launched_once(k19, lambda: k19(x, fb, sr, sc))
                note("K19", max_err(got, bare), what)
                for mode in ("soft", "hard"):
                    got = launched_once(k19, lambda: k19(
                        x, fb, sr, sc, mode, THRESH_BETA))
                    ref = ks.dwt2d_shifted_plain(x, fb, sr, sc, mode,
                                                 THRESH_BETA)
                    note("K19", max(thresh_err(g, r, b, THRESH_BETA)
                                    for g, r, b in zip(got, ref, bare)),
                         what + (mode,))
                got = launched_once(k20, lambda: k20(*c, fb, shape, sr, sc))
                note("K20", max_err(got, ks.idwt2d_unshift_plain(
                    *c, fb, shape, sr, sc)), what)
                got = launched_once(k20, lambda: k20(*c, fb, shape, sr, sc,
                                                     acc, 0.25))
                note("K20", max_err(got, ks.idwt2d_unshift_plain(
                    *c, fb, shape, sr, sc, acc, 0.25)), what + ("acc",))
            torch.cuda.synchronize()
            print(f"kernel-vs-plain shifted {name:8s} {str(shape):13s} "
                  f"shifts {SHIFTS}  worst so far K19 {worst['K19']:.3e}  "
                  f"K20 {worst['K20']:.3e}")
    # K23's map: the mean of n unshifted syntheses of n shifted analyses,
    # as K19 once per spin and K20 accumulating
    fb = port.get_filter_bank("db2")
    x = torch.rand(FRAME, generator=gen, device=dev)
    shifts = ((0, 0), (2, 1), (4, 2), (6, 3))
    acc = ref = None
    for k, (sr, sc) in enumerate(shifts):
        coeffs = k19(x, fb, sr, sc)
        scale = 1.0 / len(shifts) if k == len(shifts) - 1 else 1.0
        acc = k20(*coeffs, fb, FRAME, sr, sc, acc, scale)
        y = torch.roll(fd.idwt2d_plain(*coeffs, fb, FRAME), (-sr, -sc),
                       (-2, -1))
        ref = y if ref is None else ref + y
    e23 = max_err(acc, ref / len(shifts))
    note("K20", e23, "K23 map")
    print(f"K23's map (4 spins of K19, K20 accumulating) vs the mean of the "
          f"rolled plain syntheses: {e23:.3e}; vs the image: "
          f"{max_err(acc, x):.3e}")
    return worst


def mxu_close(got, ref, prec):
    """The worst error of a tensor-core kernel against its plain version,
    or AssertionError.  "highest" (3xTF32): KERNEL_TOL.  "bf16": kernel
    and plain sum the same exact products of bf16 operands in another
    order, so an intermediate may round to its other bf16 neighbour, which
    moves an output by at most a tap times one bf16 ulp (2^-8 relative):
    max-abs within 2^-6 of the largest output, RMS within 1e-3 of the
    output's RMS."""
    if isinstance(got, torch.Tensor):
        got, ref = (got,), (ref,)
    worst = 0.0
    for g, r in zip(got, ref):
        err = (g - r).abs()
        e = float(err.max())
        if prec == "highest":
            ok = e <= KERNEL_TOL
        else:
            ok = (e <= 2 ** -6 * float(r.abs().max())
                  and float(err.pow(2).mean().sqrt())
                  <= 1e-3 * float(r.pow(2).mean().sqrt()))
        if not ok:
            raise AssertionError(f"{prec}: kernel vs plain {e:.3e}")
        worst = max(worst, e)
    return worst


def rms_gate(got, ref, what, level=1):
    """The "bf16" gate: RMS error <= 1 % of the reference's RMS (JAX's,
    ops/mxu_dwt.py:19-21) at level 1, doubling per level as the reference's
    envelope 3e-4 * 2^level does; an image of an L-level roundtrip at level
    L.  bf16 taps do not cancel the approximation's mean in a detail
    subband, and that mean doubles per level on 0..255 data (sym8 L3 on the
    CPU plain path: 0.57, 1.18, 2.37 % at levels 1-3; 0.28-0.60 % on
    zero-mean data); a roundtrip carries it through every level and back
    (db4 L3: 1.38 %).  Returns the relative RMS error."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    rel = float(np.sqrt(np.mean((got - ref) ** 2))
                / np.sqrt(np.mean(ref ** 2)))
    limit = BF16_RMS * 2 ** (level - 1)
    if not np.all(np.isfinite(got)) or rel > limit:
        raise AssertionError(f"{what}: RMS error {rel:.3e} of the "
                             f"reference's RMS > {limit}")
    return rel


def phase_kernels_mxu(port, dev, keys=None):
    """K5/K6 and K11a/K11b against their plain versions in both precisions
    over MXU_BANKS and SHAPES_MXU, SWT levels 1-4 (a level whose support
    passes the plane goes to K8/K9 through the router in mode "mxu"), and
    against the float64 oracle.  The worst "highest" errors go to the
    kernels line; the "bf16" ones are printed.  ``keys``: only those rows
    (--only)."""
    km, kms, fd = port.ops.mxu_dwt, port.ops.mxu_swt, port.ops.fused_dwt
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    worst = {p: {"K5": 0.0, "K6": 0.0, "K11a": 0.0, "K11b": 0.0}
             for p in PRECISIONS}
    routed = 0
    for name in MXU_BANKS:
        fb = port.get_filter_bank(name)
        for shape in SHAPES_MXU:
            x = torch.rand(shape, generator=gen, device=dev)
            c = [torch.rand(half(shape), generator=gen, device=dev)
                 for _ in range(4)]
            s = [torch.rand(shape, generator=gen, device=dev)
                 for _ in range(4)]
            for prec in PRECISIONS:
                w = worst[prec]

                def note(key, got, ref, what):
                    try:
                        w[key] = max(w[key], mxu_close(got, ref, prec))
                    except AssertionError as e:
                        raise AssertionError(f"{key} {what}: {e}") from None

                what = (name, shape, prec)
                if wanted(keys, "K5"):
                    got = launched_once(km.dwt2d_mxu_fused, lambda: (
                        km.dwt2d_mxu_fused(x, fb, prec)))
                    note("K5", got, km.dwt2d_mxu_plain(x, fb, prec), what)
                if wanted(keys, "K6"):
                    got = launched_once(km.idwt2d_mxu_fused, lambda: (
                        km.idwt2d_mxu_fused(*c, fb, shape, prec)))
                    note("K6", got, km.idwt2d_mxu_plain(*c, fb, shape, prec),
                         what)
                for level in (1, 2, 3, 4):
                    if kms.swt2d_mxu_unsupported(x, fb, level):
                        continue
                    if wanted(keys, "K11a"):
                        got = launched_once(kms.swt2d_mxu_fused, lambda: (
                            kms.swt2d_mxu_fused(x, fb, level, prec)))
                        note("K11a", got,
                             kms.swt2d_mxu_plain(x, fb, level, prec),
                             what + (level,))
                    if wanted(keys, "K11b"):
                        got = launched_once(kms.iswt2d_mxu_fused, lambda: (
                            kms.iswt2d_mxu_fused(*s, fb, level, prec)))
                        note("K11b", got,
                             kms.iswt2d_mxu_plain(*s, fb, level, prec),
                             what + (level,))
            # levels whose support passes the plane: K8/K9 in mode "mxu"
            for level in (1, 2, 3, 4):
                if not wanted(keys, "K11a", "K11b") or not (
                        kms.swt2d_mxu_unsupported(x, fb, level)):
                    continue
                port.dwt.set_kernels("mxu")
                try:
                    got = launched_once(fd.swt2d_fused, lambda: (
                        port.swt.swt2d_level(x, fb, level)))
                    back = launched_once(fd.iswt2d_fused, lambda: (
                        port.swt.iswt2d_level(*s, fb, level)))
                finally:
                    port.dwt.set_kernels("auto")
                err = max(max_err(got, fd.swt2d_plain(x, fb, level)),
                          max_err(back, fd.iswt2d_plain(*s, fb, level)))
                if err > KERNEL_TOL:
                    raise AssertionError(f"{name} {shape} L{level} on K8/K9 "
                                         f"in mode mxu: {err:.3e}")
                routed += 1
            del x, c, s
            torch.cuda.synchronize()
            print(f"kernel-vs-plain tensor cores {name:8s} hlen={fb.hlen:2d} "
                  f"{str(shape):16s} worst so far "
                  + "  ".join(f"{k} {v:.2e}/{worst['bf16'][k]:.2e}"
                              for k, v in worst["highest"].items())
                  + "  (highest/bf16)")
    print(f"SWT levels whose support passes the plane, routed to K8/K9 in "
          f"mode mxu: {routed}")

    oracle = load_oracle()
    rng = np.random.default_rng(SEED)
    for name in MXU_BANKS:
        fb = port.get_filter_bank(name)
        x = rng.random((16, 24), dtype=np.float32)
        c = [rng.random((8, 12), dtype=np.float32) for _ in range(4)]
        xs = rng.random((48, 64), dtype=np.float32)
        cs = [rng.random((48, 64), dtype=np.float32) for _ in range(4)]
        refs = {"K5": oracle.ref_analysis_2d(x, fb.dec_lo, fb.dec_hi),
                "K6": [oracle.ref_synthesis_2d(*c, fb.rec_lo, fb.rec_hi, 16,
                                               24)],
                "K11a": swt2d_oracle(oracle, xs, fb, 2),
                "K11b": [iswt2d_oracle(oracle, *cs, fb, 2)]}
        dev_t = [torch.from_numpy(t).to(dev) for t in (x, xs, *c, *cs)]
        tx, txs, tc, tcs = dev_t[0], dev_t[1], dev_t[2:6], dev_t[6:]
        line = []
        for prec in PRECISIONS:
            calls = {"K5": lambda: km.dwt2d_mxu_fused(tx, fb, prec),
                     "K6": lambda: [km.idwt2d_mxu_fused(*tc, fb, (16, 24),
                                                        prec)],
                     "K11a": lambda: kms.swt2d_mxu_fused(txs, fb, 2, prec),
                     "K11b": lambda: [kms.iswt2d_mxu_fused(*tcs, fb, 2,
                                                           prec)]}
            gots = {k: f() for k, f in calls.items() if wanted(keys, k)}
            for key, got in gots.items():
                got = [g.cpu().numpy() for g in got]
                if prec == "highest":
                    e = max(float(np.abs(g - r).max())
                            for g, r in zip(got, refs[key]))
                    if e > ORACLE_TOL:
                        raise AssertionError(f"{name} {key}: kernel vs "
                                             f"oracle {e:.3e} > {ORACLE_TOL}")
                else:
                    e = max(rms_gate(g, r, f"{name} {key} bf16 vs oracle")
                            for g, r in zip(got, refs[key]))
                line.append(f"{key} {prec} {e:.2e}")
        print(f"kernel-vs-oracle tensor cores {name:8s} " + "  ".join(line)
              + "  (bf16: relative RMS)")
    for key, e in worst["bf16"].items():
        if wanted(keys, key):
            print(f"worst bf16 kernel-vs-plain {key}: {e:.3e}")
    return {k: e for k, e in worst["highest"].items() if wanted(keys, k)}


def frame(shape, seed=SEED):
    return (np.random.default_rng(seed).random(shape) * 255).astype(
        np.float32)


def check_pyramid(got, ref, what):
    """Coefficients within 3e-4 * 2^level (A at the deepest level)."""
    levels = len(ref) - 1
    worst = 0.0
    pairs = [(got[0], ref[0], levels)]
    for lev in range(1, levels + 1):
        if isinstance(ref[lev], np.ndarray):  # 1D pyramid: one array
            pairs.append((got[lev], ref[lev], lev))
        else:
            pairs += [(g, r, lev) for g, r in zip(got[lev], ref[lev])]
    for g, r, lev in pairs:
        err = float(np.abs(np.asarray(g) - np.asarray(r)).max())
        if not np.all(np.isfinite(g)) or err > COEFF_TOL * 2 ** lev:
            raise AssertionError(f"{what}: level {lev} coefficient error "
                                 f"{err:.3e} > {COEFF_TOL * 2 ** lev:.1e}")
        worst = max(worst, err)
    return worst


def check_image(got, ref, what):
    err = float(np.abs(got - ref).max())
    if got.shape != ref.shape or not np.all(np.isfinite(got)) \
            or err > ROUNDTRIP_TOL:
        raise AssertionError(f"{what}: error {err:.3e} > {ROUNDTRIP_TOL}")
    return err


def expect_counts(fd, k1, k2, what):
    got = (fd.dwt2d_fused.launches, fd.idwt2d_fused.launches)
    if got != (k1, k2):
        raise AssertionError(f"{what}: K1/K2 launches {got}, expected "
                             f"({k1}, {k2})")


def phase_main_path(port, dev):
    fd = port.ops.fused_dwt
    img = frame(FRAME)

    ref = port.Wavelets(img, "db2", 3, device="cpu")
    ref.forward()
    ref_coeffs = ref.coeffs
    ref.soft_threshold(10.0)
    ref.inverse()

    port.ops.reset_counts()
    W = port.Wavelets(img, "db2", 3, device=dev)
    W.forward()
    coeffs = W.coeffs
    expect_counts(fd, 3, 0, "main path forward")
    W.soft_threshold(10.0)
    W.inverse()
    out = W.image
    torch.cuda.synchronize()
    launches = {"K1": fd.dwt2d_fused.launches,
                "K2": fd.idwt2d_fused.launches}
    expect_counts(fd, 3, 3, "main path")
    ec = check_pyramid(coeffs, ref_coeffs, "main path forward")
    ei = check_image(out, ref.image, "main path denoised image")
    print(f"main path db2 L3 {FRAME}: forward vs cpu {ec:.3e}, denoised "
          f"image vs cpu {ei:.3e}, launches {launches}")

    port.ops.reset_counts()
    W = port.Wavelets(img, "db2", 3, device=dev)
    W.forward()
    W.inverse()
    er = check_image(W.image, img, "db2 roundtrip")
    expect_counts(fd, 3, 3, "db2 roundtrip")
    print(f"roundtrip db2 L3 {FRAME}: {er:.3e}")

    fb = port.get_filter_bank("db2")
    stack = torch.from_numpy(frame((STACK, *FRAME), SEED + 1)).to(dev)
    port.ops.reset_counts()
    rec = port.dwt.waverec2(port.dwt.wavedec2(stack, fb, 3), fb, stack.shape)
    torch.cuda.synchronize()
    expect_counts(fd, 3, 3, "stack roundtrip")
    es = check_image(rec.cpu().numpy(), stack.cpu().numpy(),
                     "stack roundtrip")
    print(f"roundtrip db2 L3 {(STACK, *FRAME)}: {es:.3e}")

    href = port.Wavelets(img, "haar", 3, device="cpu").forward()
    port.ops.reset_counts()
    W = port.Wavelets(img, "haar", 3)
    W.forward()
    eh = check_pyramid(W.coeffs, href.coeffs, "haar forward")
    W.inverse()
    ehr = check_image(W.image, img, "haar roundtrip")
    expect_counts(fd, 3, 3, "haar")
    print(f"haar L3 {FRAME}: forward vs cpu butterfly {eh:.3e}, "
          f"roundtrip {ehr:.3e}")
    return launches


def expect_launches(ops, want, what):
    """Exactly ``want`` launches per kernel name (others 0)."""
    got = {k.__name__: k.launches for k in ops.KERNELS}
    expect = {name: want.get(name, 0) for name in got}
    if got != expect:
        raise AssertionError(f"{what}: launches {got}; expected {expect}")


def drive(port, dev, img, wname, levels, want_fwd, want, what, setup=None,
          **kw):
    """Wavelets forward -> soft_threshold(10) -> inverse on the card,
    counted from 0, against the same calls on the CPU plain path.
    ``setup`` (if given) is applied to both plans before they run."""
    ops = port.ops
    ref = port.Wavelets(img, wname, levels, device="cpu", **kw)
    W = port.Wavelets(img, wname, levels, device=dev, **kw)
    if setup is not None:
        setup(ref)
        setup(W)
    ref.forward()
    ref_coeffs = ref.coeffs
    ref.soft_threshold(10.0)
    ref.inverse()

    ops.reset_counts()
    W.forward()
    coeffs = W.coeffs
    expect_launches(ops, want_fwd, f"{what} forward")
    W.soft_threshold(10.0)
    W.inverse()
    out = W.image
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in ops.KERNELS if k.launches}
    expect_launches(ops, want, what)
    ec = check_pyramid(coeffs, ref_coeffs, f"{what} forward")
    ei = check_image(out, ref.image, f"{what} denoised image")
    print(f"main path {what}: forward vs cpu {ec:.3e}, denoised image vs "
          f"cpu {ei:.3e}, launches {launches}")
    return launches


def phase_main_paths_1d(port, dev):
    sino = frame(FRAME, SEED + 2)   # detector rows x projection angles
    sig = frame((SIGNAL,), SEED + 3)
    k3k4 = drive(port, dev, sino, "db2", 3, {"dwt1d_fused": 3},
                    {"dwt1d_fused": 3, "idwt1d_fused": 3},
                    f"batched-1D db2 L3 {FRAME}", ndim=1)
    k10 = drive(port, dev, sino, "db2", 3, {"swt1d_fused": 3},
                   {"swt1d_fused": 3, "iswt1d_fused": 3},
                   f"batched-1D SWT db2 L3 {FRAME}", ndim=1, do_swt=1)
    drive(port, dev, sig, "db2", 5, {"dwt1d_fused": 5},
             {"dwt1d_fused": 5, "idwt1d_fused": 5},
             f"signal db2 L5 ({SIGNAL},)")
    drive(port, dev, sig, "db2", 3, {"swt1d_fused": 3},
             {"swt1d_fused": 3, "iswt1d_fused": 3},
             f"signal SWT db2 L3 ({SIGNAL},)", do_swt=1)
    drive(port, dev, sino, "haar", 3, {"dwt1d_fused": 3},
             {"dwt1d_fused": 3, "idwt1d_fused": 3},
             f"batched-1D haar L3 {FRAME}", ndim=1)
    return {"K3": k3k4["dwt1d_fused"], "K4": k3k4["idwt1d_fused"],
            "K10a": k10["swt1d_fused"], "K10b": k10["iswt1d_fused"]}


def install_bank(f2d):
    """set_wavelets_filters with the four analysis and four synthesis
    filters of ``f2d`` (LL, HH, iLL, iHH, then LH, HL, iLH, iHL)."""
    def setup(W):
        W.set_wavelets_filters(f2d.name, f2d.dec[0], f2d.dec[3], f2d.rec[0],
                               f2d.rec[3], LH=f2d.dec[1], HL=f2d.dec[2],
                               i_LH=f2d.rec[1], i_HL=f2d.rec[2])
    return setup


def phase_main_paths_2d_swt(port, dev, keys=None):
    """The 2D SWT (db2 L3 on the frame and the stack) and the
    non-separable plans; ``keys``: the separable SWT only where K8 or K9
    is selected, the non-separable SWT of the custom bank only where K18a
    or K18b is (--only)."""
    img = frame(FRAME, SEED + 4)
    cross = banks_2d(port)[0]
    if keys is not None and not wanted(keys, "K8", "K9"):
        k18 = drive(port, dev, img, "db2", 3, {"ns_swt2d_fused": 3},
                    {"ns_swt2d_fused": 3, "ins_swt2d_fused": 3},
                    f"non-separable SWT {cross.name} L3 {FRAME}",
                    setup=install_bank(cross), do_separable=0, do_swt=1)
        return {k: v for k, v in (("K18a", k18["ns_swt2d_fused"]),
                                  ("K18b", k18["ins_swt2d_fused"]))
                if wanted(keys, k)}
    swt = drive(port, dev, img, "db2", 3, {"swt2d_fused": 3},
                {"swt2d_fused": 3, "iswt2d_fused": 3},
                f"2D SWT db2 L3 {FRAME}", do_swt=1)

    # the stack: coefficients of its first and last frames against the CPU
    # plain path, and the roundtrip of all of it
    fb = port.get_filter_bank("db2")
    stack = frame((STACK, *FRAME), SEED + 5)
    xs = torch.from_numpy(stack).to(dev)
    port.ops.reset_counts()
    pyr = port.swt.swt2d(xs, fb, 3)
    rec = port.swt.iswt2d(pyr, fb)
    torch.cuda.synchronize()
    expect_launches(port.ops, {"swt2d_fused": 3, "iswt2d_fused": 3},
                    "stack 2D SWT")
    ends = [0, STACK - 1]
    got = port.dwt.pyramid_to_numpy(
        [pyr[0][ends]] + [tuple(s[ends] for s in c) for c in pyr[1:]])
    ref = port.dwt.pyramid_to_numpy(
        port.swt.swt2d(torch.from_numpy(stack[ends]), fb, 3))
    ec = check_pyramid(got, ref, "stack 2D SWT forward")
    er = check_image(rec.cpu().numpy(), stack, "stack 2D SWT roundtrip")
    gib = sum(s.numel() for c in pyr[1:] for s in c) * 4 / 2 ** 30
    print(f"main path 2D SWT db2 L3 {(STACK, *FRAME)}: frames 0 and "
          f"{STACK - 1} vs cpu {ec:.3e}, roundtrip {er:.3e}, details "
          f"{gib:.2f} GiB, launches 3 + 3")
    del xs, pyr, rec
    if not wanted(keys, "K18a", "K18b"):
        return {k: v for k, v in (("K8", swt["swt2d_fused"]),
                                  ("K9", swt["iswt2d_fused"]))
                if wanted(keys, k)}

    drive(port, dev, img, "db2", 3, {"dwt2d_fused": 3},
          {"dwt2d_fused": 3, "idwt2d_fused": 3},
          f"non-separable db2 L3 {FRAME}", do_separable=0)
    drive(port, dev, img, "db2", 3, {"swt2d_fused": 3},
          {"swt2d_fused": 3, "iswt2d_fused": 3},
          f"non-separable SWT db2 L3 {FRAME}", do_separable=0, do_swt=1)
    k18 = drive(port, dev, img, "db2", 3, {"ns_swt2d_fused": 3},
                {"ns_swt2d_fused": 3, "ins_swt2d_fused": 3},
                f"non-separable SWT {cross.name} L3 {FRAME}",
                setup=install_bank(cross), do_separable=0, do_swt=1)
    return {"K8": swt["swt2d_fused"], "K9": swt["iswt2d_fused"],
            "K18a": k18["ns_swt2d_fused"], "K18b": k18["ins_swt2d_fused"]}


STATIC_SPINS = ((0, 0), (1, 1), (2, 2), (3, 3))
RANDOM_SPINS = 8
BETA = 10.0


def denoise_calls(port):
    """The pipeline paths of phases 4 and 5 on an image tensor, by name:
    (call, launches on the card at 2048^2, db2, L3)."""
    pipe = port.pipeline
    return {
        "4-spin static cycle spinning": (
            lambda x: pipe.denoise2d_cycle_spinning(
                x, "db2", 3, BETA, shifts=STATIC_SPINS),
            {"dwt2d_shifted_fused": 4, "idwt2d_unshift_fused": 4,
             "dwt2d_fused": 8, "idwt2d_fused": 8}),
        f"{RANDOM_SPINS}-spin random cycle spinning": (
            lambda x: pipe.denoise2d_cycle_spinning(
                x, "db2", 3, BETA, n_spins=RANDOM_SPINS,
                generator=torch.Generator().manual_seed(SEED)),
            {"dwt2d_shifted_fused": 3 * RANDOM_SPINS,
             "idwt2d_unshift_fused": 3 * RANDOM_SPINS}),
        "denoise2d": (lambda x: pipe.denoise2d(x, "db2", 3, BETA),
                      {"dwt2d_fused": 3, "idwt2d_fused": 3}),
        "denoise2d do_swt": (
            lambda x: pipe.denoise2d(x, "db2", 3, BETA, do_swt=True),
            {"swt2d_fused": 3, "iswt2d_fused": 3}),
    }


def phase_main_paths_pipeline(port, dev):
    """The denoising pipelines, the custom-bank non-separable DWT and an
    odd frame, each against the same call on the CPU plain path, with
    exact launches."""
    img = frame(FRAME, SEED + 6)
    launches = {}
    for what, (call, want) in denoise_calls(port).items():
        ref = call(torch.from_numpy(img)).numpy()
        port.ops.reset_counts()
        out = call(torch.from_numpy(img).to(dev))
        torch.cuda.synchronize()
        got = {k.__name__: k.launches for k in port.ops.KERNELS if k.launches}
        expect_launches(port.ops, want, what)
        err = check_image(out.cpu().numpy(), ref, what)
        print(f"main path {what} db2 L3 beta {BETA} {FRAME}: image vs cpu "
              f"{err:.3e}, launches {got}")
        launches.update({k: v for k, v in got.items()
                         if k in ("dwt2d_shifted_fused",
                                  "idwt2d_unshift_fused")
                         and what.startswith("4-spin")})
    cross = banks_2d(port)[0]
    k16 = drive(port, dev, img, "db2", 3, {"nsdwt2d_fused": 3},
                {"nsdwt2d_fused": 3, "insdwt2d_fused": 3},
                f"non-separable DWT {cross.name} L3 {FRAME}",
                setup=install_bank(cross), do_separable=0)
    drive(port, dev, frame(ODD_FRAME, SEED + 7), "db2", 3,
          {"dwt2d_fused": 3}, {"dwt2d_fused": 3, "idwt2d_fused": 3},
          f"db2 L3 {ODD_FRAME}")
    return {"K19": launches["dwt2d_shifted_fused"],
            "K20": launches["idwt2d_unshift_fused"],
            "K16": k16["nsdwt2d_fused"], "K17": k16["insdwt2d_fused"]}


def drive_mxu(port, dev, img, prec, do_swt, want, what):
    """Wavelets(img, "sym8", 3) forward -> soft_threshold(10) -> inverse on
    the card in mode "mxu" at ``prec``, counted from 0, then a plain
    roundtrip; held against the CPU plain path of mode "auto": "highest"
    within the reference envelope, "bf16" within JAX's loose gate."""
    ops, dwt = port.ops, port.dwt
    ref = port.Wavelets(img, "sym8", 3, device="cpu", do_swt=do_swt)
    ref.forward()
    ref_coeffs = ref.coeffs
    ref.soft_threshold(10.0)
    ref.inverse()
    fwd = {k: v for k, v in want.items() if not k.startswith("i")}
    dwt.set_kernels("mxu")
    dwt.set_mxu_precision(prec)
    try:
        W = port.Wavelets(img, "sym8", 3, device=dev, do_swt=do_swt)
        ops.reset_counts()
        W.forward()
        coeffs = W.coeffs
        expect_launches(ops, fwd, f"{what} forward")
        W.soft_threshold(10.0)
        W.inverse()
        out = W.image
        torch.cuda.synchronize()
        launches = {k.__name__: k.launches for k in ops.KERNELS
                    if k.launches}
        expect_launches(ops, want, what)
        R = port.Wavelets(img, "sym8", 3, device=dev, do_swt=do_swt)
        R.forward()
        R.inverse()
        back = R.image
    finally:
        dwt.set_kernels("auto")
        dwt.set_mxu_precision("highest")
    levels = len(coeffs) - 1
    if prec == "highest":
        ec = check_pyramid(coeffs, ref_coeffs, f"{what} forward")
        ei = check_image(out, ref.image, f"{what} denoised image")
        er = check_image(back, img, f"{what} roundtrip")
        kind = "max-abs"
    else:
        flat = [(coeffs[0], ref_coeffs[0], levels)] + [
            (g, r, lev) for lev in range(1, levels + 1)
            for g, r in zip(coeffs[lev], ref_coeffs[lev])]
        ec = max(rms_gate(g, r, f"{what} level {lev}", lev)
                 for g, r, lev in flat)
        ei = rms_gate(out, ref.image, f"{what} denoised image", levels)
        er = rms_gate(back, img, f"{what} roundtrip", levels)
        kind = "relative RMS"
    print(f"main path {what}: forward vs cpu {ec:.3e}, denoised image vs "
          f"cpu {ei:.3e}, roundtrip {er:.3e} ({kind}), launches {launches}")
    return launches


def phase_main_paths_mxu(port, dev, keys=None):
    """Mode "mxu", both precisions: the sym8 L3 frame through Wavelets, DWT
    (3 K5, 3 K6) and SWT (3 K11a, 3 K11b), and the (8, 2048, 2048) stack
    through wavedec2/waverec2 and swt2d/iswt2d, its first and last frames
    against the CPU plain path.  ``keys``: only the transforms whose
    kernels are among them (--only)."""
    dwt, swt = port.dwt, port.swt
    img = frame(FRAME, SEED + 12)
    want_d = {"dwt2d_mxu_fused": 3, "idwt2d_mxu_fused": 3}
    want_s = {"swt2d_mxu_fused": 3, "iswt2d_mxu_fused": 3}
    do_dwt, do_swt = wanted(keys, "K5", "K6"), wanted(keys, "K11a", "K11b")
    launches = {}
    for prec in PRECISIONS:
        got = {}
        if do_dwt:
            got.update(drive_mxu(port, dev, img, prec, 0, want_d,
                                 f"mxu {prec} sym8 L3 {FRAME}"))
        if do_swt:
            got.update(drive_mxu(port, dev, img, prec, 1, want_s,
                                 f"mxu {prec} 2D SWT sym8 L3 {FRAME}"))
        if prec == "highest":
            launches = got

    fb = port.get_filter_bank("sym8")
    stack = frame((STACK, *FRAME), SEED + 13)
    ends = [0, STACK - 1]
    cpu = torch.from_numpy(stack[ends])
    refs = {"DWT": dwt.pyramid_to_numpy(dwt.wavedec2(cpu, fb, 3)),
            "SWT": dwt.pyramid_to_numpy(swt.swt2d(cpu, fb, 3))}
    xs = torch.from_numpy(stack).to(dev)
    runs = {"DWT": (lambda: dwt.wavedec2(xs, fb, 3),
                    lambda p: dwt.waverec2(p, fb, xs.shape), want_d),
            "SWT": (lambda: swt.swt2d(xs, fb, 3), lambda p: swt.iswt2d(p, fb),
                    want_s)}
    runs = {k: r for k, r in runs.items()
            if (do_dwt if k == "DWT" else do_swt)}
    for prec in PRECISIONS:
        for kind, (fwd, inv, want) in runs.items():
            dwt.set_kernels("mxu")
            dwt.set_mxu_precision(prec)
            try:
                port.ops.reset_counts()
                pyr = fwd()
                rec = inv(pyr)
                torch.cuda.synchronize()
                expect_launches(port.ops, want, f"stack {kind} mxu {prec}")
            finally:
                dwt.set_kernels("auto")
                dwt.set_mxu_precision("highest")
            got = dwt.pyramid_to_numpy(
                [pyr[0][ends]] + [tuple(s[ends] for s in c) for c in pyr[1:]])
            rec = rec.cpu().numpy()
            what = f"stack {kind} mxu {prec} sym8 L3 {(STACK, *FRAME)}"
            if prec == "highest":
                ec = check_pyramid(got, refs[kind], what)
                er = check_image(rec, stack, f"{what} roundtrip")
            else:
                ref = refs[kind]
                ec = max([rms_gate(got[0], ref[0], what, 3)] + [
                    rms_gate(g, r, f"{what} level {lev}", lev)
                    for lev in range(1, 4)
                    for g, r in zip(got[lev], ref[lev])])
                er = rms_gate(rec, stack, f"{what} roundtrip", 3)
            print(f"main path {what}: frames 0 and {STACK - 1} vs cpu "
                  f"{ec:.3e}, roundtrip {er:.3e}, launches 3 + 3")
            del pyr, rec
    del xs
    names = {"K5": "dwt2d_mxu_fused", "K6": "idwt2d_mxu_fused",
             "K11a": "swt2d_mxu_fused", "K11b": "iswt2d_mxu_fused"}
    return {k: launches[n] for k, n in names.items() if wanted(keys, k)}


def cuda_ms(fn, reps, device_only, samples=SAMPLES, required=True):
    """Median over ``samples`` of the time per call of ``reps``
    back-to-back calls between two CUDA events, after a warm-up.

    device_only: a sleep kernel queued first keeps the device busy while
    the host enqueues the calls, so the interval holds their device time
    and none of the host's launch overhead (a sample in which the device
    caught up with the host is taken again with a longer sleep).
    Otherwise the interval is what a caller feels: the host's launch
    overhead counts wherever it exceeds the device time.  A call of more
    launches than the device's launch queue holds blocks the host behind
    the sleep, so it has no device-only time: None unless ``required``.
    """
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    sleep = SLEEP_CYCLES
    while len(times) < samples:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(sleep)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        caught_up = device_only and start.query()
        end.synchronize()
        if caught_up:
            if sleep > 100 * SLEEP_CYCLES or not required and sleep > (
                    8 * SLEEP_CYCLES):
                if not required:
                    return None
                raise RuntimeError("the host cannot enqueue ahead of the "
                                   "device: no device-only time")
            sleep *= 2
            continue
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def turns(plain, kernel, reps, device_only, samples=SAMPLES):
    """plain, kernel, kernel, plain: (kernel ms, plain ms), each the mean
    of its two medians."""
    p1 = cuda_ms(plain, reps, device_only, samples)
    k1 = cuda_ms(kernel, reps, device_only, samples)
    k2 = cuda_ms(kernel, reps, device_only, samples)
    p2 = cuda_ms(plain, reps, device_only, samples)
    return (k1 + k2) / 2, (p1 + p2) / 2


def phase_times(port, dev, card):
    fd = port.ops.fused_dwt
    dwt = port.dwt
    fb = port.get_filter_bank("db2")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    # timed calls cycle over inputs that together exceed the 50 MB L2, so
    # no call finds its input in cache from the one before
    frames = [torch.rand(FRAME, generator=gen, device=dev) * 255
              for _ in range(4)]
    nx = itertools.cycle(frames).__next__
    k1_ms, k1_plain = turns(lambda: fd.dwt2d_plain(nx(), fb),
                            lambda: fd.dwt2d_fused(nx(), fb), 10, True)
    coeffs = [fd.dwt2d_fused(f, fb) for f in frames]
    nc = itertools.cycle(coeffs).__next__
    k2_ms, k2_plain = turns(lambda: fd.idwt2d_plain(*nc(), fb, FRAME),
                            lambda: fd.idwt2d_fused(*nc(), fb, FRAME), 10,
                            True)
    level_bytes = 2 * 4 * FRAME[0] * FRAME[1]
    for name, ms, plain in (("K1 dwt2d", k1_ms, k1_plain),
                            ("K2 idwt2d", k2_ms, k2_plain)):
        gbs = level_bytes / (ms * 1e-3) / 1e9
        print(f"time {name} level 0 db2 {FRAME}, device: kernel "
              f"{ms * 1e3:.1f} us ({gbs:.0f} GB/s, {gbs / 3350:.1%} of "
              f"3.35 TB/s), plain {plain * 1e3:.1f} us  [{card}]")

    def roundtrip(x):
        return dwt.waverec2(dwt.wavedec2(x, fb, 3), fb, x.shape)

    def with_mode(mode, x):
        def run():
            dwt.set_kernels(mode)
            roundtrip(x())
        return run

    stack = [torch.rand((STACK, *FRAME), generator=gen, device=dev) * 255]
    for label, src, per_call in ((f"{FRAME}", nx, 1),
                                 (f"({STACK}, {FRAME[0]}, {FRAME[1]})",
                                  itertools.cycle(stack).__next__, STACK)):
        for clock, device_only in (("device", True), ("wall", False)):
            ms, plain = turns(with_mode("torch", src),
                              with_mode("cuda", src), 3, device_only)
            print(f"time L3 db2 roundtrip {label}, {clock}: kernel path "
                  f"{ms:.3f} ms ({per_call * 1e3 / ms:.0f} frames/s), plain "
                  f"path {plain:.3f} ms ({per_call * 1e3 / plain:.0f} "
                  f"frames/s)  [{card}]")
    dwt.set_kernels("auto")
    return {"K1": (k1_ms, k1_plain), "K2": (k2_ms, k2_plain)}


def phase_times_1d(port, dev, card):
    fd = port.ops.fused_dwt
    dwt, swt = port.dwt, port.swt
    fb = port.get_filter_bank("db2")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    # inputs that together exceed the 50 MB L2, as in phase_times
    rows = [torch.rand(FRAME, generator=gen, device=dev) * 255
            for _ in range(4)]
    nx = itertools.cycle(rows).__next__
    dcoef = itertools.cycle([fd.dwt1d_fused(r, fb) for r in rows]).__next__
    scoef = itertools.cycle([fd.swt1d_fused(r, fb, 1) for r in rows]).__next__
    n = FRAME[1]
    cases = (
        ("K3", "K3 dwt1d", 32, lambda: fd.dwt1d_plain(nx(), fb),
         lambda: fd.dwt1d_fused(nx(), fb)),
        ("K4", "K4 idwt1d", 32, lambda: fd.idwt1d_plain(*dcoef(), fb, n),
         lambda: fd.idwt1d_fused(*dcoef(), fb, n)),
        ("K10a", "K10a swt1d", 48, lambda: fd.swt1d_plain(nx(), fb, 1),
         lambda: fd.swt1d_fused(nx(), fb, 1)),
        ("K10b", "K10b iswt1d", 48, lambda: fd.iswt1d_plain(*scoef(), fb, 1),
         lambda: fd.iswt1d_fused(*scoef(), fb, 1)),
    )
    times = {}
    for key, name, mib, plain, kernel in cases:
        ms, plain_ms = turns(plain, kernel, 10, True)
        times[key] = (ms, plain_ms)
        gbs = mib * 2 ** 20 / (ms * 1e-3) / 1e9
        print(f"time {name} level 0 db2 {FRAME} rows, device: kernel "
              f"{ms * 1e3:.1f} us ({gbs:.0f} GB/s, {gbs / 3350:.1%} of "
              f"3.35 TB/s, {mib} MiB), plain {plain_ms * 1e3:.1f} us  "
              f"[{card}]")

    def dwt_rt(levels):
        return lambda x: dwt.waverec1(dwt.wavedec1(x, fb, levels), fb,
                                      x.shape[-1])

    def swt_rt(levels):
        return lambda x: swt.iswt1d(swt.swt1d(x, fb, levels), fb)

    def with_mode(mode, rt, src):
        def run():
            dwt.set_kernels(mode)
            rt(src())
        return run

    sigs = itertools.cycle([torch.rand((SIGNAL,), generator=gen, device=dev)
                            * 255 for _ in range(4)]).__next__
    for label, rt, src, unit in (
            (f"batched-1D DWT L3 db2 {FRAME}", dwt_rt(3), nx, "frames"),
            (f"batched-1D SWT L3 db2 {FRAME}", swt_rt(3), nx, "frames"),
            (f"signal DWT L5 db2 ({SIGNAL},)", dwt_rt(5), sigs, "signals"),
            (f"signal SWT L3 db2 ({SIGNAL},)", swt_rt(3), sigs, "signals")):
        for clock, device_only in (("device", True), ("wall", False)):
            ms, plain = turns(with_mode("torch", rt, src),
                              with_mode("cuda", rt, src), 3, device_only)
            print(f"time roundtrip {label}, {clock}: kernel path {ms:.3f} ms "
                  f"({1e3 / ms:.0f} {unit}/s), plain path {plain:.3f} ms "
                  f"({1e3 / plain:.0f} {unit}/s)  [{card}]")
    dwt.set_kernels("auto")
    return times


def phase_times_2d_swt(port, dev, card, keys=None):
    """K8/K9 at levels 1 and 3 of the frame (db2), K18a/K18b at level 1,
    and the L3 roundtrip; ``keys``: only K8's or K9's levels (--only)."""
    fd, kn = port.ops.fused_dwt, port.ops.nonsep
    swt = port.swt
    fb = port.get_filter_bank("db2")
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    # inputs that together exceed the 50 MB L2, as in phase_times
    frames = [torch.rand(FRAME, generator=gen, device=dev) * 255
              for _ in range(4)]
    nx = itertools.cycle(frames).__next__
    level_mib = 80  # 16 MiB in, 64 MiB out (K9: the reverse)
    times = {}
    for level in (1, 3):
        coef = itertools.cycle([fd.swt2d_fused(f, fb, level)
                                for f in frames]).__next__
        got = {}
        if wanted(keys, "K8"):
            got["K8 swt2d"] = turns(lambda: fd.swt2d_plain(nx(), fb, level),
                                    lambda: fd.swt2d_fused(nx(), fb, level),
                                    10, True)
        if wanted(keys, "K9"):
            got["K9 iswt2d"] = turns(
                lambda: fd.iswt2d_plain(*coef(), fb, level),
                lambda: fd.iswt2d_fused(*coef(), fb, level), 10, True)
        for name, (ms, plain) in got.items():
            gbs = level_mib * 2 ** 20 / (ms * 1e-3) / 1e9
            print(f"time {name} level {level} db2 {FRAME}, device: kernel "
                  f"{ms * 1e3:.1f} us ({gbs:.0f} GB/s, {gbs / 3350:.1%} of "
                  f"3.35 TB/s), plain {plain * 1e3:.1f} us  [{card}]")
            if level == 1:
                times[name.split()[0]] = got[name]
    if keys is not None:
        return times
    cross = banks_2d(port)[0]
    coef = itertools.cycle([kn.ns_swt2d_fused(f, cross, 1)
                            for f in frames]).__next__
    times["K18a"] = turns(lambda: kn.ns_swt2d_plain(nx(), cross, 1),
                          lambda: kn.ns_swt2d_fused(nx(), cross, 1), 3, True)
    times["K18b"] = turns(lambda: kn.ins_swt2d_plain(*coef(), cross, 1),
                          lambda: kn.ins_swt2d_fused(*coef(), cross, 1), 3,
                          True)
    for key, name in (("K18a", "K18a ns_swt2d"), ("K18b", "K18b ins_swt2d")):
        ms, plain = times[key]
        print(f"time {name} level 1 {cross.name} {FRAME}, device: kernel "
              f"{ms * 1e3:.1f} us, plain {plain * 1e3:.1f} us  [{card}]")

    def with_mode(mode):
        def run():
            port.dwt.set_kernels(mode)
            swt.iswt2d(swt.swt2d(nx(), fb, 3), fb)
        return run

    for clock, device_only in (("device", True), ("wall", False)):
        ms, plain = turns(with_mode("torch"), with_mode("cuda"), 3,
                          device_only)
        print(f"time L3 db2 2D SWT roundtrip {FRAME}, {clock}: kernel path "
              f"{ms:.3f} ms ({1e3 / ms:.0f} frames/s), plain path "
              f"{plain:.3f} ms ({1e3 / plain:.0f} frames/s)  [{card}]")
    nsswt_roundtrip(port, nx, cross, card)
    port.dwt.set_kernels("auto")
    return times


def nsswt_roundtrip(port, nx, f2d, card):
    """Device and wall time of the L3 non-separable SWT roundtrip
    (core.nonsep: 3 K18a + 3 K18b) of the frames ``nx`` gives, on the
    kernels against the plain path, in turns."""
    ns = port.nonsep

    def with_mode(mode):
        def run():
            port.dwt.set_kernels(mode)
            ns.ins_swt2d(ns.ns_swt2d(nx(), f2d, 3), f2d)
        return run

    # the plain path's thousands of launches outrun the device's launch
    # queue behind a sleep: it has a wall time only
    kernel, plain = with_mode("cuda"), with_mode("torch")
    try:
        device = (cuda_ms(kernel, 3, True) + cuda_ms(kernel, 3, True)) / 2
        wall, plain_wall = turns(plain, kernel, 1, False)
    finally:
        port.dwt.set_kernels("auto")
    print(f"time L3 {f2d.name} non-separable SWT roundtrip {FRAME}: kernel "
          f"path {device:.3f} ms device, {wall:.3f} ms wall ({1e3 / wall:.0f} "
          f"frames/s), plain path {plain_wall:.3f} ms wall  [{card}]")


def phase_times_slice(port, dev, card):
    """K16/K17 (db3 x coif1) and K19 (soft epilogue) / K20 (accumulating)
    at level 0 of 2048^2 against their plain versions, and the cycle
    spinning paths in frames/s, kernel path against plain path."""
    ks, kn = port.ops.shifted, port.ops.nonsep
    fb = port.get_filter_bank("db2")
    cross = banks_2d(port)[0]
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    # inputs that together exceed the 50 MB L2, as in phase_times
    frames = [torch.rand(FRAME, generator=gen, device=dev) * 255
              for _ in range(4)]
    nx = itertools.cycle(frames).__next__
    ncoef = itertools.cycle([kn.nsdwt2d_fused(f, cross)
                             for f in frames]).__next__
    scoef = itertools.cycle([ks.dwt2d_shifted_fused(f, fb, 1, 1)
                             for f in frames]).__next__
    times = {
        "K16": turns(lambda: kn.nsdwt2d_plain(nx(), cross),
                     lambda: kn.nsdwt2d_fused(nx(), cross), 3, True),
        "K17": turns(lambda: kn.insdwt2d_plain(*ncoef(), cross, FRAME),
                     lambda: kn.insdwt2d_fused(*ncoef(), cross, FRAME), 3,
                     True),
        "K19": turns(lambda: ks.dwt2d_shifted_plain(nx(), fb, 1, 1, "soft",
                                                    BETA),
                     lambda: ks.dwt2d_shifted_fused(nx(), fb, 1, 1, "soft",
                                                    BETA), 10, True),
        "K20": turns(lambda: ks.idwt2d_unshift_plain(*scoef(), fb, FRAME, 1,
                                                     1, nx(), 0.25),
                     lambda: ks.idwt2d_unshift_fused(*scoef(), fb, FRAME, 1,
                                                     1, nx(), 0.25), 10,
                     True),
    }
    for key, what, mib in (("K16", f"K16 nsdwt2d {cross.name}", 32),
                           ("K17", f"K17 insdwt2d {cross.name}", 32),
                           ("K19", "K19 dwt2d_shifted db2 (1, 1) soft", 32),
                           ("K20", "K20 idwt2d_unshift db2 (1, 1) acc", 48)):
        ms, plain = times[key]
        gbs = mib * 2 ** 20 / (ms * 1e-3) / 1e9
        print(f"time {what} level 0 {FRAME}, device: kernel "
              f"{ms * 1e3:.1f} us ({gbs:.0f} GB/s, {gbs / 3350:.1%} of "
              f"3.35 TB/s, {mib} MiB), plain {plain * 1e3:.1f} us  [{card}]")

    def with_mode(mode, call):
        def run():
            port.dwt.set_kernels(mode)
            call(nx())
        return run

    calls = denoise_calls(port)
    for what in ("4-spin static cycle spinning",
                 f"{RANDOM_SPINS}-spin random cycle spinning"):
        kernel = with_mode("cuda", calls[what][0])
        plain = with_mode("torch", calls[what][0])
        ms = cuda_ms(kernel, 1, True, 7)
        plain_ms = cuda_ms(plain, 1, True, 3, required=False)
        shown = ("not measured (its launches overflow the launch queue "
                 "behind the sleep)" if plain_ms is None else
                 f"{plain_ms:.3f} ms ({1e3 / plain_ms:.1f} frames/s)")
        print(f"time {what} db2 L3 {FRAME}, device: kernel path {ms:.3f} ms "
              f"({1e3 / ms:.1f} frames/s), plain path {shown}  [{card}]")
        ms, plain_ms = turns(plain, kernel, 1, False, samples=7)
        print(f"time {what} db2 L3 {FRAME}, wall: kernel path {ms:.3f} ms "
              f"({1e3 / ms:.1f} frames/s), plain path {plain_ms:.3f} ms "
              f"({1e3 / plain_ms:.1f} frames/s)  [{card}]")
    port.dwt.set_kernels("auto")
    return times


def in_turns(calls, reps, samples=SAMPLES, device_only=True):
    """Device time (or, ``device_only`` False, wall time) of each call
    (ms): the calls in order, then in reverse (a, b, c, c, b, a), each the
    mean of its two medians."""
    seen = {k: [] for k in calls}
    for key in list(calls) + list(reversed(calls)):
        seen[key].append(cuda_ms(calls[key], reps[key], device_only,
                                 samples))
    return {k: sum(v) / 2 for k, v in seen.items()}


def phase_times_mxu(port, dev, card, keys=None):
    """K5 against K1 and K6 against K2 at sym8 level 0, K11a against K8
    and K11b against K9 at sym8 level 1, 2048^2, each with its plain
    version ("highest") and its "bf16" time, in turns within this call
    (``keys``: only those rows)."""
    km, kms, fd = port.ops.mxu_dwt, port.ops.mxu_swt, port.ops.fused_dwt
    fb = port.get_filter_bank("sym8")
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    frames = [torch.rand(FRAME, generator=gen, device=dev) * 255
              for _ in range(4)]
    nx = itertools.cycle(frames).__next__
    dc = itertools.cycle([km.dwt2d_mxu_fused(f, fb) for f in frames]).__next__
    sc = itertools.cycle([kms.swt2d_mxu_fused(f, fb, 1)
                          for f in frames]).__next__
    cases = {
        "K5": ("K1", 32, {
            "plain": lambda: km.dwt2d_mxu_plain(nx(), fb),
            "highest": lambda: km.dwt2d_mxu_fused(nx(), fb),
            "bf16": lambda: km.dwt2d_mxu_fused(nx(), fb, "bf16"),
            "tap": lambda: fd.dwt2d_fused(nx(), fb)}),
        "K6": ("K2", 32, {
            "plain": lambda: km.idwt2d_mxu_plain(*dc(), fb, FRAME),
            "highest": lambda: km.idwt2d_mxu_fused(*dc(), fb, FRAME),
            "bf16": lambda: km.idwt2d_mxu_fused(*dc(), fb, FRAME, "bf16"),
            "tap": lambda: fd.idwt2d_fused(*dc(), fb, FRAME)}),
        "K11a": ("K8", 80, {
            "plain": lambda: kms.swt2d_mxu_plain(nx(), fb, 1),
            "highest": lambda: kms.swt2d_mxu_fused(nx(), fb, 1),
            "bf16": lambda: kms.swt2d_mxu_fused(nx(), fb, 1, "bf16"),
            "tap": lambda: fd.swt2d_fused(nx(), fb, 1)}),
        "K11b": ("K9", 80, {
            "plain": lambda: kms.iswt2d_mxu_plain(*sc(), fb, 1),
            "highest": lambda: kms.iswt2d_mxu_fused(*sc(), fb, 1),
            "bf16": lambda: kms.iswt2d_mxu_fused(*sc(), fb, 1, "bf16"),
            "tap": lambda: fd.iswt2d_fused(*sc(), fb, 1)}),
    }
    reps = {"plain": 3, "highest": 10, "bf16": 10, "tap": 10}
    times = {}
    for key, (tap, mib, calls) in cases.items():
        if not wanted(keys, key):
            continue
        t = in_turns(calls, reps)
        times[key] = (t["highest"], t["plain"])
        gbs = mib * 2 ** 20 / (t["highest"] * 1e-3) / 1e9
        print(f"time {key} sym8 level {0 if key in ('K5', 'K6') else 1} "
              f"{FRAME}, device: kernel {t['highest'] * 1e3:.1f} us "
              f"({gbs:.0f} GB/s, {gbs / 3350:.1%} of 3.35 TB/s, {mib} MiB), "
              f"bf16 {t['bf16'] * 1e3:.1f} us, {tap} {t['tap'] * 1e3:.1f} "
              f"us, plain {t['plain'] * 1e3:.1f} us  [{card}]")
    return times


def phase_times_swt_levels(port, dev, card, key):
    """K11a or K11b (``key``) at sym8 and levels 1-3 of 2048^2 ("highest"
    and "bf16"), beside the tap loop on the same level (K8 or K9), in turns
    (--only): the deeper levels gather windows and scatter outputs strided
    by 2 and 4."""
    kms, fd = port.ops.mxu_swt, port.ops.fused_dwt
    fb = port.get_filter_bank("sym8")
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    frames = [torch.rand(FRAME, generator=gen, device=dev) * 255
              for _ in range(4)]
    nbytes, flops = timed_work(port)[key]
    bound_ms = bound(nbytes, flops)[0]
    tap = "K8" if key == "K11a" else "K9"
    for level in (1, 2, 3):
        if key == "K11a":
            nx = itertools.cycle(frames).__next__
            calls = {
                "highest": lambda: kms.swt2d_mxu_fused(nx(), fb, level),
                "bf16": lambda: kms.swt2d_mxu_fused(nx(), fb, level, "bf16"),
                "tap": lambda: fd.swt2d_fused(nx(), fb, level)}
        else:
            sc = itertools.cycle([kms.swt2d_mxu_fused(f, fb, level)
                                  for f in frames]).__next__
            calls = {
                "highest": lambda: kms.iswt2d_mxu_fused(*sc(), fb, level),
                "bf16": lambda: kms.iswt2d_mxu_fused(*sc(), fb, level,
                                                     "bf16"),
                "tap": lambda: fd.iswt2d_fused(*sc(), fb, level)}
        t = in_turns(calls, {"highest": 10, "bf16": 10, "tap": 10})
        print(f"time {key} sym8 level {level} {FRAME}, device: highest "
              f"{t['highest'] * 1e3:.1f} us, bf16 {t['bf16'] * 1e3:.1f} us, "
              f"{tap} {t['tap'] * 1e3:.1f} us (bound {bound_ms * 1e3:.1f} "
              f"us)  [{card}]")


def phase_times_k6_levels(port, dev, card):
    """K6 at sym8 and levels 0-2 of 2048^2 ("highest" and "bf16"), beside
    the tap loop on the same level (K2), in turns (--only): coefficient
    planes of 1024^2, 512^2 and 256^2."""
    km, fd = port.ops.mxu_dwt, port.ops.fused_dwt
    fb = port.get_filter_bank("sym8")
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    for level in (0, 1, 2):
        shape = (FRAME[0] >> level, FRAME[1] >> level)
        coeffs = [km.dwt2d_mxu_fused(torch.rand(shape, generator=gen,
                                                device=dev) * 255, fb)
                  for _ in range(4)]
        dc = itertools.cycle(coeffs).__next__
        calls = {
            "highest": lambda: km.idwt2d_mxu_fused(*dc(), fb, shape),
            "bf16": lambda: km.idwt2d_mxu_fused(*dc(), fb, shape, "bf16"),
            "tap": lambda: fd.idwt2d_fused(*dc(), fb, shape)}
        t = in_turns(calls, {"highest": 10, "bf16": 10, "tap": 10})
        nbytes = 8 * shape[0] * shape[1]
        print(f"time K6 sym8 level {level} {shape}, device: highest "
              f"{t['highest'] * 1e3:.1f} us, bf16 {t['bf16'] * 1e3:.1f} us, "
              f"K2 {t['tap'] * 1e3:.1f} us (bound "
              f"{nbytes / PEAK_BYTES * 1e6:.1f} us)  [{card}]")


def phase_times_k5_levels(port, dev, card):
    """K5 at sym8 and levels 0-2 of 2048^2 ("highest" and "bf16"), beside
    the tap loop on the same level (K1), in turns (--only): planes of
    2048^2, 1024^2 and 512^2."""
    km, fd = port.ops.mxu_dwt, port.ops.fused_dwt
    fb = port.get_filter_bank("sym8")
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    for level in (0, 1, 2):
        shape = (FRAME[0] >> level, FRAME[1] >> level)
        frames = [torch.rand(shape, generator=gen, device=dev) * 255
                  for _ in range(4)]
        nx = itertools.cycle(frames).__next__
        calls = {
            "highest": lambda: km.dwt2d_mxu_fused(nx(), fb),
            "bf16": lambda: km.dwt2d_mxu_fused(nx(), fb, "bf16"),
            "tap": lambda: fd.dwt2d_fused(nx(), fb)}
        t = in_turns(calls, {"highest": 10, "bf16": 10, "tap": 10})
        nbytes = 8 * shape[0] * shape[1]
        print(f"time K5 sym8 level {level} {shape}, device: highest "
              f"{t['highest'] * 1e3:.1f} us, bf16 {t['bf16'] * 1e3:.1f} us, "
              f"K1 {t['tap'] * 1e3:.1f} us (bound "
              f"{nbytes / PEAK_BYTES * 1e6:.1f} us)  [{card}]")


# (key, C entry, halo): the instances of tc_swt2d.cu and of K5's and K6's
# bodies in tc_dwt2d.cu whose occupancy --only reports
TC2D_OCCUPANCY = (("K11a", "pypwt_tc_swt2d_occupancy", 0),
                  ("K28 swt", "pypwt_tc_swt2d_occupancy", 1),
                  ("K11b", "pypwt_tc_iswt2d_occupancy", 0),
                  ("K28 iswt", "pypwt_tc_iswt2d_occupancy", 1),
                  ("K5", "pypwt_tc_dwt2d_occupancy", 0),
                  ("K28 dwt", "pypwt_tc_dwt2d_occupancy", 1),
                  ("K6", "pypwt_tc_idwt2d_occupancy", 0),
                  ("K28 idwt", "pypwt_tc_idwt2d_occupancy", 1))


def print_tc2d_occupancy(port, dev, keys):
    """Resident blocks per SM (the occupancy API) and dynamic shared memory
    of the 2D tensor-core instances that the selected rows among K11a, K28
    swt, K11b, K28 iswt, K5, K28 dwt, K6 and K28 idwt run at sym8 (a build
    without the query says so)."""
    from pypwt_tpu_torch.ops import _build
    lib = _build.load_library()
    hlen = port.get_filter_bank("sym8").hlen
    for key, entry, halo in TC2D_OCCUPANCY:
        if not wanted(keys, key):
            continue
        if not hasattr(lib, entry):
            print(f"occupancy {key}: not reported by this build")
            continue
        for prec in PRECISIONS:
            blocks, smem = ctypes.c_int(), ctypes.c_int()
            err = getattr(lib, entry)(
                hlen, int(prec == "bf16"), halo, dev.index,
                ctypes.byref(blocks), ctypes.byref(smem))
            if err:
                raise RuntimeError(f"occupancy query {key} {prec}: error "
                                   f"{err}")
            print(f"occupancy {key} sym8 {prec}: {blocks.value} blocks of "
                  f"256 threads per SM, {smem.value} bytes of dynamic "
                  "shared memory each")


# (key, synthesis, halo, rows, samples or coefficients per row): the
# launches K7a/K7b make at level 1 of the sinogram and K29e/K29f on a
# 4096^2 grid block
TC1D_LAUNCHES = (("K7a", 0, 0, FRAME[0], FRAME[1]),
                 ("K7b", 1, 0, FRAME[0], FRAME[1] // 2),
                 ("K29e", 0, 1, 4096, 4096), ("K29f", 1, 1, 4096, 2048))


def print_tc1d_occupancy(port, dev, keys):
    """Resident blocks per SM (the occupancy API), dynamic shared memory
    and grid of the tc_dwt1d.cu instances that K7a/K7b and K29e/K29f run
    at sym8 on their timed shapes (a build without the query says so)."""
    from pypwt_tpu_torch.ops import _build
    lib = _build.load_library()
    if not hasattr(lib, "pypwt_tc_dwt1d_occupancy"):
        print("occupancy tc_dwt1d.cu: not reported by this build")
        return
    hlen = port.get_filter_bank("sym8").hlen
    for key, syn, halo, rows, n in TC1D_LAUNCHES:
        if not wanted(keys, key):
            continue
        for prec in PRECISIONS:
            blocks, smem, grid = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
            err = lib.pypwt_tc_dwt1d_occupancy(
                syn, rows, n, hlen, int(prec == "bf16"), halo, dev.index,
                ctypes.byref(blocks), ctypes.byref(smem), ctypes.byref(grid))
            if err:
                raise RuntimeError(f"occupancy query {key} {prec}: error "
                                   f"{err}")
            print(f"occupancy {key} sym8 {prec} ({rows} rows of {n}): "
                  f"{blocks.value} blocks of 256 threads per SM, "
                  f"{smem.value} bytes of dynamic shared memory each, grid "
                  f"{grid.value}")


# (rows, samples per row, levels): the launches of K12a/K12b whose
# occupancy --only reports, the sinogram's and the 4 Mi signal's
TC_SWT1D_LAUNCHES = ((FRAME[0], FRAME[1], (1, 2, 3, 4)),
                     (1, SIGNAL, (1, 2, 3)))
# (rows, n, level, input offset, output offset): the rows whose K12a/K12b
# outputs --only digests, so that two builds of tc_swt1d.cu compare bit
# for bit: levels 1-4, n not a multiple of 4 and odd (the dilation does not
# divide it), short rows packed several to an item, 32 classes an item,
# inputs or outputs one float past a 16-byte boundary, the timed shapes
K12_DIGEST_CASES = ([(8, 256, lev, 0, 0) for lev in (1, 2, 3, 4)]
                    + [(3, 130, 1, 1, 0), (3, 130, 3, 0, 1),
                       (2, 75, 2, 1, 1), (64, 40, 1, 0, 0),
                       (64, 40, 2, 0, 0), (5, 72, 2, 1, 0),
                       (2, 4096, 7, 0, 0), (1, 1000, 1, 1, 1)]
                    + [(FRAME[0], FRAME[1], lev, 0, 0) for lev in (1, 2, 3)]
                    + [(1, SIGNAL, lev, 0, 0) for lev in (1, 2, 3)])
K12_DIGEST_BANKS = ("haar", "db2", "sym8", "sym20")


def print_k12_occupancy(port, dev):
    """Resident blocks per SM (the occupancy API), dynamic shared memory
    and grid of the tc_swt1d.cu instances that K12a/K12b run at sym8 on
    their timed rows (a build without the query says so)."""
    from pypwt_tpu_torch.ops import _build
    lib = _build.load_library()
    if not hasattr(lib, "pypwt_tc_swt1d_occupancy"):
        print("occupancy tc_swt1d.cu (K12a, K12b): not reported by this "
              "build")
        return
    hlen = port.get_filter_bank("sym8").hlen
    for (rows, n, levels), syn, prec in itertools.product(
            TC_SWT1D_LAUNCHES, (0, 1), PRECISIONS):
        for level in levels:
            out = [ctypes.c_int() for _ in range(3)]
            err = lib.pypwt_tc_swt1d_occupancy(
                syn, rows, n, level, hlen, int(prec == "bf16"), dev.index,
                *(ctypes.byref(o) for o in out))
            if err:
                raise RuntimeError(f"occupancy query K12 level {level}: "
                                   f"error {err}")
            blocks, smem, grid = (o.value for o in out)
            print(f"occupancy {'K12b' if syn else 'K12a'} sym8 {prec} level "
                  f"{level} ({rows} rows of {n}): {blocks} blocks of 256 "
                  f"threads per SM, {smem} bytes of dynamic shared memory "
                  f"each, grid {grid}")


def print_k12_digests(port, dev, keys):
    """SHA-256 of K12a's outputs (lo and hi stacked) and K12b's on seeded
    rows (K12_DIGEST_CASES, K12_DIGEST_BANKS, both precisions), each C
    entry called on outputs made here, NaN-filled; a case whose dilated
    support passes the row is left out: equal lines from two trees mean
    bit-identical kernels."""
    fd, conv = port.ops.fused_dwt, port.conv
    from pypwt_tpu_torch.ops import _build
    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for key, seed in (("K12a", SEED + 80), ("K12b", SEED + 81)):
        if not wanted(keys, key):
            continue
        syn = key == "K12b"
        gen = torch.Generator(device=dev).manual_seed(seed)
        n_cases = 0
        for (rows, n, level, oi, oo), wname, prec in itertools.product(
                K12_DIGEST_CASES, K12_DIGEST_BANKS, PRECISIONS):
            fb = port.get_filter_bank(wname)
            if max(conv.swt_pads(fb.hlen, level, syn)) > n:
                continue
            ins = [unaligned(torch.rand((rows, n), generator=gen,
                                        device=dev), oi)
                   for _ in range(2 if syn else 1)]
            outs = [torch.full((rows * n + oo,), float("nan"),
                               device=dev)[oo:].view(rows, n)
                    for _ in range(1 if syn else 2)]
            taps = [fd._host_taps(f) for f in (
                (fb.rec_lo, fb.rec_hi) if syn else (fb.dec_lo, fb.dec_hi))]
            entry = lib.pypwt_tc_iswt1d if syn else lib.pypwt_tc_swt1d
            err = entry(*(t.data_ptr() for t in ins + outs), rows, n, level,
                        conv.swt_centre(fb.hlen, syn),
                        *(t.ctypes.data for t in taps), fb.hlen,
                        int(prec == "bf16"), dev.index, stream)
            what = f"{wname} {prec} ({rows}, {n}) L{level} +{oi}/+{oo}"
            if err:
                raise RuntimeError(f"{key} {what}: error {err}")
            print(f"digest {key} {what}: {digest(torch.stack(outs))}")
            n_cases += 1
            del ins, outs
        print(f"digests of {key}: {n_cases}")


# -- K10a/K10b, the tap-loop 1D SWT pair (--only K10) ------------------------

# (bank, dtype): the rows that --only K10 times at levels 1-3 of the
# sinogram and of the signal
K10_TIMED = (("haar", torch.float32), ("db2", torch.float32),
             ("sym8", torch.float32), ("sym20", torch.float32),
             ("db4", torch.float64))
# (rows, n, level, input offset, output offset): the rows whose K10a/K10b
# outputs --only K10 digests (the card test's K10_CASES), so that two
# builds of swt1d.cu compare bit for bit: levels 1-4, a dilation equal to
# the row and past it, n not a multiple of 4 and odd (the dilation does not
# divide it), short rows packed to an item, a wrap wider than the row,
# classes wider than a warp, inputs or outputs one sample past a 16-byte
# boundary, the timed shapes
K10_DIGEST_CASES = ([(8, 256, lev, 0, 0) for lev in (1, 2, 3, 4)]
                    + [(4, 16, 5, 0, 0), (3, 10, 6, 0, 0), (3, 130, 1, 1, 0),
                       (3, 130, 3, 0, 1), (2, 75, 1, 0, 1), (2, 75, 2, 1, 1),
                       (64, 40, 1, 0, 0), (64, 40, 2, 0, 0),
                       (300, 8, 1, 1, 1), (4, 16, 3, 0, 0),
                       (2, 4096, 7, 0, 0), (2, 1000, 8, 1, 0)]
                    + [(FRAME[0], FRAME[1], lev, 0, 0) for lev in (1, 2, 3)]
                    + [(1, SIGNAL, lev, 0, 0) for lev in (1, 2, 3)])
K10_DIGEST_BANKS = ("haar", "db2", "odd5", "sym8", "sym20")


def k10_bound_ms(rows, n, dtype):
    """Bound of one K10a or K10b level on rows x n samples: 3 arrays of n
    samples each (one in, two out, or the reverse) over 3.35 TB/s."""
    return 3 * rows * n * torch.finfo(dtype).bits / 8 / PEAK_BYTES * 1e3


def phase_times_k10_levels(port, dev, card):
    """K10a and K10b at levels 1-3 of the 2048 x 2048 sinogram and of the
    (1, 4 Mi) signal, K10_TIMED's banks, in turns within this call (device
    time), each beside its bound; db2 level 1 of the sinogram also against
    its plain version (the kernels line); and the sum of launches x (time -
    bound) over the sinogram's sym8 L3 roundtrip (--only K10).  Inputs
    cycle over copies that together exceed the 50 MB L2."""
    fd = port.ops.fused_dwt
    gen = torch.Generator(device=dev).manual_seed(SEED + 26)
    times, excess = {}, 0.0
    for (what, shape), (wname, dtype) in itertools.product(
            (("sinogram", FRAME), ("signal", (1, SIGNAL))), K10_TIMED):
        fb = port.get_filter_bank(wname)
        copies = 4 if dtype == torch.float32 else 2
        xs = [torch.rand(shape, generator=gen, device=dev, dtype=dtype) * 255
              for _ in range(copies)]
        bound = k10_bound_ms(*shape, dtype)
        for level in (1, 2, 3):
            sx = itertools.cycle(xs).__next__
            sc = itertools.cycle([fd.swt1d_fused(x, fb, level)
                                  for x in xs]).__next__
            calls = {"K10a": lambda: fd.swt1d_fused(sx(), fb, level),
                     "K10b": lambda: fd.iswt1d_fused(*sc(), fb, level)}
            line = (what == "sinogram" and wname == "db2" and level == 1
                    and dtype == torch.float32)
            if line:
                calls["K10a plain"] = lambda: fd.swt1d_plain(sx(), fb, 1)
                calls["K10b plain"] = lambda: fd.iswt1d_plain(*sc(), fb, 1)
            reps = {k: 3 if k.endswith("plain") else 10 for k in calls}
            t = in_turns(calls, reps)
            if line:
                times = {k: (t[k], t[f"{k} plain"])
                         for k in ("K10a", "K10b")}
            if what == "sinogram" and wname == "sym8":
                excess += sum(t[k] - bound for k in ("K10a", "K10b"))
            print(f"time K10 {what} {shape} level {level} {wname} "
                  f"{str(dtype)[6:]}, device: "
                  + ", ".join(f"{k} {v * 1e3:.1f} us" for k, v in t.items())
                  + f"; bound {bound * 1e3:.1f} us each, K10a "
                  f"{bound / t['K10a']:.0%} of it, K10b "
                  f"{bound / t['K10b']:.0%}  [{card}]")
        del xs
    print(f"time K10 sinogram sym8 L3 roundtrip (3 K10a + 3 K10b): sum of "
          f"launches x (time - bound) {excess * 1e3:.1f} us  [{card}]")
    return times


def print_k10_occupancy(port, dev):
    """Resident blocks per SM (the occupancy API), dynamic shared memory
    and grid of the swt1d.cu instances that K10a/K10b run at K10_TIMED's
    banks on the timed rows (a build without the query says so)."""
    from pypwt_tpu_torch.ops import _build
    lib = _build.load_library()
    if not hasattr(lib, "pypwt_swt1d_occupancy"):
        print("occupancy swt1d.cu (K10a, K10b): not reported by this build")
        return
    for (rows, n), (wname, dtype), syn in itertools.product(
            (FRAME, (1, SIGNAL)), K10_TIMED, (0, 1)):
        hlen = port.get_filter_bank(wname).hlen
        for level in (1, 2, 3):
            out = [ctypes.c_int() for _ in range(3)]
            err = lib.pypwt_swt1d_occupancy(
                syn, rows, n, level, hlen, int(dtype == torch.float64),
                dev.index, *(ctypes.byref(o) for o in out))
            if err:
                raise RuntimeError(f"occupancy query K10 level {level}: "
                                   f"error {err}")
            blocks, smem, grid = (o.value for o in out)
            print(f"occupancy {'K10b' if syn else 'K10a'} {wname} "
                  f"{str(dtype)[6:]} level {level} ({rows} rows of {n}): "
                  f"{blocks} blocks of 256 threads per SM, {smem} bytes of "
                  f"dynamic shared memory each, grid {grid}")


def print_k10_digests(port, dev, keys):
    """SHA-256 of K10a's outputs (lo and hi stacked) and K10b's on seeded
    rows (K10_DIGEST_CASES, K10_DIGEST_BANKS, float32 and float64), each C
    entry called on outputs made here, NaN-filled: equal lines from two
    trees mean bit-identical kernels."""
    fd = port.ops.fused_dwt
    from pypwt_tpu_torch.ops import _build
    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    banks = {fb.name: fb for fb in banks_1d(port)}
    for key, seed in (("K10a", SEED + 82), ("K10b", SEED + 83)):
        if not wanted(keys, key):
            continue
        syn = key == "K10b"
        gen = torch.Generator(device=dev).manual_seed(seed)
        n_cases = 0
        for (rows, n, level, oi, oo), wname, dtype in itertools.product(
                K10_DIGEST_CASES, K10_DIGEST_BANKS,
                (torch.float32, torch.float64)):
            fb = banks.get(wname) or port.get_filter_bank(wname)
            npt = np.float64 if dtype == torch.float64 else np.float32
            ins = [unaligned(torch.rand((rows, n), generator=gen, device=dev,
                                        dtype=dtype), oi)
                   for _ in range(2 if syn else 1)]
            outs = [torch.full((rows * n + oo,), float("nan"), dtype=dtype,
                               device=dev)[oo:].view(rows, n)
                    for _ in range(1 if syn else 2)]
            taps = [fd._host_taps(f, npt) for f in (
                (fb.rec_lo, fb.rec_hi) if syn else (fb.dec_lo, fb.dec_hi))]
            entry = getattr(lib, ("pypwt_iswt1d" if syn else "pypwt_swt1d")
                            + ("_f64" if dtype == torch.float64 else ""))
            err = entry(*(t.data_ptr() for t in ins + outs), rows, n, level,
                        *(t.ctypes.data for t in taps), fb.hlen, dev.index,
                        stream)
            what = (f"{wname} {str(dtype)[6:]} ({rows}, {n}) L{level} "
                    f"+{oi}/+{oo}")
            if err:
                raise RuntimeError(f"{key} {what}: error {err}")
            print(f"digest {key} {what}: {digest(torch.stack(outs))}")
            n_cases += 1
            del ins, outs
        print(f"digests of {key}: {n_cases}")


# (key, halo): the instances of K9's and K27b's kernel body; their levels
# whose occupancy and phase-1 path --only reports: (bank, level, dtype)
ISWT2D_ROWS = (("K9", 0), ("K27b", 1))
ISWT2D_LEVELS = (("db2", 1, torch.float32), ("db2", 3, torch.float32),
                 ("sym8", 1, torch.float32), ("db4", 1, torch.float64))


def print_iswt2d_occupancy(port, dev, keys):
    """Resident blocks per SM (the occupancy API), dynamic shared memory and
    phase-1 path (staged windows or direct reads) of the swt2d.cu synthesis
    levels that K9 runs on the frame and K27b on the 2048 x 8192 shard (a
    build without the query says so)."""
    from pypwt_tpu_torch.ops import _build
    lib = _build.load_library()
    if not hasattr(lib, "pypwt_iswt2d_occupancy"):
        print("occupancy iswt2d (K9, K27b): not reported by this build")
        return
    for key, halo in ISWT2D_ROWS:
        if not wanted(keys, key):
            continue
        nr, nc = SHARD_BLOCK if halo else FRAME
        for wname, level, dtype in ISWT2D_LEVELS:
            fb = port.get_filter_bank(wname)
            blocks, smem, staged = (ctypes.c_int() for _ in range(3))
            err = lib.pypwt_iswt2d_occupancy(
                nr, nc, level, port.conv.swt_centre(fb.hlen, True), fb.hlen,
                int(dtype == torch.float64), halo, dev.index,
                ctypes.byref(blocks), ctypes.byref(smem),
                ctypes.byref(staged))
            if err:
                raise RuntimeError(f"occupancy query {key} {wname} L{level}: "
                                   f"error {err}")
            path = "staged windows" if staged.value else "direct reads"
            print(f"occupancy {key} {wname} level {level} "
                  f"{str(dtype)[6:]} ({nr}, {nc}): {blocks.value} blocks of "
                  f"256 threads per SM, {smem.value} bytes of dynamic shared "
                  f"memory each, phase 1 {path}")


# The synthesis levels whose outputs --only K9 / K27b digest, so that two
# builds of swt2d.cu compare bit for bit: widths around a 64-column tile
# (63, 64, 65, 131), rows that are not a multiple of 4 samples (99, 257),
# planes one sample past a 16-byte boundary, a (3, 255, 257) batch whose
# later planes start unaligned, levels 1-4, float32 and float64, sym20's
# windows past the staging budget, and the timed shapes.
DIGEST_SHAPES = ((40, 63), (40, 64), (40, 65), (40, 131), (70, 99),
                 (3, 255, 257))
DIGEST_BANKS = (("haar", torch.float32), ("db2", torch.float32),
                ("sym8", torch.float32), ("sym20", torch.float32),
                ("db4", torch.float64), ("sym20", torch.float64))
DIGEST_SHARDS = ((4, (16, 96)), (2, (3, 40, 257)), (3, (20, 131)))


def unaligned(t, floats):
    """t's values in a tensor whose data starts ``floats`` elements past
    where a fresh allocation would."""
    if floats == 0:
        return t
    flat = torch.cat([torch.zeros(floats, device=t.device, dtype=t.dtype),
                      t.flatten()])
    return flat[floats:].view(t.shape)


def digest(t):
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def print_iswt2d_digests(port, dev, keys):
    """SHA-256 of K9's and K27b's outputs on seeded inputs (DIGEST_*, and
    K9 at levels 1-3 of the frame, K27b on shard 1 of 8192^2 at levels
    1-3, db2 and, in float64, db4): equal lines from two trees mean
    bit-identical kernels."""
    fd = port.ops.fused_dwt
    gen = torch.Generator(device=dev).manual_seed(SEED + 60)

    def rand(shape, dtype):
        return torch.rand(shape, generator=gen, device=dev, dtype=dtype)

    n = 0
    if wanted(keys, "K9"):
        cases = [(w, dt, shape, level, off)
                 for w, dt in DIGEST_BANKS for shape in DIGEST_SHAPES
                 for level in (1, 2, 3, 4) for off in (0, 1)
                 if off == 0 or shape in ((40, 64), (70, 99))]
        cases += [(w, dt, FRAME, level, 0) for w, dt in (
            ("db2", torch.float32), ("db4", torch.float64))
            for level in (1, 2, 3)]
        for wname, dtype, shape, level, off in cases:
            fb = port.get_filter_bank(wname)
            c = [unaligned(rand(shape, dtype), off) for _ in range(4)]
            out = fd.iswt2d_fused(*c, fb, level)
            print(f"digest K9 {wname} level {level} {str(dtype)[6:]} "
                  f"{shape} +{off}: {digest(out)}")
            n += 1
    if wanted(keys, "K27b"):
        cases = [(w, dt, shards, shape, level, off)
                 for w, dt in DIGEST_BANKS for shards, shape in DIGEST_SHARDS
                 for level in (1, 2, 3, 4) for off in (0, 1)
                 if off == 0 or shape == (16, 96)]
        cases += [(w, dt, N_SHARDS, SHARD_BLOCK, level, 0) for w, dt in (
            ("db2", torch.float32), ("db4", torch.float64))
            for level in (1, 2, 3)]
        for wname, dtype, shards, shape, level, off in cases:
            fb = port.get_filter_bank(wname)
            top, bot = fd.halo_heights("iswt", fb, 0, level)
            rows = shape[-2]
            body, halos = [], []
            for _ in range(4):
                ext = shard_rows_of(
                    rand((*shape[:-2], shards * rows, shape[-1]), dtype), 1,
                    rows, top, bot)
                body.append(unaligned(ext[..., top:top + rows, :]
                                      .contiguous(), off))
                halos += [unaligned(ext[..., :top, :].contiguous(), off),
                          unaligned(ext[..., top + rows:, :].contiguous(),
                                    off)]
                del ext
            out = fd.iswt2d_sharded_fused(*body, tuple(halos), fb, level)
            print(f"digest K27b {wname} level {level} {str(dtype)[6:]} "
                  f"shard 1 of {shards} x {shape} +{off}: {digest(out)}")
            del body, halos, out
            n += 1
    print(f"digests of the synthesis: {n}")


# The synthesis levels whose outputs --only K6 / "K28 idwt" digest, so that
# two builds of tc_dwt2d.cu compare bit for bit: banks that reach every
# instance (TF32 k-steps 1-3, bf16 1-2), coefficient planes under one
# 32 x 32 tile, across tile edges, tiny ones whose window wraps more than
# once, column counts that are not a multiple of 4, a batch, planes one
# float past a 16-byte boundary, shards with their halos, both precisions,
# and the timed shapes.
IDWT_DIGEST_BANKS = ("db2", "sym4", "sym8", "db10", "coif5", "sym20")
IDWT_DIGEST_SHAPES = ((1, 1), (3, 2), (20, 24), (33, 65), (40, 72),
                      (3, 20, 36), (31, 64), (70, 100), (2, 34, 130))
IDWT_DIGEST_SHARDS = ((4, (16, 96)), (3, (20, 24)), (2, (3, 40, 72)),
                      (3, (8, 34)))


def print_idwt2d_digests(port, dev, keys):
    """SHA-256 of K6's and K28 idwt's outputs on seeded inputs
    (IDWT_DIGEST_*, and K6 at level 0 of the frame, K28 idwt on shard 1 of
    8192^2, sym8), both precisions: equal lines from two trees mean
    bit-identical kernels."""
    km, fd = port.ops.mxu_dwt, port.ops.fused_dwt
    gen = torch.Generator(device=dev).manual_seed(SEED + 61)

    def rand(shape):
        return torch.rand(shape, generator=gen, device=dev)

    n = 0
    if wanted(keys, "K6"):
        cases = [(w, prec, shape, off)
                 for w in IDWT_DIGEST_BANKS for prec in PRECISIONS
                 for shape in IDWT_DIGEST_SHAPES for off in (0, 1)
                 if off == 0 or shape in ((33, 65), (40, 72))]
        cases += [("sym8", prec, half(FRAME), 0) for prec in PRECISIONS]
        for wname, prec, shape, off in cases:
            fb = port.get_filter_bank(wname)
            c = [unaligned(rand(shape), off) for _ in range(4)]
            out = km.idwt2d_mxu_fused(*c, fb, (2 * shape[-2], 2 * shape[-1]),
                                      prec)
            print(f"digest K6 {wname} {prec} {shape} +{off}: {digest(out)}")
            n += 1
    if wanted(keys, "K28 idwt"):
        cases = [(w, prec, shards, shape, off)
                 for w in IDWT_DIGEST_BANKS for prec in PRECISIONS
                 for shards, shape in IDWT_DIGEST_SHARDS for off in (0, 1)
                 if off == 0 or shape == (16, 96)]
        cases += [("sym8", prec, N_SHARDS, half(SHARD_BLOCK), 0)
                  for prec in PRECISIONS]
        for wname, prec, shards, shape, off in cases:
            fb = port.get_filter_bank(wname)
            rows = shape[-2]
            top, bot = fd.halo_heights("idwt", fb, rows)
            body, halos = [], []
            for _ in range(4):
                ext = shard_rows_of(
                    rand((*shape[:-2], shards * rows, shape[-1])), 1, rows,
                    top, bot)
                body.append(unaligned(ext[..., top:top + rows, :]
                                      .contiguous(), off))
                halos += [unaligned(ext[..., :top, :].contiguous(), off),
                          unaligned(ext[..., top + rows:, :].contiguous(),
                                    off)]
                del ext
            out = km.idwt2d_sharded_mxu_fused(*body, tuple(halos), fb, prec)
            print(f"digest K28 idwt {wname} {prec} shard 1 of {shards} x "
                  f"{shape} +{off}: {digest(out)}")
            del body, halos, out
            n += 1
    print(f"digests of the tensor-core DWT synthesis: {n}")


# -- K1/K26a and K2/K26b, the tap-loop DWT on the pair bodies (--only) ------

SYN2D_TIMED_BANKS = ("db2", "sym20")  # hlen 4 and 40
F32_F64 = (torch.float32, torch.float64)


def phase_times_tap_levels(port, dev, card, key):
    """K1 (inputs of 2048^2, 1024^2 and 512^2) or K2 (coefficient planes of
    1024^2, 512^2 and 256^2) at levels 0-2 of 2048^2, db2 and sym20,
    float32 and float64, in turns, and its plain version at level 0, db2,
    float32, the kernels line's shape (--only).  Returns {key: (kernel ms,
    plain ms)} at that shape."""
    fd = port.ops.fused_dwt
    gen = torch.Generator(device=dev).manual_seed(
        SEED + (19 if key == "K1" else 18))
    times = {}
    for wname in SYN2D_TIMED_BANKS:
        fb = port.get_filter_bank(wname)
        for level in (0, 1, 2):
            shape = (FRAME[0] >> level, FRAME[1] >> level)
            if key == "K1":
                def inputs(dtype, shape=shape):
                    return torch.rand(shape, generator=gen, device=dev,
                                      dtype=dtype) * 255

                def kernel(x, fb=fb):
                    return fd.dwt2d_fused(x, fb)

                def plain(x, fb=fb):
                    return fd.dwt2d_plain(x, fb)
            else:
                def inputs(dtype, shape=shape):
                    return [torch.rand(half(shape), generator=gen,
                                       device=dev, dtype=dtype) * 255
                            for _ in range(4)]

                def kernel(c, fb=fb, shape=shape):
                    return fd.idwt2d_fused(*c, fb, shape)

                def plain(c, fb=fb, shape=shape):
                    return fd.idwt2d_plain(*c, fb, shape)
            calls, reps, sets = {}, {}, {}
            for dtype in F32_F64:
                name = str(dtype)[6:]
                sets[name] = itertools.cycle(
                    [inputs(dtype) for _ in range(4)]).__next__
                calls[name] = lambda nx=sets[name]: kernel(nx())
                reps[name] = 10
            if wname == "db2" and level == 0:
                calls["plain"] = lambda: plain(sets["float32"]())
                reps["plain"] = 3
            t = in_turns(calls, reps)
            n2 = shape[0] * shape[1]
            bounds = {name: bound(8 * n2 * (2 if name == "float64" else 1),
                                  4 * fb.hlen * n2)[0] for name in sets}
            plain_us = (f", plain {t['plain'] * 1e3:.1f} us" if "plain" in t
                        else "")
            print(f"time {key} {wname} level {level} {shape}, device: "
                  + ", ".join(f"{name} {t[name] * 1e3:.1f} us (bound "
                              f"{bounds[name] * 1e3:.1f} us)"
                              for name in sets)
                  + f"{plain_us}  [{card}]")
            if "plain" in t:
                times[key] = (t["float32"], t["plain"])
            del calls, sets
    return times


# key: (C entry, halo flag, tile unit) of the tap-loop 2D DWT instances
# whose occupancy --only reports
TAP2D_OCCUPANCY = {"K1": ("pypwt_dwt2d_occupancy", 0, "outputs"),
                   "K26a": ("pypwt_dwt2d_occupancy", 1, "outputs"),
                   "K2": ("pypwt_idwt2d_occupancy", 0, "coefficients"),
                   "K26b": ("pypwt_idwt2d_occupancy", 1, "coefficients")}


def print_tap2d_occupancy(port, dev, keys):
    """Resident blocks per SM (the occupancy API), dynamic shared memory and
    tile shape of the dwt2d.cu / idwt2d.cu instances that K1 / K2 run at
    levels 0-2 of 2048^2 and K26a / K26b on the 2048 x 8192 shard, db2 and
    sym20, float32 and float64, for the selected rows (a build without the
    query says so)."""
    from pypwt_tpu_torch.ops import _build
    lib = _build.load_library()
    for key, (query, halo, unit) in TAP2D_OCCUPANCY.items():
        if not wanted(keys, key):
            continue
        if not hasattr(lib, query):
            print(f"occupancy {key}: not reported by this build")
            continue
        levels = ([SHARD_BLOCK] if halo else
                  [(FRAME[0] >> lev, FRAME[1] >> lev) for lev in range(3)])
        for (nr, nc), wname, dtype in itertools.product(
                levels, SYN2D_TIMED_BANKS, F32_F64):
            out = [ctypes.c_int() for _ in range(4)]
            err = getattr(lib, query)(
                nr, nc, port.get_filter_bank(wname).hlen,
                int(dtype == torch.float64), halo, dev.index,
                *(ctypes.byref(o) for o in out))
            if err:
                raise RuntimeError(f"occupancy query {key} {wname}: error "
                                   f"{err}")
            blocks, smem, tr, tc = (o.value for o in out)
            print(f"occupancy {key} {wname} {str(dtype)[6:]} ({nr}, {nc}): "
                  f"{blocks} blocks of 256 threads per SM, {smem} bytes of "
                  f"dynamic shared memory each, tiles of {tr} x {tc} {unit}")


# The levels whose outputs --only K2 / K26b digest, so that two builds of
# idwt2d.cu compare bit for bit: banks of hlen 2, 4, 10, 16 and 40 and an
# odd one (banks_1d), tiny outputs whose windows wrap more than once, outputs
# across tile edges, odd ones (K2's crop), coefficient rows that are not a
# multiple of 4 samples, a batch of 3, planes one sample past a 16-byte
# boundary, shards of 8 and 16 rows (multi-hop halos at sym20), float32
# and float64, and the timed shapes.
SYN2D_DIGEST_OUTPUTS = ((2, 2), (3, 5), (40, 72), (66, 130), (63, 127),
                        (130, 258), (3, 40, 72), (2, 66, 130))
SYN2D_DIGEST_SHARDS = ((4, (8, 48)), (4, (16, 64)), (3, (10, 131)),
                       (2, (3, 20, 36)))


def print_idwt2d_tap_digests(port, dev, keys):
    """SHA-256 of K2's and K26b's outputs on seeded inputs (SYN2D_DIGEST_*,
    and K2 at level 0 of the frame and of a 2047^2 one, K26b on shard 1 of
    8192^2, db2): equal lines from two trees mean bit-identical kernels."""
    fd = port.ops.fused_dwt
    gen = torch.Generator(device=dev).manual_seed(SEED + 62)
    banks = [fb for fb in banks_1d(port) if fb.name != "db8"] + [
        port.get_filter_bank("bior4.4"), port.get_filter_bank("sym8")]

    def rand(shape, dtype):
        return torch.rand(shape, generator=gen, device=dev, dtype=dtype)

    n = 0
    if wanted(keys, "K2"):
        cases = [(fb, dt, shape, off) for fb in banks for dt in F32_F64
                 for shape in SYN2D_DIGEST_OUTPUTS for off in (0, 1)
                 if off == 0 or shape in ((66, 130), (2, 66, 130))]
        db2 = port.get_filter_bank("db2")
        cases += [(db2, dt, FRAME, 0) for dt in F32_F64]
        cases += [(db2, torch.float32, ODD_FRAME, 0)]
        for fb, dtype, shape, off in cases:
            c = [unaligned(rand(half(shape), dtype), off) for _ in range(4)]
            out = fd.idwt2d_fused(*c, fb, shape)
            print(f"digest K2 {fb.name} {str(dtype)[6:]} {shape} +{off}: "
                  f"{digest(out)}")
            n += 1
    if wanted(keys, "K26b"):
        cases = [(fb, dt, shards, shape, off) for fb in banks
                 for dt in F32_F64 for shards, shape in SYN2D_DIGEST_SHARDS
                 for off in (0, 1) if off == 0 or shape == (16, 64)]
        cases += [(port.get_filter_bank("db2"), dt, N_SHARDS,
                   half(SHARD_BLOCK), 0) for dt in F32_F64]
        for fb, dtype, shards, shape, off in cases:
            rows = shape[-2]
            top, bot = fd.halo_heights("idwt", fb, rows)
            body, halos = [], []
            for _ in range(4):
                ext = shard_rows_of(
                    rand((*shape[:-2], shards * rows, shape[-1]), dtype), 1,
                    rows, top, bot)
                body.append(unaligned(ext[..., top:top + rows, :]
                                      .contiguous(), off))
                halos += [unaligned(ext[..., :top, :].contiguous(), off),
                          unaligned(ext[..., top + rows:, :].contiguous(),
                                    off)]
                del ext
            out = fd.idwt2d_sharded_fused(*body, tuple(halos), fb)
            print(f"digest K26b {fb.name} {str(dtype)[6:]} shard 1 of "
                  f"{shards} x {shape} +{off}: {digest(out)}")
            del body, halos, out
            n += 1
    print(f"digests of the tap-loop DWT synthesis: {n}")


# -- K18a/K18b, the non-separable SWT pair (--only) -------------------------

def phase_times_nsswt_levels(port, dev, card, keys):
    """K18a and K18b at levels 1-3 of the frame on db3xcoif1 and dense8,
    float32 and float64 (--only): the kernels line's shape
    (level 1, db3xcoif1, float32) against the plain version in turns, the
    rest the kernel alone (CUDA events, sleep-primed, the mean of two
    medians of 21). Returns {key: (kernel ms, plain ms)} of that shape."""
    kn = port.ops.nonsep
    gen = torch.Generator(device=dev).manual_seed(SEED + 71)
    frames = [torch.rand(FRAME, generator=gen, device=dev) * 255
              for _ in range(4)]
    cross, _, dense = banks_2d(port)
    times = {}
    for f2d, level, dtype in itertools.product((cross, dense), (1, 2, 3),
                                               (torch.float32, torch.float64)):
        xs = [f.to(dtype) for f in frames]
        nx = itertools.cycle(xs).__next__
        coef = itertools.cycle([kn.ns_swt2d_fused(x, f2d, level)
                                for x in xs]).__next__
        calls = {"K18a": (lambda: kn.ns_swt2d_plain(nx(), f2d, level),
                          lambda: kn.ns_swt2d_fused(nx(), f2d, level)),
                 "K18b": (lambda: kn.ins_swt2d_plain(*coef(), f2d, level),
                          lambda: kn.ins_swt2d_fused(*coef(), f2d, level))}
        for key, (plain, kernel) in calls.items():
            if not wanted(keys, key):
                continue
            line = (f"time {key} level {level} {f2d.name} {str(dtype)[6:]} "
                    f"{FRAME}, device: kernel")
            if (f2d, level, dtype) == (cross, 1, torch.float32):
                times[key] = turns(plain, kernel, 3, True)
                print(f"{line} {times[key][0] * 1e3:.1f} us, plain "
                      f"{times[key][1] * 1e3:.1f} us  [{card}]")
            else:
                ms = (cuda_ms(kernel, 3, True) + cuda_ms(kernel, 3, True)) / 2
                print(f"{line} {ms * 1e3:.1f} us  [{card}]")
        del xs, coef
    return times


def print_k18_occupancy(port, dev, keys):
    """Resident blocks per SM (the occupancy API), dynamic shared memory,
    tile shape and window path (staged in shared memory, or read through
    the cache) of the nonsep_swt2d.cu instance K18a or K18b runs at levels
    1-8 of the frame for hlen 6, 8 and 40, float32 and float64 (a build
    without the query says so)."""
    from pypwt_tpu_torch.ops import _build
    lib = _build.load_library()
    for key, query, synthesis in (
            ("K18a", "pypwt_ns_swt2d_occupancy", False),
            ("K18b", "pypwt_ins_swt2d_occupancy", True)):
        if not wanted(keys, key):
            continue
        if not hasattr(lib, query):
            print(f"occupancy {key}: not reported by this build")
            continue
        for hlen, f64, level in itertools.product((6, 8, 40), (0, 1),
                                                  range(1, 9)):
            out = [ctypes.c_int() for _ in range(5)]
            err = getattr(lib, query)(
                *FRAME, level, port.conv.swt_centre(hlen, synthesis), hlen,
                f64, dev.index, *(ctypes.byref(o) for o in out))
            if err:
                raise RuntimeError(f"occupancy query {key} hlen {hlen}: "
                                   f"error {err}")
            blocks, smem, tr, tc, staged = (o.value for o in out)
            print(f"occupancy {key} hlen {hlen} "
                  f"{'float64' if f64 else 'float32'} level {level} "
                  f"{FRAME}: {blocks} blocks of 256 threads per SM, {smem} "
                  f"bytes of dynamic shared memory each, tiles of {tr} x "
                  f"{tc} outputs, {'staged' if staged else 'direct'}")


# The levels whose outputs --only K18a/K18b digests, so that two builds of
# nonsep_swt2d.cu compare bit for bit: (type, shape, level, offset) on the
# custom 2D banks and dense ones of hlen 5 and 40: levels 1-3 of (64, 128)
# and of the frame, a dilation that reaches the plane, odd planes, rows
# of 70 samples, a batch, planes one sample past a 16-byte boundary.
K18B_DIGEST_CASES = (
    [("f32", (64, 128), lev, 0) for lev in (1, 2, 3)]
    + [("f32", FRAME, lev, 0) for lev in (1, 2, 3)]
    + [("f32", (16, 64), 6, 0), ("f32", ODD_FRAME, 1, 0),
       ("f32", (33, 47), 2, 0), ("f32", (40, 70), 1, 0),
       ("f32", (3, 40, 72), 2, 0), ("f32", (64, 128), 1, 1),
       ("f64", (64, 128), 1, 0), ("f64", FRAME, 1, 0),
       ("f64", (16, 64), 6, 0), ("f64", (3, 40, 72), 2, 1)])


def print_k18_digests(port, dev, keys):
    """SHA-256 of K18b's outputs, and of K18a's four stacked, on seeded
    inputs (K18B_DIGEST_CASES): equal lines from two trees mean
    bit-identical kernels."""
    kn = port.ops.nonsep
    rng = np.random.default_rng(SEED + 72)
    banks = banks_2d(port) + [
        port.nonsep.Filters2D(list(rng.random((4, n, n)) / n ** 2),
                              list(rng.random((4, n, n)) / n ** 2),
                              f"dense{n}") for n in (5, 40)]
    for key, seed in (("K18b", SEED + 73), ("K18a", SEED + 74)):
        if not wanted(keys, key):
            continue
        gen = torch.Generator(device=dev).manual_seed(seed)
        n = 0
        for (kind, shape, level, off), f2d in itertools.product(
                K18B_DIGEST_CASES, banks):
            dtype = torch.float64 if kind == "f64" else torch.float32
            c = [unaligned(torch.rand(shape, generator=gen, device=dev,
                                      dtype=dtype), off)
                 for _ in range(4 if key == "K18b" else 1)]
            out = (kn.ins_swt2d_fused(*c, f2d, level) if key == "K18b"
                   else torch.stack(kn.ns_swt2d_fused(c[0], f2d, level)))
            print(f"digest {key} {f2d.name} {kind} {shape} L{level} +{off}: "
                  f"{digest(out)}")
            n += 1
        print(f"digests of {key}: {n}")


# The levels whose outputs --only K20 digests, so that two builds of
# idwt2d.cu compare bit for bit: SYN2D_DIGEST_OUTPUTS at each parity of the
# shift, one wider than a tile and the SHIFTS beside them (reduced mod the
# plane), with and without the accumulator (scale 0.25), planes one sample
# past a 16-byte boundary, and K20's timed level (the frame at (1, 1)), an
# odd unshifted axis (the pair body's crop) and a shifted odd one (the
# direct form).
K20_DIGEST_SHIFTS = ((0, 0), (1, 0), (0, 1), (1, 1), (5, 3), (70, 131),
                     (127, 1), (4101, 4099))


def print_shifted_occupancy(port, dev, key):
    """Resident blocks per SM (the occupancy API), dynamic shared memory
    and tile shape of the instances that K20 (idwt2d.cu) or K19
    (dwt2d.cu) runs at levels 0-2 of 2048^2 for each parity of the shift,
    db2 and sym20 (a build without the query says so)."""
    from pypwt_tpu_torch.ops import _build
    lib = _build.load_library()
    query, unit = (("pypwt_idwt2d_unshift_occupancy", "coefficients")
                   if key == "K20" else
                   ("pypwt_dwt2d_shifted_occupancy", "outputs"))
    if not hasattr(lib, query):
        print(f"occupancy {key}: not reported by this build")
        return
    for lev, wname, (sr, sc) in itertools.product(
            range(3), SYN2D_TIMED_BANKS, ((0, 0), (1, 0), (0, 1), (1, 1))):
        nr, nc = FRAME[0] >> lev, FRAME[1] >> lev
        out = [ctypes.c_int() for _ in range(4)]
        err = getattr(lib, query)(nr, nc, port.get_filter_bank(wname).hlen,
                                  sr, sc, dev.index,
                                  *(ctypes.byref(o) for o in out))
        if err:
            raise RuntimeError(f"occupancy query {key} {wname}: error {err}")
        blocks, smem, tr, tc = (o.value for o in out)
        print(f"occupancy {key} {wname} ({nr}, {nc}) shift ({sr}, {sc}): "
              f"{blocks} blocks of 256 threads per SM, {smem} bytes of "
              f"dynamic shared memory each, tiles of {tr} x {tc} {unit}")


def print_k20_digests(port, dev):
    """SHA-256 of K20's outputs on seeded inputs (K20_DIGEST_SHIFTS on
    SYN2D_DIGEST_OUTPUTS, and the frame-sized levels): equal lines from two
    trees mean bit-identical kernels."""
    ks = port.ops.shifted
    gen = torch.Generator(device=dev).manual_seed(SEED + 63)
    banks = [fb for fb in banks_1d(port) if fb.name != "db8"] + [
        port.get_filter_bank("bior4.4"), port.get_filter_bank("sym8")]

    def rand(shape):
        return torch.rand(shape, generator=gen, device=dev)

    cases = [(fb, shape, shift, acc, off) for fb in banks
             for shape in SYN2D_DIGEST_OUTPUTS for shift in K20_DIGEST_SHIFTS
             for acc in (False, True) for off in (0, 1)
             if off == 0 or (acc and shape in ((66, 130), (2, 66, 130)))]
    db2 = port.get_filter_bank("db2")
    cases += [(db2, FRAME, (1, 1), True, 0), (db2, FRAME, (5, 3), True, 0),
              (db2, (ODD_FRAME[0], FRAME[1]), (0, 1), True, 0),
              (db2, ODD_FRAME, (1, 1), True, 0)]
    for fb, shape, (sr, sc), acc, off in cases:
        c = [unaligned(rand(half(shape)), off) for _ in range(4)]
        a = unaligned(rand(shape), off) if acc else None
        out = ks.idwt2d_unshift_fused(*c, fb, shape, sr, sc, a,
                                      0.25 if acc else 1.0)
        print(f"digest K20 {fb.name} {shape} ({sr}, {sc}) "
              f"{'acc' if acc else 'store'} +{off}: {digest(out)}")
    print(f"digests of K20: {len(cases)}")


# The levels whose outputs --only K19 digests, so that two builds of
# dwt2d.cu compare bit for bit: ANA2D_DIGEST_INPUTS at K20_DIGEST_SHIFTS in
# the three epilogues, planes one sample past a 16-byte boundary, and the
# frame at the spins' level-0 shifts, an odd frame and a frame with one
# odd axis.
K19_DIGEST_MODES = (None, "soft", "hard")


def print_k19_digests(port, dev):
    """SHA-256 of K19's outputs (a, h, v, d) on seeded inputs
    (K20_DIGEST_SHIFTS on ANA2D_DIGEST_INPUTS in each epilogue, and the
    frame-sized levels): equal lines from two trees mean bit-identical
    kernels."""
    ks = port.ops.shifted
    gen = torch.Generator(device=dev).manual_seed(SEED + 64)
    banks = [fb for fb in banks_1d(port) if fb.name != "db8"] + [
        port.get_filter_bank("bior4.4"), port.get_filter_bank("sym8")]
    cases = [(fb, shape, shift, mode, off) for fb in banks
             for shape in ANA2D_DIGEST_INPUTS for shift in K20_DIGEST_SHIFTS
             for mode in K19_DIGEST_MODES for off in (0, 1)
             if off == 0 or (mode == "soft"
                             and shape in ((66, 130), (2, 66, 130)))]
    db2 = port.get_filter_bank("db2")
    cases += [(db2, FRAME, (1, 1), "soft", 0), (db2, FRAME, (3, 3), "soft", 0),
              (db2, ODD_FRAME, (1, 1), "soft", 0),
              (db2, (ODD_FRAME[0], FRAME[1]), (0, 1), "hard", 0)]
    for fb, shape, (sr, sc), mode, off in cases:
        x = unaligned(torch.rand(shape, generator=gen, device=dev), off)
        out = ks.dwt2d_shifted_fused(x, fb, sr, sc, mode, THRESH_BETA)
        print(f"digest K19 {fb.name} {shape} ({sr}, {sc}) {mode} +{off}: "
              f"{digest(torch.stack(out))}")
    print(f"digests of K19: {len(cases)}")


# The levels whose outputs --only K1 / K26a digest, so that two builds of
# dwt2d.cu compare bit for bit: banks of hlen 2, 4, 10, 16 and 40 and odd
# ones (banks_1d), tiny planes whose windows wrap more than once, planes
# across tile edges, odd ones on either or both axes (wrap_ext), rows that
# are not a multiple of 4 samples, a batch of 3, planes one sample past a
# 16-byte boundary, shards of 8 and 16 rows (multi-hop halos at sym20),
# float32 and float64, and the timed shapes.
ANA2D_DIGEST_INPUTS = ((2, 2), (3, 5), (40, 72), (66, 130), (63, 127),
                       (130, 258), (3, 40, 72), (2, 66, 130), (2047, 2046))
ANA2D_DIGEST_SHARDS = ((4, (16, 96)), (4, (8, 48)), (3, (20, 131)),
                       (2, (3, 40, 72)))


def print_dwt2d_tap_digests(port, dev, keys):
    """SHA-256 of K1's and K26a's outputs (a, h, v, d) on seeded inputs
    (ANA2D_DIGEST_*, and K1 at level 0 of the frame and of a 2047^2 one,
    K26a on shard 1 of 8192^2, db2): equal lines from two trees mean
    bit-identical kernels."""
    fd = port.ops.fused_dwt
    gen = torch.Generator(device=dev).manual_seed(SEED + 63)
    banks = [fb for fb in banks_1d(port) if fb.name != "db8"] + [
        port.get_filter_bank("bior4.4"), port.get_filter_bank("sym8")]

    def rand(shape, dtype):
        return torch.rand(shape, generator=gen, device=dev, dtype=dtype)

    def digest4(planes):
        return digest(torch.stack([p.contiguous() for p in planes]))

    n = 0
    if wanted(keys, "K1"):
        cases = [(fb, dt, shape, off) for fb in banks for dt in F32_F64
                 for shape in ANA2D_DIGEST_INPUTS for off in (0, 1)
                 if off == 0 or shape in ((66, 130), (2, 66, 130))]
        db2 = port.get_filter_bank("db2")
        cases += [(db2, dt, FRAME, 0) for dt in F32_F64]
        cases += [(db2, torch.float32, ODD_FRAME, 0)]
        for fb, dtype, shape, off in cases:
            x = unaligned(rand(shape, dtype), off)
            out = fd.dwt2d_fused(x, fb)
            print(f"digest K1 {fb.name} {str(dtype)[6:]} {shape} +{off}: "
                  f"{digest4(out)}")
            n += 1
    if wanted(keys, "K26a"):
        cases = [(fb, dt, shards, shape, off) for fb in banks
                 for dt in F32_F64 for shards, shape in ANA2D_DIGEST_SHARDS
                 for off in (0, 1) if off == 0 or shape == (16, 96)]
        cases += [(port.get_filter_bank("db2"), dt, N_SHARDS, SHARD_BLOCK, 0)
                  for dt in F32_F64]
        for fb, dtype, shards, shape, off in cases:
            rows = shape[-2]
            top, bot = fd.halo_heights("dwt", fb, 0)
            ext = shard_rows_of(rand((*shape[:-2], shards * rows,
                                      shape[-1]), dtype), 1, rows, top, bot)
            body = unaligned(ext[..., top:top + rows, :].contiguous(), off)
            up = unaligned(ext[..., :top, :].contiguous(), off)
            down = unaligned(ext[..., top + rows:, :].contiguous(), off)
            del ext
            out = fd.dwt2d_sharded_fused(body, up, down, fb)
            print(f"digest K26a {fb.name} {str(dtype)[6:]} shard 1 of "
                  f"{shards} x {shape} +{off}: {digest4(out)}")
            del body, up, down, out
            n += 1
    print(f"digests of the tap-loop DWT analysis: {n}")


# The analysis levels whose outputs --only K5 / "K28 dwt" digest, so that
# two builds of tc_dwt2d.cu compare bit for bit: banks that reach every
# instance (TF32 k-steps 3-7, bf16 2-4), planes under one 32 x 32 output
# tile, tiny ones whose window wraps more than once, planes across tile
# edges, column counts that are not a multiple of 4, odd output widths, a
# batch whose later planes start at odd offsets, planes one float past a
# 16-byte boundary, shards with their halos (two hops at sym20), both
# precisions, and the timed shapes.
DWT_DIGEST_SHAPES = ((2, 2), (6, 4), (40, 48), (66, 130), (64, 72),
                     (3, 22, 38), (70, 100), (130, 68), (2, 80, 144))
DWT_DIGEST_SHARDS = ((4, (16, 96)), (3, (20, 24)), (2, (3, 40, 72)),
                     (3, (8, 34)), (5, (4, 40)))


def print_dwt2d_digests(port, dev, keys):
    """SHA-256 of K5's and K28 dwt's outputs on seeded inputs
    (DWT_DIGEST_*, and K5 at level 0 of the frame, K28 dwt on shard 1 of
    8192^2, sym8), both precisions: equal lines from two trees mean
    bit-identical kernels."""
    km, fd = port.ops.mxu_dwt, port.ops.fused_dwt
    gen = torch.Generator(device=dev).manual_seed(SEED + 62)

    def rand(shape):
        return torch.rand(shape, generator=gen, device=dev)

    def digest4(planes):
        return digest(torch.stack([p.contiguous() for p in planes]))

    n = 0
    if wanted(keys, "K5"):
        cases = [(w, prec, shape, off)
                 for w in IDWT_DIGEST_BANKS for prec in PRECISIONS
                 for shape in DWT_DIGEST_SHAPES for off in (0, 1)
                 if off == 0 or shape in ((66, 130), (64, 72), (3, 22, 38))]
        cases += [("sym8", prec, FRAME, 0) for prec in PRECISIONS]
        for wname, prec, shape, off in cases:
            fb = port.get_filter_bank(wname)
            x = unaligned(rand(shape), off)
            out = km.dwt2d_mxu_fused(x, fb, prec)
            print(f"digest K5 {wname} {prec} {shape} +{off}: "
                  f"{digest4(out)}")
            n += 1
    if wanted(keys, "K28 dwt"):
        cases = [(w, prec, shards, shape, off)
                 for w in IDWT_DIGEST_BANKS for prec in PRECISIONS
                 for shards, shape in DWT_DIGEST_SHARDS for off in (0, 1)
                 if off == 0 or shape in ((16, 96), (8, 34))]
        cases += [("sym8", prec, N_SHARDS, SHARD_BLOCK, 0)
                  for prec in PRECISIONS]
        for wname, prec, shards, shape, off in cases:
            fb = port.get_filter_bank(wname)
            rows = shape[-2]
            top, bot = fd.halo_heights("dwt", fb, 0)
            ext = shard_rows_of(rand((*shape[:-2], shards * rows,
                                      shape[-1])), 1, rows, top, bot)
            body = unaligned(ext[..., top:top + rows, :].contiguous(), off)
            up = unaligned(ext[..., :top, :].contiguous(), off)
            down = unaligned(ext[..., top + rows:, :].contiguous(), off)
            del ext
            out = km.dwt2d_sharded_mxu_fused(body, up, down, fb, prec)
            print(f"digest K28 dwt {wname} {prec} shard 1 of {shards} x "
                  f"{shape} +{off}: {digest4(out)}")
            del body, up, down, out
            n += 1
    print(f"digests of the tensor-core DWT analysis: {n}")


def phase_library(port, dev, card, keys=None):
    """library_ms: beside each kernel, one PyTorch call that computes the
    same function at the kernel's timed shape, a strided, transposed or
    dilated convolution in full float32 (cudnn.allow_tf32 off, set in
    phase_device) on inputs padded (and, for K19/K20, rolled) outside the
    timed window; each checked against the kernel's output.  The port
    never calls them.  A call that waits for the device within itself (it
    leaves the host no way ahead of a sleep) is timed by wall clock, and
    says so.  K19's epilogue and K20's accumulator are outside
    the convolution: those two time the level alone.  cuDNN picks each
    call's fastest algorithm (cudnn.benchmark) in the check's call.
    ``keys``: only those rows' calls (--only)."""
    torch.backends.cudnn.benchmark = True
    try:
        lib = _library_calls(port, dev, card, keys)
    finally:
        torch.backends.cudnn.benchmark = False
    return {k: ms for k, ms in lib.items() if ms is not None}


def _library_calls(port, dev, card, keys):
    fd, kn, ks = port.ops.fused_dwt, port.ops.nonsep, port.ops.shifted
    conv = port.conv
    fb = port.get_filter_bank("db2")
    sep = port.nonsep.Filters2D.from_bank(fb)
    cross = banks_2d(port)[0]
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    frames = [torch.rand(FRAME, generator=gen, device=dev) * 255
              for _ in range(4)]

    def weights(filters, flip):
        w = torch.tensor(np.stack(filters), dtype=torch.float32, device=dev)
        return w.flip(-1, -2) if flip else w

    def synthesis_offset(hlen):
        # y[n] = z[n + T + 2P] for the transposed convolution z of the
        # coefficients padded by P (the polyphase centring of
        # conv.synthesis_core folded into one offset)
        h2 = hlen // 2
        return hlen - 2 + (1 - h2 % 2) - 2 * (h2 // 2)

    def timed(key, inputs, call, kernel_out, crop=lambda z: z):
        """Time ``call`` over the padded ``inputs``, after checking its
        first output against the kernel's (None for a row not selected)."""
        if not wanted(keys, key.split()[0]):
            return None
        err = max_err(crop(call(inputs[0])), kernel_out)
        if not err <= LIBRARY_TOL:
            raise AssertionError(f"{key}: library call vs kernel {err:.3e} "
                                 f"> {LIBRARY_TOL}")
        nx = itertools.cycle(inputs).__next__
        ms = cuda_ms(lambda: call(nx()), 10, True, required=False)
        clock = "device"
        if ms is None:  # the call waits for the device: time it as it is
            ms, clock = cuda_ms(lambda: call(nx()), 10, False), "wall"
        print(f"library {key}: {ms * 1e3:.1f} us {clock} (vs kernel "
              f"{err:.1e})  [{card}]")
        return ms

    def analysis(key, f2d, kernel, sr=0, sc=0):
        lp, rp = conv.analysis_pads(f2d.hlen)
        w = weights(f2d.dec, True)[:, None]
        padded = [conv._pad2_periodic(torch.roll(f, (sr, sc), (-2, -1)),
                                      lp, rp)[None, None] for f in frames]
        return timed(key, padded, lambda x: F.conv2d(x, w, stride=2)[0],
                     torch.stack(kernel(frames[0])))

    def synthesis(key, f2d, coeffs, out, sr=0, sc=0):
        pad = f2d.hlen
        o = synthesis_offset(f2d.hlen) + 2 * pad
        w = weights(f2d.rec, False)[:, None]
        padded = [conv._pad2_periodic(torch.stack(c), pad, pad)[None]
                  for c in coeffs]
        n, m = FRAME
        return timed(key, padded,
                     lambda c: F.conv_transpose2d(c, w, stride=2),
                     out, lambda z: z[0, 0, o + sr:o + sr + n,
                                      o + sc:o + sc + m])

    def stationary(key, f2d, level, kernel_out, inputs, inverse):
        f = 1 << (level - 1)
        s = conv.swt_centre(f2d.hlen, inverse)
        lp, rp = (f2d.hlen - 1 - s) * f, s * f
        if inverse:
            w = 0.25 * weights(f2d.rec, True)[None]
            padded = [conv._pad2_periodic(torch.stack(c), lp, rp)[None]
                      for c in inputs]
            return timed(key, padded,
                         lambda c: F.conv2d(c, w, dilation=f)[0, 0],
                         kernel_out)
        w = weights(f2d.dec, True)[:, None]
        padded = [conv._pad2_periodic(x, lp, rp)[None, None] for x in inputs]
        return timed(key, padded, lambda x: F.conv2d(x, w, dilation=f)[0],
                     torch.stack(kernel_out))

    lib = {}
    lib["K1"] = analysis("K1 conv2d stride 2", sep,
                         lambda x: fd.dwt2d_fused(x, fb))
    lib["K19"] = analysis("K19 conv2d stride 2, rolled (1, 1)", sep,
                          lambda x: ks.dwt2d_shifted_fused(x, fb, 1, 1), 1, 1)
    lib["K16"] = analysis(f"K16 conv2d stride 2 {cross.name}", cross,
                          lambda x: kn.nsdwt2d_fused(x, cross))
    coeffs = [fd.dwt2d_fused(f, fb) for f in frames]
    lib["K2"] = synthesis("K2 conv_transpose2d stride 2", sep, coeffs,
                          fd.idwt2d_fused(*coeffs[0], fb, FRAME))
    lib["K20"] = synthesis("K20 conv_transpose2d stride 2, unrolled (1, 1)",
                           sep, coeffs, ks.idwt2d_unshift_fused(
                               *coeffs[0], fb, FRAME, 1, 1), 1, 1)
    ncoeffs = [kn.nsdwt2d_fused(f, cross) for f in frames]
    lib["K17"] = synthesis(f"K17 conv_transpose2d stride 2 {cross.name}",
                           cross, ncoeffs,
                           kn.insdwt2d_fused(*ncoeffs[0], cross, FRAME))
    lib["K8"] = stationary("K8 conv2d dilation 1", sep, 1,
                           fd.swt2d_fused(frames[0], fb, 1), frames, False)
    scoeffs = [fd.swt2d_fused(f, fb, 1) for f in frames[:2]]
    lib["K9"] = stationary("K9 conv2d dilation 1", sep, 1,
                           fd.iswt2d_fused(*scoeffs[0], fb, 1), scoeffs, True)
    del scoeffs
    lib["K18a"] = stationary(f"K18a conv2d dilation 1 {cross.name}", cross,
                             1, kn.ns_swt2d_fused(frames[0], cross, 1),
                             frames, False)
    scoeffs = [kn.ns_swt2d_fused(f, cross, 1) for f in frames[:2]]
    lib["K18b"] = stationary(f"K18b conv2d dilation 1 {cross.name}", cross,
                             1, kn.ins_swt2d_fused(*scoeffs[0], cross, 1),
                             scoeffs, True)
    del scoeffs

    # the tensor-core forms at sym8: the same maps as K1/K2 and K8/K9
    km, kms = port.ops.mxu_dwt, port.ops.mxu_swt
    fw = port.get_filter_bank("sym8")
    wide = port.nonsep.Filters2D.from_bank(fw)
    lib["K5"] = analysis("K5 conv2d stride 2 sym8", wide,
                         lambda x: km.dwt2d_mxu_fused(x, fw))
    coeffs = [km.dwt2d_mxu_fused(f, fw) for f in frames]
    lib["K6"] = synthesis("K6 conv_transpose2d stride 2 sym8", wide, coeffs,
                          km.idwt2d_mxu_fused(*coeffs[0], fw, FRAME))
    lib["K11a"] = stationary("K11a conv2d dilation 1 sym8", wide, 1,
                             kms.swt2d_mxu_fused(frames[0], fw, 1), frames,
                             False)
    scoeffs = [kms.swt2d_mxu_fused(f, fw, 1) for f in frames[:2]]
    lib["K11b"] = stationary("K11b conv2d dilation 1 sym8", wide, 1,
                             kms.iswt2d_mxu_fused(*scoeffs[0], fw, 1),
                             scoeffs, True)
    del scoeffs, coeffs

    # 1D rows (2048 x 2048): conv1d over the rows as a batch
    lp, rp = conv.analysis_pads(fb.hlen)
    w1 = weights([fb.dec_lo, fb.dec_hi], False).flip(-1)[:, None]
    rows = [conv.periodic_pad_last(f, lp, rp)[:, None] for f in frames]
    lib["K3"] = timed("K3 conv1d stride 2", rows,
                      lambda x: F.conv1d(x, w1, stride=2).transpose(0, 1),
                      torch.stack(fd.dwt1d_fused(frames[0], fb)))
    pad = fb.hlen
    o = synthesis_offset(fb.hlen) + 2 * pad
    wr = weights([fb.rec_lo, fb.rec_hi], False)[:, None]
    c1 = [conv.periodic_pad_last(torch.stack(fd.dwt1d_fused(f, fb), 1), pad,
                                 pad) for f in frames]
    lib["K4"] = timed("K4 conv_transpose1d stride 2", c1,
                      lambda c: F.conv_transpose1d(c, wr, stride=2),
                      fd.idwt1d_fused(*fd.dwt1d_fused(frames[0], fb), fb,
                                      FRAME[1]),
                      lambda z: z[:, 0, o:o + FRAME[1]])
    s = conv.swt_centre(fb.hlen, False)
    rows = [conv.periodic_pad_last(f, fb.hlen - 1 - s, s)[:, None]
            for f in frames]
    lib["K10a"] = timed("K10a conv1d dilation 1", rows,
                        lambda x: F.conv1d(x, w1).transpose(0, 1),
                        torch.stack(fd.swt1d_fused(frames[0], fb, 1)))
    s = conv.swt_centre(fb.hlen, True)
    wb = 0.5 * weights([fb.rec_lo, fb.rec_hi], False).flip(-1)[None]
    c1 = [conv.periodic_pad_last(torch.stack(fd.swt1d_fused(f, fb, 1), 1),
                                 fb.hlen - 1 - s, s) for f in frames]
    lib["K10b"] = timed("K10b conv1d dilation 1", c1,
                        lambda c: F.conv1d(c, wb)[:, 0],
                        fd.iswt1d_fused(*fd.swt1d_fused(frames[0], fb, 1),
                                        fb, 1))

    # the 1D tensor-core forms at sym8: the same maps as K3/K4 and K10
    lp, rp = conv.analysis_pads(fw.hlen)
    w1 = weights([fw.dec_lo, fw.dec_hi], False).flip(-1)[:, None]
    rows = [conv.periodic_pad_last(f, lp, rp)[:, None] for f in frames]
    lib["K7a"] = timed("K7a conv1d stride 2 sym8", rows,
                       lambda x: F.conv1d(x, w1, stride=2).transpose(0, 1),
                       torch.stack(km.dwt1d_mxu_fused(frames[0], fw)))
    pad = fw.hlen
    o = synthesis_offset(fw.hlen) + 2 * pad
    wr = weights([fw.rec_lo, fw.rec_hi], False)[:, None]
    coef = [km.dwt1d_mxu_fused(f, fw) for f in frames]
    c1 = [conv.periodic_pad_last(torch.stack(c, 1), pad, pad) for c in coef]
    lib["K7b"] = timed("K7b conv_transpose1d stride 2 sym8", c1,
                       lambda c: F.conv_transpose1d(c, wr, stride=2),
                       km.idwt1d_mxu_fused(*coef[0], fw, FRAME[1]),
                       lambda z: z[:, 0, o:o + FRAME[1]])
    s = conv.swt_centre(fw.hlen, False)
    rows = [conv.periodic_pad_last(f, fw.hlen - 1 - s, s)[:, None]
            for f in frames]
    lib["K12a"] = timed("K12a conv1d dilation 1 sym8", rows,
                        lambda x: F.conv1d(x, w1).transpose(0, 1),
                        torch.stack(kms.swt1d_mxu_fused(frames[0], fw, 1)))
    s = conv.swt_centre(fw.hlen, True)
    wb = 0.5 * weights([fw.rec_lo, fw.rec_hi], False).flip(-1)[None]
    coef = [kms.swt1d_mxu_fused(f, fw, 1) for f in frames]
    c1 = [conv.periodic_pad_last(torch.stack(c, 1), fw.hlen - 1 - s, s)
          for c in coef]
    lib["K12b"] = timed("K12b conv1d dilation 1 sym8", c1,
                        lambda c: F.conv1d(c, wb)[:, 0],
                        kms.iswt1d_mxu_fused(*coef[0], fw, 1))
    del coef, c1, rows
    return lib


def phase_sweep_2d_swt(port, dev, card):
    """Device time of K8/K9 and K18a/K18b on a 2048^2 frame, as the
    module docstring says (CUDA events, sleep-primed, median of 21)."""
    fd, kn = port.ops.fused_dwt, port.ops.nonsep
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    # inputs that together exceed the 50 MB L2, as in phase_times
    frames = [torch.rand(FRAME, generator=gen, device=dev) for _ in range(4)]
    nx = itertools.cycle(frames).__next__

    def swt_coeffs(fn, bank, level):
        return itertools.cycle([fn(f, bank, level) for f in frames]).__next__

    def against_plain(plain, kernel):
        """plain, kernel, kernel, plain as in turns(), with one plain call
        per sample (three in a row outlasted every sleep at coif5)."""
        p1, k1 = cuda_ms(plain, 1, True), cuda_ms(kernel, 10, True)
        k2, p2 = cuda_ms(kernel, 10, True), cuda_ms(plain, 1, True)
        return (k1 + k2) / 2, (p1 + p2) / 2

    for wname, top in SWEEP_LEVELS:
        fb = port.get_filter_bank(wname)
        for level in range(1, top + 1):
            coef = swt_coeffs(fd.swt2d_fused, fb, level)
            k8 = cuda_ms(lambda: fd.swt2d_fused(nx(), fb, level), 10, True)
            k9 = cuda_ms(lambda: fd.iswt2d_fused(*coef(), fb, level), 10,
                         True)
            print(f"sweep level {wname} L{level} {FRAME}, device: K8 "
                  f"{k8 * 1e3:.1f} us, K9 {k9 * 1e3:.1f} us  [{card}]")
    rng = np.random.default_rng(SEED)
    for hlen in SWEEP_HLENS:
        f2d = port.nonsep.Filters2D(list(rng.random((4, hlen, hlen)) / hlen),
                                    list(rng.random((4, hlen, hlen)) / hlen),
                                    f"dense{hlen}")
        for level in (1, 3):
            coef = swt_coeffs(kn.ns_swt2d_fused, f2d, level)
            ka = cuda_ms(lambda: kn.ns_swt2d_fused(nx(), f2d, level), 3, True)
            kb = cuda_ms(lambda: kn.ins_swt2d_fused(*coef(), f2d, level), 3,
                         True)
            print(f"sweep filter size {hlen} L{level} {FRAME}, device: K18a "
                  f"{ka * 1e3:.1f} us, K18b {kb * 1e3:.1f} us  [{card}]")
    for wname in SWEEP_WIDTHS:
        fb = port.get_filter_bank(wname)
        coef = swt_coeffs(fd.swt2d_fused, fb, 1)
        k8 = against_plain(lambda: fd.swt2d_plain(nx(), fb, 1),
                           lambda: fd.swt2d_fused(nx(), fb, 1))
        k9 = against_plain(lambda: fd.iswt2d_plain(*coef(), fb, 1),
                           lambda: fd.iswt2d_fused(*coef(), fb, 1))
        print(f"sweep width {wname} (hlen {fb.hlen}) level 1 {FRAME}, "
              f"device: K8 {k8[0] * 1e3:.1f} us (plain {k8[1] * 1e3:.1f}), "
              f"K9 {k9[0] * 1e3:.1f} us (plain {k9[1] * 1e3:.1f})  [{card}]")


def phase_sweep_mxu(port, dev, card):
    """The crossover of the tensor-core forms: device time of K5/K6 and K1/K2
    at level l (a (2048 / 2^(l-1))^2 plane) and of K11a/K11b and K8/K9 at
    level l of 2048^2, by bank (hlen 4, 8, 16, 20, 40), both precisions,
    in turns (CUDA events, sleep-primed, median of 11)."""
    km, kms, fd = port.ops.mxu_dwt, port.ops.mxu_swt, port.ops.fused_dwt
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    frames = [torch.rand(FRAME, generator=gen, device=dev) for _ in range(4)]
    dwt_keys = ("K5", "K5 bf16", "K1", "K6", "K6 bf16", "K2")
    swt_keys = ("K11a", "K11a bf16", "K8", "K11b", "K11b bf16", "K9")
    for wname in SWEEP_MXU:
        fb = port.get_filter_bank(wname)
        for level in (1, 2, 3, 4):
            n = FRAME[0] >> (level - 1)
            planes = [f[:n, :n].contiguous() for f in frames]
            nx = itertools.cycle(planes).__next__
            dc = itertools.cycle([fd.dwt2d_fused(p, fb)
                                  for p in planes]).__next__
            fx = itertools.cycle(frames).__next__
            sc = itertools.cycle([fd.swt2d_fused(f, fb, level)
                                  for f in frames]).__next__
            t = in_turns({
                "K5": lambda: km.dwt2d_mxu_fused(nx(), fb),
                "K5 bf16": lambda: km.dwt2d_mxu_fused(nx(), fb, "bf16"),
                "K1": lambda: fd.dwt2d_fused(nx(), fb),
                "K6": lambda: km.idwt2d_mxu_fused(*dc(), fb, (n, n)),
                "K6 bf16": lambda: km.idwt2d_mxu_fused(*dc(), fb, (n, n),
                                                       "bf16"),
                "K2": lambda: fd.idwt2d_fused(*dc(), fb, (n, n)),
                "K11a": lambda: kms.swt2d_mxu_fused(fx(), fb, level),
                "K11a bf16": lambda: kms.swt2d_mxu_fused(fx(), fb, level,
                                                         "bf16"),
                "K8": lambda: fd.swt2d_fused(fx(), fb, level),
                "K11b": lambda: kms.iswt2d_mxu_fused(*sc(), fb, level),
                "K11b bf16": lambda: kms.iswt2d_mxu_fused(*sc(), fb, level,
                                                          "bf16"),
                "K9": lambda: fd.iswt2d_fused(*sc(), fb, level)},
                dict.fromkeys(dwt_keys + swt_keys, 10), 11)
            print(f"sweep crossover {wname} (hlen {fb.hlen}) L{level}, device "
                  f"us: DWT on {n}^2 "
                  + ", ".join(f"{k} {t[k] * 1e3:.1f}" for k in dwt_keys)
                  + f"; SWT on {FRAME[0]}^2 "
                  + ", ".join(f"{k} {t[k] * 1e3:.1f}" for k in swt_keys)
                  + f"  [{card}]")


def load_fft_oracle():
    spec = importlib.util.spec_from_file_location(
        "fft_oracle", ROOT / "tests" / "fft_oracle.py")
    fft = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fft)
    return fft


def phase_kernels_mxu1d(port, dev, keys=None):
    """K7a/K7b and K12a/K12b (levels 1-4) against their banded plain
    versions in both precisions on 2048 rows of 2048 and a (1, 4 Mi) row, at
    db2, sym8 and sym20 (hlen 4, 16, 40), each launch counted; then against
    the float64 oracle on small rows.  The worst "highest" errors go to the
    kernels line; the "bf16" ones are printed.  ``keys``: only those rows
    (--only)."""
    km, kms = port.ops.mxu_dwt, port.ops.mxu_swt
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    rows = [k for k in ("K7a", "K7b", "K12a", "K12b") if wanted(keys, k)]
    k12 = wanted(keys, "K12a", "K12b")
    worst = {p: dict.fromkeys(rows, 0.0) for p in PRECISIONS}
    for name in MXU1D_BANKS:
        fb = port.get_filter_bank(name)
        for shape in SHAPES_MXU1D:
            x = torch.rand(shape, generator=gen, device=dev)
            half = (shape[0], shape[1] // 2)
            c = [torch.rand(half, generator=gen, device=dev)
                 for _ in range(2)]
            s = [torch.rand(shape, generator=gen, device=dev)
                 for _ in range(2)]
            for prec in PRECISIONS:
                w = worst[prec]

                def note(key, got, ref, what):
                    try:
                        w[key] = max(w[key], mxu_close(got, ref, prec))
                    except AssertionError as e:
                        raise AssertionError(f"{key} {what}: {e}") from None

                what = (name, shape, prec)
                if wanted(keys, "K7a"):
                    got = launched_once(km.dwt1d_mxu_fused, lambda: (
                        km.dwt1d_mxu_fused(x, fb, prec)))
                    note("K7a", got, km.dwt1d_mxu_plain(x, fb, prec), what)
                if wanted(keys, "K7b"):
                    got = launched_once(km.idwt1d_mxu_fused, lambda: (
                        km.idwt1d_mxu_fused(*c, fb, shape[1], prec)))
                    note("K7b", got,
                         km.idwt1d_mxu_plain(*c, fb, shape[1], prec), what)
                for level in (1, 2, 3, 4) if k12 else ():
                    if kms.swt1d_mxu_unsupported(x, fb, level):
                        continue
                    got = launched_once(kms.swt1d_mxu_fused, lambda: (
                        kms.swt1d_mxu_fused(x, fb, level, prec)))
                    note("K12a", got, kms.swt1d_mxu_plain(x, fb, level, prec),
                         what + (level,))
                    got = launched_once(kms.iswt1d_mxu_fused, lambda: (
                        kms.iswt1d_mxu_fused(*s, fb, level, prec)))
                    note("K12b", got,
                         kms.iswt1d_mxu_plain(*s, fb, level, prec),
                         what + (level,))
            del x, c, s
            torch.cuda.synchronize()
            print(f"kernel-vs-plain 1D tensor cores {name:6s} "
                  f"hlen={fb.hlen:2d} {str(shape):14s} worst so far "
                  + "  ".join(f"{k} {v:.2e}/{worst['bf16'][k]:.2e}"
                              for k, v in worst["highest"].items())
                  + "  (highest/bf16)")
    oracle = load_oracle()
    rng = np.random.default_rng(SEED)
    for name in MXU1D_BANKS:
        fb = port.get_filter_bank(name)
        x = rng.random((3, 96), dtype=np.float32)
        c = [rng.random((3, 48), dtype=np.float32) for _ in range(2)]
        s = [rng.random((3, 96), dtype=np.float32) for _ in range(2)]
        refs = {"K7a": [np.stack([oracle.ref_analysis_1d(r, f) for r in x])
                        for f in (fb.dec_lo, fb.dec_hi)],
                "K7b": [np.stack([oracle.ref_synthesis_1d(
                    a, d, fb.rec_lo, fb.rec_hi, 96) for a, d in zip(*c)])],
                "K12a": [np.stack([oracle.ref_swt_analysis_1d(r, f, 2)
                                   for r in x])
                         for f in (fb.dec_lo, fb.dec_hi)],
                "K12b": [np.stack([oracle.ref_swt_synthesis_1d(
                    a, d, fb.rec_lo, fb.rec_hi, 2) for a, d in zip(*s)])]}
        tx = torch.from_numpy(x).to(dev)
        tc = [torch.from_numpy(t).to(dev) for t in c]
        ts = [torch.from_numpy(t).to(dev) for t in s]
        line = []
        for prec in PRECISIONS:
            gots = {"K7a": lambda: km.dwt1d_mxu_fused(tx, fb, prec),
                    "K7b": lambda: [km.idwt1d_mxu_fused(*tc, fb, 96, prec)],
                    "K12a": lambda: kms.swt1d_mxu_fused(tx, fb, 2, prec),
                    "K12b": lambda: [kms.iswt1d_mxu_fused(*ts, fb, 2, prec)]}
            for key in rows:
                got = gots[key]()
                got = [g.cpu().numpy() for g in got]
                if prec == "highest":
                    e = max(float(np.abs(g - r).max())
                            for g, r in zip(got, refs[key]))
                    if e > ORACLE_TOL:
                        raise AssertionError(f"{name} {key}: kernel vs "
                                             f"oracle {e:.3e} > {ORACLE_TOL}")
                else:
                    e = max(rms_gate(g, r, f"{name} {key} bf16 vs oracle")
                            for g, r in zip(got, refs[key]))
                line.append(f"{key} {prec} {e:.2e}")
        print(f"kernel-vs-oracle 1D tensor cores {name:6s} " + "  ".join(line)
              + "  (bf16: relative RMS)")
    for key, e in worst["bf16"].items():
        print(f"worst bf16 kernel-vs-plain {key}: {e:.3e}")
    return worst["highest"]


def f64_calls(port, fb, f2d, x, c2, c1, level):
    """Each float64 instance's call and its float64 plain version, by
    kernel: x a plane (2D) or rows (1D), c2 four subbands and c1 two
    coefficient rows of a decimated level, at SWT level ``level``."""
    fd, kn = port.ops.fused_dwt, port.ops.nonsep
    nr, nc = x.shape[-2:]
    return {
        "K1": (lambda: fd.dwt2d_fused(x, fb), lambda: fd.dwt2d_plain(x, fb)),
        "K2": (lambda: fd.idwt2d_fused(*c2, fb, (nr, nc)),
               lambda: fd.idwt2d_plain(*c2, fb, (nr, nc))),
        "K3": (lambda: fd.dwt1d_fused(x, fb), lambda: fd.dwt1d_plain(x, fb)),
        "K4": (lambda: fd.idwt1d_fused(*c1, fb, nc),
               lambda: fd.idwt1d_plain(*c1, fb, nc)),
        "K10a": (lambda: fd.swt1d_fused(x, fb, level),
                 lambda: fd.swt1d_plain(x, fb, level)),
        "K10b": (lambda: fd.iswt1d_fused(x, x, fb, level),
                 lambda: fd.iswt1d_plain(x, x, fb, level)),
        "K8": (lambda: fd.swt2d_fused(x, fb, level),
               lambda: fd.swt2d_plain(x, fb, level)),
        "K9": (lambda: fd.iswt2d_fused(x, x, x, x, fb, level),
               lambda: fd.iswt2d_plain(x, x, x, x, fb, level)),
        "K16": (lambda: kn.nsdwt2d_fused(x, f2d),
                lambda: kn.nsdwt2d_plain(x, f2d)),
        "K17": (lambda: kn.insdwt2d_fused(*c2, f2d, (nr, nc)),
                lambda: kn.insdwt2d_plain(*c2, f2d, (nr, nc))),
        "K18a": (lambda: kn.ns_swt2d_fused(x, f2d, level),
                 lambda: kn.ns_swt2d_plain(x, f2d, level)),
        "K18b": (lambda: kn.ins_swt2d_fused(x, x, x, x, f2d, level),
                 lambda: kn.ins_swt2d_plain(x, x, x, x, f2d, level)),
    }


def phase_kernels_f64(port, dev):
    """The float64 instance of every tap-loop kernel (K1-K4, K10a/K10b,
    K8/K9, K16/K17, K18a/K18b) against its float64 plain version (the
    bank's float64 values) on 2048^2 and odd planes and rows, levels 1 and
    3, over db2, db8, sym20 and the odd bank (the non-separable kernels on
    the custom 2D banks), and the separable ones against the float64 FFT
    oracle tests/fft_oracle.py."""
    kernels = port.ops.KERNELS
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    worst = {}
    banks = [port.get_filter_bank(n) for n in ("db2", "db8", "sym20")]
    banks.append(banks_1d(port)[-1])
    f2ds = banks_2d(port)
    for shape in (FRAME, ODD_PLANE):
        for i, fb in enumerate(banks):
            f2d = f2ds[i % len(f2ds)]
            x = torch.rand(shape, generator=gen, device=dev,
                           dtype=torch.float64)
            hs = half(shape)
            c2 = [torch.rand(hs, generator=gen, device=dev,
                             dtype=torch.float64) for _ in range(4)]
            c1 = [torch.rand((shape[0], hs[1]), generator=gen, device=dev,
                             dtype=torch.float64) for _ in range(2)]
            for level in (1, 3):
                for key, (kernel, plain) in f64_calls(
                        port, fb, f2d, x, c2, c1, level).items():
                    if level == 3 and key not in ("K10a", "K10b", "K8",
                                                  "K9", "K18a", "K18b"):
                        continue
                    got = launched_one(kernels, kernel, f"{key} float64")
                    got = got if isinstance(got, tuple) else (got,)
                    if any(g.dtype != torch.float64 for g in got):
                        raise AssertionError(f"{key}: float64 in, "
                                             f"{got[0].dtype} out")
                    want = plain()
                    err = max_err(got, want if isinstance(want, tuple)
                                  else (want,))
                    if not err <= F64_TOL:
                        raise AssertionError(
                            f"{key} float64 {fb.name} {shape} L{level}: "
                            f"kernel vs plain {err:.3e} > {F64_TOL}")
                    worst[key] = max(worst.get(key, 0.0), err)
            del x, c2, c1
        torch.cuda.synchronize()
        print(f"kernel-vs-plain float64 {str(shape):12s} worst so far "
              + "  ".join(f"{k} {v:.1e}" for k, v in worst.items()))
    fft = load_fft_oracle()
    rng = np.random.default_rng(SEED)
    for fb in banks:
        x = rng.random((24, 40))
        c = [rng.random((12, 20)) for _ in range(4)]
        tx = torch.from_numpy(x).to(dev)
        tc = [torch.from_numpy(t).to(dev) for t in c]
        fd = port.ops.fused_dwt

        def rows(fn, t, *args):  # along axis -2
            return np.swapaxes(fn(np.swapaxes(t, -1, -2), *args), -1, -2)

        lo = fft.fft_swt_analysis_1d(x, fb.dec_lo, 2)
        hi = fft.fft_swt_analysis_1d(x, fb.dec_hi, 2)
        # a, h, v, d: lo and hi of lo, then of hi, along axis -2
        k8 = [rows(fft.fft_swt_analysis_1d, t, f, 2)
              for t in (lo, hi) for f in (fb.dec_lo, fb.dec_hi)]

        def syn2(p, q):  # axis -2
            return np.swapaxes(fft.fft_swt_synthesis_1d(
                np.swapaxes(p, -1, -2), np.swapaxes(q, -1, -2), fb.rec_lo,
                fb.rec_hi, 2), -1, -2)
        s = [rng.random((24, 40)) for _ in range(4)]
        k9 = fft.fft_swt_synthesis_1d(syn2(s[0], s[1]), syn2(s[2], s[3]),
                                      fb.rec_lo, fb.rec_hi, 2)
        checks = {
            "K1": (fd.dwt2d_fused(tx, fb), fft.fft_dwt2d(x, fb)),
            "K2": (fd.idwt2d_fused(*tc, fb, (24, 40)),
                   fft.fft_waverec2([c[0], tuple(c[1:])], fb, (24, 40))),
            "K3": (fd.dwt1d_fused(tx, fb),
                   (fft.fft_analysis_1d(x, fb.dec_lo),
                    fft.fft_analysis_1d(x, fb.dec_hi))),
            "K4": (fd.idwt1d_fused(tc[0][:, :20].contiguous(),
                                   tc[1][:, :20].contiguous(), fb, 40),
                   fft.fft_synthesis_1d(c[0][:, :20], c[1][:, :20],
                                        fb.rec_lo, fb.rec_hi, 40)),
            "K10a": (fd.swt1d_fused(tx, fb, 2), (lo, hi)),
            "K10b": (fd.iswt1d_fused(tx, tx, fb, 2),
                     fft.fft_swt_synthesis_1d(x, x, fb.rec_lo, fb.rec_hi, 2)),
            "K8": (fd.swt2d_fused(tx, fb, 2), k8),
            "K9": (fd.iswt2d_fused(*(torch.from_numpy(t).to(dev) for t in s),
                                   fb, 2), k9),
        }
        if fb.hlen % 2:  # the oracle's synthesis centring is for even hlen
            del checks["K2"], checks["K4"]
        errs = {}
        for key, (got, ref) in checks.items():
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, (tuple, list)) else (ref,)
            errs[key] = max(float(np.abs(g.cpu().numpy() - np.asarray(r))
                                  .max()) for g, r in zip(got, ref))
        print(f"kernel-vs-fft-oracle float64 {fb.name:6s} "
              + "  ".join(f"{k} {v:.1e}" for k, v in errs.items()))
        if max(errs.values()) > F64_TOL:
            raise AssertionError(f"{fb.name}: float64 kernel vs FFT oracle "
                                 f"{max(errs.values()):.3e} > {F64_TOL}")
    return worst


def drive_mxu1d(port, dev, img, wname, levels, prec, want, what, **kw):
    """Wavelets(img, wname, levels, **kw) forward -> soft_threshold(10) ->
    inverse on the card in mode "mxu" at ``prec``, counted from 0, then a
    plain roundtrip; held against the CPU plain path of mode "auto" as
    drive_mxu holds the 2D path."""
    ops, dwt = port.ops, port.dwt
    ref = port.Wavelets(img, wname, levels, device="cpu", **kw)
    ref.forward()
    ref_coeffs = ref.coeffs
    ref.soft_threshold(10.0)
    ref.inverse()
    fwd = {k: v for k, v in want.items() if not k.startswith("i")}
    dwt.set_kernels("mxu")
    dwt.set_mxu_precision(prec)
    try:
        W = port.Wavelets(img, wname, levels, device=dev, **kw)
        ops.reset_counts()
        W.forward()
        coeffs = W.coeffs
        expect_launches(ops, fwd, f"{what} forward")
        W.soft_threshold(10.0)
        W.inverse()
        out = W.image
        torch.cuda.synchronize()
        launches = {k.__name__: k.launches for k in ops.KERNELS
                    if k.launches}
        expect_launches(ops, want, what)
        R = port.Wavelets(img, wname, levels, device=dev, **kw)
        R.forward()
        R.inverse()
        back = R.image.reshape(img.shape)
    finally:
        dwt.set_kernels("auto")
        dwt.set_mxu_precision("highest")
    levels = len(coeffs) - 1  # as the plan clamps them
    if prec == "highest":
        ec = check_pyramid(coeffs, ref_coeffs, f"{what} forward")
        ei = check_image(out, ref.image, f"{what} denoised image")
        er = check_image(back, img, f"{what} roundtrip")
        kind = "max-abs"
    else:
        flat = [(coeffs[0], ref_coeffs[0], levels)] + [
            (coeffs[lev], ref_coeffs[lev], lev)
            for lev in range(1, levels + 1)]
        ec = max(rms_gate(g, r, f"{what} level {lev}", lev)
                 for g, r, lev in flat)
        ei = rms_gate(out, ref.image, f"{what} denoised image", levels)
        er = rms_gate(back, img, f"{what} roundtrip", levels)
        kind = "relative RMS"
    print(f"main path {what}: forward vs cpu {ec:.3e}, denoised image vs "
          f"cpu {ei:.3e}, roundtrip {er:.3e} ({kind}), launches {launches}")
    return launches


def phase_main_paths_mxu1d(port, dev, keys=None):
    """Mode "mxu", both precisions, sym8: the 2048 x 2048 sinogram as
    batched 1D, DWT L3 (3 K7a, 3 K7b, no K3/K4) and SWT L3 (3 K12a, 3
    K12b, no K10), and one 4 Mi-sample signal, DWT L5 (5 + 5) and SWT L3
    (3 + 3), each against the CPU plan.  ``keys``: only the transforms
    whose kernels are among them (--only)."""
    sino = frame(FRAME, SEED + 18)
    sig = frame((SIGNAL,), SEED + 19)
    dwt, swt = wanted(keys, "K7a", "K7b"), wanted(keys, "K12a", "K12b")
    launches = {}
    for prec in PRECISIONS:
        got = {}
        if dwt:
            got.update(drive_mxu1d(
                port, dev, sino, "sym8", 3, prec,
                {"dwt1d_mxu_fused": 3, "idwt1d_mxu_fused": 3},
                f"mxu {prec} batched-1D sym8 L3 {FRAME}", ndim=1))
        if swt:
            got.update(drive_mxu1d(
                port, dev, sino, "sym8", 3, prec,
                {"swt1d_mxu_fused": 3, "iswt1d_mxu_fused": 3},
                f"mxu {prec} batched-1D SWT sym8 L3 {FRAME}", ndim=1,
                do_swt=1))
        if prec == "highest":
            launches = got
        if dwt:
            drive_mxu1d(port, dev, sig, "sym8", 5, prec,
                        {"dwt1d_mxu_fused": 5, "idwt1d_mxu_fused": 5},
                        f"mxu {prec} signal sym8 L5 ({SIGNAL},)")
        if swt:
            drive_mxu1d(port, dev, sig, "sym8", 3, prec,
                        {"swt1d_mxu_fused": 3, "iswt1d_mxu_fused": 3},
                        f"mxu {prec} signal SWT sym8 L3 ({SIGNAL},)",
                        do_swt=1)
    names = {"K7a": "dwt1d_mxu_fused", "K7b": "idwt1d_mxu_fused",
             "K12a": "swt1d_mxu_fused", "K12b": "iswt1d_mxu_fused"}
    return {k: launches[v] for k, v in names.items() if wanted(keys, k)}


def phase_main_paths_f64(port, dev):
    """Float64 plans on the card in mode "auto", on the float64 instances
    (exact launches, every level on a kernel): Wavelets(img, "db4", 3,
    dtype=np.float64) on the 2048^2 frame, DWT (3 K1, 3 K2) and SWT (3 K8,
    3 K9); the 2048 x 2048 sinogram as batched 1D, DWT (3 K3, 3 K4) and SWT
    (3 K10a, 3 K10b); the non-separable plans of the db3 x coif1 bank, DWT
    (3 K16, 3 K17) and SWT (3 K18a, 3 K18b); and pipeline.denoise2d on a
    float64 frame (3 K1, 3 K2).  Roundtrips within 1e-10 (JAX's float64
    gate), coefficients and the denoised image within 1e-10 of the plain
    path on the device (mode "torch")."""
    dwt, ops = port.dwt, port.ops
    img = np.random.default_rng(SEED + 20).random(FRAME) * 255
    cross = banks_2d(port)[0]
    plans = (("2D DWT", {}, None, ("dwt2d_fused", "idwt2d_fused")),
             ("2D SWT", dict(do_swt=1), None, ("swt2d_fused",
                                               "iswt2d_fused")),
             ("batched-1D DWT", dict(ndim=1), None, ("dwt1d_fused",
                                                      "idwt1d_fused")),
             ("batched-1D SWT", dict(ndim=1, do_swt=1), None,
              ("swt1d_fused", "iswt1d_fused")),
             (f"non-separable {cross.name}", dict(do_separable=0), cross,
              ("nsdwt2d_fused", "insdwt2d_fused")),
             (f"non-separable SWT {cross.name}",
              dict(do_separable=0, do_swt=1), cross,
              ("ns_swt2d_fused", "ins_swt2d_fused")))
    launches = {}

    def plan(kw, f2d):
        W = port.Wavelets(img, "db4", 3, dtype=np.float64, device=dev, **kw)
        if f2d is not None:
            install_bank(f2d)(W)
        return W

    for what, kw, f2d, names in plans:
        dwt.set_kernels("torch")
        try:
            R = plan(kw, f2d)
            R.forward()
            ref = R.coeffs
        finally:
            dwt.set_kernels("auto")
        W = plan(kw, f2d)
        ops.reset_counts()
        W.forward()
        coeffs = W.coeffs
        W.inverse()
        out = W.image
        torch.cuda.synchronize()
        got = {k.__name__: k.launches for k in ops.KERNELS if k.launches}
        expect_launches(ops, {names[0]: 3, names[1]: 3},
                        f"float64 {what}")
        launches.update(got)
        leaves = []
        for g, r in zip(coeffs, ref):
            g = g if isinstance(g, list) else [g]
            r = r if isinstance(r, list) else [r]
            leaves += list(zip(g, r))
        if any(g.dtype != np.float64 for g, _ in leaves):
            raise AssertionError(f"float64 {what}: coefficients not float64")
        ec = max(float(np.abs(g - r).max()) for g, r in leaves)
        er = float(np.abs(out.reshape(img.shape) - img).max())
        if out.dtype != np.float64 or not ec <= F64_PLAN_TOL \
                or not er < F64_PLAN_TOL:
            raise AssertionError(f"float64 {what}: forward vs plain {ec:.3e}"
                                 f", roundtrip {er:.3e} (limit "
                                 f"{F64_PLAN_TOL})")
        print(f"main path float64 {what} db4 L3 {FRAME}: forward vs plain "
              f"on the card {ec:.3e}, roundtrip {er:.3e}, launches {got}")
    x = torch.from_numpy(img).to(dev)
    dwt.set_kernels("torch")
    try:
        ref = port.pipeline.denoise2d(x, "db2", 3, BETA)
    finally:
        dwt.set_kernels("auto")
    ops.reset_counts()
    out = port.pipeline.denoise2d(x, "db2", 3, BETA)
    torch.cuda.synchronize()
    expect_launches(ops, {"dwt2d_fused": 3, "idwt2d_fused": 3},
                    "float64 denoise2d")
    err = float((out - ref).abs().max())
    if out.dtype != torch.float64 or not err <= F64_PLAN_TOL:
        raise AssertionError(f"float64 denoise2d: {err:.3e}")
    print(f"main path float64 denoise2d db2 L3 beta {BETA} {FRAME}: image vs "
          f"plain on the card {err:.3e}, launches 3 + 3")
    return launches


def mxu1d_cases(port, fb, rows, level):
    """Level ``level`` of bank ``fb`` on the sinogram's level shape (DWT:
    2048 rows of 2048 / 2^(l-1); SWT: 2048 x 2048) of ``rows``, for
    the tensor-core forms, their tap-loop kernels and plain versions: by
    key, the calls that cycle over inputs beyond the L2; and the DWT
    level's row length."""
    km, kms, fd = port.ops.mxu_dwt, port.ops.mxu_swt, port.ops.fused_dwt
    n = FRAME[1] >> (level - 1)
    drows = [r[:, :n].contiguous() for r in rows]
    nx = itertools.cycle(drows).__next__
    dc = itertools.cycle([fd.dwt1d_fused(r, fb) for r in drows]).__next__
    sx = itertools.cycle(rows).__next__
    sc = itertools.cycle([fd.swt1d_fused(r, fb, level)
                          for r in rows]).__next__
    return n, {
        "K7a": {"plain": lambda: km.dwt1d_mxu_plain(nx(), fb),
                "highest": lambda: km.dwt1d_mxu_fused(nx(), fb),
                "bf16": lambda: km.dwt1d_mxu_fused(nx(), fb, "bf16"),
                "tap": lambda: fd.dwt1d_fused(nx(), fb)},
        "K7b": {"plain": lambda: km.idwt1d_mxu_plain(*dc(), fb, n),
                "highest": lambda: km.idwt1d_mxu_fused(*dc(), fb, n),
                "bf16": lambda: km.idwt1d_mxu_fused(*dc(), fb, n, "bf16"),
                "tap": lambda: fd.idwt1d_fused(*dc(), fb, n)},
        "K12a": {"plain": lambda: kms.swt1d_mxu_plain(sx(), fb, level),
                 "highest": lambda: kms.swt1d_mxu_fused(sx(), fb, level),
                 "bf16": lambda: kms.swt1d_mxu_fused(sx(), fb, level,
                                                     "bf16"),
                 "tap": lambda: fd.swt1d_fused(sx(), fb, level)},
        "K12b": {"plain": lambda: kms.iswt1d_mxu_plain(*sc(), fb, level),
                 "highest": lambda: kms.iswt1d_mxu_fused(*sc(), fb, level),
                 "bf16": lambda: kms.iswt1d_mxu_fused(*sc(), fb, level,
                                                      "bf16"),
                 "tap": lambda: fd.iswt1d_fused(*sc(), fb, level)},
    }


def phase_times_mxu1d(port, dev, card, keys=None):
    """K7a against K3 and K7b against K4 at sym8 levels 1-3 of the 2048 x
    2048 sinogram (level l: 2048 rows of 2048 / 2^(l-1)), K12a against K10a
    and K12b against K10b at levels 1-3 of 2048 x 2048, each with its plain
    version ("highest") and its "bf16" time, in turns within this call
    (device time: the 1D paths are host-bound); then levels 1-5 of the 4 Mi
    signal's DWT (K7a/K7b in both precisions) and 1-3 of its SWT,
    tensor-core kernel against tap loop.  Level 1 of the sinogram goes to
    the kernels line.  ``keys``: only those rows (--only)."""
    fb = port.get_filter_bank("sym8")
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    rows = [torch.rand(FRAME, generator=gen, device=dev) * 255
            for _ in range(4)]
    reps = {"plain": 3, "highest": 10, "bf16": 10, "tap": 10}
    times = {}
    for level in (1, 2, 3):
        n, cases = mxu1d_cases(port, fb, rows, level)
        for key, calls in cases.items():
            if not wanted(keys, key):
                continue
            t = in_turns(calls, reps)
            tap = {"K7a": "K3", "K7b": "K4", "K12a": "K10a",
                   "K12b": "K10b"}[key]
            if level == 1:
                times[key] = (t["highest"], t["plain"])
            shape = (FRAME[0], n) if key.startswith("K7") else FRAME
            print(f"time {key} sym8 level {level} rows {shape}, device: "
                  f"kernel {t['highest'] * 1e3:.1f} us, bf16 "
                  f"{t['bf16'] * 1e3:.1f} us, {tap} {t['tap'] * 1e3:.1f} us, "
                  f"plain {t['plain'] * 1e3:.1f} us  [{card}]")
    km, kms, fd = port.ops.mxu_dwt, port.ops.mxu_swt, port.ops.fused_dwt
    sigs = [torch.rand((1, SIGNAL), generator=gen, device=dev) * 255
            for _ in range(4)]
    for level in (1, 2, 3, 4, 5):
        n = SIGNAL >> (level - 1)
        parts = [s[:, :n].contiguous() for s in sigs]
        nx = itertools.cycle(parts).__next__
        dc = itertools.cycle([fd.dwt1d_fused(p, fb) for p in parts]).__next__
        calls = {}
        if wanted(keys, "K7a"):
            calls.update({
                "K7a": lambda: km.dwt1d_mxu_fused(nx(), fb),
                "K7a bf16": lambda: km.dwt1d_mxu_fused(nx(), fb, "bf16"),
                "K3": lambda: fd.dwt1d_fused(nx(), fb)})
        if wanted(keys, "K7b"):
            calls.update({
                "K7b": lambda: km.idwt1d_mxu_fused(*dc(), fb, n),
                "K7b bf16": lambda: km.idwt1d_mxu_fused(*dc(), fb, n,
                                                        "bf16"),
                "K4": lambda: fd.idwt1d_fused(*dc(), fb, n)})
        swt = level <= 3 and wanted(keys, "K12a", "K12b")
        if swt:
            sx = itertools.cycle(sigs).__next__
            sc = itertools.cycle([fd.swt1d_fused(s, fb, level)
                                  for s in sigs]).__next__
            calls.update({
                "K12a": lambda: kms.swt1d_mxu_fused(sx(), fb, level),
                "K10a": lambda: fd.swt1d_fused(sx(), fb, level),
                "K12b": lambda: kms.iswt1d_mxu_fused(*sc(), fb, level),
                "K10b": lambda: fd.iswt1d_fused(*sc(), fb, level)})
        if not calls:  # --only K12: no DWT rows past level 3
            continue
        t = in_turns(calls, dict.fromkeys(calls, 10))
        rows = f"(1, {n}) DWT" + (f", (1, {SIGNAL}) SWT" if swt else "")
        print(f"time signal sym8 level {level} ({rows}), device us: "
              + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in t.items())
              + f"  [{card}]")
    return times


def phase_times_f64(port, dev, card):
    """The float64 instances of K1-K4 against their float32 ones at level 0
    of 2048^2 (2D) and 2048 rows of 2048 (1D), db2, in turns within this
    call (device time); float64 moves twice the bytes."""
    fd = port.ops.fused_dwt
    fb = port.get_filter_bank("db2")
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    times = {}
    for dtype in (torch.float32, torch.float64):
        frames = [torch.rand(FRAME, generator=gen, device=dev,
                             dtype=dtype) * 255 for _ in range(4)]
        nx = itertools.cycle(frames).__next__
        c2 = itertools.cycle([fd.dwt2d_fused(f, fb) for f in frames]).__next__
        c1 = itertools.cycle([fd.dwt1d_fused(f, fb) for f in frames]).__next__
        times[dtype] = {
            "K1": lambda nx=nx: fd.dwt2d_fused(nx(), fb),
            "K2": lambda c2=c2: fd.idwt2d_fused(*c2(), fb, FRAME),
            "K3": lambda nx=nx: fd.dwt1d_fused(nx(), fb),
            "K4": lambda c1=c1: fd.idwt1d_fused(*c1(), fb, FRAME[1])}
    calls = {f"{k} {str(d).split('.')[-1]}": f for d, fs in times.items()
             for k, f in fs.items()}
    t = in_turns(calls, dict.fromkeys(calls, 10))
    for key in ("K1", "K2", "K3", "K4"):
        a, b = t[f"{key} float32"], t[f"{key} float64"]
        print(f"time {key} level 0 db2 {FRAME}, device: float64 "
              f"{b * 1e3:.1f} us, float32 {a * 1e3:.1f} us ({b / a:.2f}x; "
              f"bytes 2x)  [{card}]")


def phase_sweep_mxu1d(port, dev, card):
    """The crossover of the 1D tensor-core forms: device time of K7a/K7b
    against K3/K4 at level l of the 2048 x 2048 sinogram (2048 rows of
    2048 / 2^(l-1)) and of K12a/K12b against K10a/K10b at level l of 2048 x
    2048, by bank (hlen 4, 8, 16, 20, 40) and level (1-4), both precisions,
    in turns (CUDA events, sleep-primed, median of 11)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    rows = [torch.rand(FRAME, generator=gen, device=dev) for _ in range(4)]
    keys = ("K7a", "K7a bf16", "K3", "K7b", "K7b bf16", "K4",
            "K12a", "K12a bf16", "K10a", "K12b", "K12b bf16", "K10b")
    for wname in SWEEP_MXU:
        fb = port.get_filter_bank(wname)
        for level in (1, 2, 3, 4):
            n, cases = mxu1d_cases(port, fb, rows, level)
            tap = {"K7a": "K3", "K7b": "K4", "K12a": "K10a", "K12b": "K10b"}
            calls = {}
            for key, c in cases.items():
                calls[key] = c["highest"]
                calls[key + " bf16"] = c["bf16"]
                calls[tap[key]] = c["tap"]
            t = in_turns(calls, dict.fromkeys(calls, 10), 11)
            print(f"sweep crossover 1D {wname} (hlen {fb.hlen}) L{level}, "
                  f"device us: DWT on {FRAME[0]} x {n} "
                  + ", ".join(f"{k} {t[k] * 1e3:.1f}" for k in keys[:6])
                  + f"; SWT on {FRAME[0]} x {FRAME[1]} "
                  + ", ".join(f"{k} {t[k] * 1e3:.1f}" for k in keys[6:])
                  + f"  [{card}]")


PYR_BANKS = ("db2", "sym8", "bior4.4", "sym20")  # hlen 4, 16, 10, 40
PYR_LEVELS = (2, 3, 5)
PYR_SHAPES = (FRAME, (256, 512))
REFUSED_FRAME = (2046, 2046)  # its level-0 approximation is odd


def phase_kernels_pyramid(port, dev):
    """K24/K25 against their plain versions on the card (0..255 data:
    each level within 3e-4 * 2^level, the roundtrip K25(K24(x)) and K25 on
    the pyramid within 7e-4) over banks of 4 to 40 taps, L 2, 3 and 5, the
    2048^2 frame and a 256 x 512 plane, and the (8, 2048, 2048) stack at
    db2 L3, one launch each; then against the float64 oracle
    tests/oracle.py level by level on a small plane."""
    fp = port.ops.fused_pyramid
    k24, k25 = fp.wavedec2_pyramid_fused, fp.waverec2_pyramid_fused
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    worst = {"K24": 0.0, "K25": 0.0}
    cases = [(w, s, lev) for w in PYR_BANKS for s in PYR_SHAPES
             for lev in PYR_LEVELS] + [("db2", (STACK, *FRAME), 3)]
    for wname, shape, levels in cases:
        fb = port.get_filter_bank(wname)
        x = torch.rand(shape, generator=gen, device=dev) * 255
        pyr = launched_once(k24, lambda: k24(x, fb, levels))
        e24 = check_pyramid(
            port.dwt.pyramid_to_numpy(pyr), port.dwt.pyramid_to_numpy(
                fp.wavedec2_pyramid_plain(x, fb, levels)),
            f"K24 {wname} {shape} L{levels}")
        rec = launched_once(k25, lambda: k25(pyr, fb, shape))
        e25 = max_err(rec, fp.waverec2_pyramid_plain(pyr, fb, shape))
        ert = max_err(rec, x)
        torch.cuda.synchronize()
        print(f"kernel-vs-plain pyramid {wname:7s} hlen={fb.hlen:2d} "
              f"{str(shape):17s} L{levels}: K24 {e24:.3e}  K25 {e25:.3e}  "
              f"roundtrip {ert:.3e}")
        if not max(e25, ert) <= ROUNDTRIP_TOL:
            raise AssertionError(f"K25 {wname} {shape} L{levels}: "
                                 f"{max(e25, ert):.3e} > {ROUNDTRIP_TOL}")
        worst["K24"] = max(worst["K24"], e24)
        worst["K25"] = max(worst["K25"], e25)
        del x, pyr, rec
    oracle = load_oracle()
    rng = np.random.default_rng(SEED)
    for name in PYR_BANKS:
        fb = port.get_filter_bank(name)
        x = rng.random((32, 64))
        got = port.dwt.pyramid_to_numpy(
            k24(torch.from_numpy(x.astype(np.float32)).to(dev), fb, 3))
        a, ref = x, []
        for _ in range(3):
            a, h, v, d = oracle.ref_analysis_2d(a, fb.dec_lo, fb.dec_hi)
            ref.append((h, v, d))
        ref = [a] + ref
        e24 = max(float(np.abs(g - r).max())
                  for g, r in zip(flat(got), flat(ref)))
        c = [rng.random((4, 8))] + [tuple(rng.random((32 >> lev, 64 >> lev))
                                          for _ in range(3))
                                    for lev in range(1, 4)]
        out = k25(port.dwt.pyramid_from_numpy(
            [c[0].astype(np.float32)] + [tuple(s.astype(np.float32)
                                               for s in t) for t in c[1:]],
            dev), fb, (32, 64)).cpu().numpy()
        a = c[0]
        for lev in range(3, 0, -1):
            a = oracle.ref_synthesis_2d(a, *c[lev], fb.rec_lo, fb.rec_hi,
                                        32 >> (lev - 1), 64 >> (lev - 1))
        e25 = float(np.abs(out - a).max())
        print(f"kernel-vs-oracle pyramid {name:7s} L3 (32, 64): K24 "
              f"{e24:.3e}  K25 {e25:.3e}")
        if max(e24, e25) > ORACLE_TOL:
            raise AssertionError(f"{name}: pyramid kernels vs oracle "
                                 f"{max(e24, e25):.3e} > {ORACLE_TOL}")
    return worst


def flat(pyr):
    return [pyr[0]] + [s for t in pyr[1:] for s in t]


def counts(ops):
    return {k.__name__: k.launches for k in ops.KERNELS if k.launches}


def drive_tail(port, dev, img, wname, mode, want_fwd, want, what):
    """Wavelets(img, wname, 3) forward -> soft_threshold(10) -> inverse on
    the card with tail fusion on in kernel mode ``mode``, counted from 0,
    then a plain roundtrip; against the CPU per-level plan."""
    ops, dwt = port.ops, port.dwt
    ref = port.Wavelets(img, wname, 3, device="cpu")
    ref.forward()
    ref_coeffs = ref.coeffs
    ref.soft_threshold(10.0)
    ref.inverse()
    dwt.set_tail_fuse(True)
    dwt.set_kernels(mode)
    try:
        W = port.Wavelets(img, wname, 3, device=dev)
        ops.reset_counts()
        W.forward()
        coeffs = W.coeffs
        expect_launches(ops, want_fwd, f"{what} forward")
        W.soft_threshold(10.0)
        W.inverse()
        out = W.image
        torch.cuda.synchronize()
        launches = counts(ops)
        expect_launches(ops, want, what)
        R = port.Wavelets(img, wname, 3, device=dev)
        R.forward()
        R.inverse()
        back = R.image
    finally:
        dwt.set_tail_fuse(False)
        dwt.set_kernels("auto")
    ec = check_pyramid(coeffs, ref_coeffs, f"{what} forward")
    ei = check_image(out, ref.image, f"{what} denoised image")
    er = check_image(back, img, f"{what} roundtrip")
    print(f"main path {what}: forward vs cpu {ec:.3e}, denoised image vs "
          f"cpu {ei:.3e}, roundtrip {er:.3e}, launches {launches}")
    return launches


def phase_main_paths_pyramid(port, dev):
    """Tail fusion (set_tail_fuse(True), reset in finally) through
    Wavelets on the 2048^2 frame, db2 L3 (K1 + K24, K25 + K2) and in mode
    "mxu" at sym8 L3 (K5 + K24, K25 + K6); the all-levels entries at
    2048^2 db2 L3 and on the stack (one launch each); denoise2d of the
    frame; and the routes the pyramid kernels refuse (a float64 plan, a
    2046^2 frame, whose level-0 approximation is odd: 3 + 3 per-level
    launches), beside a 2047^2 frame, whose 1024^2 approximation they take,
    as JAX does."""
    ops, dwt, fp = port.ops, port.dwt, port.ops.fused_pyramid
    img = frame(FRAME, SEED + 31)
    tail = {"dwt2d_fused": 1, "wavedec2_pyramid_fused": 1}
    got = drive_tail(port, dev, img, "db2", "auto", tail,
                     {**tail, "idwt2d_fused": 1, "waverec2_pyramid_fused": 1},
                     f"tail-fused db2 L3 {FRAME}")
    launches = {"K24": got["wavedec2_pyramid_fused"],
                "K25": got["waverec2_pyramid_fused"]}
    tail = {"dwt2d_mxu_fused": 1, "wavedec2_pyramid_fused": 1}
    drive_tail(port, dev, img, "sym8", "mxu", tail,
               {**tail, "idwt2d_mxu_fused": 1, "waverec2_pyramid_fused": 1},
               f"tail-fused mxu sym8 L3 {FRAME}")
    tail = {"dwt2d_fused": 1, "wavedec2_pyramid_fused": 1}
    drive_tail(port, dev, frame(ODD_FRAME, SEED + 32), "db2", "auto", tail,
               {**tail, "idwt2d_fused": 1, "waverec2_pyramid_fused": 1},
               f"tail-fused db2 L3 {ODD_FRAME}")
    per = {"dwt2d_fused": 3}
    drive_tail(port, dev, frame(REFUSED_FRAME, SEED + 33), "db2", "auto",
               per, {**per, "idwt2d_fused": 3},
               f"tail fusion refused, db2 L3 {REFUSED_FRAME}")

    fb = port.get_filter_bank("db2")
    for shape, seed in ((FRAME, SEED + 34), ((STACK, *FRAME), SEED + 35)):
        x = frame(shape, seed)
        ends = [0, STACK - 1] if len(shape) == 3 else slice(None)
        ref = dwt.pyramid_to_numpy(dwt.wavedec2(torch.from_numpy(x[ends]),
                                                fb, 3))
        xs = torch.from_numpy(x).to(dev)
        ops.reset_counts()
        pyr = fp.wavedec2_pyramid(xs, fb, 3)
        rec = fp.waverec2_pyramid(pyr, fb, xs.shape)
        torch.cuda.synchronize()
        expect_launches(ops, {"wavedec2_pyramid_fused": 1,
                              "waverec2_pyramid_fused": 1},
                        f"all-levels {shape}")
        ec = check_pyramid(dwt.pyramid_to_numpy(
            [pyr[0][ends]] + [tuple(s[ends] for s in t) for t in pyr[1:]]),
            ref, f"all-levels {shape} forward")
        er = check_image(rec.cpu().numpy(), x, f"all-levels {shape} "
                         "roundtrip")
        print(f"main path all-levels wavedec2_pyramid/waverec2_pyramid db2 "
              f"L3 {shape}: forward vs cpu {ec:.3e}, roundtrip {er:.3e}, "
              f"launches 1 + 1")
        del xs, pyr, rec

    call = lambda x: port.pipeline.denoise2d(x, "db2", 3, BETA)  # noqa: E731
    ref = call(torch.from_numpy(img)).numpy()
    dwt.set_tail_fuse(True)
    try:
        ops.reset_counts()
        out = call(torch.from_numpy(img).to(dev))
        torch.cuda.synchronize()
        got = counts(ops)
    finally:
        dwt.set_tail_fuse(False)
    expect_launches(ops, {"dwt2d_fused": 1, "wavedec2_pyramid_fused": 1,
                          "idwt2d_fused": 1, "waverec2_pyramid_fused": 1},
                    "tail-fused denoise2d")
    err = check_image(out.cpu().numpy(), ref, "tail-fused denoise2d")
    print(f"main path tail-fused denoise2d db2 L3 beta {BETA} {FRAME}: "
          f"image vs cpu per-level {err:.3e}, launches {got}")

    img64 = frame(FRAME, SEED + 36).astype(np.float64)
    ref = port.Wavelets(img64, "db2", 3, dtype=np.float64, device="cpu")
    ref.forward()
    dwt.set_tail_fuse(True)
    try:
        W = port.Wavelets(img64, "db2", 3, dtype=np.float64, device=dev)
        ops.reset_counts()
        W.forward()
        coeffs = W.coeffs
        W.inverse()
        torch.cuda.synchronize()
        got = counts(ops)
    finally:
        dwt.set_tail_fuse(False)
    expect_launches(ops, {"dwt2d_fused": 3, "idwt2d_fused": 3},
                    "tail fusion refused, float64")
    ec = max(float(np.abs(np.asarray(g) - np.asarray(r)).max())
             for g, r in zip(flat(coeffs), flat(ref.coeffs)))
    er = float(np.abs(W.image - img64).max())
    if not (ec <= 1e-11 and er <= F64_PLAN_TOL):
        raise AssertionError(f"float64 plan with tail fusion: {ec:.3e}, "
                             f"{er:.3e}")
    print(f"main path tail fusion refused, float64 db2 L3 {FRAME}: forward "
          f"vs cpu {ec:.3e}, roundtrip {er:.3e}, launches {got}")
    return launches


def phase_times_pyramid(port, dev, card):
    """K24/K25 device time at 2048^2 db2 L3 against their plain versions
    and against K1/K2 once per level, and the two-level tail of
    tail fusion (K24 on the 1024^2 level-0 approximation) against K1 at
    levels 2 and 3, in turns; then the L3 roundtrip three ways, per-level,
    tail-fused and all-levels, device and wall, in turns, and the per-level
    roundtrip replayed from a CUDA graph (wall and device): what launch
    savings alone are worth."""
    fd, fp, dwt = port.ops.fused_dwt, port.ops.fused_pyramid, port.dwt
    fb = port.get_filter_bank("db2")
    gen = torch.Generator(device=dev).manual_seed(SEED + 37)
    # inputs that together exceed the 50 MB L2, as in phase_times
    frames = [torch.rand(FRAME, generator=gen, device=dev) * 255
              for _ in range(4)]
    nx = itertools.cycle(frames).__next__
    pyrs = [fp.wavedec2_pyramid_fused(f, fb, 3) for f in frames]
    npy = itertools.cycle(pyrs).__next__
    a0s = [fd.dwt2d_fused(f, fb)[0] for f in frames]
    na0 = itertools.cycle(a0s).__next__
    tails = [fp.wavedec2_pyramid_fused(a, fb, 2) for a in a0s]
    ntl = itertools.cycle(tails).__next__
    sizes = [FRAME] + [(FRAME[0] >> lev, FRAME[1] >> lev) for lev in (1, 2)]

    def k1_levels(x, levels):
        for _ in range(levels):
            x = fd.dwt2d_fused(x, fb)[0]

    def k2_levels(pyr, out):
        a = pyr[0]
        for lev in range(len(pyr) - 1, 0, -1):
            a = fd.idwt2d_fused(a, *pyr[lev], fb, out[lev - 1])

    calls = {
        "K24": lambda: fp.wavedec2_pyramid_fused(nx(), fb, 3),
        "K24 plain": lambda: fp.wavedec2_pyramid_plain(nx(), fb, 3),
        "K1 x3": lambda: k1_levels(nx(), 3),
        "K25": lambda: fp.waverec2_pyramid_fused(npy(), fb, FRAME),
        "K25 plain": lambda: fp.waverec2_pyramid_plain(npy(), fb, FRAME),
        "K2 x3": lambda: k2_levels(npy(), sizes),
        "K24 tail": lambda: fp.wavedec2_pyramid_fused(na0(), fb, 2),
        "K1 levels 2-3": lambda: k1_levels(na0(), 2),
        "K25 tail": lambda: fp.waverec2_pyramid_fused(ntl(), fb, sizes[1]),
        "K2 levels 3-2": lambda: k2_levels(ntl(), sizes[1:]),
    }
    reps = {k: 3 if "plain" in k else 10 for k in calls}
    t = in_turns(calls, reps)
    for key, base in (("K24", "K1 x3"), ("K25", "K2 x3"),
                      ("K24 tail", "K1 levels 2-3"),
                      ("K25 tail", "K2 levels 3-2")):
        plain = t.get(f"{key} plain")
        shown = "" if plain is None else f", plain {plain * 1e3:.1f} us"
        print(f"time {key} db2 L3 {FRAME}, device: kernel "
              f"{t[key] * 1e3:.1f} us, {base} {t[base] * 1e3:.1f} us"
              f"{shown}  [{card}]")

    def per_level(x):
        return dwt.waverec2(dwt.wavedec2(x, fb, 3), fb, x.shape)

    def tail_fused(x):
        dwt.set_tail_fuse(True)
        try:
            return per_level(x)
        finally:
            dwt.set_tail_fuse(False)

    def all_levels(x):
        return fp.waverec2_pyramid(fp.wavedec2_pyramid(x, fb, 3), fb,
                                   x.shape)

    ways = {"per-level": lambda: per_level(nx()),
            "tail-fused": lambda: tail_fused(nx()),
            "all-levels": lambda: all_levels(nx())}
    # the per-level roundtrip of each frame captured once
    graphs = []
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in frames:
            per_level(f)
    torch.cuda.current_stream().wait_stream(side)
    for f in frames:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, capture_error_mode="relaxed"):
            out = per_level(f)
        graphs.append((g, f, out))
    for g, f, out in graphs:
        g.replay()
    torch.cuda.synchronize()
    err = max(max_err(out, per_level(f)) for g, f, out in graphs)
    if err > 1e-6:
        raise AssertionError(f"graph replay vs eager roundtrip {err:.3e}")
    ng = itertools.cycle(graphs).__next__
    ways["per-level graph"] = lambda: ng()[0].replay()
    rt = {}
    for clock, device_only in (("device", True), ("wall", False)):
        rt[clock] = in_turns(ways, dict.fromkeys(ways, 3),
                             device_only=device_only)
    for way in ways:
        d, w = rt["device"][way], rt["wall"][way]
        print(f"time L3 db2 roundtrip {FRAME} {way}: device {d:.4f} ms, wall "
              f"{w:.4f} ms ({1e3 / w:.0f} frames/s wall)  [{card}]")
    del graphs
    return {"K24": (t["K24"], t["K24 plain"]),
            "K25": (t["K25"], t["K25 plain"])}


# -- the row-sharded layer: K26a/K26b, K27a/K27b, K28 ------------------------

N_SHARDS = 4
BIG = (8192, 8192)         # one 256 MB float32 image, a size users shard
BIG_ODD = (8190, 8191)     # padded to 8192^2 by ShardedWavelets
SHARD_BANKS = ("db2", "sym8", "bior4.4", "sym20")  # hlen 4, 16, 10, 40
# 4 virtual shards of each plane (64 x 96: 16-row shards, multi-hop halos
# at sym20 and at SWT L4) and a stack
SHARD_PLANES = (BIG, (256, 512), (64, 96), (2, 2048, 2048))
SHARD_F64_PLANES = ((256, 512), (64, 96), (2, 2048, 2048))
F64_SHARD_TOL = 1e-10
SHARD_BLOCK = (BIG[0] // N_SHARDS, BIG[1])  # one shard of BIG: 2048 x 8192


def vmesh(port, n_data, n_rows, dev):
    """A (data, rows) mesh of virtual shards, all on ``dev``."""
    return port.parallel.mesh.make_mesh(n_data, n_rows,
                                        [dev] * (n_data * n_rows))


def sharded_levels(port, dev, x, fb, levels, swt, kernel, prec="highest"):
    """Run ``levels`` row-sharded levels of x (4 virtual shards) and back,
    level by level: each shard's kernel (K26/K27, or K28 where ``kernel``
    is "mxu") against its plain version on the same shard and halos, then
    the synthesis levels on the kernel's coefficients.  Returns the worst
    error of each entry, the roundtrip error and the gathered level-1
    coefficients."""
    par, fd = port.parallel, port.ops.fused_dwt
    km, kms = port.ops.mxu_dwt, port.ops.mxu_swt
    sp, ring_mod = par.spatial, par.ring
    m = vmesh(port, 1, N_SHARDS, dev)
    ring = ring_mod.LocalRing.for_mesh(m, batched=x.ndim == 3)
    parts = ring_mod.shard_rows(x, m)
    if kernel == "mxu":
        ana = (lambda s, t, b, lev: kms.swt2d_sharded_mxu_fused(
            s, t, b, fb, lev, prec)) if swt else (
            lambda s, t, b, lev: km.dwt2d_sharded_mxu_fused(s, t, b, fb,
                                                            prec))
        ana_p = (lambda s, t, b, lev: kms.swt2d_sharded_mxu_plain(
            s, t, b, fb, lev, prec)) if swt else (
            lambda s, t, b, lev: km.dwt2d_sharded_mxu_plain(s, t, b, fb,
                                                            prec))
        syn = (lambda c, h, lev: kms.iswt2d_sharded_mxu_fused(
            *c, h, fb, lev, prec)) if swt else (
            lambda c, h, lev: km.idwt2d_sharded_mxu_fused(*c, h, fb, prec))
        syn_p = (lambda c, h, lev: kms.iswt2d_sharded_mxu_plain(
            *c, h, fb, lev, prec)) if swt else (
            lambda c, h, lev: km.idwt2d_sharded_mxu_plain(*c, h, fb, prec))
        keys = ("K28 swt", "K28 iswt") if swt else ("K28 dwt", "K28 idwt")
        ka = kms.swt2d_sharded_mxu_fused if swt else km.dwt2d_sharded_mxu_fused
        ks = (kms.iswt2d_sharded_mxu_fused if swt
              else km.idwt2d_sharded_mxu_fused)
    else:
        ana = (lambda s, t, b, lev: fd.swt2d_sharded_fused(s, t, b, fb, lev)
               ) if swt else (lambda s, t, b, lev:
                              fd.dwt2d_sharded_fused(s, t, b, fb))
        ana_p = (lambda s, t, b, lev: fd.swt2d_sharded_plain(s, t, b, fb,
                                                             lev)
                 ) if swt else (lambda s, t, b, lev:
                                fd.dwt2d_sharded_plain(s, t, b, fb))
        syn = (lambda c, h, lev: fd.iswt2d_sharded_fused(*c, h, fb, lev)
               ) if swt else (lambda c, h, lev:
                              fd.idwt2d_sharded_fused(*c, h, fb))
        syn_p = (lambda c, h, lev: fd.iswt2d_sharded_plain(*c, h, fb, lev)
                 ) if swt else (lambda c, h, lev:
                                fd.idwt2d_sharded_plain(*c, h, fb))
        keys = ("K27a", "K27b") if swt else ("K26a", "K26b")
        ka = fd.swt2d_sharded_fused if swt else fd.dwt2d_sharded_fused
        ks = fd.iswt2d_sharded_fused if swt else fd.idwt2d_sharded_fused
    def close(got, ref, limit, what, level):
        """The kernel's worst error against the plain version: within
        ``limit`` (float32: 3e-4 * 2^level or 7e-4 on 0..255 data; float64:
        1e-10); in "bf16" the RMS gate of ``level`` (rms_gate's rule, on the
        device), returning the relative RMS error."""
        if prec == "bf16":
            if isinstance(got, torch.Tensor):
                got, ref = (got,), (ref,)
            worst = 0.0
            for g, r in zip(got, ref):
                g, r = g.double(), r.double()
                rel = float((g - r).pow(2).mean().sqrt()
                            / r.pow(2).mean().sqrt())
                if not rel <= BF16_RMS * 2 ** (level - 1):
                    raise AssertionError(f"{what}: bf16 RMS error {rel:.3e}")
                worst = max(worst, rel)
            return worst
        e = max_err(got, ref)
        if x.dtype == torch.float64:
            limit = F64_SHARD_TOL
        if not e <= limit:
            raise AssertionError(f"{what}: kernel vs plain {e:.3e} > "
                                 f"{limit:.1e}")
        return e
    errs = {keys[0]: 0.0, keys[1]: 0.0}
    a, details, level1 = parts, [], None
    for lev in range(1, levels + 1):
        halos = sp._exchange([a], "swt" if swt else "dwt", fb, ring, lev)
        outs = []
        for s, hs in zip(a, halos):
            got = launched_once(ka, lambda: ana(s, *hs, lev))
            e = close(got, ana_p(s, *hs, lev), COEFF_TOL * 2 ** lev,
                      f"{keys[0]} L{lev}", lev)
            errs[keys[0]] = max(errs[keys[0]], e)
            outs.append(got)
        a, h, v, d = (list(t) for t in zip(*outs))
        details.append((h, v, d))
        if lev == 1:
            level1 = [ring_mod.gather_rows(t) for t in (a, h, v, d)]
    for lev in range(levels, 0, -1):
        planes = [a, *details[lev - 1]]
        halos = sp._exchange(planes, "iswt" if swt else "idwt", fb, ring,
                             lev)
        outs = []
        for c, hs in zip(zip(*planes), halos):
            got = launched_once(ks, lambda: syn(c, hs, lev))
            # its output is the approximation of level lev - 1
            e = close(got, syn_p(c, hs, lev),
                      max(ROUNDTRIP_TOL, COEFF_TOL * 2 ** (lev - 1)),
                      f"{keys[1]} L{lev}", max(lev - 1, 1))
            errs[keys[1]] = max(errs[keys[1]], e)
            outs.append(got)
        a = outs
    back = ring_mod.gather_rows(a)
    ert = max_err(back, x)
    tol = (F64_SHARD_TOL if x.dtype == torch.float64 else
           ROUNDTRIP_TOL if prec == "highest" else None)
    if tol is not None and not ert <= tol:
        raise AssertionError(f"{keys} roundtrip {ert:.3e} > {tol}")
    if tol is None:
        rms_gate(back.cpu().numpy(), x.cpu().numpy(), f"{keys} roundtrip",
                 levels)
    return errs, ert, level1


def phase_kernels_sharded(port, dev, keys=None):
    """K26a/K26b, K27a/K27b (float32 and, at db4, float64) and K28's four
    entries (both precisions) against their plain versions on 4 virtual
    shards of cuda:0, on the shards and halos the ring exchanged: banks
    db2, sym8, bior4.4 and sym20, DWT L1-3 and SWT L1-4, planes 8192^2,
    256 x 512 and 64 x 96 (16-row shards: multi-hop halos at sym20 and at
    SWT L4) and the (2, 2048, 2048) stack, on 0..255 data (each analysis
    level within 3e-4 * 2^level, each synthesis level within that of the
    approximation it makes, 3e-4 * 2^(level-1), and at least 7e-4, the
    roundtrip within 7e-4; float64 within 1e-10; "bf16" each level and
    the roundtrip on rms_gate's rule); K28 runs the SWT levels whose
    support fits in a shard's rows (mode "mxu" sends the others to K27).
    Then the
    gathered level 1 against the float64 oracle on a [0, 1) 64 x 96
    plane.  ``keys``: only the kernel families of those rows (--only)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    worst = {k: 0.0 for k in ("K26a", "K26b", "K27a", "K27b", "K28 dwt",
                              "K28 idwt", "K28 swt", "K28 iswt")}
    bf16 = dict.fromkeys(("K28 dwt", "K28 idwt", "K28 swt", "K28 iswt"), 0.0)
    conv = port.conv
    for name in SHARD_BANKS:
        fb = port.get_filter_bank(name)
        for shape in SHARD_PLANES:
            x = torch.rand(shape, generator=gen, device=dev) * 255
            line = []
            for swt, levels in ((False, 3), (True, 4)):
                if wanted(keys, *(("K27a", "K27b") if swt
                                  else ("K26a", "K26b"))):
                    errs, ert, _ = sharded_levels(port, dev, x, fb, levels,
                                                  swt, "cuda")
                    for k, e in errs.items():
                        worst[k] = max(worst[k], e)
                    line.append(f"{'/'.join(errs)} {max(errs.values()):.2e} "
                                f"rt {ert:.2e}")
                if not wanted(keys, *(("K28 swt", "K28 iswt") if swt
                                      else ("K28 dwt", "K28 idwt"))):
                    continue
                # K28 covers the SWT levels whose support fits in a row
                top = levels if not swt else max([0] + [
                    lev for lev in range(1, levels + 1) if max(
                        conv.swt_pads(fb.hlen, lev, False)
                        + conv.swt_pads(fb.hlen, lev, True)) <= shape[-1]])
                for prec in PRECISIONS if top else ():
                    errs, ert, _ = sharded_levels(port, dev, x, fb, top, swt,
                                                  "mxu", prec)
                    for k, e in errs.items():
                        if prec == "highest":
                            worst[k] = max(worst[k], e)
                        else:
                            bf16[k] = max(bf16[k], e)
                    line.append(f"K28 {'swt' if swt else 'dwt'} L{top} "
                                f"{prec} {max(errs.values()):.2e} "
                                f"rt {ert:.2e}")
            del x
            torch.cuda.synchronize()
            print(f"kernel-vs-plain sharded {name:7s} {str(shape):17s} "
                  + "; ".join(line))
    fb = port.get_filter_bank("db4")
    for shape in SHARD_F64_PLANES if wanted(keys, *SHARD_KEYS[:4]) else ():
        x = torch.rand(shape, generator=gen, device=dev,
                       dtype=torch.float64) * 255
        e1, r1, _ = sharded_levels(port, dev, x, fb, 3, False, "cuda")
        e2, r2, _ = sharded_levels(port, dev, x, fb, 4, True, "cuda")
        print(f"kernel-vs-plain sharded float64 db4 {str(shape):17s} "
              f"K26 {max(e1.values()):.2e} rt {r1:.2e}, K27 "
              f"{max(e2.values()):.2e} rt {r2:.2e}")

    oracle = load_oracle()
    rng = np.random.default_rng(SEED + 41)
    for name in SHARD_BANKS:
        fb = port.get_filter_bank(name)
        xn = rng.random((64, 96))
        x = torch.from_numpy(xn.astype(np.float32)).to(dev)
        refs = {False: oracle.ref_analysis_2d(xn, fb.dec_lo, fb.dec_hi),
                True: swt2d_oracle(oracle, xn, fb, 1)}
        line = []
        for swt in (False, True):
            for kernel in ("cuda", "mxu"):
                family = "K28" if kernel == "mxu" else "K27" if swt else "K26"
                if not any(k.startswith(family) and wanted(keys, k)
                           for k in SHARD_KEYS):
                    continue
                _, _, level1 = sharded_levels(port, dev, x, fb, 1, swt,
                                              kernel)
                e = max(float(np.abs(g.cpu().numpy() - r).max())
                        for g, r in zip(level1, refs[swt]))
                if e > ORACLE_TOL:
                    raise AssertionError(f"{name} sharded {kernel} swt={swt}"
                                         f" vs oracle {e:.3e}")
                line.append(f"{family} {'SWT' if swt else 'DWT'} {e:.2e}")
        print(f"kernel-vs-oracle sharded {name:7s} (64, 96) level 1, "
              "gathered: " + "  ".join(line))
    for key, e in bf16.items():
        if wanted(keys, key):
            print(f"worst bf16 kernel-vs-plain sharded {key}: {e:.3e}")
    return {k: e for k, e in worst.items() if wanted(keys, k)}


def phase_main_paths_sharded(port, dev, keys=None):
    """The row-sharded plans on meshes of 4 virtual shards of cuda:0,
    counted from 0, against the unsharded plans on the card:
    ShardedWavelets(8192^2, "db2", 3) forward -> soft_threshold(10) ->
    inverse (12 K26a, 12 K26b, no K1/K2), do_swt=1 (12 K27a + 12 K27b), in
    mode "mxu" sym8 L3 DWT and SWT in both precisions (12 + 12 of K28's
    entries); the non-aligned 8190 x 8191 image (padded, cropped,
    roundtrip) and its denoise(10, spins=4) against the unsharded denoise
    of the same drawn shifts; BatchedWavelets on the (8, 2048, 2048) stack,
    data-parallel over 4 shards (12 K1 + 12 K2, no exchange) and hybrid
    over 2 x 2 (12 K26a + 12 K26b); norm1 and norm2sq one all-reduce
    each.  ``keys``: only the transforms whose kernels are among them, and
    the db2 DWT plans (odd image, denoise, stack, norms) with K26
    (--only)."""
    ops, par, dwt = port.ops, port.parallel, port.dwt
    SW = par.ShardedWavelets
    mesh = vmesh(port, 1, N_SHARDS, dev)
    img = frame(BIG, SEED + 42)
    launches = {}
    row_of = {"dwt2d_sharded_fused": "K26a", "idwt2d_sharded_fused": "K26b",
              "swt2d_sharded_fused": "K27a", "iswt2d_sharded_fused": "K27b",
              "dwt2d_sharded_mxu_fused": "K28 dwt",
              "idwt2d_sharded_mxu_fused": "K28 idwt",
              "swt2d_sharded_mxu_fused": "K28 swt",
              "iswt2d_sharded_mxu_fused": "K28 iswt"}
    cases = (("db2", 0, "auto", "highest",
              {"dwt2d_sharded_fused": 12, "idwt2d_sharded_fused": 12}),
             ("db2", 1, "auto", "highest",
              {"swt2d_sharded_fused": 12, "iswt2d_sharded_fused": 12}),
             ("sym8", 0, "mxu", "highest",
              {"dwt2d_sharded_mxu_fused": 12,
               "idwt2d_sharded_mxu_fused": 12}),
             ("sym8", 1, "mxu", "highest",
              {"swt2d_sharded_mxu_fused": 12,
               "iswt2d_sharded_mxu_fused": 12}),
             ("sym8", 0, "mxu", "bf16",
              {"dwt2d_sharded_mxu_fused": 12,
               "idwt2d_sharded_mxu_fused": 12}),
             ("sym8", 1, "mxu", "bf16",
              {"swt2d_sharded_mxu_fused": 12,
               "iswt2d_sharded_mxu_fused": 12}))
    for wname, do_swt, mode, prec, want in cases:
        if not wanted(keys, *(row_of[k] for k in want)):
            continue
        what = (f"ShardedWavelets {wname} L3 {'SWT' if do_swt else 'DWT'} "
                f"{BIG} mode {mode}{' ' + prec if mode == 'mxu' else ''}")
        dwt.set_kernels(mode)
        dwt.set_mxu_precision(prec)
        try:
            ref = port.Wavelets(img, wname, 3, do_swt=do_swt, device=dev)
            ref.forward()
            ref_coeffs = ref.coeffs
            ref.soft_threshold(10.0)
            ref.inverse()
            ref_image = ref.image
            del ref
            S = SW(img, wname, 3, do_swt=do_swt, mesh=mesh)
            ops.reset_counts()
            S.forward()
            coeffs = S.coeffs
            expect_launches(ops, {k: v for k, v in want.items()
                                  if "idwt" not in k and "iswt" not in k},
                            f"{what} forward")
            S.soft_threshold(10.0)
            S.inverse()
            out = S.image
            torch.cuda.synchronize()
            got = counts(ops)
            expect_launches(ops, want, what)
        finally:
            dwt.set_kernels("auto")
            dwt.set_mxu_precision("highest")
        if prec == "highest":
            ec = check_pyramid(coeffs, ref_coeffs, f"{what} forward")
            ei = check_image(out, ref_image, f"{what} denoised image")
        else:
            ec = max([rms_gate(coeffs[0], ref_coeffs[0], what, 3)] + [
                rms_gate(g, r, f"{what} level {lev}", lev)
                for lev in range(1, 4)
                for g, r in zip(coeffs[lev], ref_coeffs[lev])])
            ei = rms_gate(out, ref_image, f"{what} image", 3)
        print(f"main path {what}: forward vs unsharded {ec:.3e}, denoised "
              f"image vs unsharded {ei:.3e}, launches {got}")
        if prec == "highest":
            launches.update({row_of[k]: v for k, v in got.items()
                             if wanted(keys, row_of[k])})
        del coeffs, ref_coeffs, out
    if not wanted(keys, "K26a", "K26b"):
        return launches

    odd = frame(BIG_ODD, SEED + 43)
    S = SW(odd, "db2", 3, mesh=mesh)
    S.forward()
    S.inverse()
    er = check_image(S.image, odd, f"{BIG_ODD} roundtrip")
    S = SW(odd, "db2", 3, mesh=mesh, seed=SEED)
    ops.reset_counts()
    S.denoise(BETA, spins=4)
    out = S.image
    got = counts(ops)
    # the unsharded denoise of the same drawn shifts
    rng = np.random.default_rng(SEED)
    pad = np.pad(odd, [(0, p - n) for p, n in zip(S._padded, BIG_ODD)],
                 mode="wrap")
    acc = None
    for _ in range(4):
        sr, sc = int(rng.integers(0, BIG_ODD[0])), int(
            rng.integers(0, BIG_ODD[1]))
        W = port.Wavelets(np.roll(pad, (sr, sc), (0, 1)), "db2", 3,
                          device=dev)
        W.forward()
        W.soft_threshold(BETA)
        W.inverse()
        y = np.roll(W.image, (-sr, -sc), (0, 1))
        acc = y if acc is None else acc + y
    ed = check_image(out, (acc / 4)[:BIG_ODD[0], :BIG_ODD[1]],
                     f"{BIG_ODD} denoise spins=4")
    if got != {"dwt2d_sharded_fused": 12 * 4, "idwt2d_sharded_fused": 12 * 4}:
        raise AssertionError(f"denoise spins=4: launches {got}")
    print(f"main path ShardedWavelets db2 L3 {BIG_ODD} (padded to "
          f"{S._padded}): roundtrip {er:.3e}; denoise({BETA}, spins=4) vs "
          f"unsharded denoise of the same shifts {ed:.3e}, launches {got}")

    stack = frame((STACK, *FRAME), SEED + 44)
    ref = port.dwt.pyramid_to_numpy(port.dwt.wavedec2(
        torch.from_numpy(stack).to(dev), port.get_filter_bank("db2"), 3))
    for n_data, n_rows, want, hops in (
            (4, 1, {"dwt2d_fused": 12, "idwt2d_fused": 12}, 0),
            (2, 2, {"dwt2d_sharded_fused": 12,
                    "idwt2d_sharded_fused": 12}, 6 + 24)):
        B = par.BatchedWavelets(stack, "db2", 3,
                                mesh=vmesh(port, n_data, n_rows, dev))
        ops.reset_counts()
        B.ring.reset()
        B.forward()
        coeffs = [B.coeff_only(0)] + [
            tuple(B.coeff_only(3 * (lev - 1) + k) for k in (1, 2, 3))
            for lev in range(1, 4)]
        B.inverse()
        out = B.image
        torch.cuda.synchronize()
        got = counts(ops)
        expect_launches(ops, want, f"BatchedWavelets {n_data} x {n_rows}")
        if B.ring.counts["ppermute"] != hops:
            raise AssertionError(f"BatchedWavelets {n_data} x {n_rows}: "
                                 f"{B.ring.counts['ppermute']} exchanges")
        ec = check_pyramid(coeffs, ref, f"BatchedWavelets {n_data}x{n_rows}")
        er = check_image(out, stack, f"BatchedWavelets {n_data}x{n_rows}")
        B.forward()
        for norm in (B.norm1, B.norm2sq):
            B.ring.reset()
            norm()
            if B.ring.counts != {"ppermute": 0, "all_gather": 0,
                                 "all_reduce": 1, "all_to_all": 0}:
                raise AssertionError(f"{norm.__name__}: {B.ring.counts}")
        print(f"main path BatchedWavelets db2 L3 {stack.shape} over "
              f"{n_data} data x {n_rows} rows: forward vs unsharded {ec:.3e}"
              f", roundtrip {er:.3e}, launches {got}, exchanges "
              f"{hops}, norm1/norm2sq one all-reduce each")
        del B, coeffs, out
    S = SW(img, "db2", 3, mesh=mesh)
    S.forward()
    for norm, ref_norm in ((S.norm1, port.thresh.norm1),
                           (S.norm2sq, port.thresh.norm2sq)):
        S.ring.reset()
        got = norm()
        if S.ring.counts["all_reduce"] != 1 or S.ring.counts["ppermute"]:
            raise AssertionError(f"{norm.__name__}: {S.ring.counts}")
        want = float(ref_norm(port.dwt.wavedec2(
            torch.from_numpy(img).to(dev), port.get_filter_bank("db2"), 3)))
        if abs(got - want) > 1e-4 * want:
            raise AssertionError(f"{norm.__name__} {got} vs {want}")
    print(f"main path ShardedWavelets {BIG} norm1/norm2sq: one all-reduce "
          "each, within 1e-4 of the unsharded norms")
    return launches


def phase_audit_sharded(port, dev):
    """The counted exchange schedule of the 8192^2 row-sharded DWT and SWT
    (db2 L3, 4 virtual shards) against audit.predict_rowsharded: equal
    ppermute counts each way, no all-gather, all-reduce or all-to-all;
    the halo bytes per shard."""
    par = port.parallel
    audit = par.audit
    fb = port.get_filter_bank("db2")
    x = torch.from_numpy(frame(BIG, SEED + 45)).to(dev)
    for swt in (False, True):
        fwd, inv = audit.rowsharded_fns(fb, 3, vmesh(port, 1, N_SHARDS, dev),
                                        swt)
        fwd.ring.reset()
        pyr = fwd(x)
        f = audit.schedule_of(fwd.ring)
        fwd.ring.reset()
        inv(pyr)
        i = audit.schedule_of(fwd.ring)
        torch.cuda.synchronize()
        pred = audit.predict_rowsharded(fb, 3, *BIG, N_SHARDS, swt)
        for sched, key in ((f, "fwd_ppermute"), (i, "inv_ppermute")):
            if sched["ppermute"] != pred[key] or any(
                    sched[k] for k in ("all_gather", "all_reduce",
                                       "all_to_all")):
                raise AssertionError(f"schedule {sched} vs {pred}")
        fwd_bytes = 4 * sum(f["ppermute_elems"])
        if fwd_bytes != pred["fwd_halo_bytes"]:
            raise AssertionError(f"halo bytes {fwd_bytes} vs {pred}")
        print(f"audit {'SWT' if swt else 'DWT'} db2 L3 {BIG} on {N_SHARDS} "
              f"shards: ppermute forward {f['ppermute']} / inverse "
              f"{i['ppermute']} (predicted {pred['fwd_ppermute']} / "
              f"{pred['inv_ppermute']}), all-gather 0, all-reduce 0, "
              f"all-to-all 0; halo bytes per shard forward {fwd_bytes} "
              f"({fwd_bytes / (4 * BIG[0] * BIG[1] / N_SHARDS):.2e} of a "
              f"shard), inverse {4 * sum(i['ppermute_elems'])}")
        del pyr


def shard_rows_of(g, i, n, top, bot):
    """Rows [i n - top, i n + n + bot) of plane(s) g, wrapped."""
    rows = torch.arange(i * n - top, i * n + n + bot, device=g.device)
    return g.index_select(-2, rows % g.shape[-2]).contiguous()


def phase_times_sharded(port, dev, card, keys=None):
    """Device time of each K26-K28 entry on one 2048 x 8192 shard of the
    8192^2 image (K26/K27 at db2, K28 at sym8 "highest" and "bf16", level 1
    for the SWT), against its plain version and against its unsharded kernel on
    the same block (K1/K2, K8/K9, K5/K6, K11a/K11b), in turns; beside each,
    one PyTorch convolution of the same map on the shard's rows extended
    and padded outside the timed call (library_ms); then the 8192^2 db2 L3
    roundtrip on 4 virtual shards against the unsharded one, device and
    wall: the device cost of sharding on one card.  ``keys``: only those
    entries, and the roundtrip with K26 (--only)."""
    par = port.parallel
    n, nc = SHARD_BLOCK
    gen = torch.Generator(device=dev).manual_seed(SEED + 46)
    globs = [torch.rand(BIG, generator=gen, device=dev) * 255
             for _ in range(2)]
    times, library = {}, {}
    torch.backends.cudnn.benchmark = True
    try:
        for key, wname, kind, mxu in (
                ("K26a", "db2", "dwt", False), ("K26b", "db2", "idwt", False),
                ("K27a", "db2", "swt", False), ("K27b", "db2", "iswt", False),
                ("K28 dwt", "sym8", "dwt", True),
                ("K28 idwt", "sym8", "idwt", True),
                ("K28 swt", "sym8", "swt", True),
                ("K28 iswt", "sym8", "iswt", True)):
            if not wanted(keys, key):
                continue
            fb = port.get_filter_bank(wname)
            f2d = port.nonsep.Filters2D.from_bank(fb)
            calls, lib = sharded_calls(port, fb, f2d, kind, mxu, globs, n,
                                       nc, dev)
            reps = {"kernel": 10, "unsharded": 10, "plain": 3, "bf16": 10}
            t = in_turns(calls, reps)
            times[key] = (t["kernel"], t["plain"])
            library[key] = lib
            bf16 = f"bf16 {t['bf16'] * 1e3:.1f} us, " if "bf16" in t else ""
            print(f"time {key} {wname} {kind} on a {n} x {nc} shard, "
                  f"device: kernel {t['kernel'] * 1e3:.1f} us, {bf16}"
                  "unsharded kernel on the block "
                  f"{t['unsharded'] * 1e3:.1f} us, plain "
                  f"{t['plain'] * 1e3:.1f} us, library "
                  f"{lib * 1e3:.1f} us  [{card}]")
    finally:
        torch.backends.cudnn.benchmark = False
    if not wanted(keys, "K26a", "K26b"):
        return times, library
    fb = port.get_filter_bank("db2")
    sp, ring_mod = par.spatial, par.ring
    mesh = vmesh(port, 1, N_SHARDS, dev)
    ring = ring_mod.LocalRing.for_mesh(mesh, batched=False)
    parts = [ring_mod.shard_rows(g, mesh) for g in globs]
    nparts = itertools.cycle(parts).__next__
    nglob = itertools.cycle(globs).__next__
    ways = {
        "4 virtual shards": lambda: sp._local_waverec2(
            sp._local_wavedec2(nparts(), fb, 3, ring), fb, ring),
        "unsharded": lambda: port.dwt.waverec2(
            port.dwt.wavedec2(nglob(), fb, 3), fb, BIG)}
    rt = {clock: in_turns(ways, dict.fromkeys(ways, 3), device_only=d)
          for clock, d in (("device", True), ("wall", False))}
    for way in ways:
        print(f"time L3 db2 roundtrip {BIG} {way}: device "
              f"{rt['device'][way]:.4f} ms, wall {rt['wall'][way]:.4f} ms  "
              f"[{card}]")
    d = rt["device"]
    print(f"sharding overhead on one card, 8192^2 db2 L3 roundtrip: device "
          f"{d['4 virtual shards'] / d['unsharded']:.3f}x, wall "
          f"{rt['wall']['4 virtual shards'] / rt['wall']['unsharded']:.3f}x"
          f"  [{card}]")
    return times, library


def sharded_calls(port, fb, f2d, kind, mxu, globs, n, nc, dev):
    """(timed calls, library ms) of one entry on shard 1 of each global
    plane: the kernel (and, for K28, its "bf16" precision), its plain
    version and the unsharded kernel on the same block; the library call
    is checked against the kernel and timed here."""
    fd, km, kms, conv = (port.ops.fused_dwt, port.ops.mxu_dwt,
                         port.ops.mxu_swt, port.conv)
    lev = 1
    i = 1
    if kind in ("dwt", "swt"):
        top, bot = fd.halo_heights(kind, fb, n, lev)
        ins = [(shard_rows_of(g, i, n, 0, 0), shard_rows_of(g, i, n, top, 0)
                [..., :top, :].contiguous(),
                shard_rows_of(g, i, n, 0, bot)[..., n:, :].contiguous())
               for g in globs]
        if kind == "dwt":
            k = (lambda s, t, b, *prec: km.dwt2d_sharded_mxu_fused(
                s, t, b, fb, *prec)) \
                if mxu else (lambda s, t, b: fd.dwt2d_sharded_fused(s, t, b,
                                                                     fb))
            p = (lambda s, t, b: km.dwt2d_sharded_mxu_plain(s, t, b, fb)) \
                if mxu else (lambda s, t, b: fd.dwt2d_sharded_plain(s, t, b,
                                                                     fb))
            u = (lambda s: km.dwt2d_mxu_fused(s, fb)) if mxu else (
                lambda s: fd.dwt2d_fused(s, fb))
        else:
            k = (lambda s, t, b, *prec: kms.swt2d_sharded_mxu_fused(
                s, t, b, fb, lev, *prec)) if mxu \
                else (lambda s, t, b: fd.swt2d_sharded_fused(s, t, b, fb,
                                                             lev))
            p = (lambda s, t, b: kms.swt2d_sharded_mxu_plain(s, t, b, fb,
                                                             lev)) if mxu \
                else (lambda s, t, b: fd.swt2d_sharded_plain(s, t, b, fb,
                                                             lev))
            u = (lambda s: kms.swt2d_mxu_fused(s, fb, lev)) if mxu else (
                lambda s: fd.swt2d_fused(s, fb, lev))
        nx = itertools.cycle(ins).__next__
        calls = {"kernel": lambda: k(*nx()), "plain": lambda: p(*nx()),
                 "unsharded": lambda: u(nx()[0])}
        if mxu:
            calls["bf16"] = lambda: k(*nx(), "bf16")
        kernel_out = torch.stack(k(*ins[0]))
        # the library call: one convolution of the shard's rows extended by
        # the halos and its columns padded periodically, outside the timing
        cl, cr = ((fb.hlen - 1 - fb.hlen // 2, max(fb.hlen // 2 - 1, 0))
                  if kind == "dwt" else conv.swt_pads(fb.hlen, lev, False))
        padded = [conv.periodic_pad_last(shard_rows_of(g, i, n, top, bot),
                                         cl, cr)[None, None] for g in globs]
        w = torch.tensor(np.stack(f2d.dec), dtype=torch.float32,
                         device=dev).flip(-1, -2)[:, None]
        call = ((lambda z: F.conv2d(z, w, stride=2)[0]) if kind == "dwt"
                else (lambda z: F.conv2d(z, w, dilation=1 << (lev - 1))[0]))
        return calls, library_time(call, padded, kernel_out)
    # syntheses: coefficient planes of each global plane's transform
    coeffs = [(fd.dwt2d_fused(g, fb) if kind == "idwt"
               else fd.swt2d_fused(g, fb, lev)) for g in globs]
    rows = n // 2 if kind == "idwt" else n
    top, bot = fd.halo_heights(kind, fb, rows, lev)
    ins = []
    for c in coeffs:
        body = [shard_rows_of(p, i, rows, 0, 0) for p in c]
        halos = []
        for pl in c:
            ext = shard_rows_of(pl, i, rows, top, bot)
            halos += [ext[..., :top, :].contiguous(),
                      ext[..., top + rows:, :].contiguous()]
        ins.append((body, tuple(halos)))
    if kind == "idwt":
        k = (lambda b, h, *prec: km.idwt2d_sharded_mxu_fused(
            *b, h, fb, *prec)) if mxu \
            else (lambda b, h: fd.idwt2d_sharded_fused(*b, h, fb))
        p = (lambda b, h: km.idwt2d_sharded_mxu_plain(*b, h, fb)) if mxu \
            else (lambda b, h: fd.idwt2d_sharded_plain(*b, h, fb))
        u = (lambda b: km.idwt2d_mxu_fused(*b, fb, (n, nc))) if mxu else (
            lambda b: fd.idwt2d_fused(*b, fb, (n, nc)))
    else:
        k = (lambda b, h, *prec: kms.iswt2d_sharded_mxu_fused(
            *b, h, fb, lev, *prec)) \
            if mxu else (lambda b, h: fd.iswt2d_sharded_fused(*b, h, fb,
                                                              lev))
        p = (lambda b, h: kms.iswt2d_sharded_mxu_plain(*b, h, fb, lev)) \
            if mxu else (lambda b, h: fd.iswt2d_sharded_plain(*b, h, fb,
                                                              lev))
        u = (lambda b: kms.iswt2d_mxu_fused(*b, fb, lev)) if mxu else (
            lambda b: fd.iswt2d_fused(*b, fb, lev))
    nx = itertools.cycle(ins).__next__
    calls = {"kernel": lambda: k(*nx()), "plain": lambda: p(*nx()),
             "unsharded": lambda: u(nx()[0])}
    if mxu:
        calls["bf16"] = lambda: k(*nx(), "bf16")
    kernel_out = k(*ins[0])
    if kind == "idwt":
        pad = fb.hlen
        h2 = fb.hlen // 2
        o = fb.hlen - 2 + (1 - h2 % 2) - 2 * (h2 // 2) + 2 * pad
        padded = [conv.periodic_pad_last(torch.stack(
            [shard_rows_of(pl, i, rows, pad, pad) for pl in c]), pad,
            pad)[None] for c in coeffs]
        w = torch.tensor(np.stack(f2d.rec), dtype=torch.float32,
                         device=dev)[:, None]
        return calls, library_time(
            lambda z: F.conv_transpose2d(z, w, stride=2)[0, 0,
                                                         o:o + n, o:o + nc],
            padded, kernel_out)
    cl, cr = conv.swt_pads(fb.hlen, lev, True)
    padded = [conv.periodic_pad_last(torch.stack(
        [shard_rows_of(pl, i, rows, cl, cr) for pl in c]), cl, cr)[None]
        for c in coeffs]
    w = 0.25 * torch.tensor(np.stack(f2d.rec), dtype=torch.float32,
                            device=dev).flip(-1, -2)[None]
    return calls, library_time(
        lambda z: F.conv2d(z, w, dilation=1 << (lev - 1))[0, 0], padded,
        kernel_out)


def library_time(call, inputs, kernel_out):
    """Device time (ms) of ``call`` over ``inputs`` (wall where it waits
    for the device), after checking its first output against the
    kernel's."""
    err = max_err(call(inputs[0]), kernel_out)
    if not err <= LIBRARY_TOL:
        raise AssertionError(f"library call vs kernel {err:.3e} > "
                             f"{LIBRARY_TOL}")
    nx = itertools.cycle(inputs).__next__
    ms = cuda_ms(lambda: call(nx()), 10, True, required=False)
    if ms is None:
        ms = cuda_ms(lambda: call(nx()), 10, False)
    return ms


def sharded_work(port):
    """(bytes, flops) of each K26-K28 entry's timed call on a 2048 x 8192
    shard: its input and halo rows read once, its output written once; the
    map's flops (K26/K27 at db2, K28 at sym8, as K1/K2, K8/K9)."""
    fd = port.ops.fused_dwt
    n, nc = SHARD_BLOCK
    n2 = n * nc
    out = {}
    for key, wname, kind in (
            ("K26a", "db2", "dwt"), ("K26b", "db2", "idwt"),
            ("K27a", "db2", "swt"), ("K27b", "db2", "iswt"),
            ("K28 dwt", "sym8", "dwt"), ("K28 idwt", "sym8", "idwt"),
            ("K28 swt", "sym8", "swt"), ("K28 iswt", "sym8", "iswt")):
        fb = port.get_filter_bank(wname)
        h = fb.hlen
        if kind == "dwt":
            t, b = fd.halo_heights(kind, fb, n)
            out[key] = (4 * (n + t + b) * nc + 4 * n2, 4 * h * n2)
        elif kind == "idwt":
            t, b = fd.halo_heights(kind, fb, n // 2)
            out[key] = (4 * 4 * (n // 2 + t + b) * (nc // 2) + 4 * n2,
                        4 * h * n2)
        elif kind == "swt":
            t, b = fd.halo_heights(kind, fb, n, 1)
            out[key] = (4 * (n + t + b) * nc + 16 * n2, 12 * h * n2)
        else:
            t, b = fd.halo_heights(kind, fb, n, 1)
            out[key] = (16 * (n + t + b) * nc + 4 * n2, 12 * h * n2)
    return out


# -- the grid and sequence layouts: K29a-K29h --------------------------------

GRID_BANKS = ("haar", "db2", "db4", "sym8", "sym20")  # hlen 2, 4, 8, 16, 40
# a 2 x 2 grid of each plane: 8192^2 (4096^2 shards), 256 x 512, and 64 x 96
# (32 x 48 shards; sym20's halos take several hops at depth)
GRID_PLANES = (BIG, (256, 512), (64, 96))
GRID_SHARD = (BIG[0] // 2, BIG[1] // 2)  # one block of BIG: 4096 x 4096
SEQ = 1 << 26               # one 256 MB float32 signal, over 4 shards
SEQ_BATCH = (8, 1 << 24)    # JAX's leading batch axis
SEQ_SMALL = 4096            # on 8 shards
K29 = tuple(f"K29{c}" for c in "abcdefgh")
_PASSES = ("ana_lanes", "syn_lanes", "ana_rows", "syn_rows")


def k29_entry(port, kind, axis, mxu, prec="highest"):
    """(key, wrapper, call, plain call) of one K29 entry: the pass ``kind``
    ("ana", "syn") along ``axis`` (-1 the lanes, -2 the rows), K29a-K29d or
    in mode "mxu" K29e-K29h."""
    name = f"{kind}_{'lanes' if axis == -1 else 'rows'}"
    key = K29[_PASSES.index(name) + (4 if mxu else 0)]
    mod = port.ops.mxu_dwt if mxu else port.ops.fused_dwt
    sfx = "_mxu" if mxu else ""
    fused = getattr(mod, f"{name}{sfx}_fused")
    plain = getattr(mod, f"{name}{sfx}_plain")
    extra = (prec,) if mxu else ()
    return (key, fused, lambda *a: fused(*a, *extra),
            lambda *a: plain(*a, *extra))


def k29_levels(port, dev, x, fb, levels, n_shards, mxu, prec="highest"):
    """``levels`` levels of x on virtual shards of ``dev`` (a 2 x 2 grid of
    a plane, or ``n_shards`` shards of a signal or rows along their
    samples), pass by pass: each shard's K29 kernel against its plain
    version on the same shard and the halos its ring exchanged, then the
    synthesis back on the kernels' coefficients.  Returns the worst error
    of each entry, the roundtrip error and the gathered level-1
    coefficients."""
    par, conv = port.parallel, port.conv
    sp, rm = par.spatial, par.ring
    grid = n_shards is None
    if grid:
        mesh = par.mesh.make_mesh2d(2, 2, [dev] * 4)
        rings = rm.GridRings.for_mesh(mesh)
        parts = rm.shard_grid(x, mesh)
        gather = lambda p: rm.gather_grid(p, 2)  # noqa: E731
    else:
        ring = rm.LocalRing([dev] * n_shards, n_shards)
        parts = rm.shard_last(x, vmesh(port, 1, n_shards, dev))
        gather = rm.gather_last
    f64 = x.dtype == torch.float64
    errs = {}

    def check(key, got, ref, limit, level, what):
        if prec == "bf16":
            if isinstance(got, torch.Tensor):
                got, ref = (got,), (ref,)
            e = max(rms_gate(g.cpu().numpy(), r.cpu().numpy(), what, level)
                    for g, r in zip(got, ref))
        else:
            e = max_err(got, ref)
            limit = F64_SHARD_TOL if f64 else limit
            if not e <= limit:
                raise AssertionError(f"{what}: kernel vs plain {e:.3e} > "
                                     f"{limit:.1e}")
        errs[key] = max(errs.get(key, 0.0), e)

    def ana(planes, axis, rg, lev):
        key, fused, call, plain = k29_entry(port, "ana", axis, mxu, prec)
        lp, rp = conv.analysis_pads(fb.hlen)
        out = []
        for p, (b, a) in zip(planes, sp._halos(planes, lp, rp, rg, axis)):
            got = launched_once(fused, lambda: call(p, b, a, fb))
            check(key, got, plain(p, b, a, fb), COEFF_TOL * 2 ** lev, lev,
                  f"{key} {fb.name} L{lev}")
            out.append(got)
        return [list(t) for t in zip(*out)]

    def syn(lo, hi, axis, rg, lev):
        key, fused, call, plain = k29_entry(port, "syn", axis, mxu, prec)
        L = lo[0].shape[axis]
        lp, rp = conv.synthesis_pads(fb.hlen, L, 2 * L)
        hl, hh = (sp._halos(q, lp, rp, rg, axis) for q in (lo, hi))
        out = []
        for a, d, ha, hd in zip(lo, hi, hl, hh):
            halos = (*ha, *hd)
            got = launched_once(fused, lambda: call(a, d, halos, fb))
            # its output is the approximation of level lev - 1
            check(key, got, plain(a, d, halos, fb),
                  max(ROUNDTRIP_TOL, COEFF_TOL * 2 ** (lev - 1)),
                  max(lev - 1, 1), f"{key} {fb.name} L{lev}")
            out.append(got)
        return out

    a, details, level1 = parts, [], None
    for lev in range(1, levels + 1):
        if grid:
            t1, t2 = ana(a, -1, rings.cols, lev)
            a, h = ana(t1, -2, rings.rows, lev)
            v, d = ana(t2, -2, rings.rows, lev)
            details.append((h, v, d))
        else:
            a, d = ana(a, -1, ring, lev)
            details.append((d,))
        if lev == 1:
            level1 = [gather(t) for t in (a, *details[0])]
    for lev in range(levels, 0, -1):
        if grid:
            h, v, d = details[lev - 1]
            t1 = syn(a, h, -2, rings.rows, lev)
            t2 = syn(v, d, -2, rings.rows, lev)
            a = syn(t1, t2, -1, rings.cols, lev)
        else:
            a = syn(a, details[lev - 1][0], -1, ring, lev)
    back = gather(a)
    ert = max_err(back, x)
    if prec == "bf16":
        rms_gate(back.cpu().numpy(), x.cpu().numpy(), "K29 roundtrip", levels)
    elif not ert <= (F64_SHARD_TOL if f64 else ROUNDTRIP_TOL):
        raise AssertionError(f"K29 roundtrip {ert:.3e}")
    return errs, ert, level1


def _mxu_covers(fb):
    return fb.hlen % 2 == 0 and fb.hlen >= 4


def phase_kernels_grid(port, dev):
    """K29a-K29d (float32, and float64 at db4) and K29e-K29h (both
    precisions) against their plain versions on virtual shards of cuda:0,
    on the halos the rings exchanged, level by level (L3 of a 2 x 2 grid:
    8192^2 at db2 and sym8, 256 x 512 and 64 x 96 at haar, db2, db4, sym8
    and sym20; L5 of the 2^26-sample signal on 4 shards at db2 and sym8 and
    of its (8, 2^24) batch at db2; L5 of a 4096-sample signal on 8 shards
    at every bank), on 0..255 data (each analysis pass within 3e-4 *
    2^level, each synthesis within that of the level it makes and at least
    7e-4, the roundtrip within 7e-4; float64 within 1e-10; "bf16" on
    rms_gate's rule); the tensor-core forms on the even banks of 4+ taps.
    Then the gathered level 1 against the float64 oracle on [0, 1) data (a
    64 x 96 grid, a 4096-sample signal on 8 shards)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 50)
    worst = dict.fromkeys(K29, 0.0)
    bf16 = dict.fromkeys(K29[4:], 0.0)
    cases = [(BIG, None, 3, ("db2", "sym8")),
             ((256, 512), None, 3, GRID_BANKS),
             ((64, 96), None, 3, GRID_BANKS),
             ((SEQ,), 4, 5, ("db2", "sym8")),
             (SEQ_BATCH, 4, 5, ("db2",)),
             ((SEQ_SMALL,), 8, 5, GRID_BANKS)]
    for shape, n, levels, banks in cases:
        for name in banks:
            fb = port.get_filter_bank(name)
            x = torch.rand(shape, generator=gen, device=dev) * 255
            line = []
            forms = [(False, "highest")]
            if _mxu_covers(fb) and (shape != BIG or name == "sym8"):
                forms += [(True, "highest"), (True, "bf16")]
            if shape == BIG and name == "sym8":
                forms = forms[1:]
            for mxu, prec in forms:
                errs, ert, _ = k29_levels(port, dev, x, fb, levels, n, mxu,
                                          prec)
                for k, e in errs.items():
                    table = bf16 if prec == "bf16" else worst
                    table[k] = max(table[k], e)
                line.append(f"{'/'.join(errs)}{' ' + prec if mxu else ''} "
                            f"{max(errs.values()):.2e} rt {ert:.2e}")
            del x
            torch.cuda.synchronize()
            print(f"kernel-vs-plain {'grid 2x2' if n is None else f'seq {n}'}"
                  f" {name:6s} {str(shape):17s} L{levels} " + "; ".join(line))
    fb = port.get_filter_bank("db4")
    for shape, n in (((256, 512), None), ((64, 96), None), ((SEQ_SMALL,), 8),
                     ((3, 1024), 4)):
        x = torch.rand(shape, generator=gen, device=dev,
                       dtype=torch.float64) * 255
        errs, ert, _ = k29_levels(port, dev, x, fb, 3, n, False)
        print(f"kernel-vs-plain float64 db4 {str(shape):17s} "
              f"{'/'.join(errs)} {max(errs.values()):.2e} rt {ert:.2e}")

    oracle = load_oracle()
    rng = np.random.default_rng(SEED + 51)
    for name in GRID_BANKS:
        fb = port.get_filter_bank(name)
        xg, xs = rng.random((64, 96)), rng.random(SEQ_SMALL)
        refs = ((xg, None, oracle.ref_analysis_2d(xg, fb.dec_lo, fb.dec_hi)),
                (xs, 8, (oracle.ref_analysis_1d(xs, fb.dec_lo),
                         oracle.ref_analysis_1d(xs, fb.dec_hi))))
        line = []
        for xn, n, ref in refs:
            x = torch.from_numpy(xn.astype(np.float32)).to(dev)
            for mxu in (False, True) if _mxu_covers(fb) else (False,):
                _, _, level1 = k29_levels(port, dev, x, fb, 1, n, mxu)
                e = max(float(np.abs(g.cpu().numpy() - r).max())
                        for g, r in zip(level1, ref))
                if e > ORACLE_TOL:
                    raise AssertionError(f"{name} K29 mxu={mxu} vs oracle "
                                         f"{e:.3e}")
                line.append(f"{'grid' if n is None else 'seq'}"
                            f"{' mxu' if mxu else ''} {e:.2e}")
        print(f"kernel-vs-oracle K29 {name:6s} level 1, gathered: "
              + "  ".join(line))
    for key, e in bf16.items():
        print(f"worst bf16 kernel-vs-plain {key}: {e:.3e}")
    return worst


def _k29_counts(mxu, lanes, rows):
    """The launches of a grid (3 passes per shard and level) or sequence
    DWT roundtrip: ``lanes`` lane and ``rows`` row passes each way (a
    sequence has no row passes)."""
    sfx = "_mxu_fused" if mxu else "_fused"
    want = {f"ana_lanes{sfx}": lanes, f"syn_lanes{sfx}": lanes}
    if rows:
        want.update({f"ana_rows{sfx}": rows, f"syn_rows{sfx}": rows})
    return want


def _k29_names():
    """Wrapper name -> K29 key."""
    return {f"{p}{sfx}": K29[i + (4 if sfx.startswith("_mxu") else 0)]
            for sfx in ("_fused", "_mxu_fused")
            for i, p in enumerate(_PASSES)}


def phase_main_paths_grid(port, dev):
    """The grid and sequence plans on virtual shards of cuda:0, counted
    from 0, against the unsharded plans on the card: ShardedWavelets of the
    8192^2 image on a 2 x 2 grid, db2 L3 forward -> soft_threshold(10) ->
    inverse (36 launches of K29a-K29d each way: 3 per shard and level), the
    SWT (torch ops: no TPU kernel), sym8 L3 in mode "mxu" in both
    precisions (36 + 36 of K29e-K29h); the 8190 x 8191 image (padded,
    cropped, roundtrip) and its denoise(10, spins=4) against the unsharded
    denoise of the same drawn shifts; the 2^26-sample signal on 4 shards,
    db2 L5 (20 + 20), db2 L3 SWT, sym8 L5 in mode "mxu" (20 + 20 of
    K29e/K29f), against the unsharded 1D plan; the (8, 2^24) batch through
    wavedec1_seqsharded (db2 L5) against wavedec1; norm1 and norm2sq one
    all-reduce each."""
    ops, par, dwt = port.ops, port.parallel, port.dwt
    SW = par.ShardedWavelets
    grid = par.mesh.make_mesh2d(2, 2, [dev] * 4)
    seq = vmesh(port, 1, N_SHARDS, dev)
    img = frame(BIG, SEED + 52)
    sig = frame((SEQ,), SEED + 53)
    names = _k29_names()
    launches = {}
    cases = (("db2", 0, "auto", "highest", img, grid, 3, (12, 24)),
             ("db2", 1, "auto", "highest", img, grid, 3, None),
             ("sym8", 0, "mxu", "highest", img, grid, 3, (12, 24)),
             ("sym8", 0, "mxu", "bf16", img, grid, 3, (12, 24)),
             ("db2", 0, "auto", "highest", sig, seq, 5, (20, 0)),
             ("db2", 1, "auto", "highest", sig, seq, 3, None),
             ("sym8", 0, "mxu", "highest", sig, seq, 5, (20, 0)))
    for wname, do_swt, mode, prec, x, mesh, levels, per in cases:
        layout = "grid 2x2" if x.ndim == 2 else f"seq {N_SHARDS}"
        what = (f"ShardedWavelets {layout} {wname} L{levels} "
                f"{'SWT' if do_swt else 'DWT'} {x.shape} mode {mode}"
                f"{' ' + prec if mode == 'mxu' else ''}")
        want = {} if per is None else _k29_counts(mode == "mxu", *per)
        dwt.set_kernels(mode)
        dwt.set_mxu_precision(prec)
        try:
            ref = port.Wavelets(x, wname, levels, do_swt=do_swt, device=dev)
            ref.forward()
            ref_coeffs = [np.ravel(c) if x.ndim == 1 else c
                          for c in ref.coeffs]
            ref.soft_threshold(10.0)
            ref.inverse()
            ref_image = np.reshape(ref.image, x.shape)
            del ref
            S = SW(x, wname, levels, do_swt=do_swt, mesh=mesh)
            ops.reset_counts()
            S.forward()
            coeffs = S.coeffs
            expect_launches(ops, {k: v for k, v in want.items()
                                  if k.startswith("ana")}, f"{what} forward")
            S.soft_threshold(10.0)
            S.inverse()
            out = S.image
            torch.cuda.synchronize()
            got = counts(ops)
            expect_launches(ops, want, what)
        finally:
            dwt.set_kernels("auto")
            dwt.set_mxu_precision("highest")
        if prec == "highest":
            ec = check_pyramid(coeffs, ref_coeffs, f"{what} forward")
            ei = check_image(out, ref_image, f"{what} denoised image")
        else:
            ec = max([rms_gate(coeffs[0], ref_coeffs[0], what, levels)] + [
                rms_gate(g, r, f"{what} level {lev}", lev)
                for lev in range(1, levels + 1)
                for g, r in zip(coeffs[lev], ref_coeffs[lev])])
            ei = rms_gate(out, ref_image, f"{what} image", levels)
        print(f"main path {what}: forward vs unsharded {ec:.3e}, denoised "
              f"image vs unsharded {ei:.3e}, launches {got}")
        if prec == "highest":
            for k, v in got.items():
                launches[names[k]] = launches.get(names[k], 0) + v
        del coeffs, out

    odd = frame(BIG_ODD, SEED + 54)
    S = SW(odd, "db2", 3, mesh=grid)
    S.forward()
    S.inverse()
    er = check_image(S.image, odd, f"{BIG_ODD} grid roundtrip")
    S = SW(odd, "db2", 3, mesh=grid, seed=SEED)
    ops.reset_counts()
    S.denoise(BETA, spins=4)
    out = S.image
    got = counts(ops)
    rng = np.random.default_rng(SEED)
    pad = np.pad(odd, [(0, p - n) for p, n in zip(S._padded, BIG_ODD)],
                 mode="wrap")
    acc = None
    for _ in range(4):
        sr, sc = int(rng.integers(0, BIG_ODD[0])), int(
            rng.integers(0, BIG_ODD[1]))
        W = port.Wavelets(np.roll(pad, (sr, sc), (0, 1)), "db2", 3,
                          device=dev)
        W.forward()
        W.soft_threshold(BETA)
        W.inverse()
        y = np.roll(W.image, (-sr, -sc), (0, 1))
        acc = y if acc is None else acc + y
    ed = check_image(out, (acc / 4)[:BIG_ODD[0], :BIG_ODD[1]],
                     f"{BIG_ODD} grid denoise spins=4")
    if got != _k29_counts(False, 48, 96):
        raise AssertionError(f"grid denoise spins=4: launches {got}")
    print(f"main path ShardedWavelets grid 2x2 db2 L3 {BIG_ODD} (padded to "
          f"{S._padded}): roundtrip {er:.3e}; denoise({BETA}, spins=4) vs "
          f"unsharded denoise of the same shifts {ed:.3e}, launches {got}")
    del S, W, acc, out

    fb = port.get_filter_bank("db2")
    rows = torch.from_numpy(frame(SEQ_BATCH, SEED + 55)).to(dev)
    ops.reset_counts()
    pyr = par.spatial.wavedec1_seqsharded(rows, fb, 5, seq)
    back = par.ring.gather_last(par.spatial.waverec1_seqsharded(pyr, fb,
                                                                seq))
    torch.cuda.synchronize()
    got = counts(ops)
    expect_launches(ops, _k29_counts(False, 20, 0),
                    f"{SEQ_BATCH} sequence")
    ref = port.dwt.pyramid_to_numpy(port.dwt.wavedec1(rows, fb, 5))
    ec = check_pyramid([par.ring.gather_last(c).cpu().numpy() for c in pyr],
                       ref, f"{SEQ_BATCH} sequence")
    er = check_image(back.cpu().numpy(), rows.cpu().numpy(),
                     f"{SEQ_BATCH} sequence roundtrip")
    print(f"main path wavedec1_seqsharded {SEQ_BATCH} db2 L5 over {N_SHARDS}"
          f" shards: forward vs wavedec1 {ec:.3e}, roundtrip {er:.3e}, "
          f"launches {got}")
    del rows, pyr, back

    for x, mesh in ((img, grid), (sig, seq)):
        S = SW(x, "db2", 3, mesh=mesh)
        S.forward()
        ref = port.Wavelets(x, "db2", 3, device=dev)
        ref.forward()
        for norm in ("norm1", "norm2sq"):
            S.ring.reset()
            got = getattr(S, norm)()
            if (S.ring.counts["all_reduce"], S.ring.counts["ppermute"]) != (
                    1, 0):
                raise AssertionError(f"{norm}: {S.ring.counts}")
            want = getattr(ref, norm)()
            if abs(got - want) > 1e-4 * want:
                raise AssertionError(f"{norm} {got} vs {want}")
        print(f"main path ShardedWavelets {S.shape} "
              f"norm1/norm2sq: one all-reduce each, within 1e-4 of the "
              "unsharded norms")
        del S, ref
    return launches


def phase_audit_grid(port, dev):
    """The counted exchange schedules of the 8192^2 grid DWT and SWT (db2
    L3, 2 x 2) and of the 2^26-sample sequence DWT (db2 L5) and SWT (L3, 4
    shards) against audit.predict_gridsharded(_swt) and
    predict_seqsharded(_swt): equal ppermute counts each way, no
    all-gather, all-reduce or all-to-all."""
    par = port.parallel
    audit = par.audit
    fb = port.get_filter_bank("db2")
    grid = par.mesh.make_mesh2d(2, 2, [dev] * 4)
    img = torch.from_numpy(frame(BIG, SEED + 56)).to(dev)
    sig = torch.from_numpy(frame((SEQ,), SEED + 57)).to(dev)
    cases = (("grid DWT", audit.gridsharded_fns(fb, 3, grid), img,
              audit.predict_gridsharded(fb, 3, *BIG, 2, 2)),
             ("grid SWT", audit.gridsharded_fns(fb, 3, grid, True), img,
              audit.predict_gridsharded_swt(fb, 3, *BIG, 2, 2)),
             ("sequence DWT", audit.seqsharded_fns(
                 fb, 5, vmesh(port, 1, N_SHARDS, dev)), sig,
              audit.predict_seqsharded(fb, 5, SEQ, N_SHARDS)),
             ("sequence SWT", audit.seqsharded_swt_fns(
                 fb, 3, vmesh(port, 1, N_SHARDS, dev)), sig,
              audit.predict_seqsharded_swt(fb, 3, SEQ, N_SHARDS)))
    for what, (fwd, inv), x, pred in cases:
        fwd.ring.reset()
        pyr = fwd(x)
        f = audit.schedule_of(fwd.ring)
        fwd.ring.reset()
        inv(pyr)
        i = audit.schedule_of(fwd.ring)
        torch.cuda.synchronize()
        for sched, key in ((f, "fwd_ppermute"), (i, "inv_ppermute")):
            if sched["ppermute"] != pred[key] or any(
                    sched[k] for k in ("all_gather", "all_reduce",
                                       "all_to_all")):
                raise AssertionError(f"{what}: schedule {sched} vs {pred}")
        print(f"audit {what} db2 {tuple(x.shape)}: ppermute forward "
              f"{f['ppermute']} / inverse {i['ppermute']} (predicted "
              f"{pred['fwd_ppermute']} / {pred['inv_ppermute']}), "
              f"all-gather 0, all-reduce 0, all-to-all 0; halo bytes per "
              f"shard forward {4 * sum(f['ppermute_elems'])}")
        del pyr


def _window(g, r0, nr, c0, nc, top=0, bot=0, left=0, right=0):
    """Rows [r0 - top, r0 + nr + bot) and columns [c0 - left, c0 + nc +
    right) of the plane g, wrapped."""
    rows = torch.arange(r0 - top, r0 + nr + bot, device=g.device)
    cols = torch.arange(c0 - left, c0 + nc + right, device=g.device)
    return (g.index_select(-2, rows % g.shape[-2])
            .index_select(-1, cols % g.shape[-1]).contiguous())


def _split(ext, before, n, axis):
    """(body, before, after) of a halo-extended window along ``axis``."""
    return (ext.narrow(axis, before, n).contiguous(),
            ext.narrow(axis, 0, before).contiguous(),
            ext.narrow(axis, before + n, ext.shape[axis] - before - n)
            .contiguous())


def _syn_offset(hlen):
    """y[n] = z[n + T + 2P] for the transposed convolution z of
    coefficients padded by P (chip_smoke's K2/K4 library calls)."""
    h2 = hlen // 2
    return hlen - 2 + (1 - h2 % 2) - 2 * (h2 // 2)


def grid_calls(port, fb, mxu, key, globs, dev, bf16=False):
    """(timed calls, library ms) of one K29 entry at level 0 of
    block (1, 1) of each global 8192^2 plane on a 2 x 2 grid: the lanes
    pass on the 4096^2 block, the rows pass on its column pass's output t1
    (4096 x 2048), the syntheses on the coefficients of each; the library
    call (one convolution on the window padded outside the timed call) is
    checked against the kernel and timed here.  ``bf16``: a tensor-core
    entry's "bf16" call too."""
    conv, fd = port.conv, port.ops.fused_dwt
    n = GRID_SHARD[0]
    h = fb.hlen
    kind = "ana" if key in ("K29a", "K29c", "K29e", "K29g") else "syn"
    axis = -1 if key in ("K29a", "K29b", "K29e", "K29f") else -2
    _, _, call, plain = k29_entry(port, kind, axis, mxu)
    wd = torch.tensor(np.stack([fb.dec_lo, fb.dec_hi]), dtype=torch.float32,
                      device=dev).flip(-1)
    wr = torch.tensor(np.stack([fb.rec_lo, fb.rec_hi]), dtype=torch.float32,
                      device=dev)
    lp, rp = conv.analysis_pads(h)
    o = _syn_offset(h) + 2 * h
    if axis == -1:
        planes = globs
        if kind == "ana":
            ins = [_split(_window(g, n, n, n, n, 0, 0, lp, rp), lp, n, -1)
                   for g in planes]
            lib_in = [_window(g, n, n, n, n, 0, 0, lp, rp)[:, None]
                      for g in planes]
            lib = (lambda z: F.conv1d(z, wd[:, None], stride=2)
                   .transpose(0, 1))
            crop = None
        else:
            coeffs = [fd.dwt1d_fused(g, fb) for g in planes]
            m = n // 2
            lpi, rpi = conv.synthesis_pads(h, m, n)
            ins = []
            for c in coeffs:
                pa, pd = (_split(_window(p, n, n, m, m, 0, 0, lpi, rpi), lpi,
                                 m, -1) for p in c)
                ins.append((pa[0], pd[0], (*pa[1:], *pd[1:])))
            lib_in = [torch.stack([_window(p, n, n, m, m, 0, 0, h, h)
                                   for p in c], 1) for c in coeffs]
            lib = lambda z: F.conv_transpose1d(z, wr[:, None], stride=2)  # noqa: E731,E501
            crop = lambda z: z[:, 0, o:o + n]  # noqa: E731
    else:
        t = [fd.dwt1d_fused(g, fb)[0] for g in globs]  # (8192, 4096) each
        m = n // 2
        if kind == "ana":
            ins = [_split(_window(p, n, n, m, m, lp, rp), lp, n, -2)
                   for p in t]
            lib_in = [_window(p, n, n, m, m, lp, rp)[None, None] for p in t]
            lib = (lambda z: F.conv2d(z, wd[:, None, :, None],
                                      stride=(2, 1))[0])
            crop = None
        else:
            coeffs = [fd.dwt1d_fused(p.T.contiguous(), fb) for p in t]
            coeffs = [tuple(c.T.contiguous() for c in pair)
                      for pair in coeffs]  # (4096, 4096) each, rows halved
            lpi, rpi = conv.synthesis_pads(h, m, n)
            ins = []
            for c in coeffs:
                pa, pd = (_split(_window(p, m, m, m, m, lpi, rpi), lpi, m,
                                 -2) for p in c)
                ins.append((pa[0], pd[0], (*pa[1:], *pd[1:])))
            lib_in = [torch.stack([_window(p, m, m, m, m, h, h)
                                   for p in c])[None] for c in coeffs]
            lib = (lambda z: F.conv_transpose2d(z, wr[:, None, :, None],
                                                stride=(2, 1)))
            crop = lambda z: z[0, 0, o:o + n]  # noqa: E731
    nx = itertools.cycle(ins).__next__
    calls = {"kernel": lambda: call(*nx(), fb),
             "plain": lambda: plain(*nx(), fb)}
    if bf16:
        _, _, call16, _ = k29_entry(port, kind, axis, mxu, "bf16")
        calls["bf16"] = lambda: call16(*nx(), fb)
    out = call(*ins[0], fb)
    kernel_out = torch.stack(out) if isinstance(out, tuple) else out
    libcall = lib if crop is None else (lambda z: crop(lib(z)))
    return calls, library_time(libcall, lib_in, kernel_out)


def time_seq_shard_mxu(port, dev, card, keys, gen):
    """K29e and K29f at sym8 on one sequence shard (2^24 samples, and its
    2^23 coefficient pairs) of a 2^26-sample signal over 4 shards, both
    precisions, against K7a/K7b on the same shard without halos, in
    turns."""
    conv, km, fd = port.conv, port.ops.mxu_dwt, port.ops.fused_dwt
    fb = port.get_filter_bank("sym8")
    h = fb.hlen
    n = SEQ // N_SHARDS
    m = n // 2
    sig = torch.rand(SEQ, generator=gen, device=dev) * 255
    lp, rp = conv.analysis_pads(h)
    ana = [_split(_window(sig[None], 0, 1, c0, n, 0, 0, lp, rp), lp, n, -1)
           for c0 in (0, n)]
    co = fd.dwt1d_fused(sig[None], fb)
    lpi, rpi = conv.synthesis_pads(h, m, n)
    syn = []
    for c0 in (0, m):
        pa, pd = (_split(_window(p, 0, 1, c0, m, 0, 0, lpi, rpi), lpi, m, -1)
                  for p in co)
        syn.append((pa[0], pd[0], (*pa[1:], *pd[1:])))
    del sig, co
    na, ns = itertools.cycle(ana).__next__, itertools.cycle(syn).__next__
    calls = {}
    if wanted(keys, "K29e"):
        calls.update({
            "K29e": lambda: km.ana_lanes_mxu_fused(*na(), fb),
            "K29e bf16": lambda: km.ana_lanes_mxu_fused(*na(), fb, "bf16"),
            "K7a on the shard": lambda: km.dwt1d_mxu_fused(na()[0], fb)})
    if wanted(keys, "K29f"):
        calls.update({
            "K29f": lambda: km.syn_lanes_mxu_fused(*ns(), fb),
            "K29f bf16": lambda: km.syn_lanes_mxu_fused(*ns(), fb, "bf16"),
            "K7b on the shard": lambda: km.idwt1d_mxu_fused(
                *ns()[:2], fb, n)})
    t = in_turns(calls, dict.fromkeys(calls, 10))
    print(f"time sym8 on a {n}-sample sequence shard, device us: "
          + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in t.items())
          + f"  [{card}]")


def grid_work(port):
    """(bytes, flops) of each K29 entry's timed call at level 0 of one
    4096^2 grid block: its input and halos read once, its output written
    once; two flops per FMA (K29a-K29d at db2, K29e-K29h at sym8)."""
    conv = port.conv
    n = GRID_SHARD[0]
    m = n // 2
    out = {}
    for keys, wname in (("abcd", "db2"), ("efgh", "sym8")):
        fb = port.get_filter_bank(wname)
        h = fb.hlen
        lp, rp = conv.analysis_pads(h)
        lpi, rpi = conv.synthesis_pads(h, m, n)
        ka, kb, kc, kd = (f"K29{c}" for c in keys)
        out[ka] = (4 * n * (n + lp + rp) + 4 * n * n, 2 * h * n * n)
        out[kb] = (4 * 2 * n * (m + lpi + rpi) + 4 * n * n, 2 * h * n * n)
        out[kc] = (4 * (n + lp + rp) * m + 4 * n * m, 2 * h * n * m)
        out[kd] = (4 * 2 * (m + lpi + rpi) * m + 4 * n * m, 2 * h * n * m)
    return out


def phase_times_grid(port, dev, card, keys=None):
    """Device time of each K29 entry at level 0 of one 4096^2 block of the
    8192^2 grid (K29a-K29d at db2, K29e-K29h at sym8 "highest"; the lanes
    pass on the block, the rows pass on its column pass's 4096 x 2048
    output), against its plain version in turns, beside one PyTorch
    convolution of the same map (library_ms: conv1d / conv_transpose1d
    along the lanes, conv2d / conv_transpose2d with an (hlen, 1) kernel
    along the rows); K29a on one 2^24-sample sequence shard; then the 8192^2
    db2 L3 roundtrip three ways, device and wall: the 2 x 2 grid, 4 row
    shards, the unsharded plan; and the sym8 L3 roundtrip on the grid in
    mode "mxu" ("highest": 36 + 36 launches of K29e-K29h).  ``keys``
    (--only): those rows alone, the tensor-core ones in both precisions
    and K29e/K29f also on a sequence shard, and no roundtrip."""
    par = port.parallel
    gen = torch.Generator(device=dev).manual_seed(SEED + 58)
    globs = [torch.rand(BIG, generator=gen, device=dev) * 255
             for _ in range(2)]
    times, library = {}, {}
    torch.backends.cudnn.benchmark = True
    try:
        for i, key in enumerate(K29):
            if not wanted(keys, key):
                continue
            mxu = i >= 4
            fb = port.get_filter_bank("sym8" if mxu else "db2")
            calls, lib = grid_calls(port, fb, mxu, key, globs, dev,
                                    bf16=mxu and keys is not None)
            t = in_turns(calls, dict(kernel=10, plain=3, bf16=10))
            times[key] = (t["kernel"], t["plain"])
            library[key] = lib
            bf16 = (f", bf16 {t['bf16'] * 1e3:.1f} us" if "bf16" in t
                    else "")
            print(f"time {key} {fb.name} level 0 of a {GRID_SHARD} grid "
                  f"block, device: kernel {t['kernel'] * 1e3:.1f} us{bf16}, "
                  f"plain {t['plain'] * 1e3:.1f} us, library "
                  f"{lib * 1e3:.1f} us  [{card}]")
    finally:
        torch.backends.cudnn.benchmark = False
    if keys is not None:
        del globs
        if wanted(keys, "K29e", "K29f"):
            time_seq_shard_mxu(port, dev, card, keys, gen)
        return times, library
    fb = port.get_filter_bank("db2")
    conv, fd = port.conv, port.ops.fused_dwt
    n = SEQ // N_SHARDS
    sig = torch.rand(SEQ, generator=gen, device=dev) * 255
    lp, rp = conv.analysis_pads(fb.hlen)
    ins = [_split(_window(sig[None], 0, 1, c0, n, 0, 0, lp, rp)[0], lp, n,
                  -1) for c0 in (0, n)]
    nx = itertools.cycle(ins).__next__
    t = in_turns({"kernel": lambda: fd.ana_lanes_fused(*nx(), fb),
                  "K3 on the shard": lambda: fd.dwt1d_fused(nx()[0], fb)},
                 {"kernel": 10, "K3 on the shard": 10})
    print(f"time K29a db2 on a {n}-sample sequence shard, device: kernel "
          f"{t['kernel'] * 1e3:.1f} us, K3 on the same shard "
          f"{t['K3 on the shard'] * 1e3:.1f} us  [{card}]")
    del sig, ins
    sp, rm = par.spatial, par.ring
    grid = par.mesh.make_mesh2d(2, 2, [dev] * 4)
    rings = rm.GridRings.for_mesh(grid)
    rmesh = vmesh(port, 1, N_SHARDS, dev)
    ring = rm.LocalRing.for_mesh(rmesh, batched=False)
    gparts = [rm.shard_grid(g, grid) for g in globs]
    rparts = [rm.shard_rows(g, rmesh) for g in globs]
    ng = itertools.cycle(gparts).__next__
    nr = itertools.cycle(rparts).__next__
    nglob = itertools.cycle(globs).__next__
    fb8 = port.get_filter_bank("sym8")

    def grid_sym8_mxu():
        port.dwt.set_kernels("mxu")
        try:
            return sp._local_waverec2_grid(
                sp._local_wavedec2_grid(ng(), fb8, 3, rings), fb8, rings)
        finally:
            port.dwt.set_kernels("auto")

    ways = {
        "grid 2x2": lambda: sp._local_waverec2_grid(
            sp._local_wavedec2_grid(ng(), fb, 3, rings), fb, rings),
        "4 row shards": lambda: sp._local_waverec2(
            sp._local_wavedec2(nr(), fb, 3, ring), fb, ring),
        "unsharded": lambda: port.dwt.waverec2(
            port.dwt.wavedec2(nglob(), fb, 3), fb, BIG),
        "grid 2x2 sym8 mxu": grid_sym8_mxu}
    rt = {clock: in_turns(ways, dict.fromkeys(ways, 1), device_only=d)
          for clock, d in (("device", True), ("wall", False))}
    for way in ways:
        what = (f'L3 sym8 "mxu" roundtrip {BIG} grid 2x2'
                if way == "grid 2x2 sym8 mxu"
                else f"L3 db2 roundtrip {BIG} {way}")
        print(f"time {what}: device {rt['device'][way]:.4f} ms, wall "
              f"{rt['wall'][way]:.4f} ms  [{card}]")
    d, w = rt["device"], rt["wall"]
    print(f"grid against unsharded, 8192^2 db2 L3 roundtrip on one card: "
          f"device {d['grid 2x2'] / d['unsharded']:.3f}x, wall "
          f"{w['grid 2x2'] / w['unsharded']:.3f}x; against the row layout: "
          f"device {d['grid 2x2'] / d['4 row shards']:.3f}x  [{card}]")
    return times, library


# The row passes whose outputs --only K29g / K29h / K29d digest, so that
# two builds of tc_dwt2d.cu or axis_rows.cu compare bit for bit: banks that
# reach instances of both tensor-core kernels in both precisions (hlen 4,
# 10, 16 and 40; K29d: h2 2, 5, 8 and 20, float32 and float64), input
# shards of 64 and of 8 rows (K29h, K29d: 32 and 4 coefficient rows;
# sym20's halos then take several hops), rows of 2048, 33 and 4094 samples
# (nc % 4 of 0, 1 and 2), inputs or outputs one sample past a 16-byte
# boundary, and the timed shapes (level 0 of one 4096^2 grid block, sym8).
ROWS_DIGEST_BANKS = ("db2", "db5", "sym8", "sym20")
ROWS_DIGEST_SHARDS = ((2, 64), (4, 8))  # (shards, input rows of a shard)
ROWS_DIGEST_NC = (2048, 33, 4094)
ROWS_DIGEST_OFFSETS = ((0, 0), (1, 0), (0, 1))  # floats past: in, out


def print_rows_occupancy(port, dev, keys):
    """Resident blocks per SM (the occupancy API), dynamic shared memory and
    tile shape of the K29g / K29h instances of ROWS_DIGEST_BANKS in both
    precisions, and of K29d's in both types (a build without the query
    says so)."""
    from pypwt_tpu_torch.ops import _build
    lib = _build.load_library()
    entry = "pypwt_tc_rows_occupancy"
    for syn, key in ((0, "K29g"), (1, "K29h")):
        if not wanted(keys, key):
            continue
        if not hasattr(lib, entry):
            print(f"occupancy {key}: not reported by this build")
            continue
        for wname in ROWS_DIGEST_BANKS:
            for prec in PRECISIONS:
                out = [ctypes.c_int() for _ in range(4)]
                err = getattr(lib, entry)(
                    syn, port.get_filter_bank(wname).hlen,
                    int(prec == "bf16"), dev.index,
                    *(ctypes.byref(o) for o in out))
                if err:
                    raise RuntimeError(f"occupancy query {key} {wname} "
                                       f"{prec}: error {err}")
                blocks, smem, tr, tc = (o.value for o in out)
                unit = "coefficients" if syn else "outputs"
                print(f"occupancy {key} {wname} {prec}: {blocks} blocks of "
                      f"256 threads per SM, {smem} bytes of dynamic shared "
                      f"memory each, tiles of {tr} x {tc} {unit}")
    entry = "pypwt_syn_rows_occupancy"
    if not wanted(keys, "K29d"):
        return
    if not hasattr(lib, entry):
        print("occupancy K29d: not reported by this build")
        return
    for wname in ROWS_DIGEST_BANKS:
        for f64 in (0, 1):
            out = [ctypes.c_int() for _ in range(4)]
            err = getattr(lib, entry)(
                port.get_filter_bank(wname).hlen, f64, dev.index,
                *(ctypes.byref(o) for o in out))
            if err:
                raise RuntimeError(f"occupancy query K29d {wname}: error "
                                   f"{err}")
            blocks, smem, tr, tc = (o.value for o in out)
            print(f"occupancy K29d {wname} {'float64' if f64 else 'float32'}"
                  f": {blocks} blocks of 256 threads per SM, {smem} bytes of "
                  f"dynamic shared memory each, tiles of {tr} x {tc} "
                  "coefficients")


def print_rows_digests(port, dev, keys):
    """SHA-256 of K29g's and K29h's outputs on seeded inputs
    (ROWS_DIGEST_*), both precisions, and of K29d's in float32 and float64,
    each C entry called on the shard, its halo rows and outputs made here:
    equal lines from two trees mean bit-identical kernels."""
    fd = port.ops.fused_dwt
    from pypwt_tpu_torch.ops import _build
    lib = _build.load_library()
    gen = torch.Generator(device=dev).manual_seed(SEED + 64)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def rand(shape):
        return torch.rand(shape, generator=gen, device=dev)

    def empty(shape, off):
        n = shape[0] * shape[1]
        return torch.empty(n + off, device=dev)[off:].view(shape)

    def split(g, shards, rows, top, bot, off):
        ext = shard_rows_of(g, 1, rows, top, bot)
        return [unaligned(t.contiguous(), off) for t in
                (ext[top:top + rows], ext[:top], ext[top + rows:])]

    cases = [(w, prec, shards, rows, nc, oi, oo)
             for w in ROWS_DIGEST_BANKS for prec in PRECISIONS
             for shards, rows in ROWS_DIGEST_SHARDS
             for nc in ROWS_DIGEST_NC for oi, oo in ROWS_DIGEST_OFFSETS]
    cases += [("sym8", prec, 2, GRID_SHARD[0], GRID_SHARD[1] // 2, 0, 0)
              for prec in PRECISIONS]
    n = 0
    for wname, prec, shards, rows, nc, oi, oo in cases:
        fb = port.get_filter_bank(wname)
        bf16 = int(prec == "bf16")
        what = (f"{wname} {prec} shard 1 of {shards} x ({rows}, {nc}) "
                f"+{oi}/+{oo}")
        if wanted(keys, "K29g"):
            top, bot = fd.one_axis_pads("ana", fb, 0)
            x, up, down = split(rand((shards * rows, nc)), shards, rows, top,
                                bot, oi)
            out = [empty((rows // 2, nc), oo) for _ in range(2)]
            taps = [fd._host_taps(f) for f in (fb.dec_lo, fb.dec_hi)]
            err = lib.pypwt_tc_ana_rows(
                x.data_ptr(), up.data_ptr(), down.data_ptr(),
                *(o.data_ptr() for o in out), rows, nc, top, bot,
                *(t.ctypes.data for t in taps), fb.hlen, bf16, dev.index,
                stream)
            if err:
                raise RuntimeError(f"K29g {what}: error {err}")
            print(f"digest K29g {what}: {digest(torch.stack(out))}")
            n += 1
            del x, up, down, out
        if wanted(keys, "K29h"):
            L = rows // 2
            top, bot = fd.one_axis_pads("syn", fb, L)
            (a, at, ab), (d, dt, db) = (
                split(rand((shards * L, nc)), shards, L, top, bot, oi)
                for _ in range(2))
            halos = (at, ab, dt, db)
            ptrs = fd.halo_array(halos)
            out = empty((2 * L, nc), oo)
            taps = [fd._host_taps(f) for f in (fb.rec_lo, fb.rec_hi)]
            err = lib.pypwt_tc_syn_rows(
                a.data_ptr(), d.data_ptr(), ctypes.addressof(ptrs),
                out.data_ptr(), L, nc, top, bot,
                *(t.ctypes.data for t in taps), fb.hlen, bf16, dev.index,
                stream)
            if err:
                raise RuntimeError(f"K29h {what}: error {err}")
            print(f"digest K29h {what}: {digest(out)}")
            n += 1
            del a, d, halos, out
    gen_d = torch.Generator(device=dev).manual_seed(SEED + 65)
    for wname, prec, shards, rows, nc, oi, oo in cases:
        if prec != PRECISIONS[0] or not wanted(keys, "K29d"):
            continue
        fb = port.get_filter_bank(wname)
        L = rows // 2
        top, bot = fd.one_axis_pads("syn", fb, L)
        for dtype in (torch.float32, torch.float64):
            (a, at, ab), (d, dt, db) = (
                split(torch.rand((shards * L, nc), generator=gen_d,
                                 device=dev).to(dtype), shards, L, top, bot,
                      oi) for _ in range(2))
            halos = (at, ab, dt, db)
            ptrs = fd.halo_array(halos)
            out = torch.empty(2 * L * nc + oo, device=dev,
                              dtype=dtype)[oo:].view(2 * L, nc)
            taps = [fd._taps(f, out) for f in (fb.rec_lo, fb.rec_hi)]
            what = (f"{wname} {str(dtype)[6:]} shard 1 of {shards} x ({L}, "
                    f"{nc}) +{oi}/+{oo}")
            err = fd._entry(lib, "pypwt_syn_rows", out)(
                a.data_ptr(), d.data_ptr(), ctypes.addressof(ptrs),
                out.data_ptr(), L, nc, top, bot,
                *(t.ctypes.data for t in taps), fb.hlen, dev.index, stream)
            if err:
                raise RuntimeError(f"K29d {what}: error {err}")
            print(f"digest K29d {what}: {digest(out)}")
            n += 1
            del a, d, halos, out
    print(f"digests of the row passes: {n}")


_PK, _NSP = "ops/pallas_dwt.py", "ops/nonsep_pallas.py"
# key, name, source under pypwt_tpu_torch/csrc/, the TPU kernel's call
KERNEL_ROWS = (
    ("K1", "dwt2d (K1)", "dwt2d.cu", f"{_PK}:287"),
    ("K2", "idwt2d (K2)", "idwt2d.cu", f"{_PK}:477"),
    ("K3", "dwt1d (K3)", "dwt1d.cu", f"{_PK}:2064"),
    ("K4", "idwt1d (K4)", "idwt1d.cu", f"{_PK}:2104"),
    ("K10a", "swt1d (K10a)", "swt1d.cu", f"{_PK}:2159"),
    ("K10b", "iswt1d (K10b)", "swt1d.cu", f"{_PK}:2213"),
    ("K8", "swt2d (K8)", "swt2d.cu", f"{_PK}:1912"),
    ("K9", "iswt2d (K9)", "swt2d.cu", f"{_PK}:2004"),
    ("K16", "nsdwt2d (K16)", "nonsep_dwt2d.cu", f"{_NSP}:147"),
    ("K17", "insdwt2d (K17)", "nonsep_dwt2d.cu", f"{_NSP}:238"),
    ("K18a", "ns_swt2d (K18a)", "nonsep_swt2d.cu", f"{_NSP}:344"),
    ("K18b", "ins_swt2d (K18b)", "nonsep_swt2d.cu", f"{_NSP}:344"),
    ("K19", "dwt2d_shifted (K19)", "dwt2d.cu", f"{_PK}:609"),
    ("K20", "idwt2d_unshift (K20)", "idwt2d.cu", f"{_PK}:721"),
    ("K5", "dwt2d_mxu (K5)", "tc_dwt2d.cu", "ops/mxu_dwt.py:251"),
    ("K6", "idwt2d_mxu (K6)", "tc_dwt2d.cu", "ops/mxu_dwt.py:347"),
    ("K11a", "swt2d_mxu (K11a)", "tc_swt2d.cu", "ops/mxu_swt.py:315"),
    ("K11b", "iswt2d_mxu (K11b)", "tc_swt2d.cu", "ops/mxu_swt.py:410"),
    ("K7a", "dwt1d_mxu (K7a)", "tc_dwt1d.cu", "ops/mxu_dwt.py:421"),
    ("K7b", "idwt1d_mxu (K7b)", "tc_dwt1d.cu", "ops/mxu_dwt.py:477"),
    ("K12a", "swt1d_mxu (K12a)", "tc_swt1d.cu", "ops/mxu_swt.py:494"),
    ("K12b", "iswt1d_mxu (K12b)", "tc_swt1d.cu", "ops/mxu_swt.py:560"),
    ("K24", "wavedec2_pyramid (K24)", "pyramid2d.cu",
     "ops/fused_pyramid.py:168"),
    ("K25", "waverec2_pyramid (K25)", "pyramid2d.cu",
     "ops/fused_pyramid.py:308"),
    ("K26a", "dwt2d_sharded (K26a)", "dwt2d.cu", f"{_PK}:1483"),
    ("K26b", "idwt2d_sharded (K26b)", "idwt2d.cu", f"{_PK}:1544"),
    ("K27a", "swt2d_sharded (K27a)", "swt2d.cu", f"{_PK}:1606"),
    ("K27b", "iswt2d_sharded (K27b)", "swt2d.cu", f"{_PK}:1669"),
    ("K28 dwt", "dwt2d_sharded_mxu (K28)", "tc_dwt2d.cu",
     "ops/mxu_dwt.py:571"),
    ("K28 idwt", "idwt2d_sharded_mxu (K28)", "tc_dwt2d.cu",
     "ops/mxu_dwt.py:651"),
    ("K28 swt", "swt2d_sharded_mxu (K28)", "tc_swt2d.cu",
     "ops/mxu_swt.py:656"),
    ("K28 iswt", "iswt2d_sharded_mxu (K28)", "tc_swt2d.cu",
     "ops/mxu_swt.py:737"),
    ("K29a", "ana_lanes (K29a)", "dwt1d.cu", f"{_PK}:1719"),
    ("K29b", "syn_lanes (K29b)", "idwt1d.cu", f"{_PK}:1751"),
    ("K29c", "ana_rows (K29c)", "axis_rows.cu", f"{_PK}:1785"),
    ("K29d", "syn_rows (K29d)", "axis_rows.cu", f"{_PK}:1821"),
    ("K29e", "ana_lanes_mxu (K29e)", "tc_dwt1d.cu", "ops/mxu_dwt.py:713"),
    ("K29f", "syn_lanes_mxu (K29f)", "tc_dwt1d.cu", "ops/mxu_dwt.py:821"),
    ("K29g", "ana_rows_mxu (K29g)", "tc_dwt2d.cu", "ops/mxu_dwt.py:763"),
    ("K29h", "syn_rows_mxu (K29h)", "tc_dwt2d.cu", "ops/mxu_dwt.py:873"),
)


def timed_work(port):
    """(bytes, flops) of each kernel's timed call: every input read once,
    every output written once, two flops per FMA of its map.  2D at
    2048^2 (db2; K16-K18 the db3 x coif1 bank; K5/K6 and K11a/K11b sym8,
    whose bound is that of K1/K2 and K8/K9 at sym8: the same bytes, the
    map's flops over the float32 rate), 1D on 2048 rows of 2048 (K7a/K7b
    and K12a/K12b at sym8, as K3/K4 and K10); K20 with its
    accumulator."""
    n2 = FRAME[0] * FRAME[1]
    h = port.get_filter_bank("db2").hlen
    hx = banks_2d(port)[0].hlen
    hw = port.get_filter_bank("sym8").hlen
    return {
        "K5": (8 * n2, 4 * hw * n2), "K6": (8 * n2, 4 * hw * n2),
        "K11a": (20 * n2, 12 * hw * n2), "K11b": (20 * n2, 12 * hw * n2),
        "K1": (8 * n2, 4 * h * n2), "K2": (8 * n2, 4 * h * n2),
        "K3": (8 * n2, 2 * h * n2), "K4": (8 * n2, 2 * h * n2),
        "K10a": (12 * n2, 4 * h * n2), "K10b": (12 * n2, 4 * h * n2),
        "K8": (20 * n2, 12 * h * n2), "K9": (20 * n2, 12 * h * n2),
        "K16": (8 * n2, 2 * hx * hx * n2), "K17": (8 * n2, 2 * hx * hx * n2),
        "K18a": (20 * n2, 8 * hx * hx * n2),
        "K18b": (20 * n2, 8 * hx * hx * n2),
        "K19": (8 * n2, 4 * h * n2), "K20": (12 * n2, 4 * h * n2),
        "K7a": (8 * n2, 2 * hw * n2), "K7b": (8 * n2, 2 * hw * n2),
        "K12a": (12 * n2, 4 * hw * n2), "K12b": (12 * n2, 4 * hw * n2),
        "K24": (pyr_bytes(n2, 3), 4 * h * n2 * sum(4 ** -l for l in range(3))),
        "K25": (pyr_bytes(n2, 3), 4 * h * n2 * sum(4 ** -l for l in range(3))),
    }


def pyr_bytes(n, levels):
    """Bytes of a whole-pyramid kernel over ``levels`` levels of an image of
    n float32 samples: the image once, the details of every level and the
    deepest approximation once, 4 n (2 - 4^-L)."""
    return 4 * n * (2 - 4.0 ** -levels)


def path_bounds():
    """Bound (ms) of the paths that hold the covered TPU kernels: the bytes
    their level kernels must move (each input read once, each output
    written once; the thresholds' passes not counted) over 3.35 TB/s, from
    the shapes of phase 4.  K13: the 4 Mi-sample DWT L5 roundtrip (8 bytes
    per input sample per level, each way); K14: its SWT L3 roundtrip (12
    per sample per level, each way); K21: the 8-spin random cycle spinning
    and K23 the 4-spin static one at 2048^2, db2 L3 (per spin 8 bytes per
    input pixel of each analysis level, 8 per output pixel of each synthesis
    level, 12 at level 0 where K20 adds the accumulator); K22: one K19
    level at 2048^2; K15: the 4 Mi-sample DWT L5 and SWT L3 roundtrips in
    mode "mxu" (K7/K12 on a (1, n) row: the bytes of K13 and K14)."""
    n, n2 = SIGNAL, FRAME[0] * FRAME[1]
    levels = [n2 / 4 ** lev for lev in range(3)]
    spin = 8 * sum(levels) + 8 * sum(levels[1:]) + 12 * n2
    paths = {
        "K13": 16 * sum(n / 2 ** lev for lev in range(5)),
        "K14": 24 * n * 3,
        "K21": RANDOM_SPINS * spin,
        "K22": 8 * n2,
        "K23": len(STATIC_SPINS) * spin,
        "K15": 16 * sum(n / 2 ** lev for lev in range(5)) + 24 * n * 3,
        # the two-level tail of tail fusion: K24 on the level-0
        # approximation of 2048^2 (and K1 at levels 2 and 3, for scale)
        "K24 tail": pyr_bytes(n2 / 4, 2),
        "K1 levels 2-3": 8 * (n2 / 4 + n2 / 16),
        "K1 levels 1-3": 8 * sum(levels),
    }
    return {k: b / PEAK_BYTES * 1e3 for k, b in paths.items()}


def bound(nbytes, flops):
    """The least time of a call, in ms: the larger of its bytes over the
    card's memory rate and its flops over its float32 rate."""
    t_bytes, t_flops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS
    return (max(t_bytes, t_flops) * 1e3,
            "bytes" if t_bytes >= t_flops else "operations")


MXU2D_KEYS = ("K5", "K6", "K11a", "K11b")
SHARD_KEYS = ("K26a", "K26b", "K27a", "K27b", "K28 dwt", "K28 idwt",
              "K28 swt", "K28 iswt")
MXU1D_KEYS = ("K7a", "K7b", "K12a", "K12b")
ONLY_KEYS = (("K1", "K2", "K9", "K10a", "K10b", "K18a", "K18b", "K19", "K20")
             + MXU2D_KEYS + MXU1D_KEYS + SHARD_KEYS + K29)


def in_family(key, item):
    """Whether row ``key`` is ``item`` or of its family: ``item`` and a
    space (K28 dwt) or ``item`` and one letter (K7a, K29e)."""
    rest = key[len(item):] if key.startswith(item) else None
    return rest is not None and (
        rest == "" or rest[0] == " " or (len(rest) == 1 and rest.isalpha()))


def only_keys(spec):
    """The rows that ``--only`` names: each comma-separated item is a row's
    key or a family (K7, K10, K12, K28, K29), or SystemExit."""
    keys = set()
    for item in (t.strip() for t in spec.split(",")):
        got = {k for k in ONLY_KEYS if in_family(k, item)}
        if not got:
            print(f"chip_smoke: --only {item!r} names no selectable row "
                  f"(one of {', '.join(ONLY_KEYS)}, or K7, K10, K12, K28, "
                  f"K29)",
                  file=sys.stderr)
            sys.exit(2)
        keys |= got
    return keys


def wanted(keys, *names):
    """Whether any of ``names`` is selected (every row when keys is None)."""
    return keys is None or any(n in keys for n in names)


def run_only(port, dev, card, keys):
    """The narrow run of ``--only``: the selected rows' checks, main paths
    and times, then their kernels line."""
    worst, launches, times, library = {}, {}, {}, {}
    if "K9" in keys:
        worst.update(phase_kernels_swt2d(port, dev, keys))
        launches.update(phase_main_paths_2d_swt(port, dev, keys))
        times.update(phase_times_2d_swt(port, dev, card, keys))
    if wanted(keys, "K9", "K27b"):
        print_iswt2d_occupancy(port, dev, keys)
        print_iswt2d_digests(port, dev, keys)
    if wanted(keys, *MXU2D_KEYS):
        worst.update(phase_kernels_mxu(port, dev, keys))
        launches.update(phase_main_paths_mxu(port, dev, keys))
        times.update(phase_times_mxu(port, dev, card, keys))
    for key in ("K11a", "K11b"):
        if key in keys:
            phase_times_swt_levels(port, dev, card, key)
    if "K5" in keys:
        phase_times_k5_levels(port, dev, card)
    if wanted(keys, "K5", "K28 dwt"):
        print_dwt2d_digests(port, dev, keys)
    if "K1" in keys or "K2" in keys:
        worst.update(phase_kernels(port, dev, keys))
        launches.update(phase_main_path(port, dev))
    for key in ("K1", "K2"):
        if key in keys:
            times.update(phase_times_tap_levels(port, dev, card, key))
    print_tap2d_occupancy(port, dev, keys)
    if wanted(keys, "K1", "K26a"):
        print_dwt2d_tap_digests(port, dev, keys)
    if wanted(keys, "K2", "K26b"):
        print_idwt2d_tap_digests(port, dev, keys)
    if "K6" in keys:
        phase_times_k6_levels(port, dev, card)
    if wanted(keys, "K6", "K28 idwt"):
        print_idwt2d_digests(port, dev, keys)
    if wanted(keys, *(row[0] for row in TC2D_OCCUPANCY)):
        print_tc2d_occupancy(port, dev, keys)
    if wanted(keys, *MXU1D_KEYS):
        worst.update(phase_kernels_mxu1d(port, dev, keys))
        launches.update(phase_main_paths_mxu1d(port, dev, keys))
        times.update(phase_times_mxu1d(port, dev, card, keys))
    if wanted(keys, "K19", "K20"):
        worst.update(phase_kernels_shifted(port, dev))
        launches.update(phase_main_paths_pipeline(port, dev))
        times.update(phase_times_slice(port, dev, card))
    if "K20" in keys:
        print_shifted_occupancy(port, dev, "K20")
        print_k20_digests(port, dev)
    if "K19" in keys:
        print_shifted_occupancy(port, dev, "K19")
        print_k19_digests(port, dev)
    if wanted(keys, "K18a", "K18b"):
        worst.update(phase_kernels_nonsep(port, dev, keys))
        if "K9" not in keys:  # else K9's main paths drove them
            launches.update(phase_main_paths_2d_swt(port, dev, keys))
        times.update(phase_times_nsswt_levels(port, dev, card, keys))
        print_k18_occupancy(port, dev, keys)
        print_k18_digests(port, dev, keys)
    if wanted(keys, "K10a", "K10b"):
        worst.update(phase_kernels_1d(port, dev, keys))
        launches.update(phase_main_paths_1d(port, dev))
        times.update(phase_times_k10_levels(port, dev, card))
        print_k10_occupancy(port, dev)
        print_k10_digests(port, dev, keys)
    if wanted(keys, "K1", "K2", "K9", "K10a", "K10b", "K18a", "K18b", "K19",
              "K20", *MXU2D_KEYS, *MXU1D_KEYS):
        library.update(phase_library(port, dev, card, keys))
    if wanted(keys, "K7a", "K7b", "K29e", "K29f"):
        print_tc1d_occupancy(port, dev, keys)
    if wanted(keys, "K12a", "K12b"):
        print_k12_occupancy(port, dev)
        print_k12_digests(port, dev, keys)
    if wanted(keys, *SHARD_KEYS):
        worst.update(phase_kernels_sharded(port, dev, keys))
        launches.update(phase_main_paths_sharded(port, dev, keys))
        sharded_times, sharded_library = phase_times_sharded(port, dev, card,
                                                             keys)
        times.update(sharded_times)
        library.update(sharded_library)
    if wanted(keys, "K29g", "K29h", "K29d"):
        print_rows_occupancy(port, dev, keys)
        print_rows_digests(port, dev, keys)
    if wanted(keys, *K29):
        worst.update(phase_kernels_grid(port, dev))
        launches.update(phase_main_paths_grid(port, dev))
        phase_audit_grid(port, dev)
        grid_times, grid_library = phase_times_grid(port, dev, card, keys)
        times.update(grid_times)
        library.update(grid_library)
    print(json.dumps({"kernels": kernel_rows(
        port, worst, launches, times, library, keys)}))
    print(card_line())


def kernel_rows(port, worst, launches, times, library, keys=None):
    """The entries of the kernels line (all rows, or those of ``keys``)."""
    work = {**timed_work(port), **sharded_work(port), **grid_work(port)}
    kernels = []
    for key, name, source, tpu in KERNEL_ROWS:
        if not wanted(keys, key):
            continue
        bound_ms, bound_by = bound(*work[key])
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"pypwt_tpu_torch/csrc/{source}",
            "replaces": f"pypwt_tpu/{tpu}",
            "launches": launches[key], "max_abs_err": worst[key],
            "ms": times[key][0], "plain_ms": times[key][1],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library.get(key)})
    return kernels


def main():
    args = sys.argv[1:]
    if args not in ([], ["--sweep"]) and not (
            len(args) == 2 and args[0] == "--only"):
        print("usage: python3 chip_smoke.py [--sweep | --only KEYS]",
              file=sys.stderr)
        sys.exit(2)
    keys = only_keys(args[1]) if args[:1] == ["--only"] else None
    card = phase_device()
    port = import_port()
    from pypwt_tpu_torch.ops import _build
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    phase_build(_build)
    if keys is not None:
        run_only(port, dev, card, keys)
        print(f"only {', '.join(sorted(keys))} done in "
              f"{time.perf_counter() - t0:.1f} s")
        return
    if args == ["--sweep"]:
        phase_sweep_2d_swt(port, dev, card)
        phase_sweep_mxu(port, dev, card)
        phase_sweep_mxu1d(port, dev, card)
        print(f"sweep done in {time.perf_counter() - t0:.1f} s")
        return
    worst = phase_kernels(port, dev)
    worst.update(phase_kernels_1d(port, dev))
    worst.update(phase_kernels_swt2d(port, dev))
    worst.update(phase_kernels_nonsep(port, dev))
    worst.update(phase_kernels_shifted(port, dev))
    worst.update(phase_kernels_mxu(port, dev))
    worst.update(phase_kernels_mxu1d(port, dev))
    phase_kernels_f64(port, dev)
    worst.update(phase_kernels_pyramid(port, dev))
    worst.update(phase_kernels_sharded(port, dev))
    worst.update(phase_kernels_grid(port, dev))
    launches = phase_main_path(port, dev)
    launches.update(phase_main_paths_1d(port, dev))
    launches.update(phase_main_paths_2d_swt(port, dev))
    launches.update(phase_main_paths_pipeline(port, dev))
    launches.update(phase_main_paths_mxu(port, dev))
    launches.update(phase_main_paths_mxu1d(port, dev))
    phase_main_paths_f64(port, dev)
    launches.update(phase_main_paths_pyramid(port, dev))
    launches.update(phase_main_paths_sharded(port, dev))
    phase_audit_sharded(port, dev)
    launches.update(phase_main_paths_grid(port, dev))
    phase_audit_grid(port, dev)
    times = phase_times(port, dev, card)
    times.update(phase_times_1d(port, dev, card))
    times.update(phase_times_2d_swt(port, dev, card))
    times.update(phase_times_slice(port, dev, card))
    times.update(phase_times_mxu(port, dev, card))
    times.update(phase_times_mxu1d(port, dev, card))
    phase_times_f64(port, dev, card)
    times.update(phase_times_pyramid(port, dev, card))
    sharded_times, sharded_library = phase_times_sharded(port, dev, card)
    times.update(sharded_times)
    grid_times, grid_library = phase_times_grid(port, dev, card)
    times.update(grid_times)
    library = phase_library(port, dev, card)
    library.update(sharded_library)
    library.update(grid_library)
    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith(("jax.", "pypwt_tpu.")))
    if leaked:
        raise AssertionError(f"JAX modules loaded: {leaked[:5]}")
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    for key, ms in path_bounds().items():
        print(f"bound of the path holding {key}: {ms * 1e3:.1f} us (bytes)")
    print(json.dumps({"kernels": kernel_rows(port, worst, launches, times,
                                             library)}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
