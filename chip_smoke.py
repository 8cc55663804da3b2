#!/usr/bin/env python3
"""Smoke run of the PyTorch port (pypwt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py           # the smoke run below
    python3 chip_smoke.py --sweep   # build, then only the 2D SWT sweep

Run from the root of a checkout.  Phases, in order; any failure raises,
prints its traceback and exits non-zero without the final ok line:

1. device: needs CUDA (exits 1 without it); prints torch/CUDA versions,
   ``nvcc --version`` and the card's name and power limit;
2. build: compiles every kernel (K1/K2, K3/K4, K10a/K10b, K8/K9,
   K18a/K18b) from pypwt_tpu_torch/csrc/ with nvcc, one process per source,
   and prints each kernel's registers and spills;
3. K1/K2 against their plain torch versions on the card, over banks hlen
   2..40 and shapes up to 4096^2 (max-abs <= 2e-5 on uniform [0,1) data:
   the two differ only in summation order and FMA contraction), and
   against the float64 numpy oracle tests/oracle.py on a small plane;
   then K3/K4/K10a/K10b the same way, over the banks, an odd-length bank
   for K10, rows from (1, 8) to (2048, 2048) and one 4 Mi-sample signal,
   every SWT level the signal allows, and a wrap wider than the signal;
   then K8/K9 over the banks and the odd one, planes (8, 8), (33, 47),
   (2, 256, 512) and 2048^2, every level the clamp allows (at 2048^2 for
   db2 and sym20), a wrap wider than the plane and the oracle; then
   K18a/K18b on three custom 2D banks that do not factor, levels 1-3, at
   (64, 128) and 2048^2;
4. main paths, each held against the same calls on the CPU plain path
   (coefficients within 3e-4 * 2^level, image within 7e-4) and counted
   (exact launches of every kernel, 0 declined): Wavelets(img, "db2", 3,
   device="cuda") forward -> soft_threshold(10) -> inverse on a 2048^2
   0..255 frame (3 K1, 3 K2), then the plain roundtrip, the (8, 2048, 2048)
   stack through wavedec2/waverec2, and haar; then the 1D plans: a 2048 x
   2048 sinogram as batched 1D (ndim=1), DWT (3 K3, 3 K4) and SWT (3 K10a,
   3 K10b), one 4 Mi-sample signal (DWT L5, SWT L3), and haar batched 1D;
   then the 2D SWT (3 K8, 3 K9), the stack through swt2d/iswt2d (its first
   and last frames against the CPU), do_separable=0 with db2, DWT (on
   K1/K2) and SWT (on K8/K9), and do_separable=0, do_swt=1 with the custom
   db3 x coif1 bank (3 K18a, 3 K18b);
5. times (CUDA events, warm-up, median of 21 samples): level-0 K1/K2
   against their plain versions at 2048^2 (device time), and the L3
   roundtrip in frames/s, kernel path against plain path, at 2048^2 and on
   the stack, both as device time and as wall time (host launch overhead
   included); then level 0 of K3/K4/K10a/K10b at 2048 x 2048 against their
   plain versions, and the batched-1D and 4 Mi-signal roundtrips; then
   K8/K9 at levels 1 and 3 and K18a/K18b at level 1, 2048^2, and the 2D
   SWT L3 roundtrip.

The line before the last is one JSON object with each kernel's route,
source, the TPU kernel it replaces, its launches in the main-path run, its
worst error in phase 3 and its times; before it, the card's name and power
limit.  The last line is {"ok": true, "device": {...}}.

``--sweep`` times the 2D stationary kernels on a 2048^2 frame by level
(K8/K9), by filter size (K18a/K18b on dense random banks) and by bank
width (K8/K9 against their plain versions), and prints no ok line.
"""

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

ROOT = Path(__file__).resolve().parent
SEED = 1234
BANKS = ("haar", "db2", "db8", "sym20", "bior3.5")
SHAPES = ((8, 8), (64, 128), (2, 256, 512), (2048, 2048), (4096, 4096))
KERNEL_TOL = 2e-5      # kernel vs plain, uniform [0,1) data
COEFF_TOL = 3e-4       # x 2^level, 0..255 data (BASELINE.md envelope)
ROUNDTRIP_TOL = 7e-4   # bench.py:64 envelope
ORACLE_TOL = 1e-5      # float32 kernel vs float64 oracle, [0,1) data
FRAME = (2048, 2048)
STACK = 8
SAMPLES = 21
SLEEP_CYCLES = 20_000_000  # ~10 ms at the H100's 1.98 GHz boost clock
SHAPES_1D = ((1, 8), (3, 64), (64, 1024), FRAME, (1, 4 * 1024 * 1024))
SIGNAL = 4 * 1024 * 1024   # one 16 MiB signal
SHAPES_SWT2D = ((8, 8), (33, 47), (2, 256, 512), FRAME)
SWEEP_WIDTHS = ("haar", "db2", "db4", "db8", "coif5", "sym20")
SWEEP_LEVELS = (("db2", 11), ("sym8", 7), ("sym20", 6))  # bank, top level
SWEEP_HLENS = (2, 4, 6, 8, 12, 16)
# an odd-length bank for the a-trous kernels, which take every hlen
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


def phase_kernels(port, dev):
    fd = port.ops.fused_dwt
    k1, k2 = fd.dwt2d_fused, fd.idwt2d_fused
    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst = {"K1": 0.0, "K2": 0.0}
    for name in BANKS:
        fb = port.get_filter_bank(name)
        for shape in SHAPES:
            x = torch.rand(shape, generator=gen, device=dev)
            n = k1.launches
            got = k1(x, fb)
            if k1.launches != n + 1:
                raise AssertionError("K1 launch count did not move")
            e1 = max_err(got, fd.dwt2d_plain(x, fb))
            cshape = (*shape[:-2], shape[-2] // 2, shape[-1] // 2)
            c = [torch.rand(cshape, generator=gen, device=dev)
                 for _ in range(4)]
            n = k2.launches
            out = k2(*c, fb, shape)
            if k2.launches != n + 1:
                raise AssertionError("K2 launch count did not move")
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
    return worst


def load_oracle():
    spec = importlib.util.spec_from_file_location(
        "oracle", ROOT / "tests" / "oracle.py")
    oracle = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(oracle)
    return oracle


def banks_1d(port):
    """The banks of phase 3, and an odd-length one (the a-trous kernels
    only: K10, K8/K9)."""
    odd = port.FilterBank("odd5", *(np.asarray(t, np.float64)
                                    for t in ODD_TAPS))
    return [port.get_filter_bank(n) for n in BANKS] + [odd]


def launched_once(kernel, call):
    n = kernel.launches
    got = call()
    if kernel.launches != n + 1:
        raise AssertionError(f"{kernel.__name__}: launch count did not move")
    return got


def phase_kernels_1d(port, dev):
    fd = port.ops.fused_dwt
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
            if fb.hlen % 2 == 0:
                got = launched_once(fd.dwt1d_fused,
                                    lambda: fd.dwt1d_fused(x, fb))
                note("K3", max_err(got, fd.dwt1d_plain(x, fb)),
                     (fb.name, shape))
                half = (shape[0], shape[1] // 2)
                ca, cd = a[:, :half[1]].contiguous(), d[:, :half[1]].contiguous()
                got = launched_once(fd.idwt1d_fused, lambda: fd.idwt1d_fused(
                    ca, cd, fb, shape[1]))
                note("K4", max_err(got, fd.idwt1d_plain(ca, cd, fb, shape[1])),
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
        if fb.hlen % 2 == 0:
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


def phase_kernels_swt2d(port, dev):
    """K8/K9 against their plain versions over the banks (the odd 5-tap one
    included), every level the clamp allows (at 2048^2 for db2 and sym20;
    levels 1-2 for the others there), a wrap wider than the plane, and the
    float64 oracle."""
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
    return worst


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


def phase_kernels_nonsep(port, dev):
    kn = port.ops.nonsep
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    worst = {"K18a": 0.0, "K18b": 0.0}
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
    return worst


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
    got = (fd.dwt2d_fused.launches, fd.idwt2d_fused.launches,
           fd.dwt2d_fused.declined + fd.idwt2d_fused.declined)
    if got != (k1, k2, 0):
        raise AssertionError(f"{what}: K1/K2 launches, declined = {got}, "
                             f"expected ({k1}, {k2}, 0)")


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
          f"image vs cpu {ei:.3e}, launches {launches}, declined 0")

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
    """Exactly ``want`` launches per kernel name (others 0), 0 declined."""
    got = {k.__name__: k.launches for k in ops.KERNELS}
    declined = sum(k.declined for k in ops.KERNELS)
    expect = {name: want.get(name, 0) for name in got}
    if got != expect or declined:
        raise AssertionError(f"{what}: launches {got}, declined {declined}; "
                             f"expected {expect}, declined 0")


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
          f"cpu {ei:.3e}, launches {launches}, declined 0")
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


def phase_main_paths_2d_swt(port, dev):
    img = frame(FRAME, SEED + 4)
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
          f"{gib:.2f} GiB, launches 3 + 3, declined 0")
    del xs, pyr, rec

    drive(port, dev, img, "db2", 3, {"dwt2d_fused": 3},
          {"dwt2d_fused": 3, "idwt2d_fused": 3},
          f"non-separable db2 L3 {FRAME}", do_separable=0)
    drive(port, dev, img, "db2", 3, {"swt2d_fused": 3},
          {"swt2d_fused": 3, "iswt2d_fused": 3},
          f"non-separable SWT db2 L3 {FRAME}", do_separable=0, do_swt=1)
    cross = banks_2d(port)[0]
    k18 = drive(port, dev, img, "db2", 3, {"ns_swt2d_fused": 3},
                {"ns_swt2d_fused": 3, "ins_swt2d_fused": 3},
                f"non-separable SWT {cross.name} L3 {FRAME}",
                setup=install_bank(cross), do_separable=0, do_swt=1)
    return {"K8": swt["swt2d_fused"], "K9": swt["iswt2d_fused"],
            "K18a": k18["ns_swt2d_fused"], "K18b": k18["ins_swt2d_fused"]}


def cuda_ms(fn, reps, device_only):
    """Median over SAMPLES of the time per call of ``reps`` back-to-back
    calls between two CUDA events, after a warm-up.

    device_only: a sleep kernel queued first keeps the device busy while
    the host enqueues the calls, so the interval holds their device time
    and none of the host's launch overhead (a sample in which the device
    caught up with the host is taken again with a longer sleep).
    Otherwise the interval is what a caller feels: the host's launch
    overhead counts wherever it exceeds the device time.
    """
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    sleep = SLEEP_CYCLES
    while len(samples) < SAMPLES:
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
            if sleep > 100 * SLEEP_CYCLES:
                raise RuntimeError("the host cannot enqueue ahead of the "
                                   "device: no device-only time")
            sleep *= 2
            continue
        samples.append(start.elapsed_time(end) / reps)
    return statistics.median(samples)


def turns(plain, kernel, reps, device_only):
    """plain, kernel, kernel, plain: (kernel ms, plain ms), each the mean
    of its two medians."""
    p1 = cuda_ms(plain, reps, device_only)
    k1 = cuda_ms(kernel, reps, device_only)
    k2 = cuda_ms(kernel, reps, device_only)
    p2 = cuda_ms(plain, reps, device_only)
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


def phase_times_2d_swt(port, dev, card):
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
        k8 = turns(lambda: fd.swt2d_plain(nx(), fb, level),
                   lambda: fd.swt2d_fused(nx(), fb, level), 10, True)
        k9 = turns(lambda: fd.iswt2d_plain(*coef(), fb, level),
                   lambda: fd.iswt2d_fused(*coef(), fb, level), 10, True)
        for name, (ms, plain) in (("K8 swt2d", k8), ("K9 iswt2d", k9)):
            gbs = level_mib * 2 ** 20 / (ms * 1e-3) / 1e9
            print(f"time {name} level {level} db2 {FRAME}, device: kernel "
                  f"{ms * 1e3:.1f} us ({gbs:.0f} GB/s, {gbs / 3350:.1%} of "
                  f"3.35 TB/s), plain {plain * 1e3:.1f} us  [{card}]")
        if level == 1:
            times["K8"], times["K9"] = k8, k9
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
    port.dwt.set_kernels("auto")
    return times


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


def main():
    if sys.argv[1:] not in ([], ["--sweep"]):
        print("usage: python3 chip_smoke.py [--sweep]", file=sys.stderr)
        sys.exit(2)
    card = phase_device()
    port = import_port()
    from pypwt_tpu_torch.ops import _build
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    phase_build(_build)
    if sys.argv[1:] == ["--sweep"]:
        phase_sweep_2d_swt(port, dev, card)
        print(f"sweep done in {time.perf_counter() - t0:.1f} s")
        return
    worst = phase_kernels(port, dev)
    worst.update(phase_kernels_1d(port, dev))
    worst.update(phase_kernels_swt2d(port, dev))
    worst.update(phase_kernels_nonsep(port, dev))
    launches = phase_main_path(port, dev)
    launches.update(phase_main_paths_1d(port, dev))
    launches.update(phase_main_paths_2d_swt(port, dev))
    times = phase_times(port, dev, card)
    times.update(phase_times_1d(port, dev, card))
    times.update(phase_times_2d_swt(port, dev, card))
    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith(("jax.", "pypwt_tpu.")))
    if leaked:
        raise AssertionError(f"JAX modules loaded: {leaked[:5]}")
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    kernels = [
        {"name": "dwt2d (K1)", "route": "cuda",
         "source": "pypwt_tpu_torch/csrc/dwt2d.cu",
         "replaces": "pypwt_tpu/ops/pallas_dwt.py:287",
         "launches": launches["K1"], "max_abs_err": worst["K1"],
         "ms": times["K1"][0], "plain_ms": times["K1"][1]},
        {"name": "idwt2d (K2)", "route": "cuda",
         "source": "pypwt_tpu_torch/csrc/idwt2d.cu",
         "replaces": "pypwt_tpu/ops/pallas_dwt.py:477",
         "launches": launches["K2"], "max_abs_err": worst["K2"],
         "ms": times["K2"][0], "plain_ms": times["K2"][1]},
    ]
    pk, nsp = "ops/pallas_dwt.py", "ops/nonsep_pallas.py"
    for key, name, source, tpu in (
            ("K3", "dwt1d (K3)", "dwt1d.cu", f"{pk}:2064"),
            ("K4", "idwt1d (K4)", "idwt1d.cu", f"{pk}:2104"),
            ("K10a", "swt1d (K10a)", "swt1d.cu", f"{pk}:2159"),
            ("K10b", "iswt1d (K10b)", "swt1d.cu", f"{pk}:2213"),
            ("K8", "swt2d (K8)", "swt2d.cu", f"{pk}:1912"),
            ("K9", "iswt2d (K9)", "swt2d.cu", f"{pk}:2004"),
            ("K18a", "ns_swt2d (K18a)", "nonsep_swt2d.cu", f"{nsp}:344"),
            ("K18b", "ins_swt2d (K18b)", "nonsep_swt2d.cu", f"{nsp}:344")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"pypwt_tpu_torch/csrc/{source}",
            "replaces": f"pypwt_tpu/{tpu}",
            "launches": launches[key], "max_abs_err": worst[key],
            "ms": times[key][0], "plain_ms": times[key][1]})
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
