#!/usr/bin/env python3
"""Smoke run of the PyTorch port (pypwt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, in order; any failure raises,
prints its traceback and exits non-zero without the final ok line:

1. device: needs CUDA (exits 1 without it); prints torch/CUDA versions,
   ``nvcc --version`` and the card's name and power limit;
2. build: compiles K1/K2 from pypwt_tpu_torch/csrc/ with nvcc;
3. K1/K2 against their plain torch versions on the card, over banks hlen
   2..40 and shapes up to 4096^2 (max-abs <= 2e-5 on uniform [0,1) data:
   the two differ only in summation order and FMA contraction), and
   against the float64 numpy oracle tests/oracle.py on a small plane;
4. main path: Wavelets(img, "db2", 3, device="cuda") forward ->
   soft_threshold(10) -> inverse on a 2048^2 0..255 frame, held against
   the same calls on the CPU plain path (coefficients within
   3e-4 * 2^level, image within 7e-4) and counted: exactly 3 K1 and 3 K2
   launches, 0 declined.  Then the plain roundtrip (< 7e-4), the (8, 2048,
   2048) stack through wavedec2/waverec2, and haar;
5. times (CUDA events, warm-up, median of 21 samples): level-0 K1/K2
   against their plain versions at 2048^2 (device time), and the L3
   roundtrip in frames/s, kernel path against plain path, at 2048^2 and on
   the stack, both as device time and as wall time (host launch overhead
   included).

The line before the last is one JSON object with each kernel's route,
source, the TPU kernel it replaces, its launches in the main-path run, its
worst error in phase 3 and its times; before it, the card's name and power
limit.  The last line is {"ok": true, "device": {...}}.
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
    spec = importlib.util.spec_from_file_location(
        "oracle", ROOT / "tests" / "oracle.py")
    oracle = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(oracle)
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


def frame(shape, seed=SEED):
    return (np.random.default_rng(seed).random(shape) * 255).astype(
        np.float32)


def check_pyramid(got, ref, what):
    """Coefficients within 3e-4 * 2^level (A at the deepest level)."""
    levels = len(ref) - 1
    worst = 0.0
    pairs = [(got[0], ref[0], levels)]
    for lev in range(1, levels + 1):
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

    fd.reset_counts()
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

    fd.reset_counts()
    W = port.Wavelets(img, "db2", 3, device=dev)
    W.forward()
    W.inverse()
    er = check_image(W.image, img, "db2 roundtrip")
    expect_counts(fd, 3, 3, "db2 roundtrip")
    print(f"roundtrip db2 L3 {FRAME}: {er:.3e}")

    fb = port.get_filter_bank("db2")
    stack = torch.from_numpy(frame((STACK, *FRAME), SEED + 1)).to(dev)
    fd.reset_counts()
    rec = port.dwt.waverec2(port.dwt.wavedec2(stack, fb, 3), fb, stack.shape)
    torch.cuda.synchronize()
    expect_counts(fd, 3, 3, "stack roundtrip")
    es = check_image(rec.cpu().numpy(), stack.cpu().numpy(),
                     "stack roundtrip")
    print(f"roundtrip db2 L3 {(STACK, *FRAME)}: {es:.3e}")

    href = port.Wavelets(img, "haar", 3, device="cpu").forward()
    fd.reset_counts()
    W = port.Wavelets(img, "haar", 3)
    W.forward()
    eh = check_pyramid(W.coeffs, href.coeffs, "haar forward")
    W.inverse()
    ehr = check_image(W.image, img, "haar roundtrip")
    expect_counts(fd, 3, 3, "haar")
    print(f"haar L3 {FRAME}: forward vs cpu butterfly {eh:.3e}, "
          f"roundtrip {ehr:.3e}")
    return launches


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


def main():
    card = phase_device()
    port = import_port()
    from pypwt_tpu_torch.ops import _build
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    phase_build(_build)
    worst = phase_kernels(port, dev)
    launches = phase_main_path(port, dev)
    times = phase_times(port, dev, card)
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
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
