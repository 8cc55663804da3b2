"""Packaging of the PyTorch port: importing it loads no JAX and builds
nothing, its build directory is git-ignored, its sources import neither
jax nor pypwt_tpu, and chip_smoke.py refuses to run without a GPU."""

import ast
import ctypes
import importlib.util
import os
import shutil
import subprocess
import sys
import tomllib
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "pypwt_tpu_torch"


def _run(args, cwd, timeout=120):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_import_loads_no_jax_and_builds_nothing():
    # run in a fresh process: this one has imported jax already
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import pypwt_tpu_torch\n"
        "from pypwt_tpu_torch.ops import _build\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pypwt_tpu'))\n"
        "assert not bad, bad\n"
        "assert _build._lib is None\n"
        "print('ok', len(pypwt_tpu_torch.wavelist()))\n")
    res = _run(["-c", code], ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok 72"


def test_2d_swt_and_nonsep_on_cpu_load_no_jax():
    code = (
        "import sys\n"
        "import numpy as np, pypwt_tpu_torch as P\n"
        "img = np.random.default_rng(0).random((32, 48)).astype('float32')\n"
        "for kw in (dict(do_swt=1), dict(do_separable=0, do_swt=1),\n"
        "           dict(do_separable=0)):\n"
        "    W = P.Wavelets(img, 'db2', 2, device='cpu', **kw)\n"
        "    W.forward(); W.inverse()\n"
        "    assert abs(W.image - img).max() < 7e-4\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pypwt_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = _run(["-c", code], ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_pipeline_on_cpu_loads_no_jax():
    code = (
        "import sys\n"
        "import numpy as np, torch\n"
        "from pypwt_tpu_torch import pipeline\n"
        "img = np.random.default_rng(0).random((32, 48)).astype('float32')\n"
        "a = pipeline.denoise2d_cycle_spinning(img, 'db2', 2, 0.1,\n"
        "    shifts=((0, 0), (1, 1)), device='cpu')\n"
        "b = pipeline.denoise2d_cycle_spinning(img, 'db2', 2, 0.1,\n"
        "    generator=torch.Generator().manual_seed(0), n_spins=2,\n"
        "    device='cpu')\n"
        "c = pipeline.denoise2d(img, 'db2', 2, 0.1, device='cpu')\n"
        "assert a.shape == b.shape == c.shape == (32, 48)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pypwt_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = _run(["-c", code], ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_tensor_core_mode_on_cpu_loads_no_jax():
    """set_kernels("mxu") in both precisions: the banded plain versions of
    K5/K6 and K11a/K11b (ops.mxu_dwt, ops.mxu_swt) run without JAX."""
    code = (
        "import sys\n"
        "import numpy as np, pypwt_tpu_torch as P\n"
        "from pypwt_tpu_torch.core import dwt\n"
        "from pypwt_tpu_torch.ops import mxu_dwt, mxu_swt\n"
        "img = np.random.default_rng(0).random((64, 96)).astype('float32')\n"
        "dwt.set_kernels('mxu')\n"
        "for prec in ('highest', 'bf16'):\n"
        "    dwt.set_mxu_precision(prec)\n"
        "    for swt in (0, 1):\n"
        "        W = P.Wavelets(img, 'sym8', 2, device='cpu', do_swt=swt)\n"
        "        W.forward(); W.inverse()\n"
        "        assert abs(W.image - img).max() < (7e-4 if prec == "
        "'highest' else 0.05)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pypwt_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = _run(["-c", code], ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_1d_tensor_core_mode_and_float64_on_cpu_load_no_jax():
    """The 1D tensor-core path in mode "mxu" (K7a/K7b and K12a/K12b's banded
    plain versions, batched 1D and one signal, both precisions) and float64
    plans (2D, 1D, non-separable) run without JAX."""
    code = (
        "import sys\n"
        "import numpy as np, pypwt_tpu_torch as P\n"
        "from pypwt_tpu_torch.core import dwt\n"
        "rng = np.random.default_rng(0)\n"
        "dwt.set_kernels('mxu')\n"
        "for prec in ('highest', 'bf16'):\n"
        "    dwt.set_mxu_precision(prec)\n"
        "    for img, kw in ((rng.random((8, 256)).astype('float32'),\n"
        "                     dict(ndim=1)),\n"
        "                    (rng.random(1024).astype('float32'), {})):\n"
        "        for swt in (0, 1):\n"
        "            W = P.Wavelets(img, 'sym8', 3, device='cpu',\n"
        "                           do_swt=swt, **kw)\n"
        "            W.forward(); W.inverse()\n"
        "            err = abs(W.image.reshape(img.shape) - img).max()\n"
        "            assert err < (7e-4 if prec == 'highest' else 0.05)\n"
        "dwt.set_kernels('auto')\n"
        "img = rng.random((32, 48))\n"
        "for kw in ({}, dict(do_swt=1), dict(ndim=1),\n"
        "           dict(do_separable=0)):\n"
        "    W = P.Wavelets(img, 'db4', 2, dtype=np.float64, device='cpu',\n"
        "                   **kw)\n"
        "    W.forward(); W.inverse()\n"
        "    assert W.image.dtype == np.float64\n"
        "    assert abs(W.image - img).max() < 1e-10\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pypwt_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = _run(["-c", code], ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax(path):
    for mod in _imports(path):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "pypwt_tpu"), mod


def test_build_dir_is_ignored():
    lines = (ROOT / ".gitignore").read_text().split()
    assert "pypwt_tpu_torch/_build/" in lines


def test_pyproject_ships_the_port():
    cfg = tomllib.loads((ROOT / "pyproject.toml").read_text())
    tools = cfg["tool"]
    assert "pypwt_tpu_torch*" in tools["setuptools"]["packages"]["find"][
        "include"]
    data = tools["setuptools"]["package-data"]["pypwt_tpu_torch"]
    assert {"csrc/*.cu", "csrc/*.cuh", "KERNELS.md"} <= set(data)
    assert any(m.startswith("cuda:")
               for m in tools["pytest"]["ini_options"]["markers"])
    for pattern in ("csrc/*.cu", "csrc/*.cuh"):
        assert list(PKG.glob(pattern))


def test_rows_occupancy_entry_is_declared_as_chip_turns_calls_it():
    """K29g / K29h's occupancy query has the ctypes signature in _build
    that chip_turns.py gives it where a parent tree's _build lacks it:
    synthesis, hlen, bf16 and device, then four int pointers (blocks per
    SM, shared memory, tile rows, tile columns)."""
    from pypwt_tpu_torch.ops import _build
    spec = importlib.util.spec_from_file_location("chip_turns",
                                                  ROOT / "chip_turns.py")
    turns = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(turns)
    name = "pypwt_tc_rows_occupancy"
    want = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
    assert _build._SIGNATURES[name] == turns.ENTRY_TYPES[name] == want


def test_swt1d_occupancy_entry_is_declared_as_chip_turns_calls_it():
    """K12a / K12b's occupancy query has the ctypes signature in _build
    that chip_turns.py gives it where a parent tree's _build lacks it:
    synthesis, rows, n, level, hlen, bf16 and device, then three int
    pointers (blocks per SM, shared memory, grid)."""
    from pypwt_tpu_torch.ops import _build
    spec = importlib.util.spec_from_file_location("chip_turns",
                                                  ROOT / "chip_turns.py")
    turns = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(turns)
    name = "pypwt_tc_swt1d_occupancy"
    want = [ctypes.c_int] * 7 + [ctypes.c_void_p] * 3
    assert _build._SIGNATURES[name] == turns.ENTRY_TYPES[name] == want


def test_syn_rows_occupancy_entry_is_declared_as_chip_turns_calls_it():
    """K29d's occupancy query has the ctypes signature in _build that
    chip_turns.py gives it where a parent tree's _build lacks it: hlen, f64
    and device, then four int pointers (blocks per SM, shared memory, tile
    rows, tile columns)."""
    from pypwt_tpu_torch.ops import _build
    spec = importlib.util.spec_from_file_location("chip_turns",
                                                  ROOT / "chip_turns.py")
    turns = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(turns)
    name = "pypwt_syn_rows_occupancy"
    want = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
    assert _build._SIGNATURES[name] == turns.ENTRY_TYPES[name] == want


def test_unshift_occupancy_entry_is_declared_as_chip_turns_calls_it():
    """K20's occupancy query has the ctypes signature in _build that
    chip_turns.py gives it where a parent tree's _build lacks it: nr, nc,
    hlen, sr, sc and device, then four int pointers (blocks per SM, shared
    memory, tile rows, tile columns)."""
    from pypwt_tpu_torch.ops import _build
    spec = importlib.util.spec_from_file_location("chip_turns",
                                                  ROOT / "chip_turns.py")
    turns = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(turns)
    name = "pypwt_idwt2d_unshift_occupancy"
    want = [ctypes.c_int] * 6 + [ctypes.c_void_p] * 4
    assert _build._SIGNATURES[name] == turns.ENTRY_TYPES[name] == want


def test_shifted_occupancy_entry_is_declared_as_chip_turns_calls_it():
    """K19's occupancy query has the ctypes signature in _build that
    chip_turns.py gives it where a parent tree's _build lacks it, K20's:
    nr, nc, hlen, sr, sc and device, then four int pointers (blocks per
    SM, shared memory, tile rows, tile columns)."""
    from pypwt_tpu_torch.ops import _build
    spec = importlib.util.spec_from_file_location("chip_turns",
                                                  ROOT / "chip_turns.py")
    turns = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(turns)
    name = "pypwt_dwt2d_shifted_occupancy"
    want = [ctypes.c_int] * 6 + [ctypes.c_void_p] * 4
    assert _build._SIGNATURES[name] == turns.ENTRY_TYPES[name] == want


def test_stencil_occupancy_entry_is_declared_as_chip_turns_calls_it():
    """K18b's occupancy query has the ctypes signature in _build that
    chip_turns.py gives it where a parent tree's _build lacks it: nr, nc,
    level, centre, hlen, f64 and device, then five int pointers (blocks per
    SM, shared memory, tile rows, tile columns, staged)."""
    from pypwt_tpu_torch.ops import _build
    spec = importlib.util.spec_from_file_location("chip_turns",
                                                  ROOT / "chip_turns.py")
    turns = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(turns)
    name = "pypwt_ins_swt2d_occupancy"
    want = [ctypes.c_int] * 7 + [ctypes.c_void_p] * 5
    assert _build._SIGNATURES[name] == turns.ENTRY_TYPES[name] == want


def test_ns_stencil_occupancy_entry_is_declared_as_chip_turns_calls_it():
    """K18a's occupancy query has the ctypes signature in _build that
    chip_turns.py gives it where a parent tree's _build lacks it, K18b's:
    nr, nc, level, centre, hlen, f64 and device, then five int pointers
    (blocks per SM, shared memory, tile rows, tile columns, staged)."""
    from pypwt_tpu_torch.ops import _build
    spec = importlib.util.spec_from_file_location("chip_turns",
                                                  ROOT / "chip_turns.py")
    turns = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(turns)
    name = "pypwt_ns_swt2d_occupancy"
    want = [ctypes.c_int] * 7 + [ctypes.c_void_p] * 5
    assert _build._SIGNATURES[name] == turns.ENTRY_TYPES[name] == want
    assert _build._SIGNATURES["pypwt_ins_swt2d_occupancy"] == want

def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this test checks the refusal "
                    "without one")
    res = _run(["chip_smoke.py"], ROOT)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert "is_available() is False" in res.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    res = _run(["chip_smoke.py"], tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
