"""Packaging of the PyTorch port: importing it loads no JAX and builds
nothing, its build directory is git-ignored, its sources import neither
jax nor pypwt_tpu, and chip_smoke.py refuses to run without a GPU."""

import ast
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
