"""The port reads JAX's three environment switches at import, as
``pypwt_tpu/core/dwt.py`` does: ``PYPWT_KERNELS`` (default "auto") sets
``core.dwt.set_kernels`` and ``PYPWT_MXU_PRECISION`` (default "highest")
``set_mxu_precision``, where a value they refuse raises ``ValueError`` at
import, naming the variable ("jnp" and "pallas" stay refused);
``PYPWT_TAIL_FUSE`` turns tail fusion on if it is exactly "1" and leaves
it off for anything else.  Each case imports the port in a fresh
process."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SHOW = ("from pypwt_tpu_torch.core import dwt\n"
        "print(dwt._KERNEL_MODE, dwt.mxu_precision(), dwt._TAIL_FUSE)\n")


def _import(**env):
    base = {k: v for k, v in os.environ.items()
            if k not in ("PYTHONPATH", "PYPWT_KERNELS", "PYPWT_MXU_PRECISION",
                         "PYPWT_TAIL_FUSE")}
    return subprocess.run([sys.executable, "-c", SHOW], cwd=ROOT,
                          env={**base, **env}, capture_output=True,
                          text=True, timeout=120)


@pytest.mark.parametrize("env, want", [
    ({}, "auto highest False"),
    ({"PYPWT_MXU_PRECISION": "bf16"}, "auto bf16 False"),
    ({"PYPWT_KERNELS": "mxu"}, "mxu highest False"),
    ({"PYPWT_KERNELS": "mxu", "PYPWT_MXU_PRECISION": "bf16"},
     "mxu bf16 False"),
    ({"PYPWT_KERNELS": "torch"}, "torch highest False"),
    ({"PYPWT_KERNELS": "cuda"}, "cuda highest False"),
    ({"PYPWT_TAIL_FUSE": "0"}, "auto highest False"),
    ({"PYPWT_TAIL_FUSE": "yes"}, "auto highest False"),
    ({"PYPWT_TAIL_FUSE": "1"}, "auto highest True"),
    ({"PYPWT_TAIL_FUSE": "1", "PYPWT_KERNELS": "mxu"}, "mxu highest True"),
], ids=["defaults", "bf16", "mxu", "mxu-bf16", "torch", "cuda",
        "tail-fuse-0", "tail-fuse-yes", "tail-fuse-1", "tail-fuse-1-mxu"])
def test_env_switch_sets_the_mode(env, want):
    res = _import(**env)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == want.split()


@pytest.mark.parametrize("var, value", [
    ("PYPWT_KERNELS", "pallas"), ("PYPWT_KERNELS", "jnp"),
    ("PYPWT_KERNELS", "MXU"), ("PYPWT_MXU_PRECISION", "fp8"),
    ("PYPWT_MXU_PRECISION", "tf32")])
def test_refused_env_value_raises_at_import(var, value):
    res = _import(**{var: value})
    assert res.returncode != 0
    last = res.stderr.strip().splitlines()[-1]
    assert last.startswith("ValueError") and var in last and value in last
