"""pypwt_tpu_torch -- the wavelet engine on PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (H100).

The port of ``pypwt_tpu`` (JAX/Pallas on TPU), which stays beside it as
the reference.  Ported so far: the separable, decimated multi-level 2D
DWT and its inverse (``core.dwt``, ``core.haar``) with its two level
kernels K1/K2; the 1D and batched-1D DWT (``core.dwt``, ``core.haar``)
with K3/K4; the stationary transform (``core.swt``), 1D and batched-1D
with K10a/K10b and 2D with K8/K9 (all in ``ops.fused_dwt``); the
non-separable 2D transforms (``core.nonsep``), whose levels run on
K16/K17 (DWT) and K18a/K18b (SWT) (``ops.nonsep``; sources in
``csrc/``); the threshold operators (``core.thresh``); the ``Wavelets``
class for all of them; and the denoising pipelines (``pipeline``:
``denoise2d`` and the cycle-spinning ``denoise2d_cycle_spinning``, whose
shifted levels run on K19/K20, ``ops.shifted``); the tensor-core path of
wide banks, ``core.dwt.set_kernels("mxu")`` with
``set_mxu_precision("highest"|"bf16")``, whose 2D DWT levels run on
K5/K6 and 1D DWT levels on K7a/K7b (``ops.mxu_dwt``), 2D SWT levels on
K11a/K11b and 1D SWT levels on K12a/K12b (``ops.mxu_swt``); float64 plans
on the float64 instances of the tap-loop kernels; and the whole-pyramid
2D DWT, every level in one launch of K24 (analysis) or K25 (synthesis)
(``ops.fused_pyramid.wavedec2_pyramid``/``waverec2_pyramid``), which
tail-level fusion (``core.dwt.set_tail_fuse(True)`` or
``PYPWT_TAIL_FUSE=1``, off by default) runs under ``core.dwt.wavedec2``/
``waverec2`` for levels 2..L; and the multi-device layer ``parallel``
(the row-sharded, grid, sequence and data-parallel layouts:
``ShardedWavelets`` on a row mesh, on a ``make_mesh2d`` grid or, for a
1D input, over a signal's samples; ``BatchedWavelets``;
``parallel.spatial``'s row-sharded transforms on K26-K28, its
grid-sharded and sequence-sharded transforms on the one-axis passes
K29a-K29h, all with halo exchanges through ``parallel.ring``).  This package
imports neither jax nor pypwt_tpu, and builds its kernels at their first
launch, never at import.

Quick start (mirrors the reference README):

    >>> import numpy as np, pypwt_tpu_torch
    >>> img = np.random.rand(512, 512).astype(np.float32)
    >>> W = pypwt_tpu_torch.Wavelets(img, "db2", 3, device="cuda")
    >>> W.forward()
    >>> W.soft_threshold(10.0)
    >>> W.inverse()
    >>> denoised = W.image
"""

from .api import Wavelets  # noqa: F401
from .filters import FilterBank, get_filter_bank, wavelist  # noqa: F401
from .version import __version__  # noqa: F401
from . import core  # noqa: F401
from .core import conv, dwt, haar, nonsep, shapes, swt, thresh  # noqa: F401
from . import ops  # noqa: F401
from . import parallel  # noqa: F401
from . import pipeline  # noqa: F401

__all__ = [
    "Wavelets",
    "FilterBank",
    "get_filter_bank",
    "wavelist",
    "core",
    "parallel",
    "pipeline",
    "__version__",
]
