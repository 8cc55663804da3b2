"""pypwt_tpu_torch -- the wavelet engine on PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (H100).

The port of ``pypwt_tpu`` (JAX/Pallas on TPU), which stays beside it as
the reference.  Ported so far: the separable, decimated multi-level 2D
DWT and its inverse (``core.dwt``, ``core.haar``) with its two level
kernels K1/K2 (``ops.fused_dwt``, ``csrc/``), the threshold operators
(``core.thresh``) and the ``Wavelets`` class for that transform.  This
package imports neither jax nor pypwt_tpu, and builds its kernels at their
first launch, never at import.

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
from .core import conv, dwt, haar, shapes, thresh  # noqa: F401

__all__ = [
    "Wavelets",
    "FilterBank",
    "get_filter_bank",
    "wavelist",
    "core",
    "__version__",
]
