"""Hand-written CUDA kernels for Hopper and their wrappers (see
``pypwt_tpu_torch/KERNELS.md`` for the map from the TPU kernels).

``KERNELS`` lists every kernel wrapper of the package, 40 in all
(``fused_dwt``: K1-K4, K10a/K10b, K8/K9, the row-sharded K26a/K26b,
K27a/K27b and the grid and sequence passes K29a-K29d; ``shifted``:
K19/K20; ``nonsep``: K16/K17, K18a/K18b; the tensor-core forms
``mxu_dwt``: K5/K6, K7a/K7b, K28's DWT pair, K29e-K29h and ``mxu_swt``:
K11a/K11b, K12a/K12b, K28's SWT pair; the whole-pyramid kernels
``fused_pyramid``: K24/K25); ``reset_counts`` sets all their ``launches``
counts to 0."""

from . import fused_dwt, fused_pyramid, mxu_dwt, mxu_swt, nonsep, shifted

KERNELS = (fused_dwt.KERNELS + shifted.KERNELS + nonsep.KERNELS
           + mxu_dwt.KERNELS + mxu_swt.KERNELS + fused_pyramid.KERNELS)


def reset_counts():
    """Set every kernel's ``launches`` count to 0."""
    for k in KERNELS:
        k.launches = 0
