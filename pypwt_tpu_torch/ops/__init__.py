"""Hand-written CUDA kernels for Hopper and their wrappers (see
``pypwt_tpu_torch/KERNELS.md`` for the map from the TPU kernels).

``KERNELS`` lists every kernel wrapper of the package, 14 in all
(``fused_dwt``: K1-K4, K10a/K10b, K8/K9; ``shifted``: K19/K20;
``nonsep``: K16/K17, K18a/K18b); ``reset_counts`` sets all their
``launches`` counts to 0."""

from . import fused_dwt, nonsep, shifted

KERNELS = fused_dwt.KERNELS + shifted.KERNELS + nonsep.KERNELS


def reset_counts():
    """Set every kernel's ``launches`` count to 0."""
    for k in KERNELS:
        k.launches = 0
