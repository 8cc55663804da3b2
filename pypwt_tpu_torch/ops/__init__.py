"""Hand-written CUDA kernels for Hopper and their wrappers (see
``pypwt_tpu_torch/KERNELS.md`` for the map from the TPU kernels).

``KERNELS`` lists every kernel wrapper of the package (``fused_dwt``:
K1-K4, K10a/K10b, K8/K9; ``nonsep``: K18a/K18b); ``reset_counts`` sets
all their ``launches`` and ``declined`` counts to 0."""

from . import fused_dwt, nonsep

KERNELS = fused_dwt.KERNELS + nonsep.KERNELS


def reset_counts():
    """Set every kernel's ``launches`` and ``declined`` count to 0."""
    for k in KERNELS:
        k.launches = 0
        k.declined = 0
