"""Hand-written CUDA kernels for Hopper and their wrappers (see
``pypwt_tpu_torch/KERNELS.md`` for the map from the TPU kernels)."""
