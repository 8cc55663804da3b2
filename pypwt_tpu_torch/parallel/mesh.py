"""Device meshes for multi-device execution (the port of
``pypwt_tpu.parallel.mesh``).

A ``Mesh`` is a numpy array of ``torch.device``s with named axes, as
``jax.sharding.Mesh`` is: ``(data, rows)`` for stacks and row-sharded
images, ``(rows, cols)`` for a grid.  Where JAX places a global array with
a ``NamedSharding``, the port holds one tensor per shard, each on its mesh
device (``parallel.ring.shard_rows``), and moves halos between them with
the exchanges of ``parallel.ring``.

Without ``devices`` a mesh takes every visible CUDA device and raises if
there is none: it never falls back to the CPU.  A caller may repeat a
device: ``[torch.device("cuda", 0)] * 4`` runs four virtual shards on one
card (the same per-shard kernels and exchanges that four cards would run),
``[torch.device("cpu")] * 8`` eight on the CPU, as the tests do (the
counterpart of JAX's ``--xla_force_host_platform_device_count``).
"""

from __future__ import annotations

import numpy as np
import torch

BATCH_AXIS = "data"
ROW_AXIS = "rows"
COL_AXIS = "cols"


class Mesh:
    """``devices`` (an array of ``torch.device``) with one name per
    axis; ``shape[name]`` is that axis' size, as in JAX."""

    def __init__(self, devices, axis_names):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a {self.devices.ndim}-D device array for axes "
                             f"{self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self):
        return f"Mesh({self.shape})"


def _cuda_devices():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "no CUDA device is visible: pass devices= to build a mesh "
            "(for instance [torch.device('cpu')] * 8)")
    return [torch.device("cuda", i) for i in range(n)]


def _take(devices, count):
    devices = [torch.device(d) for d in devices]
    if len(devices) < count:
        raise ValueError(f"a mesh of {count} devices from {len(devices)}")
    return devices[:count]


def make_mesh(n_data: int | None = None, n_rows: int = 1,
              devices=None) -> Mesh:
    """A (data, rows) mesh.  Defaults to all devices on the data axis."""
    if devices is None:
        devices = _cuda_devices()
    if n_data is None:
        n_data = len(devices) // n_rows
    use = np.empty(n_data * n_rows, dtype=object)
    use[:] = _take(devices, n_data * n_rows)
    return Mesh(use.reshape(n_data, n_rows), (BATCH_AXIS, ROW_AXIS))


def make_mesh2d(n_rows: int, n_cols: int, devices=None) -> Mesh:
    """A (rows, cols) mesh for grid-sharding one large image in both
    spatial dimensions (``ShardedWavelets``' grid layout,
    ``spatial.wavedec2_gridsharded``), devices row-major: device
    i * n_cols + j holds block (i, j)."""
    if devices is None:
        devices = _cuda_devices()
    use = np.empty(n_rows * n_cols, dtype=object)
    use[:] = _take(devices, n_rows * n_cols)
    return Mesh(use.reshape(n_rows, n_cols), (ROW_AXIS, COL_AXIS))


def multihost_initialize(**kwargs):
    """Start the process group of a multi-process run
    (``torch.distributed.init_process_group(**kwargs)``: give it
    ``init_method``, ``world_size`` and ``rank``; nothing here discovers a
    cluster).  ``parallel.ring.ProcessGroupRing`` then exchanges halos
    between the ranks."""
    import torch.distributed as dist
    dist.init_process_group(**kwargs)
