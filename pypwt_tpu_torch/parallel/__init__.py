"""Multi-device layer of the port (``pypwt_tpu.parallel``): device meshes
(``mesh``), the counted exchanges between shards (``ring``), sharded
transforms of one image or signal with halo exchanges (``spatial``: the
row layout on the kernels K26-K28, the grid and sequence layouts on K29),
data-parallel stacks (``batch``), the plans ``ShardedWavelets`` (row,
grid and sequence layouts) and ``BatchedWavelets``, and the
exchange-schedule audit (``audit``)."""

from . import audit, batch, mesh, ring, spatial  # noqa: F401
from .api import BatchedWavelets  # noqa: F401
from .sharded import ShardedWavelets  # noqa: F401
