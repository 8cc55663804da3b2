"""Multi-device layer of the port (``pypwt_tpu.parallel``'s row-sharded
and data-parallel layouts): device meshes (``mesh``), the counted
exchanges between shards (``ring``), row-sharded transforms of one image
with halo exchanges on the kernels K26-K28 (``spatial``), data-parallel
stacks (``batch``), the plans ``ShardedWavelets`` and ``BatchedWavelets``,
and the exchange-schedule audit (``audit``)."""

from . import audit, batch, mesh, ring, spatial  # noqa: F401
from .api import BatchedWavelets  # noqa: F401
from .sharded import ShardedWavelets  # noqa: F401
