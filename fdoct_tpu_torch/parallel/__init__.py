"""Scale-out over a device mesh, one process per device.

The port of ``fdoct_tpu/parallel``: the mesh axes ``('data', 'ascan')`` —
frames (data parallelism) × lateral A-scan rows; the depth axis stays local,
so no product needs communication.  The group average sums over 'data', the
display scale's min and max complete over 'ascan', C-scans assemble whole
B-scans with an all-gather over 'ascan'.  JAX runs one controller over
global arrays; here every process (``torchrun``, or a
:class:`~fdoct_tpu_torch.parallel.distributed.WorldOfOne`) runs the same
program on its own block of each batch (:mod:`.mesh`, :mod:`.sharded`).
"""

from fdoct_tpu_torch.parallel.distributed import WorldOfOne, initialize_multihost
from fdoct_tpu_torch.parallel.mesh import make_mesh, mesh_device
from fdoct_tpu_torch.parallel.sharded import (
    build_session_bscan_step, build_session_bscan_step_int8, gather_rows, shard_frames,
    sharded_angio_volume, sharded_bscan_step, sharded_bscan_step_int8, sharded_cscan_volume,
    sharded_cscan_volume_int8,
)

__all__ = [
    "WorldOfOne", "build_session_bscan_step", "build_session_bscan_step_int8", "gather_rows",
    "initialize_multihost", "make_mesh", "mesh_device", "shard_frames", "sharded_angio_volume", "sharded_bscan_step",
    "sharded_bscan_step_int8", "sharded_cscan_volume", "sharded_cscan_volume_int8",
]
