"""Volume reconstruction over the frames of a C-scan.

The port of the C-scan volume functions of ``fdoct_tpu/parallel``, on one
device: a device mesh (``mesh`` not None) is not ported yet (ROADMAP Queue 1
item 12, which extends these same names with ``torch.distributed``).
"""

from fdoct_tpu_torch.parallel.sharded import sharded_cscan_volume, sharded_cscan_volume_int8

__all__ = ["sharded_cscan_volume", "sharded_cscan_volume_int8"]
