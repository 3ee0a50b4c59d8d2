"""Per-variant analysis plugins (the port's copies of ``fdoct_tpu/plugins``).

Each plugin implements the informal protocol the Session expects:

- ``key(session, ch) -> bool`` — handle a keypress, True if consumed.
- ``on_bscan(session, result) -> None`` — called with every completed
  (displayed) B-scan group; ``result.bscan``/``bscandb`` may be tensors on
  the session's device, and a plugin slices them before moving them to the
  host.
"""

from fdoct_tpu_torch.plugins.jmask import JMaskPlugin
from fdoct_tpu_torch.plugins.roi import ROIPlugin
from fdoct_tpu_torch.plugins.vibrometry import (
    VibrometryPlugin, bessel_db_inverse, errnull, render_vib_profile,
)

__all__ = ["JMaskPlugin", "ROIPlugin", "VibrometryPlugin", "bessel_db_inverse", "errnull",
           "render_vib_profile"]
