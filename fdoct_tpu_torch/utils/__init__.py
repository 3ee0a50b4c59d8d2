"""Host utilities."""

import numpy as np
import torch


def to_host(x) -> np.ndarray:
    """A numpy array of ``x``: a tensor (on any device) through
    ``.cpu().numpy()``, anything else through ``np.asarray``.  Slice a
    device tensor before calling this, so that only the slice is copied."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)
