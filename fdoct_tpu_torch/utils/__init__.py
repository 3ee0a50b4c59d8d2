"""Host utilities."""

import numpy as np
import torch

from fdoct_tpu_torch.utils.profiling import count, span, tracing


def to_host(x) -> np.ndarray:
    """A numpy array of ``x``: a tensor (on any device) through
    ``.cpu().numpy()``, anything else through ``np.asarray``.  Slice a
    device tensor before calling this, so that only the slice is copied.

    While a profiler session runs, a CUDA tensor's copy is the span
    ``to_host``: first ``to_host.wait``, the host waiting for the work queued
    on the tensor's stream, then ``to_host.copy``; the counter
    ``to_host.bytes`` adds the bytes copied."""
    if torch.is_tensor(x):
        if x.is_cuda and tracing():
            return _to_host_traced(x)
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _to_host_traced(x: torch.Tensor) -> np.ndarray:
    with span("to_host"):
        with span("to_host.wait"):
            torch.cuda.current_stream(x.device).synchronize()
        with span("to_host.copy"):
            out = x.detach().cpu().numpy()
    count("to_host.bytes", x.nbytes)
    return out
