"""Host utilities."""

import numpy as np
import torch

from fdoct_tpu_torch.utils.profiling import count, span, tracing


def to_host(x) -> np.ndarray:
    """A numpy array of ``x``: a CUDA tensor through a copy into pinned host
    memory (:func:`_host_copy`), a tensor on any other device through
    ``.cpu().numpy()``, anything else through ``np.asarray``.  Slice a
    device tensor before calling this, so that only the slice is copied.

    While a profiler session runs, a CUDA tensor's copy is the span
    ``to_host``: first ``to_host.wait``, the host waiting for the work queued
    on the tensor's stream, then ``to_host.copy``; the counter
    ``to_host.bytes`` adds the bytes copied, and ``to_host.reused_bytes``
    those of them whose pinned destination the allocator had cached (a
    block made for the copy, or the ``.cpu()`` route, adds 0)."""
    if torch.is_tensor(x):
        if x.is_cuda and tracing():
            return _to_host_traced(x)
        return _host_copy(x)[0]
    return np.asarray(x)


def _host_copy(x: torch.Tensor) -> tuple[np.ndarray, bool]:
    """``x`` in host memory, and whether it went the pinned route.

    A CUDA tensor is copied, contiguous, into a pinned tensor of PyTorch's
    caching host allocator: one DMA at the link's rate, where ``.cpu()``
    stages through a bounce buffer into fresh pageable pages.  The copy blocks,
    so the array is whole on return, and it records no event, so the block
    goes back to the allocator's cache, for the next copy of its size class,
    once the caller drops the array (its ``base``); an array still held keeps
    its block.  Where pinning fails, and for every other tensor, the copy
    goes through ``.cpu()``."""
    x = x.detach()
    if x.is_cuda:
        try:
            dst = _pinned_empty(x.shape, x.dtype)
        except RuntimeError:            # pinned host memory exhausted
            pass
        else:
            dst.copy_(x.contiguous())
            return dst.numpy(), True
    return x.cpu().numpy(), False


def _pinned_empty(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, pin_memory=True)


def _host_allocs() -> int | None:
    """The pinned blocks the caching host allocator has made so far, or None
    where this PyTorch does not say."""
    return torch.cuda.host_memory_stats().get("num_host_alloc")


def _to_host_traced(x: torch.Tensor) -> np.ndarray:
    with span("to_host"):
        with span("to_host.wait"):
            torch.cuda.current_stream(x.device).synchronize()
        allocs = _host_allocs() if x.is_cuda else None
        with span("to_host.copy"):
            out, pinned = _host_copy(x)
        reused = pinned and allocs is not None and _host_allocs() == allocs
    count("to_host.bytes", x.nbytes)
    if x.is_cuda:
        count("to_host.reused_bytes", x.nbytes if reused else 0)
    return out
