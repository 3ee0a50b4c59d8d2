"""``utils.to_host``: a CUDA tensor's copy into a pinned block of PyTorch's
caching host allocator, the block's reuse once its array is dropped, the
fallback through ``.cpu()`` where pinning fails, the counter
``to_host.reused_bytes`` of the traced path, and the unchanged route of
every other input.

    python -m pytest tests/test_torch_to_host.py -q

On the CPU a tensor subclass that says it is on the card, and a pool of
plain tensors that counts its blocks as the caching host allocator does,
stand in for the card.  The ``cuda`` cases skip without a card; on the card
they run with ``python -m pytest --noconftest -m cuda
tests/test_torch_to_host.py``.  This file imports no JAX.
"""

from __future__ import annotations

import collections
import types
import weakref

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fdoct_tpu_torch import utils
from fdoct_tpu_torch.utils import profiling, to_host
from fdoct_tpu_torch.utils.profiling import StageTimer


class OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card."""

    is_cuda = True


def on_card(t: torch.Tensor) -> torch.Tensor:
    return t.as_subclass(OnCard)


class CachedPins:
    """Stands in for the caching host allocator: a size class's block is
    made once, goes back to the cache when the last array on it is dropped,
    and is handed out again."""

    def __init__(self):
        self.allocs = 0
        self.cached: collections.Counter = collections.Counter()

    def empty(self, shape, dtype) -> torch.Tensor:
        t = torch.empty(shape, dtype=dtype)
        if self.cached[t.nbytes]:
            self.cached[t.nbytes] -= 1
        else:
            self.allocs += 1
        weakref.finalize(t.untyped_storage(), self.cached.update, [t.nbytes])
        return t


@pytest.fixture
def spans(monkeypatch):
    fresh = StageTimer()
    monkeypatch.setattr(profiling, "SPANS", fresh)
    return fresh


@pytest.fixture
def pins(monkeypatch):
    """The pinned route on the CPU: ``CachedPins`` for the allocation, its
    count for the allocator's ``num_host_alloc``, the stream's synchronize a
    no-op."""
    pool = CachedPins()
    monkeypatch.setattr(utils, "_pinned_empty", pool.empty)
    monkeypatch.setattr(utils, "_host_allocs", lambda: pool.allocs)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(synchronize=lambda: None))
    return pool


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_traced_copies_count_the_bytes_of_cached_blocks(spans, pins):
    x = on_card(torch.arange(60, dtype=torch.float32).reshape(5, 12))
    n = x.nbytes
    with cpu_profile():
        first = to_host(x)                                # a block made for it
        np.testing.assert_array_equal(first, np.arange(60, dtype=np.float32).reshape(5, 12))
        del first
        held = to_host(x)                                 # the cached block again
        other = to_host(x)                                # the first is held: a new one
        small = to_host(x[1:3])                           # another size class
    assert pins.allocs == 3
    assert np.array_equal(held, other) and held.ctypes.data != other.ctypes.data
    np.testing.assert_array_equal(small, x[1:3].numpy())
    snap = spans.snapshot()
    assert snap["counters"] == {"to_host.bytes": 3 * n + small.nbytes,
                                "to_host.reused_bytes": n}
    assert {k: v["count"] for k, v in snap["spans"].items()} == {
        "to_host": 4, "to_host.wait": 4, "to_host.copy": 4}


def test_untraced_copy_goes_the_pinned_route_and_records_nothing(spans, pins):
    x = on_card(torch.arange(12, dtype=torch.int16).reshape(3, 4))
    got = to_host(x.t())                                  # a non-contiguous view
    assert got.flags.c_contiguous and got.dtype == np.int16
    np.testing.assert_array_equal(got, np.arange(12, dtype=np.int16).reshape(3, 4).T)
    assert pins.allocs == 1
    assert spans.snapshot() == {"spans": {}, "counters": {}}


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
def test_copy_falls_back_to_cpu_when_pinning_fails(spans, pins, monkeypatch, traced):
    def refused(shape, dtype):
        raise torch.OutOfMemoryError("pinned host memory exhausted")

    monkeypatch.setattr(utils, "_pinned_empty", refused)
    x = on_card(torch.linspace(0, 1, 24, dtype=torch.float64).reshape(2, 3, 4))
    if traced:
        with cpu_profile():
            got = to_host(x)
    else:
        got = to_host(x)
    assert got.dtype == np.float64 and got.shape == (2, 3, 4)
    np.testing.assert_array_equal(got, torch.linspace(0, 1, 24, dtype=torch.float64)
                                  .reshape(2, 3, 4).numpy())
    expect = {"to_host.bytes": x.nbytes, "to_host.reused_bytes": 0} if traced else {}
    assert spans.snapshot()["counters"] == expect


def test_cpu_tensors_and_non_tensors_keep_their_route(spans, monkeypatch):
    def never(shape, dtype):
        raise AssertionError("a CPU tensor took the pinned route")

    monkeypatch.setattr(utils, "_pinned_empty", never)
    x = torch.arange(6, dtype=torch.uint8).reshape(2, 3)
    with cpu_profile():
        got = to_host(x)
        listed = to_host([[1, 2], [3, 4]])
    np.testing.assert_array_equal(got, x.numpy())
    assert got.ctypes.data == x.data_ptr()                # .cpu() of a CPU tensor copies nothing
    np.testing.assert_array_equal(listed, np.array([[1, 2], [3, 4]]))
    assert spans.snapshot() == {"spans": {}, "counters": {}}


# --------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


CASES = {
    "f32": (torch.float32, (512, 300)),
    "u8": (torch.uint8, (7, 33, 5)),
    "i64": (torch.int64, (1000,)),
    "f64": (torch.float64, (3, 4)),
    "bool": (torch.bool, (17,)),
    "scalar": (torch.float32, ()),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_card_copy_is_cpu_bit_for_bit_in_pinned_memory(cuda, case):
    dtype, shape = CASES[case]
    g = torch.Generator(device=cuda).manual_seed(11)
    x = (torch.rand(shape, generator=g, device=cuda) * 200).to(dtype)
    for t in (x, x[1:] if x.dim() else x, x.transpose(0, -1) if x.dim() > 1 else x):
        got, want = to_host(t), t.cpu().numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want)
        assert torch.is_tensor(got.base) and got.base.is_pinned()


@pytest.mark.cuda
def test_card_dropped_block_is_reused(cuda):
    x = torch.arange(1 << 20, dtype=torch.float32, device=cuda)
    to_host(x)                                            # the size class's block exists
    first = to_host(x)
    allocs = torch.cuda.host_memory_stats()["num_host_alloc"]
    del first
    second = to_host(x)
    assert torch.cuda.host_memory_stats()["num_host_alloc"] == allocs
    np.testing.assert_array_equal(second, x.cpu().numpy())


@pytest.mark.cuda
def test_card_held_array_keeps_its_block(cuda):
    x = torch.arange(1 << 18, dtype=torch.int32, device=cuda)
    held = to_host(x)
    x.neg_()
    again = to_host(x)
    assert held.ctypes.data != again.ctypes.data
    np.testing.assert_array_equal(held, np.arange(1 << 18, dtype=np.int32))
    np.testing.assert_array_equal(again, -np.arange(1 << 18, dtype=np.int32))
