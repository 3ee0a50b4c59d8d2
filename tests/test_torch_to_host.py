"""``utils.to_host``: a CUDA tensor's copy into a pinned block of PyTorch's
caching host allocator, the block's reuse once its array is dropped, the
fallback through ``.cpu()`` where pinning fails, the counter
``to_host.reused_bytes`` of the traced path, and the unchanged route of
every other input.  ``utils.to_device``, its host→device counterpart: host
frames bound for the card written into a block of the same allocator and
copied ``non_blocking`` (into ``out`` when given), the pageable fallback,
and the routes of tensors and of other devices.

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
from fdoct_tpu_torch.utils import profiling, to_device, to_host
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


@pytest.fixture
def card(monkeypatch, pins):
    """``to_device``'s copies to the card, made on the CPU.  Blocks of
    ``pins`` are pinned host tensors, as is ``card.pinned(t)``;
    ``card.out(shape, dtype)`` is a tensor on the card.  Each copy from a
    pinned tensor to the card (``.to``) or into a tensor on the card
    (``copy_``) is appended to ``card.copies`` as (source, non_blocking)."""
    copies = []

    class Card(torch.Tensor):
        def copy_(self, src, non_blocking=False):
            copies.append((src, non_blocking))
            torch.Tensor.copy_(self.as_subclass(torch.Tensor), src.as_subclass(torch.Tensor))
            return self

    class Pinned(torch.Tensor):
        def is_pinned(self, device=None):
            return True

        def to(self, device, non_blocking=False):
            assert torch.device(device).type == "cuda"
            dst = torch.empty(self.shape, dtype=self.dtype).as_subclass(Card)
            return dst.copy_(self, non_blocking=non_blocking)

    monkeypatch.setattr(utils, "_pinned_empty",
                        lambda shape, dtype: pins.empty(shape, dtype).as_subclass(Pinned))
    return types.SimpleNamespace(
        copies=copies, block=Pinned, pinned=lambda t: t.as_subclass(Pinned),
        out=lambda shape, dtype: torch.zeros(shape, dtype=dtype).as_subclass(Card))


#: 12-bit-camera-like frames; their uint8 cast and a strided view are cases too
FRAMES = np.random.default_rng(5).integers(0, 1 << 16, (4, 6, 10), dtype=np.uint16)


@pytest.mark.parametrize("route", [
    "u8", "u8-out", "u16", "u16-out", "strided", "strided-out", "unpinnable-out",
    "pinned-tensor", "pinned-tensor-out", "pageable-tensor-out",
    "cpu-array", "cpu-list", "cpu-tensor", "cpu-out"])
def test_to_device_routes(card, pins, monkeypatch, route):
    """Host frames bound for the card: one block of the host allocator,
    filled bit for bit, copied ``non_blocking`` (into ``out`` when given);
    where pinning fails, a pageable copy.  A tensor is copied ``non_blocking``
    when pinned and takes no block; on the CPU nothing is pinned, and an
    array without ``out`` is not copied."""
    kind, into, _ = route.partition("-out")
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    frames = torch.from_numpy(FRAMES)
    #: the input, its device, whether it takes a block, and the copy to the
    #: card's non_blocking (None: nothing goes to the card)
    x, device, block, non_blocking = {
        "u8": (FRAMES.astype(np.uint8), cuda, True, True),
        "u16": (FRAMES, cuda, True, True),
        "strided": (FRAMES[:, ::2, 1::3], cuda, True, True),
        "unpinnable": (FRAMES, cuda, False, False),
        "pinned-tensor": (card.pinned(frames), cuda, False, True),
        "pageable-tensor": (frames, cuda, False, False),
        "cpu-array": (FRAMES, cpu, False, None),
        "cpu-list": (FRAMES[0].tolist(), cpu, False, None),
        "cpu-tensor": (frames, cpu, False, None),
        "cpu": (FRAMES, cpu, False, None),
    }[kind]
    if kind == "unpinnable":
        def refused(shape, dtype):
            raise torch.OutOfMemoryError("pinned host memory exhausted")
        monkeypatch.setattr(utils, "_pinned_empty", refused)
    want = np.asarray(x.as_subclass(torch.Tensor) if torch.is_tensor(x) else x)
    dtype = torch.from_numpy(np.ascontiguousarray(want)).dtype
    out = None
    if into:
        out = (card.out(want.shape, dtype) if device == cuda
               else torch.zeros(want.shape, dtype=dtype))

    got = to_device(x, device, out=out)
    assert got.dtype == dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.as_subclass(torch.Tensor).numpy(), want)
    if out is not None:
        assert got.data_ptr() == out.data_ptr()
    assert pins.allocs == int(block)
    if non_blocking is None:
        assert card.copies == []
    else:
        ((src, nb),) = card.copies
        assert nb is non_blocking
        assert isinstance(src, card.block) is (block or kind == "pinned-tensor")
        np.testing.assert_array_equal(src.as_subclass(torch.Tensor).numpy(), want)
        if torch.is_tensor(x):
            assert src is x
    if kind == "cpu-array":
        assert got.data_ptr() == FRAMES.ctypes.data           # as_tensor of an array copies nothing
    if kind == "cpu-tensor":
        assert got is x


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


@pytest.mark.cuda
@pytest.mark.parametrize("into", [False, True], ids=["to", "out"])
def test_card_frames_overwritten_after_to_device_never_reach_the_card(cuda, into):
    """While a long kernel holds the stream, host frames overwritten right
    after to_device returns, and the next batch staged at once, reach the
    card as they were at each call: the allocator does not hand out the
    first block again before its copy has landed."""
    frames = np.full((8, 512, 2048), 7, np.uint8)
    out = torch.empty(frames.shape, dtype=torch.uint8, device=cuda) if into else None
    torch.cuda.synchronize()
    torch.cuda._sleep(1 << 30)                            # about half a second of spinning
    got = to_device(frames, cuda, out=out)
    frames[:] = 9
    again = to_device(frames, cuda)
    frames[:] = 11
    assert not torch.cuda.current_stream(cuda).query()    # both copies still queued
    torch.cuda.synchronize()
    assert bool((got == 7).all()) and bool((again == 9).all())


@pytest.mark.cuda
def test_card_repeated_batches_make_no_new_host_block(cuda):
    """After warm-up, batch after batch of one size through to_device (each
    followed by a synchronise, as the session's display copy is) reuses the
    allocator's cached blocks: num_host_alloc stays flat."""
    rng = np.random.default_rng(1)
    batches = rng.integers(0, 1 << 12, (4, 8, 480, 720), dtype=np.uint16)
    out = torch.empty(batches.shape[1:], dtype=torch.uint16, device=cuda)
    for k in range(3):
        to_device(batches[k], cuda, out=out)
        torch.cuda.synchronize()
    allocs = torch.cuda.host_memory_stats()["num_host_alloc"]
    for k in range(12):
        got = to_device(batches[k % 4], cuda, out=out if k % 2 else None)
        torch.cuda.synchronize()
        assert torch.equal(got.int().cpu(), torch.from_numpy(batches[k % 4].astype(np.int32)))
    assert torch.cuda.host_memory_stats()["num_host_alloc"] == allocs
