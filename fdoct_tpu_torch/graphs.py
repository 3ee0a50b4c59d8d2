"""Captured CUDA graphs of the group steps: the counterpart of the JAX
package's compiled, one-dispatch programs.

The JAX session runs a steady-state batch of averaging groups as one
``jax.jit`` program, a ``lax.scan`` over the groups (``_session_group_pipeline``
and ``_session_group_pipeline_int8`` of fdoct_tpu/session.py); bench.py's
headline is the same kind of program (``scan_groups``).  PyTorch runs
eagerly, one Python call per launch: a group kernel and some fifteen to
twenty small launches of the display chain a group.  A :class:`CapturedStep`
records such a step once per key in a ``torch.cuda.CUDAGraph`` and replays
it, after the recipe of ``torch.cuda.graphs``:

- the graph reads static inputs, tensors that the caller writes before each
  replay (the session copies each batch's frames into its input; bench's
  chains read their frames tensor itself);
- before the capture the step runs once eagerly on a side stream, so that
  what is done lazily at first use (the kernels' nvcc build and shared-memory
  attribute, cuBLAS's workspaces, the int8 operator's packing) happens
  outside the capture; that run's outputs are the result of the call that
  captures, so a capture launches each kernel as often as an eager call;
- a replay's outputs live in the graph's memory, which the next replay
  overwrites: :meth:`Captured.replay` returns clones, one copy of each
  output tensor per call;
- the kernel wrappers count their launches in Python
  (``ops.kernels.LAUNCHES``), and the mesh's collectives the bytes they move
  (``parallel.mesh.COLLECTIVE_BYTES``), which a replay does not run: the
  capture records each graph's counts, takes them back out (nothing ran),
  and every replay adds them.

A key is what ``jax.jit`` keys a program on: the static arguments and the
inputs' shapes and types.  The tensors a graph reads besides its inputs (the
session's calibration frames, the int8 plan, a chain's frames) are its
``state``, held by strong references and compared with ``is``, as the
session compares its int8 plan's key: a capture that rebinds one of them
makes the next call capture again.  A failed capture or replay raises;
nothing falls back to the eager step.
"""

from __future__ import annotations

import collections
import dataclasses
from collections.abc import Callable, Hashable, Sequence
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from fdoct_tpu_torch.ops import kernels
from fdoct_tpu_torch.parallel.mesh import COLLECTIVE_BYTES

#: the graphs a CapturedStep keeps: a session uses one a route and frame
#: shape in use, bench's chains four a row
MAX_GRAPHS = 8

#: the session's routes that run eagerly on the card, and why; a session
#: says each once when it takes it
EAGER_ROUTES = {
    "per-frame": ("per-frame path runs eagerly (not captured): its accumulator and "
                  "captures change frame by frame"),
}


class NoHostSync(TorchDispatchMode):
    """A dispatch mode that raises on the operations a captured step must
    not run: a read of a device value on the host (``.item()``, ``float()``,
    ``bool()``: ``aten._local_scalar_dense``, ``aten.is_nonzero``),
    ``aten.nonzero`` (its size is data) and ``aten.lift_fresh`` (a tensor
    made from host data, which on the card is a copy from pageable memory).
    The tests run the steps under it on the CPU, where no graph exists, to
    show that a graph can capture them."""

    FORBIDDEN = ("_local_scalar_dense", "is_nonzero", "nonzero", "lift_fresh")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in self.FORBIDDEN:
            raise RuntimeError(f"host synchronisation in a step: {func}")
        return func(*args, **(kwargs or {}))


def _taken_back(counter: dict[str, int], before: dict[str, int]) -> dict[str, int]:
    """What ``counter`` gained since ``before``, taken back out of it: a
    capture records that work into its graph and runs none of it."""
    gained = {k: v - before[k] for k, v in counter.items() if v != before[k]}
    for k, n in gained.items():
        counter[k] -= n
    return gained


def _clone_outputs(tree: Any) -> Any:
    """Clones of the tensors in a tuple, list or NamedTuple tree of outputs;
    anything else (None) as it is."""
    if torch.is_tensor(tree):
        return tree.clone()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_clone_outputs(t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone_outputs(t) for t in tree)
    return tree


@dataclasses.dataclass(eq=False)
class Captured:
    """One captured step."""
    graph: torch.cuda.CUDAGraph
    state: tuple                    # the tensors it reads besides its inputs
    inputs: tuple                   # the static inputs, written before each replay
    outputs: Any                    # the static outputs, overwritten by each replay
    launches: dict[str, int]        # kernel launches of one replay, by wrapper
    collective_bytes: dict[str, int]  # bytes one replay hands to collectives, by kind
    pool_bytes: int                 # device memory its capture reserved (its pool)

    def replay(self) -> Any:
        """Replays the graph on the current stream and returns clones of its
        outputs; adds its launches to ``ops.kernels.LAUNCHES`` and its bytes
        to ``parallel.mesh.COLLECTIVE_BYTES``."""
        self.graph.replay()
        for counter, counts in ((kernels.LAUNCHES, self.launches),
                                (COLLECTIVE_BYTES, self.collective_bytes)):
            for name, n in counts.items():
                counter[name] += n
        return _clone_outputs(self.outputs)


class CapturedStep:
    """CUDA graphs of step functions, one per key, each with its own memory
    pool.  At most :data:`MAX_GRAPHS` graphs are kept: a new key evicts the
    least recently used, and a key whose state changed is captured again in
    place.  :meth:`clear` frees them all."""

    def __init__(self):
        self._graphs: collections.OrderedDict[Hashable, Captured] = collections.OrderedDict()
        self._stream: torch.cuda.Stream | None = None
        self.captures = 0

    def __len__(self) -> int:
        return len(self._graphs)

    def items(self) -> list[tuple[Hashable, Captured]]:
        return list(self._graphs.items())

    def lookup(self, key: Hashable, state: Sequence) -> Captured | None:
        """The graph of ``key`` if it was captured on these ``state`` tensors
        (each the same object), else None."""
        c = self._graphs.get(key)
        if c is None or len(c.state) != len(state) or any(
                a is not b for a, b in zip(c.state, state)):
            return None
        self._graphs.move_to_end(key)
        return c

    def capture(self, key: Hashable, state: Sequence, fn: Callable[..., Any],
                inputs: Sequence[torch.Tensor]) -> Any:
        """Runs ``fn(*inputs)`` eagerly on a side stream and returns clones of
        its outputs, then captures it as the graph of ``key``, reading
        ``inputs`` (CUDA tensors the caller writes before each replay) and
        ``state``."""
        self._graphs.pop(key, None)                 # its state is stale: free it first
        while len(self._graphs) >= MAX_GRAPHS:
            self._graphs.popitem(last=False)
        dev = inputs[0].device
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        side, cur = self._stream, torch.cuda.current_stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            warm = fn(*inputs)                      # the eager warm-up
        cur.wait_stream(side)
        result = _clone_outputs(warm)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        launched, moved = dict(kernels.LAUNCHES), dict(COLLECTIVE_BYTES)
        graph = torch.cuda.CUDAGraph()
        # thread_local: another thread's CUDA calls (a viewer's copies, the
        # NCCL watchdog's event queries) may go on while this one captures
        with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
            outputs = fn(*inputs)
        self._graphs[key] = Captured(graph, tuple(state), tuple(inputs), outputs,
                                     _taken_back(kernels.LAUNCHES, launched),
                                     _taken_back(COLLECTIVE_BYTES, moved),
                                     torch.cuda.memory_reserved(dev) - reserved)
        self.captures += 1
        return result

    def clear(self) -> None:
        self._graphs.clear()
