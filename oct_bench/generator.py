"""What every traffic kind shares.

A traffic mix is a data file, ``oct_bench/traffic/<mix>.json``, whose
``kind`` names the code that drives the program with it,
``oct_bench/traffic/<kind>.py``, found by name (:meth:`Catalog.kind`).  A
kind module gives ``run(cell, seed, seconds, trace, device, t_start)``,
which sets up (counted in ``setup_s``), warms up, measures for the window
and returns a :class:`Run`, and ``readings(check, rc, device)``, the
numbers of the comparison with the reference.  Everything of the program is
imported inside the functions, after the harness has fixed the cache
directories.
"""

from __future__ import annotations

import dataclasses
import random
import sys
import time

import torch

#: where in the window the traced stretch of a ``--trace 1`` run starts
TRACE_AT = 0.4


@dataclasses.dataclass
class Run:
    """What one run of a traffic mix leaves for the harness."""

    attempted: int
    failed: int
    e2e: dict                     # end-to-end metric name → value
    layer: dict                   # what the per-layer readers read
    check: dict                   # what the comparison with the reference reads
    memory_peak_bytes: int


class Reservoir:
    """A uniform sample of ``size`` items of a stream of unknown length,
    drawn from the seed (Algorithm R)."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = random.Random(seed)
        self.items: list = []
        self.seen = 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.size:
                self.items[j] = item


def mark(t_start: float, what: str) -> None:
    """Say on standard error when a part of the set-up ended."""
    print(f"oct_bench: {what} at {time.perf_counter() - t_start:.3f} s", file=sys.stderr)


def memory_peak(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
