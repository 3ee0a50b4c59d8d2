"""The comparison that decides ``correct``.

After the window has closed and the program's state is freed, the plain
reference (:mod:`oct_bench.reference`) works out again, in float64 from the
inputs the benchmark made, what the timed path produced.  Each traffic kind
(``oct_bench/traffic/<kind>.py``) says what that is, in its ``readings``:
every number the comparison can take.  ``oct_bench/limits/<workload>.json``
names those the cell is held to, each with its limit, and :func:`decide`
holds them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from oct_bench.reference import RefConfig

F64 = torch.float64


def on_device(a: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``; 16-bit counts widened on the host."""
    if a.dtype == np.uint16:
        a = a.astype(np.int32)
    return torch.as_tensor(a).to(device)


def readings(kind, check: dict, pipeline: dict, device) -> dict[str, float]:
    """The numbers of traffic kind ``kind`` (its module) for what a run left."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rc = RefConfig.from_pipeline(pipeline)
    with torch.no_grad():
        return kind.readings(check, rc, device)


def level_diff(got: np.ndarray, want: torch.Tensor) -> torch.Tensor:
    """got − want in uint8 levels, signed; inf where the shapes differ."""
    if tuple(got.shape) != tuple(want.shape):
        return torch.full((1,), math.inf)
    return (torch.as_tensor(got).to(want.device).int() - want.int()).double()


def level_gap(got: np.ndarray, want: torch.Tensor) -> torch.Tensor:
    return level_diff(got, want).abs()


def decide(values: dict[str, float], limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for each number the limits
    file names; a number missing or not finite fails."""
    checks, ok = {}, bool(limits.get("checks"))
    for name, limit in limits.get("checks", {}).items():
        value = values.get(name, math.nan)
        checks[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, checks
