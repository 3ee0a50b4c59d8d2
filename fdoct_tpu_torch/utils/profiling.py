"""Frame-rate meter and stage timers: ``fdoct_tpu/utils/profiling.py``,
shared by path (standard library only; see :mod:`fdoct_tpu_torch._shared`).
Its ``device_trace`` wraps ``jax.profiler`` and is not part of the port."""

from __future__ import annotations

from fdoct_tpu_torch._shared import load_reference_module

_profiling = load_reference_module("utils/profiling.py")

FpsMeter = _profiling.FpsMeter
StageTimer = _profiling.StageTimer

__all__ = ["FpsMeter", "StageTimer"]
