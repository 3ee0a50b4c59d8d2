"""Configuration: the JAX package's schema, shared by path.

``PipelineConfig`` and the positional ini readers/writers are those of
``fdoct_tpu/config.py`` (standard library only), loaded without importing
``fdoct_tpu`` so that JAX stays unloaded (see :mod:`fdoct_tpu_torch._shared`).
"""

from __future__ import annotations

from fdoct_tpu_torch._shared import load_reference_module

_config = load_reference_module("config.py")

PipelineConfig = _config.PipelineConfig
read_ini = _config.read_ini
write_ini = _config.write_ini

__all__ = ["PipelineConfig", "read_ini", "write_ini"]
