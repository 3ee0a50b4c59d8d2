"""Synthetic interferograms: ``fdoct_tpu/sources/synthetic.py``, shared by
path (numpy only; see :mod:`fdoct_tpu_torch._shared`)."""

from __future__ import annotations

from fdoct_tpu_torch._shared import load_reference_module

_synthetic = load_reference_module("sources/synthetic.py")

SyntheticSource = _synthetic.SyntheticSource

__all__ = ["SyntheticSource"]
