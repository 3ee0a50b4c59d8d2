"""The plain reference of the benchmark: the upstream's steps in float64,
written from BscanFFT.cpp and independent of the program under test (it
imports nothing of ``fdoct_tpu_torch``, ``fdoct_tpu`` or ``jax``)."""

from oct_bench.reference.oct_ref import (
    RefConfig, ascan_mags, cscan_views, grids, volume,
)

__all__ = ["RefConfig", "ascan_mags", "cscan_views", "grids", "volume"]
