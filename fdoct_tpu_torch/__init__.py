"""fdoct_tpu_torch — the FD-OCT framework on PyTorch and CUDA.

A port of ``fdoct_tpu`` (JAX) that runs the frame→B-scan main path on an
NVIDIA GPU, with the fused group reconstruction as hand-written Hopper
kernels (``csrc/fused_recon.cu``).  It imports ``torch`` and never ``jax``,
and nothing of ``fdoct_tpu``: where it needs one of that package's pure host
modules (configuration, sources, sinks, plugins, image and data files,
profiling meters, the camera ring) it keeps its own copy.  Its command line
is ``fdoct-torch`` (``python -m fdoct_tpu_torch``, :mod:`fdoct_tpu_torch.cli`).
"""

from fdoct_tpu_torch.calibration import Calibration
from fdoct_tpu_torch.config import PipelineConfig
from fdoct_tpu_torch.pipeline import (
    BscanOutputs, form_bscan, reconstruct, reconstruct_bscan, reconstruct_group,
)
from fdoct_tpu_torch.plugins import JMaskPlugin, ROIPlugin, VibrometryPlugin
from fdoct_tpu_torch.session import BscanResult, Session
from fdoct_tpu_torch.sinks import RunWriter

__version__ = "0.1.0"

__all__ = [
    "BscanOutputs", "BscanResult", "Calibration", "JMaskPlugin", "PipelineConfig", "ROIPlugin",
    "RunWriter", "Session", "VibrometryPlugin", "form_bscan", "reconstruct", "reconstruct_bscan",
    "reconstruct_group",
]
