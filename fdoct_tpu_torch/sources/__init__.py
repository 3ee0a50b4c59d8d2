"""Frame sources."""

from fdoct_tpu_torch.sources.camera import CameraSource
from fdoct_tpu_torch.sources.replay import DirectorySource, ReplaySource
from fdoct_tpu_torch.sources.synthetic import SyntheticSource

__all__ = ["CameraSource", "DirectorySource", "ReplaySource", "SyntheticSource"]
