"""Frame sources."""

from fdoct_tpu_torch.sources.synthetic import SyntheticSource

__all__ = ["SyntheticSource"]
