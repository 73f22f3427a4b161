"""Config module for --arch gemma2-27b: the per-arch entry point (the
canonical definition and its reduced variant live in ``archs.py``)."""

from repro_torch.configs.archs import GEMMA2_27B as CONFIG
from repro_torch.configs.archs import REDUCED as _REDUCED

REDUCED_CONFIG = _REDUCED["gemma2-27b"]

__all__ = ["CONFIG", "REDUCED_CONFIG"]
