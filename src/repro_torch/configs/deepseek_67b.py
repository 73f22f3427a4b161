"""Config module for --arch deepseek-67b: the per-arch entry point (the
canonical definition and its reduced variant live in ``archs.py``)."""

from repro_torch.configs.archs import DEEPSEEK_67B as CONFIG
from repro_torch.configs.archs import REDUCED as _REDUCED

REDUCED_CONFIG = _REDUCED["deepseek-67b"]

__all__ = ["CONFIG", "REDUCED_CONFIG"]
