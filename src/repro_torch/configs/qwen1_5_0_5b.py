"""Config module for --arch qwen1.5-0.5b: the per-arch entry point (the
canonical definition and its reduced variant live in ``archs.py``)."""

from repro_torch.configs.archs import QWEN15_05B as CONFIG
from repro_torch.configs.archs import REDUCED as _REDUCED

REDUCED_CONFIG = _REDUCED["qwen1.5-0.5b"]

__all__ = ["CONFIG", "REDUCED_CONFIG"]
