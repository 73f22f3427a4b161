"""Config module for --arch llama3-8b: the per-arch entry point (the
canonical definition and its reduced variant live in ``archs.py``)."""

from repro_torch.configs.archs import LLAMA3_8B as CONFIG
from repro_torch.configs.archs import REDUCED as _REDUCED

REDUCED_CONFIG = _REDUCED["llama3-8b"]

__all__ = ["CONFIG", "REDUCED_CONFIG"]
