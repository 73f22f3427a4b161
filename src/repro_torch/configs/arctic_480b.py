"""Config module for --arch arctic-480b: the per-arch entry point (the
canonical definition and its reduced variant live in ``archs.py``)."""

from repro_torch.configs.archs import ARCTIC_480B as CONFIG
from repro_torch.configs.archs import REDUCED as _REDUCED

REDUCED_CONFIG = _REDUCED["arctic-480b"]

__all__ = ["CONFIG", "REDUCED_CONFIG"]
