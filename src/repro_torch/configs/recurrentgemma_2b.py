"""Config module for --arch recurrentgemma-2b: the per-arch entry point (the
canonical definition and its reduced variant live in ``archs.py``)."""

from repro_torch.configs.archs import RECURRENTGEMMA_2B as CONFIG
from repro_torch.configs.archs import REDUCED as _REDUCED

REDUCED_CONFIG = _REDUCED["recurrentgemma-2b"]

__all__ = ["CONFIG", "REDUCED_CONFIG"]
