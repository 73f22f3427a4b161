"""Config module for --arch mamba2-2.7b: the per-arch entry point (the
canonical definition and its reduced variant live in ``archs.py``)."""

from repro_torch.configs.archs import MAMBA2_27B as CONFIG
from repro_torch.configs.archs import REDUCED as _REDUCED

REDUCED_CONFIG = _REDUCED["mamba2-2.7b"]

__all__ = ["CONFIG", "REDUCED_CONFIG"]
