"""Config module for --arch olmoe-1b-7b: the per-arch entry point (the
canonical definition and its reduced variant live in ``archs.py``)."""

from repro_torch.configs.archs import OLMOE_1B_7B as CONFIG
from repro_torch.configs.archs import REDUCED as _REDUCED

REDUCED_CONFIG = _REDUCED["olmoe-1b-7b"]

__all__ = ["CONFIG", "REDUCED_CONFIG"]
