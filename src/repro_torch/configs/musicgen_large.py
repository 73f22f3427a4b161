"""Config module for --arch musicgen-large: the per-arch entry point (the
canonical definition and its reduced variant live in ``archs.py``)."""

from repro_torch.configs.archs import MUSICGEN_LARGE as CONFIG
from repro_torch.configs.archs import REDUCED as _REDUCED

REDUCED_CONFIG = _REDUCED["musicgen-large"]

__all__ = ["CONFIG", "REDUCED_CONFIG"]
