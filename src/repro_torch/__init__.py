"""FlowGNN in PyTorch with hand-written CUDA kernels for Hopper.

A second package beside the JAX one (``src/repro``), with the same module
layout so that each file has an obvious twin there. It imports ``torch`` and
numpy only. Its entry points run on ``cuda`` unless the caller asks for the
CPU with ``device="cpu"``: where no device is given and there is no GPU they
raise instead of quietly running on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: the one asked for, else ``cuda``.

    Raises ``RuntimeError`` when nothing was asked for and there is no GPU.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return torch.device("cuda")


__all__ = ["DeviceLike", "resolve_device"]
