"""The port's kernel entry points, under the twin name of
``repro/kernels/ops.py``.

Each wrapper launches its hand-written CUDA kernel for CUDA tensors (or
raises) and runs the kernel's plain PyTorch version for CPU tensors; the
dispatch lives in the kernel's own module. Only ``layer_fused`` is ported
so far; the other TPU kernels are listed in ROADMAP queue 2.
"""

from repro_torch.kernels.layer_fused import layer_fused, layer_fused_ref

__all__ = ["layer_fused", "layer_fused_ref"]
