"""The port's kernel entry points, under the twin name of
``repro/kernels/ops.py``.

Each wrapper launches its hand-written CUDA kernel for CUDA tensors (or
raises) and runs the kernel's plain PyTorch version for CPU tensors; the
dispatch lives in the kernel's own module. ``layer_fused`` (self-term
epilogue) and ``mp_pipeline`` are ported; the other TPU kernels are listed
in ROADMAP queue 2.
"""

from repro_torch.kernels.layer_fused import layer_fused, layer_fused_ref
from repro_torch.kernels.mp_pipeline import mp_pipeline, mp_pipeline_ref

__all__ = ["layer_fused", "layer_fused_ref", "mp_pipeline",
           "mp_pipeline_ref"]
