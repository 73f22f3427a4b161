"""The port's kernel entry points, under the names and signatures of
``repro/kernels/ops.py``.

Each wrapper launches its hand-written CUDA kernel for CUDA tensors (or
raises) and runs the kernel's plain PyTorch version for CPU tensors; the
dispatch lives in the kernel's own module. Ported: ``layer_fused`` (self
term, degree scalers and directional field epilogues), ``mp_pipeline``,
``mp_scatter`` (float32 and bfloat16 messages), ``mp_scatter_multi``,
``seg_softmax``, ``nt_mlp``, ``fused_nt_scatter``, ``flash_attention``
and, in their own modules, ``gather_rows`` and the MoE path that composes
it with ``mp_scatter`` (``moe_dispatch.py``): every TPU kernel of the
reference. Beside them ``flash_attention_bwd``, the backward of
``flash_attention`` (the reference differentiates its attention in jnp,
``nn/flash.py::_bwd``). The plain versions are re-exported beside them for
tests and ``chip_smoke.py``.
"""

from typing import Callable, Dict, Optional

import torch

from repro_torch.kernels import mp_scatter as _mp_scatter
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_ref,
                                                 flash_attention_ref)
from repro_torch.kernels.fused_nt_scatter import (fused_nt_scatter,
                                                  fused_nt_scatter_ref)
from repro_torch.kernels.layer_fused import layer_fused, layer_fused_ref
from repro_torch.kernels.mp_pipeline import mp_pipeline, mp_pipeline_ref
from repro_torch.kernels.mp_scatter import (mp_scatter, mp_scatter_multi_ref,
                                            mp_scatter_ref)
from repro_torch.kernels.nt_mlp import nt_mlp, nt_mlp_ref
from repro_torch.kernels.seg_softmax import seg_softmax, segment_softmax_ref


def mp_scatter_multi(msg, receivers, edge_mask, num_nodes, *,
                     want_sum=False, want_sumsq=False, want_count=False,
                     want_max=False, want_min=False, node_tile=8,
                     edge_tile=128, num_banks=4,
                     rows_per_block: Optional[int] = None
                     ) -> Dict[str, torch.Tensor]:
    """Single-pass multi-statistic sweep; returns raw f32 accumulators."""
    stats = tuple(
        name for name, want in (
            ("sum", want_sum), ("sumsq", want_sumsq), ("count", want_count),
            ("max", want_max), ("min", want_min)) if want)
    return _mp_scatter.mp_scatter_multi(
        msg, receivers, edge_mask, num_nodes, stats=stats,
        node_tile=node_tile, edge_tile=edge_tile, num_banks=num_banks,
        rows_per_block=rows_per_block)


def launch_counters() -> Dict[str, Callable]:
    """Every kernel wrapper of the port by name, as its module holds it now;
    each counts the CUDA launches it makes in ``.launches``."""
    from repro_torch.kernels import (flash_attention as fa,
                                     fused_nt_scatter as fns,
                                     gather_rows as gr, layer_fused as lf,
                                     mp_pipeline as mp, mp_scatter as ms,
                                     nt_mlp as nt, seg_softmax as ss)
    return {"layer_fused": lf.layer_fused, "mp_pipeline": mp.mp_pipeline,
            "mp_scatter": ms.mp_scatter,
            "mp_scatter_multi": ms.mp_scatter_multi,
            "seg_softmax": ss.seg_softmax, "gather_rows": gr.gather_rows,
            "nt_mlp": nt.nt_mlp, "fused_nt_scatter": fns.fused_nt_scatter,
            "flash_attention": fa.flash_attention,
            "flash_attention_bwd": fa.flash_attention_bwd}


__all__ = ["flash_attention", "flash_attention_bwd", "flash_attention_bwd_ref",
           "flash_attention_ref", "fused_nt_scatter", "fused_nt_scatter_ref",
           "launch_counters", "layer_fused", "layer_fused_ref", "mp_pipeline",
           "mp_pipeline_ref", "mp_scatter", "mp_scatter_multi",
           "mp_scatter_multi_ref", "mp_scatter_ref", "nt_mlp", "nt_mlp_ref",
           "seg_softmax", "segment_softmax_ref"]
