"""The per-destination softmax of an edge stream, with its plain PyTorch
version.

The twin of ``repro/kernels/seg_softmax.py``: for logits (E,) or (E, H),
each destination's unmasked incoming edges are normalised per head,
``exp(l - max) / sum exp(l - max)``, with the statistics in float32 and the
result in ``logits.dtype``. Masked edges, edges whose receiver lies
outside [0, N), and the edges of destinations no unmasked edge reaches get
exactly 0.

``seg_softmax`` takes its plain version ``segment_softmax_ref`` for tensors
on the CPU. For CUDA tensors it runs the hand-written kernels of
``csrc/seg_softmax.cu`` or raises: two launches a call, the statistics
(running max and online-rescaled denominator) and then the normalisation.
``seg_softmax.launches`` counts those CUDA launches, two a call. The tile
knobs (``edge_tile``, ``num_banks``) describe the TPU kernel's grid; they
are accepted and the result does not depend on them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mp_pipeline import launch_ptr, owned_stream


def segment_softmax_ref(logits: torch.Tensor, receivers: torch.Tensor,
                        edge_mask: torch.Tensor,
                        num_nodes: int) -> torch.Tensor:
    """Per-destination softmax, plain version. logits: (E,) or (E, H).
    An edge whose receiver lies outside [0, N) weighs 0, as in the JAX
    kernel (whose oracle gathers a clipped row's statistics instead)."""
    own, receivers = owned_stream(receivers, edge_mask, num_nodes)
    m = own if logits.ndim == 1 else own[:, None]
    l32 = logits.to(torch.float32)
    neg = torch.where(m, l32, -torch.inf)
    idx = receivers if l32.ndim == 1 else receivers[:, None].expand_as(l32)
    seg_max = torch.full((num_nodes,) + tuple(l32.shape[1:]), -torch.inf,
                         device=l32.device).scatter_reduce(
        0, idx, neg, "amax", include_self=False)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    e = torch.where(m, torch.exp(l32 - seg_max[receivers]), 0.0)
    denom = torch.zeros_like(seg_max).index_add_(0, receivers, e)
    denom = torch.clamp(denom, min=1e-16)
    return (e / denom[receivers]).to(logits.dtype)


def seg_softmax(logits: torch.Tensor, receivers: torch.Tensor,
                edge_mask: torch.Tensor, num_nodes: int, *,
                edge_tile: int = 128, num_banks: int = 4,
                rows_per_block: Optional[int] = None) -> torch.Tensor:
    """Streaming per-destination softmax of (E,) or (E, H) logits. CPU
    tensors run ``segment_softmax_ref``; CUDA tensors launch the two
    kernels. ``rows_per_block`` overrides how many destination rows one
    block of the statistics launch owns (the result does not depend on
    it)."""
    if logits.ndim not in (1, 2):
        raise ValueError(f"seg_softmax expects (E,) or (E, H) logits, got "
                         f"{tuple(logits.shape)}")
    if logits.device.type == "cpu":
        return segment_softmax_ref(logits, receivers, edge_mask, num_nodes)
    if logits.device.type != "cuda":
        raise ValueError(f"seg_softmax runs on cpu or cuda, not "
                         f"{logits.device}")
    return _launch(logits, receivers, edge_mask, num_nodes, rows_per_block)


seg_softmax.launches = 0


def _kernel():
    fn = build.load("seg_softmax").seg_softmax_launch
    if fn.argtypes is None:
        # without argtypes ctypes passes every int as a 32-bit C int:
        # pointers are cut and the stream slot holds garbage
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(logits, receivers, edge_mask, num_nodes, rows_per_block):
    dev = logits.device
    squeeze = logits.ndim == 1
    lg = logits[:, None] if squeeze else logits
    e, h = lg.shape
    if h == 0:
        raise ValueError("logits must have at least one head")
    if e * h >= 2 ** 31 or num_nodes * h >= 2 ** 31:
        raise ValueError("seg_softmax indexes edges and node rows with int32")
    if rows_per_block is not None and rows_per_block < 1:
        raise ValueError("rows_per_block must be >= 1")
    f32 = torch.float32
    need = functools.partial(launch_ptr, dev)
    ptrs = (need(lg, "logits", f32, (e, h)),
            need(receivers, "receivers", torch.int64, (e,)),
            need(edge_mask, "edge_mask", torch.bool, (e,)))
    # the statistics are scratch: (N, H) running max and denominator. They
    # are freed on return, before the launches run; the caching allocator
    # hands their memory only to work queued later on this stream
    m = torch.empty((num_nodes, h), dtype=f32, device=dev)
    d = torch.empty((num_nodes, h), dtype=f32, device=dev)
    out = torch.empty((e, h), dtype=f32, device=dev)
    err = _kernel()(*ptrs, m.data_ptr(), d.data_ptr(), out.data_ptr(),
                    num_nodes, e, h, rows_per_block or 0,
                    torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"seg_softmax launch failed with CUDA error {err}")
    seg_softmax.launches += int(num_nodes > 0) + int(e > 0)
    return out[:, 0] if squeeze else out
