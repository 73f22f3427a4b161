"""The per-destination softmax of an edge stream, with its plain PyTorch
version.

The twin of ``repro/kernels/seg_softmax.py``: for logits (E,) or (E, H),
each destination's unmasked incoming edges are normalised per head,
``exp(l - max) / sum exp(l - max)``, with the statistics in float32 and the
result in ``logits.dtype``. Like the JAX kernel, it keeps statistics for
the rows [0, n_pad), ``n_pad = ceil(N / num_banks) * num_banks``: an
unmasked edge whose receiver lies in the padding rows [N, n_pad) is
normalised with the other edges into its padding row. Masked edges, edges
whose receiver lies outside [0, n_pad), and the edges of destinations no
unmasked edge reaches get exactly 0.

``seg_softmax`` takes its plain version ``segment_softmax_ref`` for tensors
on the CPU. For CUDA tensors it runs the hand-written kernel of
``csrc/seg_softmax.cu`` or raises: one launch a call, in which each block
buckets the edges of the rows it owns, takes their max and denominator and
writes their weights. ``seg_softmax.launches`` counts those CUDA launches,
one a call.
``num_banks`` sets n_pad as above and so decides the weights of edges into
the padding rows; ``edge_tile`` describes the TPU kernel's grid, is
accepted, and the result does not depend on it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mp_pipeline import (launch_ptr, no_backward,
                                             owned_stream)


def padded_rows(num_nodes: int, num_banks: int) -> int:
    """n_pad: ``num_nodes`` rounded up to a multiple of ``num_banks``, the
    rows the JAX kernel keeps statistics for."""
    if num_banks < 1:
        raise ValueError(f"num_banks must be >= 1, got {num_banks}")
    return -(-num_nodes // num_banks) * num_banks


def segment_softmax_ref(logits: torch.Tensor, receivers: torch.Tensor,
                        edge_mask: torch.Tensor, num_nodes: int, *,
                        num_banks: int = 4) -> torch.Tensor:
    """Per-destination softmax, plain version. logits: (E,) or (E, H).
    Statistics over the rows [0, n_pad) (``padded_rows``), as in the JAX
    kernel: an edge into a padding row [N, n_pad) is normalised there, an
    edge whose receiver lies outside [0, n_pad) weighs 0 (the JAX oracle
    gathers a clipped row's statistics instead)."""
    n_pad = padded_rows(num_nodes, num_banks)
    own, receivers = owned_stream(receivers, edge_mask, n_pad)
    m = own if logits.ndim == 1 else own[:, None]
    l32 = logits.to(torch.float32)
    neg = torch.where(m, l32, -torch.inf)
    idx = receivers if l32.ndim == 1 else receivers[:, None].expand_as(l32)
    seg_max = torch.full((n_pad,) + tuple(l32.shape[1:]), -torch.inf,
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
    tensors run ``segment_softmax_ref``; CUDA tensors launch the kernel.
    ``rows_per_block`` overrides how many destination rows one block owns
    (the result does not depend on it)."""
    if logits.ndim not in (1, 2):
        raise ValueError(f"seg_softmax expects (E,) or (E, H) logits, got "
                         f"{tuple(logits.shape)}")
    if logits.device.type == "cpu":
        return segment_softmax_ref(logits, receivers, edge_mask, num_nodes,
                                   num_banks=num_banks)
    if logits.device.type != "cuda":
        raise ValueError(f"seg_softmax runs on cpu or cuda, not "
                         f"{logits.device}")
    no_backward("seg_softmax", logits)
    return _launch(logits, receivers, edge_mask,
                   padded_rows(num_nodes, num_banks), rows_per_block)


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


def _launch(logits, receivers, edge_mask, n_pad, rows_per_block):
    dev = logits.device
    squeeze = logits.ndim == 1
    lg = logits[:, None] if squeeze else logits
    e, h = lg.shape
    if h == 0:
        raise ValueError("logits must have at least one head")
    if e * h >= 2 ** 31 or n_pad * h >= 2 ** 31:
        raise ValueError("seg_softmax indexes edges and node rows with int32")
    if rows_per_block is not None and rows_per_block < 1:
        raise ValueError("rows_per_block must be >= 1")
    f32 = torch.float32
    need = functools.partial(launch_ptr, dev)
    ptrs = (need(lg, "logits", f32, (e, h)),
            need(receivers, "receivers", torch.int64, (e,)),
            need(edge_mask, "edge_mask", torch.bool, (e,)))
    # the statistics are scratch: (n_pad, H) max and denominator. They are
    # freed on return, before the launch runs; the caching allocator hands
    # their memory only to work queued later on this stream
    m = torch.empty((n_pad, h), dtype=f32, device=dev)
    d = torch.empty((n_pad, h), dtype=f32, device=dev)
    out = torch.empty((e, h), dtype=f32, device=dev)
    err = _kernel()(*ptrs, m.data_ptr(), d.data_ptr(), out.data_ptr(),
                    n_pad, e, h, rows_per_block or 0,
                    torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"seg_softmax launch failed with CUDA error {err}")
    build.count_launches(seg_softmax, int(n_pad > 0 or e > 0))
    return out[:, 0] if squeeze else out
