"""NT fused with the GIN-style message transform and scatter, with its
plain PyTorch version.

The twin of ``repro/kernels/fused_nt_scatter.py``: for x (N, D_in), an MLP
D_in -> D_ff -> D, an edge stream and ``edge_feat`` (E, D),

    y      = relu(x @ w1 + b1) @ w2 + b2
    out[i] = sum over unmasked e with dst(e) = i of relu(y[src(e)] + ef[e])

in float32, (N, D). An edge whose sender or receiver lies outside [0, N)
adds nothing, as in the Pallas kernel. Mind the argument order: the kernel
takes ``(..., edge_mask, edge_feat)``, its oracle ``fused_nt_scatter_ref``
``(..., edge_feat, edge_mask)``, as in the reference.

x and the weights share one dtype (``ValueError`` otherwise, on every
device). ``fused_nt_scatter`` takes the plain version for tensors on the
CPU. For CUDA tensors (the MLP's operands float32, bfloat16 or float16;
``edge_feat`` any of the three; widened to float32 inside) it runs
``csrc/fused_nt_scatter.cu`` or raises: two launches a call, the NT tile
writing y to a float32 scratch, then ``mp_pipeline``'s edge phase (the sum
of relu(y[src] + edge_feat)) with its check that drops edges whose sender
lies outside [0, N), launched so that its set-up and bucketing overlap the
NT tile. ``fused_nt_scatter.launches`` counts those CUDA launches, two a
call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mp_pipeline import launch_ptr
from repro_torch.kernels.mp_scatter import mp_scatter_ref
from repro_torch.kernels.nt_mlp import (DTYPE_CODES, check_mlp, mlp_ptrs,
                                       nt_mlp_ref)


def fused_nt_scatter_ref(x, w1, b1, w2, b2, senders, receivers, edge_feat,
                         edge_mask) -> torch.Tensor:
    """Plain version (the oracle's argument order: ``edge_feat`` before
    ``edge_mask``)."""
    n = x.shape[0]
    y = nt_mlp_ref(x, w1, b1, w2, b2)
    sent = (senders >= 0) & (senders < n)
    msg = torch.relu(y[torch.where(sent, senders, 0)]
                     + edge_feat.to(torch.float32))
    return mp_scatter_ref(msg, receivers, edge_mask & sent, n)


def fused_nt_scatter(x, w1, b1, w2, b2, senders, receivers, edge_mask,
                     edge_feat, *, node_tile: int = 32,
                     rows_per_block: Optional[int] = None) -> torch.Tensor:
    """out[i] = sum_{e: dst(e)=i} relu(MLP(x)[src(e)] + edge_feat[e]),
    (N, D) float32. N % node_tile == 0, as the reference asks. CPU tensors
    run the plain version; CUDA tensors launch the two kernels.
    ``rows_per_block`` overrides how many rows one block of each launch
    owns (the result does not depend on it)."""
    check_mlp(x, w1, b1, w2, b2)
    n = x.shape[0]
    e, d = senders.shape[0], w2.shape[1]
    if tuple(edge_feat.shape) != (e, d):
        raise ValueError(f"edge_feat must be (E, D) = {(e, d)}, got "
                         f"{tuple(edge_feat.shape)}")
    if n % node_tile:
        raise ValueError("pad N to node_tile")
    if x.device.type == "cpu":
        return fused_nt_scatter_ref(x, w1, b1, w2, b2, senders, receivers,
                                    edge_feat, edge_mask)
    if x.device.type != "cuda":
        raise ValueError(f"fused_nt_scatter runs on cpu or cuda, not "
                         f"{x.device}")
    return _launch(x, w1, b1, w2, b2, senders, receivers, edge_mask,
                   edge_feat, rows_per_block)


fused_nt_scatter.launches = 0


def _kernel():
    fn = build.load("fused_nt_scatter").fused_nt_scatter_launch
    if fn.argtypes is None:
        # without argtypes ctypes passes every int as a 32-bit C int:
        # pointers are cut and the stream slot holds garbage
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(x, w1, b1, w2, b2, senders, receivers, edge_mask, edge_feat,
            rows_per_block):
    dev = x.device
    n, d_in = x.shape
    d_ff, d = w2.shape
    e = senders.shape[0]
    if e * d >= 2 ** 31:
        raise ValueError("fused_nt_scatter indexes edges with int32")
    mlp = mlp_ptrs(x, w1, b1, w2, b2, rows_per_block)
    if edge_feat.dtype not in DTYPE_CODES:
        raise ValueError(f"edge_feat must be float32, bfloat16 or float16, "
                         f"not {edge_feat.dtype}")
    need = functools.partial(launch_ptr, dev)
    edges = (need(senders, "senders", torch.int64, (e,)),
             need(receivers, "receivers", torch.int64, (e,)),
             need(edge_mask, "edge_mask", torch.bool, (e,)),
             need(edge_feat, "edge_feat", edge_feat.dtype, (e, d)))
    # y is scratch, freed on return before the launches run; the caching
    # allocator hands its memory only to work queued later on this stream
    y = torch.empty((n, d), dtype=torch.float32, device=dev)
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    rows = rows_per_block or 0
    err = _kernel()(*mlp, *edges, y.data_ptr(), out.data_ptr(), n, e, d_in,
                    d_ff, d, DTYPE_CODES[x.dtype],
                    DTYPE_CODES[edge_feat.dtype], rows, rows,
                    torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_nt_scatter launch failed with CUDA error "
                           f"{err}")
    fused_nt_scatter.launches += 2 * int(n > 0)
    return out
