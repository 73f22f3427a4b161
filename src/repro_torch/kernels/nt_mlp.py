"""The FlowGNN NT unit (a node tile's two-layer MLP), with its plain PyTorch
version.

The twin of ``repro/kernels/nt_mlp.py``: ``y = relu(x @ w1 + b1) @ w2 + b2``
for x (N, D_in), w1 (D_in, D_ff), w2 (D_ff, D_out), computed in float32
and returned in ``x.dtype``, with the hidden tile kept on chip.

x and the weights share one dtype (``ValueError`` otherwise, on every
device). ``nt_mlp`` takes its plain version ``nt_mlp_ref`` for tensors on
the CPU (any float dtype). For CUDA tensors it launches the hand-written
kernel ``csrc/nt_mlp.cu`` (float32, bfloat16 or float16, widened to float32
inside; the result rounded to nearest even into ``x.dtype``) or raises;
``nt_mlp.launches`` counts those launches. The tile knobs (``node_tile``,
``k_tile``) describe the TPU kernel's grid: the result does not depend on
them, but the reference's padding rules stand.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mp_pipeline import launch_ptr


def nt_mlp_ref(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
               w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Node transformation: 2-layer MLP with ReLU, in float32 (the f32
    result, as the reference's oracle)."""
    f32 = torch.float32
    h = torch.relu(x.to(f32) @ w1.to(f32) + b1.to(f32))
    return h @ w2.to(f32) + b2.to(f32)


# the operand types the NT kernels take, by the code their C entry points
# take (nt_tile.cuh's Dtype)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def check_mlp(x, w1, b1, w2, b2) -> None:
    """The shapes of one MLP's operands, and their one dtype
    (``ValueError``)."""
    for name, t in (("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        if t.dtype != x.dtype:
            raise ValueError(f"the MLP's operands must share x's dtype "
                             f"{x.dtype}; {name} is {t.dtype}")
    if x.ndim != 2:
        raise ValueError(f"x must be (N, D_in), got {tuple(x.shape)}")
    d_in, d_ff = x.shape[1], w1.shape[-1]
    if (tuple(w1.shape) != (d_in, d_ff) or tuple(b1.shape) != (d_ff,)
            or w2.ndim != 2 or w2.shape[0] != d_ff
            or tuple(b2.shape) != (w2.shape[1],)):
        raise ValueError(
            f"MLP shapes do not chain: x {tuple(x.shape)}, w1 "
            f"{tuple(w1.shape)}, b1 {tuple(b1.shape)}, w2 {tuple(w2.shape)}, "
            f"b2 {tuple(b2.shape)}")


def nt_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
           w2: torch.Tensor, b2: torch.Tensor, *, node_tile: int = 128,
           k_tile: int = 128,
           rows_per_block: Optional[int] = None) -> torch.Tensor:
    """y = relu(x @ w1 + b1) @ w2 + b2 in ``x.dtype``, float32 inside; x
    and the weights of one dtype. N % node_tile == 0 and D_in % k_tile == 0,
    as the reference asks (pad at the call site). CPU tensors run
    ``nt_mlp_ref``; CUDA tensors launch the kernel. ``rows_per_block``
    overrides how many node rows one CUDA block owns (the result does not
    depend on it)."""
    check_mlp(x, w1, b1, w2, b2)
    n, d_in = x.shape
    if n % node_tile or d_in % k_tile:
        raise ValueError("pad N to node_tile and D_in to k_tile")
    if x.device.type == "cpu":
        return nt_mlp_ref(x, w1, b1, w2, b2).to(x.dtype)
    if x.device.type != "cuda":
        raise ValueError(f"nt_mlp runs on cpu or cuda, not {x.device}")
    return _launch(x, w1, b1, w2, b2, rows_per_block)


nt_mlp.launches = 0


def mlp_ptrs(x, w1, b1, w2, b2, rows_per_block):
    """The data pointers of the MLP's operands for a launch, after the
    checks the kernel cannot make: everything of x's dtype (float32,
    bfloat16 or float16) and contiguous on x's device (``ValueError``)."""
    n, d_in = x.shape
    d_ff, d_out = w2.shape
    if 0 in (d_in, d_ff, d_out):
        raise ValueError("the MLP's widths must be at least 1")
    if n * max(d_in, d_ff, d_out) >= 2 ** 31:
        raise ValueError("the NT kernels index rows with int32")
    if rows_per_block is not None and rows_per_block < 1:
        raise ValueError("rows_per_block must be >= 1")
    dt = x.dtype
    if dt not in DTYPE_CODES:
        raise ValueError(f"the NT kernels take float32, bfloat16 or float16, "
                         f"not {dt}")
    need = functools.partial(launch_ptr, x.device)
    return (need(x, "x", dt, (n, d_in)), need(w1, "w1", dt, (d_in, d_ff)),
            need(b1, "b1", dt, (d_ff,)), need(w2, "w2", dt, (d_ff, d_out)),
            need(b2, "b2", dt, (d_out,)))


def _kernel():
    fn = build.load("nt_mlp").nt_mlp_launch
    if fn.argtypes is None:
        # without argtypes ctypes passes every int as a 32-bit C int:
        # pointers are cut and the stream slot holds garbage
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(x, w1, b1, w2, b2, rows_per_block):
    ptrs = mlp_ptrs(x, w1, b1, w2, b2, rows_per_block)
    n, d_in = x.shape
    d_ff, d_out = w2.shape
    out = torch.empty((n, d_out), dtype=x.dtype, device=x.device)
    err = _kernel()(*ptrs, out.data_ptr(), n, d_in, d_ff, d_out,
                    DTYPE_CODES[x.dtype], rows_per_block or 0,
                    torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"nt_mlp launch failed with CUDA error {err}")
    nt_mlp.launches += int(n > 0)
    return out
