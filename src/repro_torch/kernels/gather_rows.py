"""The banked row gather of the MoE combine, with its plain PyTorch version.

The twin of ``repro/kernels/gather_rows.py``: ``out[i] = y[idx[i]]`` as
float32 for y (N, D) of any float dtype, with masked rows 0. The port keeps
the Pallas kernel's contract, not its oracle's: an unmasked index outside
[0, N) gives a zero row (no bank owns it there), where ``gather_rows_ref``
of the JAX package clips it to the nearest row.

``gather_rows`` takes its plain version ``gather_rows_ref`` for tensors on
the CPU. For CUDA tensors it launches the hand-written kernel
``csrc/gather_rows.cu`` (y float32 or bfloat16) or raises;
``gather_rows.launches`` counts those launches. For ``meta`` tensors (the
dry run) it makes the kernel's output and launches nothing; under an
active counter (``repro_torch/counter.py``) each call, on the card or on meta,
declares its launch and its work (``kernels/cost.py``). The tile knobs
(``idx_tile``, ``num_banks``) describe the TPU kernel's grid: the result
does not depend on them, but the reference's padding rules stand.

Gradients. Where autograd needs the graph (grad mode on and ``y``
requiring grad) ``gather_rows`` goes through ``GatherRowsFn``, whose
backward is the dual kernel: ``mp_scatter(dout, idx, mask, N)`` (masked
and out-of-range rows add nothing), cast to ``y.dtype``. Both directions
are owner computes, so the gradient is the same bits every run.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, cost
from repro_torch.kernels.mp_pipeline import launch_ptr
from repro_torch import counter

# the dtypes the CUDA kernel reads y in
CUDA_Y_DTYPES = (torch.float32, torch.bfloat16)


def gather_rows_ref(y: torch.Tensor, idx: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Plain version: f32 rows ``y[idx]`` where ``mask`` is set and the
    index lies in [0, N), zero rows elsewhere."""
    own = mask & (idx >= 0) & (idx < y.shape[0])
    rows = y[torch.where(own, idx, 0)].to(torch.float32)
    return torch.where(own[:, None], rows, 0.0)


def gather_rows(y: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor, *,
                idx_tile: int = 128, num_banks: int = 4) -> torch.Tensor:
    """out[i] = y[idx[i]] (masked or out-of-range rows 0), (S, D) float32.
    S % idx_tile == 0 and N % num_banks == 0, as the reference asks (pad
    at the call site). CPU tensors run ``gather_rows_ref``; CUDA tensors
    launch the kernel; meta tensors get its output."""
    if y.ndim != 2 or idx.ndim != 1 or mask.shape != idx.shape:
        raise ValueError(f"gather_rows expects y (N, D) and idx, mask (S,); "
                         f"got {tuple(y.shape)}, {tuple(idx.shape)}, "
                         f"{tuple(mask.shape)}")
    if idx.shape[0] % idx_tile or y.shape[0] % num_banks:
        raise ValueError("pad S to idx_tile and N to num_banks")
    if y.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"gather_rows runs on cpu, cuda or meta, not "
                         f"{y.device}")
    if torch.is_grad_enabled() and y.requires_grad:
        return GatherRowsFn.apply(y, idx, mask)
    return _gather(y, idx, mask)


gather_rows.launches = 0


def _gather(y, idx, mask):
    """``gather_rows``' value: the plain version on the CPU, one counted
    launch on the card."""
    if y.device.type == "cpu":
        return gather_rows_ref(y, idx, mask)
    return _launch(y, idx, mask)


class GatherRowsFn(torch.autograd.Function):
    """``gather_rows`` with its backward, ``mp_scatter`` of the output's
    gradient back to the rows of y."""

    @staticmethod
    def forward(ctx, y, idx, mask):
        ctx.save_for_backward(idx, mask)
        ctx.y_rows, ctx.y_dtype = y.shape[0], y.dtype
        return _gather(y, idx, mask)

    @staticmethod
    def backward(ctx, dout):
        from repro_torch.kernels.mp_scatter import mp_scatter
        idx, mask = ctx.saved_tensors
        dy = mp_scatter(dout.contiguous(), idx, mask, ctx.y_rows)
        return dy.to(ctx.y_dtype), None, None


def _kernel():
    fn = build.load("gather_rows").gather_rows_launch
    if fn.argtypes is None:
        # without argtypes ctypes passes every int as a 32-bit C int:
        # pointers are cut and the stream slot holds garbage
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(y, idx, mask):
    dev = y.device
    n, d = y.shape
    s = idx.shape[0]
    if y.dtype not in CUDA_Y_DTYPES:
        raise ValueError(f"y must be one of {CUDA_Y_DTYPES} on the card, got "
                         f"{y.dtype}")
    if d == 0:
        raise ValueError("y must have at least one column")
    if n * d >= 2 ** 31 or s * d >= 2 ** 31:
        raise ValueError("gather_rows indexes rows with int32")
    need = functools.partial(launch_ptr, dev)
    ptrs = (need(y, "y", y.dtype, (n, d)),
            need(idx, "idx", torch.int64, (s,)),
            need(mask, "mask", torch.bool, (s,)))
    out = torch.empty((s, d), dtype=torch.float32, device=dev)
    if counter.active():
        counter.note_kernel("gather_rows", *cost.gather_rows_work(
            s, d, y.element_size()), launches=int(s > 0))
    if dev.type == "meta":
        return out
    err = _kernel()(*ptrs, out.data_ptr(), n, s, d,
                    int(y.dtype == torch.bfloat16),
                    torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather_rows launch failed with CUDA error {err}")
    build.count_launches(gather_rows, int(s > 0))
    return out
