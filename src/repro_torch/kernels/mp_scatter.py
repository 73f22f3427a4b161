"""The scatter of a materialised edge stream, with its plain PyTorch versions.

The twin of ``repro/kernels/mp_scatter.py``. Given per-edge messages
``msg`` (E, D), destinations ``receivers`` (E,) and ``edge_mask`` (E,):

  * ``mp_scatter`` sums the unmasked edges' rows per destination,
    accumulating in float32 and returning (N, D) in ``msg.dtype``;
  * ``mp_scatter_multi`` feeds several float32 accumulators from one sweep
    (``MULTI_STATS``): ``sum``, ``sumsq``, ``count`` (N, 1), ``max`` and
    ``min``, whose empty destinations hold -inf and +inf.

Edges whose receiver lies outside [0, N) add nothing, masked or not, as
in the JAX kernels and oracles (the MoE dispatch points its dropped
assignments one past the buffer).

The tile knobs (``node_tile``, ``edge_tile``, ``num_banks``) describe the
TPU kernels' grids; they are accepted and the result does not depend on
them. Each wrapper takes its plain version (``mp_scatter_ref``,
``mp_scatter_multi_ref``) for tensors on the CPU. For CUDA tensors it
launches the hand-written kernel ``csrc/mp_scatter.cu`` or raises; its
``.launches`` counts those launches: one cooperative launch a call, which
buckets the edges by owner and folds each row's edges in stream order
(bitwise a float32 stream-order fold). On the card the messages are
float32 or bfloat16 (read as such, accumulated in float32);
``mp_scatter`` writes bfloat16 sums itself, rounded to nearest even. The
wrapper allocates the kernel's int32 scratch (``counts`` (N), ``row_start``
(N + 1), ``order`` (E), one ``torch.empty``); the kernel clears it.

Gradients. Where autograd needs the graph (grad mode on and ``msg``
requiring grad) ``mp_scatter`` goes through ``MpScatterFn``, whose backward
is the dual kernel: the gradient of the messages is
``gather_rows(dout, receivers, edge_mask)`` (a masked or out-of-range edge
gets a zero row) cast to ``msg.dtype``, as the reference differentiates
the MoE's ``.at[slot].set`` and ``.at[st].add`` (``repro/nn/moe.py``). The
owner computes in both directions, so the gradient is deterministic too.
``mp_scatter_multi`` has no backward (no training path reaches it): on a
CUDA tensor that requires grad under grad mode it raises rather than
return a result autograd cannot follow.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mp_pipeline import (launch_ptr, no_backward,
                                             owned_stream, seg_extreme_rows,
                                             seg_sum_rows)

# Statistic names in the fixed output order of mp_scatter_multi.
MULTI_STATS = ("sum", "sumsq", "count", "max", "min")


# the dtypes the CUDA kernels read messages in
CUDA_MSG_DTYPES = (torch.float32, torch.bfloat16)


def mp_scatter_ref(msg: torch.Tensor, receivers: torch.Tensor,
                   edge_mask: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """Masked scatter-sum of per-edge messages into per-node rows (f32)."""
    own, rcv = owned_stream(receivers, edge_mask, num_nodes)
    return seg_sum_rows(
        torch.where(own[:, None], msg, 0.0).to(torch.float32), rcv,
        num_nodes)


def mp_scatter_multi_ref(msg: torch.Tensor, receivers: torch.Tensor,
                         edge_mask: torch.Tensor, num_nodes: int,
                         stats) -> Dict[str, torch.Tensor]:
    """Plain version of the multi-statistic sweep: raw f32 accumulators
    keyed by name in ``MULTI_STATS`` order; max / min of empty destinations
    are -inf / +inf, as the kernel's."""
    m32 = msg.to(torch.float32)
    own, receivers = owned_stream(receivers, edge_mask, num_nodes)
    own = own[:, None]
    zero = torch.where(own, m32, 0.0)
    out = {}
    if "sum" in stats:
        out["sum"] = seg_sum_rows(zero, receivers, num_nodes)
    if "sumsq" in stats:
        out["sumsq"] = seg_sum_rows(zero * zero, receivers, num_nodes)
    if "count" in stats:
        out["count"] = seg_sum_rows(own.to(torch.float32), receivers,
                                    num_nodes)
    if "max" in stats:
        out["max"] = seg_extreme_rows(m32, own, receivers, num_nodes,
                                      -torch.inf, "amax")
    if "min" in stats:
        out["min"] = seg_extreme_rows(m32, own, receivers, num_nodes,
                                      torch.inf, "amin")
    return out


def _check_msg(msg: torch.Tensor, what: str) -> None:
    if msg.ndim != 2:
        raise ValueError(f"{what} expects (E, D) messages, got "
                         f"{tuple(msg.shape)}")
    if msg.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {msg.device}")


def mp_scatter(msg: torch.Tensor, receivers: torch.Tensor,
               edge_mask: torch.Tensor, num_nodes: int, *,
               node_tile: int = 8, edge_tile: int = 128, num_banks: int = 4,
               rows_per_block: Optional[int] = None) -> torch.Tensor:
    """Scatter-sum ``msg`` (E, D) into (num_nodes, D) over the unmasked
    edges; f32 accumulation, the result in ``msg.dtype``. CPU tensors run
    ``mp_scatter_ref``; CUDA tensors launch the kernel. ``rows_per_block``
    overrides how many destination rows one CUDA block takes per step of
    the accumulate phase (the kernel's own choice by default; the result
    does not depend on it)."""
    _check_msg(msg, "mp_scatter")
    if torch.is_grad_enabled() and msg.requires_grad:
        return MpScatterFn.apply(msg, receivers, edge_mask, num_nodes,
                                 rows_per_block)
    return _scatter_sum(msg, receivers, edge_mask, num_nodes, rows_per_block)


mp_scatter.launches = 0


def _scatter_sum(msg, receivers, edge_mask, num_nodes, rows_per_block):
    """``mp_scatter``'s value: the plain version on the CPU, one counted
    launch on the card."""
    if msg.device.type == "cpu":
        return mp_scatter_ref(msg, receivers, edge_mask,
                              num_nodes).to(msg.dtype)
    out = _launch(msg, receivers, edge_mask, num_nodes, ("sum",),
                  rows_per_block, multi=False)["sum"]
    build.count_launches(mp_scatter, int(num_nodes > 0))
    return out


class MpScatterFn(torch.autograd.Function):
    """``mp_scatter`` with its backward, ``gather_rows`` of the output's
    gradient at the receivers."""

    @staticmethod
    def forward(ctx, msg, receivers, edge_mask, num_nodes, rows_per_block):
        ctx.save_for_backward(receivers, edge_mask)
        ctx.msg_dtype = msg.dtype
        return _scatter_sum(msg, receivers, edge_mask, num_nodes,
                            rows_per_block)

    @staticmethod
    def backward(ctx, dout):
        from repro_torch.kernels.gather_rows import gather_rows
        receivers, edge_mask = ctx.saved_tensors
        dmsg = gather_rows(dout.contiguous(), receivers, edge_mask,
                           idx_tile=1, num_banks=1)
        return dmsg.to(ctx.msg_dtype), None, None, None, None


def mp_scatter_multi(msg: torch.Tensor, receivers: torch.Tensor,
                     edge_mask: torch.Tensor, num_nodes: int, *, stats,
                     node_tile: int = 8, edge_tile: int = 128,
                     num_banks: int = 4,
                     rows_per_block: Optional[int] = None
                     ) -> Dict[str, torch.Tensor]:
    """One sweep over the edge stream feeding the ``stats`` accumulators (a
    subset of ``MULTI_STATS``). Returns ``{name: f32 tensor}`` in
    ``MULTI_STATS`` order: sum / sumsq / max / min (num_nodes, D), count
    (num_nodes, 1); max / min of empty destinations are -inf / +inf. CPU
    tensors run ``mp_scatter_multi_ref``; CUDA tensors launch the
    kernel."""
    stats = tuple(s for s in MULTI_STATS if s in stats)
    if not stats:
        raise ValueError("stats must name at least one accumulator")
    _check_msg(msg, "mp_scatter_multi")
    no_backward("mp_scatter_multi", msg)
    if msg.device.type == "cpu":
        return mp_scatter_multi_ref(msg, receivers, edge_mask, num_nodes,
                                    stats)
    out = _launch(msg, receivers, edge_mask, num_nodes, stats,
                  rows_per_block, multi=True)
    build.count_launches(mp_scatter_multi, int(num_nodes > 0))
    return out


mp_scatter_multi.launches = 0


def _kernel(multi: bool):
    lib = build.load("mp_scatter")
    fn = lib.mp_scatter_multi_launch if multi else lib.mp_scatter_launch
    if fn.argtypes is None:
        # without argtypes ctypes passes every int as a 32-bit C int:
        # pointers are cut and the stream slot holds garbage
        outs = 5 if multi else 1
        fn.argtypes = ([ctypes.c_void_p] * (3 + outs) + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
    return fn


def launch_plan(num_nodes: int, num_edges: int, d: int, dtype, *,
                multi: bool, rows_per_block: Optional[int] = None) -> dict:
    """How the kernel launches these sizes on the current CUDA device:
    ``grid`` (blocks of the cooperative launch, chosen from E, N and D, at
    most every block the card holds at once), ``rows`` (rows a block takes
    per step) and ``buckets`` ("block" when each block buckets the edges
    of its own rows in shared memory, "grid" when the grid buckets them
    all in the scratch, between grid barriers)."""
    fn = build.load("mp_scatter").mp_scatter_plan
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)] * 3
        fn.restype = ctypes.c_int
    grid, rows, local = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = fn(num_nodes, num_edges, d, rows_per_block or 0,
             int(dtype == torch.bfloat16), int(multi), ctypes.byref(grid),
             ctypes.byref(rows), ctypes.byref(local))
    if err != 0:
        raise RuntimeError(f"mp_scatter_plan failed with CUDA error {err}")
    return {"grid": grid.value, "rows": rows.value,
            "buckets": "block" if local.value else "grid"}


def _launch(msg, receivers, edge_mask, num_nodes, stats, rows_per_block, *,
            multi):
    dev = msg.device
    e, d = msg.shape
    if d == 0:
        raise ValueError("messages must have at least one lane")
    if e >= 2 ** 31 or num_nodes * d >= 2 ** 31:
        raise ValueError("mp_scatter indexes edges and node rows with int32")
    if rows_per_block is not None and rows_per_block < 1:
        raise ValueError("rows_per_block must be >= 1")
    if msg.dtype not in CUDA_MSG_DTYPES:
        raise ValueError(f"msg must be one of {CUDA_MSG_DTYPES} on the card, "
                         f"got {msg.dtype}")
    f32 = torch.float32
    need = functools.partial(launch_ptr, dev)
    ptrs = (need(msg, "msg", msg.dtype, (e, d)),
            need(receivers, "receivers", torch.int64, (e,)),
            need(edge_mask, "edge_mask", torch.bool, (e,)))
    widths = {"sum": d, "sumsq": d, "count": 1, "max": d, "min": d}
    # the multi sweep returns raw f32 accumulators; the sum alone comes
    # back in the messages' dtype, as the reference's mp_scatter
    out = {s: torch.empty((num_nodes, widths[s]),
                          dtype=f32 if multi else msg.dtype, device=dev)
           for s in stats}
    outs = ([out[s].data_ptr() if s in out else None for s in MULTI_STATS]
            if multi else [out["sum"].data_ptr()])
    # the owner buckets, in one allocation: per-row counts (N), their scan
    # (N + 1), the edges by row (E)
    scratch = torch.empty(2 * num_nodes + 1 + e, dtype=torch.int32,
                          device=dev)
    base = scratch.data_ptr()
    err = _kernel(multi)(*ptrs, *outs, num_nodes, e, d, rows_per_block or 0,
                         int(msg.dtype == torch.bfloat16), base,
                         base + 4 * num_nodes, base + 4 * (2 * num_nodes + 1),
                         torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        name = "mp_scatter_multi" if multi else "mp_scatter"
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    return out
