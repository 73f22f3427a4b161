"""The model and FSDP axes inside a ``shard_map``'d step.

The reference leaves its tensor, sequence and vocab parallelism to GSPMD:
inside ``jit`` the rule table places every activation and XLA inserts the
collectives. The port has no compiler to do that, so each layer of a
serving step on a mesh (``launch/steps.py``) holds its local pieces, as
``param_specs(..., rules)`` split them, and calls the collective where
GSPMD would put one (Megatron's schedule):

  * a column piece of a weight (``heads``, ``kv_heads``, ``ff``,
    ``vocab``, ``experts`` on the model axis) computes its own columns and
    needs nothing;
  * a row piece's product is a partial sum: added over the axis in
    float32 and cast once (``reduce_partial``), by ``psum`` where the
    residual is whole, by ``psum_scatter`` over the sequence where it is
    split by sequence (``seq_sp``);
  * a residual split by sequence is ``all_gather``ed over it before the
    projections (``gather_seq``);
  * an activation split by a rule where the weights are whole (Mamba2's
    ``ssm_heads``) is cut to the position's block (``own_rows``), and one
    whose next product needs it whole (the SSD's output, the RG-LRU's
    conv before the gates) is ``all_gather``ed (``gather_dim``);
  * a weight split over a data axis (FSDP: ``embed_fsdp``, ``expert_ff``)
    is ``all_gather``ed over it just before its product and dropped after
    (``gather_fsdp``), as the reference's ``_mlp_sp_shardmap`` and
    ``moe_ffn`` do and GSPMD does for attention and the embeddings.

The same code serves the training step: each collective's transpose
(``distributed/collectives.py``) is the backward of its use here, so the
gather of a split residual returns its cotangent by ``psum_scatter``, a
row piece's ``psum_scatter`` by ``all_gather``, a ``psum`` by ``psum``,
and an FSDP weight's gather reduce-scatters its gradient over the data
axes. These helpers run inside a position of ``shard_map``; without a
mesh they are identities.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.distributed.collectives import (all_gather, axis_index,
                                                 axis_size, psum,
                                                 psum_scatter)
from repro_torch.distributed.sharding import (Mesh, MeshAxis, ShardingRules,
                                              axis_names_of)


def split_axis(rules: Optional[ShardingRules], mesh: Optional[Mesh],
               logical: str) -> MeshAxis:
    """The mesh axis (or axes) ``rules`` split the logical axis over on
    ``mesh``; ``None`` where it is whole (no mesh, no rule, or an axis of
    size 1)."""
    if mesh is None or rules is None:
        return None
    ax = rules.axis(logical)
    return ax if ax is not None and mesh.axis_sizes(ax) > 1 else None


def residual_rules(rules: Optional[ShardingRules], mesh: Optional[Mesh],
                   seq_len: int) -> Optional[ShardingRules]:
    """``rules`` for a forward over ``seq_len`` tokens: the residual stays
    split by sequence (``seq_sp``) only where the length is above 1 and
    its axis divides it; otherwise it is whole on every position (the
    reference's GSPMD pads instead; the numbers do not depend on the
    layout)."""
    sp = split_axis(rules, mesh, "seq_sp")
    if sp is None or (seq_len > 1 and seq_len % mesh.axis_sizes(sp) == 0):
        return rules
    table = dict(rules.table)
    table["seq_sp"] = None
    return ShardingRules(table=table)


def own_rows(x: torch.Tensor, axis: MeshAxis, dim: int = 1) -> torch.Tensor:
    """This position's block of ``x``'s dimension ``dim`` (the sequence by
    default) over ``axis``; ``x`` itself without one."""
    if axis is None:
        return x
    size = x.shape[dim] // axis_size(axis)
    return x.narrow(dim, axis_index(axis) * size, size).contiguous()


def gather_dim(x: torch.Tensor, axis: MeshAxis, dim: int) -> torch.Tensor:
    """The whole of ``x``'s dimension ``dim`` where it is split over
    ``axis`` (each position its block, in index order); ``x`` itself
    without one."""
    return x if axis is None else all_gather(x, axis, axis=dim, tiled=True)


def gather_seq(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """The whole sequence (dimension 1) of a residual split over ``axis``;
    ``x`` itself without one."""
    return gather_dim(x, axis, 1)


def gather_fsdp(w: torch.Tensor, dim: int, axis: MeshAxis) -> torch.Tensor:
    """The whole of a weight's dimension ``dim`` where FSDP splits it over
    the data axis (or axes) ``axis`` (``w`` itself without one)."""
    return gather_dim(w, axis, dim)


class _Float32Product(torch.autograd.Function):
    """``h2 @ w`` of 16-bit operands on the card with a float32 result
    (cuBLAS through ``mm``'s ``out_dtype`` overload, which has no
    derivative). The backward takes the cotangent in the operands' dtype,
    as autograd of their 16-bit product would receive it."""

    @staticmethod
    def forward(ctx, h2, w):
        ctx.save_for_backward(h2, w)
        return torch.ops.aten.mm.dtype(h2, w, torch.float32)

    @staticmethod
    def backward(ctx, g):
        h2, w = ctx.saved_tensors
        g = g.to(h2.dtype)
        return (g @ w.T if ctx.needs_input_grad[0] else None,
                h2.T @ g if ctx.needs_input_grad[1] else None)


def float32_product(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``h @ w`` (h (..., k), w (k, n)) with a float32 result: a row
    piece's partial sum before it is added over the axis, so that it is
    rounded once, after the sum, as the whole product is. 16-bit operands
    on the card go through cuBLAS with a float32 output (``mm``'s
    ``out_dtype`` overload, ``_Float32Product`` under grad), and so do
    meta ones, which plan the card's ops (``repro_torch/counter.py``);
    elsewhere they are widened first."""
    if h.dtype == torch.float32 and w.dtype == torch.float32:
        return h @ w
    h2 = h.reshape(-1, h.shape[-1])
    if h.is_cuda or h.is_meta:
        out = _Float32Product.apply(h2, w)
    else:
        out = h2.to(torch.float32) @ w.to(torch.float32)
    return out.reshape(*h.shape[:-1], w.shape[-1])


def reduce_partial(out: torch.Tensor, axis: MeshAxis, seq_axis: MeshAxis,
                   dtype: torch.dtype) -> torch.Tensor:
    """A row piece's product ``out`` (B, S, d), a partial sum over
    ``axis``, added over it in float32 (position order) and cast once to
    ``dtype``: ``psum`` where the residual is whole, ``psum_scatter`` over
    the sequence where it is split over ``seq_axis`` (each position its
    rows). Without ``axis`` the product is whole: each position keeps its
    rows."""
    if axis is None:
        return own_rows(out, seq_axis).to(dtype)
    part = out.to(torch.float32)
    if seq_axis is None:
        part = psum(part, axis)
    elif axis_names_of(seq_axis) != axis_names_of(axis):
        raise NotImplementedError(
            f"a partial sum over {axis!r} scattered over a sequence split "
            f"over {seq_axis!r}: the rule tables put both on the model "
            f"axis")
    else:
        part = psum_scatter(part, axis, scatter_dimension=1)
    return part.to(dtype)


def row_parallel(h: torch.Tensor, w: torch.Tensor, axis: MeshAxis,
                 seq_axis: MeshAxis, dtype: torch.dtype) -> torch.Tensor:
    """``h @ w`` where ``w`` is a row piece over ``axis`` (whole without
    one): the partial sum with a float32 result (``float32_product``),
    added over the axis and cast once (``reduce_partial``)."""
    out = h @ w if axis is None else float32_product(h, w)
    return reduce_partial(out, axis, seq_axis, dtype)


def global_batch(local: int, rules: Optional[ShardingRules],
                 mesh: Optional[Mesh]) -> int:
    """The global batch of a position's ``local`` rows."""
    ax = split_axis(rules, mesh, "batch")
    return local * (mesh.axis_sizes(ax) if ax is not None else 1)


__all__ = ["float32_product", "gather_dim", "gather_fsdp", "gather_seq",
           "global_batch", "own_rows", "reduce_partial", "residual_rules",
           "row_parallel", "split_axis"]
