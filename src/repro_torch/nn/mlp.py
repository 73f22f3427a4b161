"""Feed-forward blocks: gated (SwiGLU/GeGLU) and plain MLP.

The twin of ``repro/nn/mlp.py``. The products are ``torch.matmul``, as the
JAX package leaves them to XLA.

On a mesh (``rules`` / ``mesh``, inside a position of a serving or
training step's ``shard_map``) a position holds column pieces of
``w_gate`` / ``w_up`` and a row piece of ``w_down`` (``ff`` on the model
axis); under FSDP their ``embed_fsdp`` dimension is split over the data
axes too and gathered just before the products, as
``_mlp_sp_shardmap`` does (``gather_fsdp``). Where the residual
is whole, the local FFN's product is ``psum``med over the axis in
float32. Where it is split by sequence (a prefill), ``mlp`` runs the
reference's Megatron-SP schedule (``_mlp_sp_shardmap``): ``all_gather``
over the sequence, the local FFN, ``psum_scatter`` back to each
position's rows. The reference takes that form under its own condition
(``cfg.sp_shardmap_mlp``, a gated MLP, S > 1, ``seq_sp`` set) and leaves
other split residuals to GSPMD, whose gather and reduction give the same
numbers; the port takes it for every split residual.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (Mesh, ParamDef, ShardingRules,
                                              logical_constraint)
from repro_torch.distributed.tensor_parallel import (gather_fsdp, gather_seq,
                                                     global_batch,
                                                     row_parallel, split_axis)
from repro_torch.nn.layers import activation


def mlp_param_defs(cfg: ModelConfig, *, gated: bool = True,
                   d_ff: int = 0) -> Dict[str, ParamDef]:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    defs = {
        "w_up": ParamDef((d, ff), ("embed_fsdp", "ff"), dtype=cfg.dtype),
        "w_down": ParamDef((ff, d), ("ff", "embed_fsdp"), dtype=cfg.dtype),
    }
    if gated:
        defs["w_gate"] = ParamDef((d, ff), ("embed_fsdp", "ff"),
                                  dtype=cfg.dtype)
    return defs


def _ffn(params: Dict[str, torch.Tensor], x: torch.Tensor,
         cfg: ModelConfig, ef=None) -> torch.Tensor:
    """The FFN's hidden layer (before ``w_down``); ``ef``: the data axes
    FSDP splits the weights' rows over."""
    act = activation(cfg.act)
    up = x @ gather_fsdp(params["w_up"], 0, ef)
    if "w_gate" in params:
        return act(x @ gather_fsdp(params["w_gate"], 0, ef)) * up
    return act(up)


def mlp(params: Dict[str, torch.Tensor], x: torch.Tensor,
        cfg: ModelConfig, *, rules: Optional[ShardingRules] = None,
        mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The FFN. On a mesh, where the residual is split by sequence,
    Megatron-SP: all-gather(seq) -> local FFN -> reduce-scatter(seq) (the
    reference's ``_mlp_sp_shardmap``); without a mesh every axis is whole
    and nothing is gathered or added."""
    sp = split_axis(rules, mesh, "seq_sp")
    ff_ax = split_axis(rules, mesh, "ff")
    ef = split_axis(rules, mesh, "embed_fsdp")
    h = _ffn(params, gather_seq(x, sp), cfg, ef)
    h = logical_constraint(
        h, "batch", "seq", "act_ff", rules=rules, mesh=mesh,
        shape=(global_batch(x.shape[0], rules, mesh), h.shape[1],
               h.shape[2] * (mesh.axis_sizes(ff_ax) if ff_ax else 1)))
    return row_parallel(h, gather_fsdp(params["w_down"], 1, ef), ff_ax, sp,
                        x.dtype)
