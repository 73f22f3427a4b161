"""Feed-forward blocks: gated (SwiGLU/GeGLU) and plain MLP.

The twin of ``repro/nn/mlp.py``. The products are ``torch.matmul``, as the
JAX package leaves them to XLA; its hand-scheduled sequence-parallel form
(``_mlp_sp_shardmap``) is a TPU mesh schedule with no counterpart on one
GPU.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import ParamDef
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


def mlp(params: Dict[str, torch.Tensor], x: torch.Tensor,
        cfg: ModelConfig) -> torch.Tensor:
    act = activation(cfg.act)
    up = x @ params["w_up"]
    if "w_gate" in params:
        h = act(x @ params["w_gate"]) * up
    else:
        h = act(up)
    return h @ params["w_down"]
