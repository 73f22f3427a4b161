"""Causal LM wrapper: embeddings, stack, prefill and decode steps.

The twin of ``repro/models/lm.py`` for every assigned architecture through
``ModelConfig``: dense (qwen, deepseek, gemma2, llama3), the VLM and audio
backbones (``prefix_embed``, whose front ends are stubs in the JAX package
too), MoE (olmoe, arctic), SSM (mamba2) and hybrid (recurrentgemma). The
parameter tree has the JAX nesting and shapes (``lm_param_defs``).
``forward`` returns the reference's three values, the MoE aux loss last.
The training loss is not ported yet (ROADMAP, "The rest of the LM
substrate").
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import DeviceLike
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import ParamDef
from repro_torch.nn.layers import sinusoidal_pos, softcap
from repro_torch.nn.transformer import (apply_norm, norm_defs, stack_apply,
                                        stack_cache_defs, stack_param_defs)


def lm_param_defs(cfg: ModelConfig) -> Dict[str, Any]:
    d, v = cfg.d_model, cfg.vocab_pad
    defs: Dict[str, Any] = {
        "embed": ParamDef((v, d), scale=d ** -0.5, dtype=cfg.dtype),
        "stack": stack_param_defs(cfg),
        "final_norm": norm_defs(cfg),
    }
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((d, v), dtype=cfg.dtype)
    return defs


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Random weights by the JAX package's init rule
    (``distributed/sharding.py::init_one``), drawn from ``generator``."""
    return sharding.init_params(generator, lm_param_defs(cfg), device)


def _embed(params, tokens: torch.Tensor, cfg: ModelConfig,
           prefix_embed: Optional[torch.Tensor]) -> torch.Tensor:
    # the JAX package's one-hot lookup serves a vocab-sharded table on a TPU
    # mesh; on one device it takes jnp.take, as this index gather does
    x = params["embed"][tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    if prefix_embed is not None and cfg.prefix_len:
        x[:, :prefix_embed.shape[1]] = prefix_embed.to(x.dtype)
    return x


def _mask_pad_vocab(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.vocab_pad == cfg.vocab_size:
        return logits
    valid = torch.arange(cfg.vocab_pad, device=logits.device) < cfg.vocab_size
    return torch.where(valid, logits,
                       torch.tensor(-1e30, dtype=logits.dtype,
                                    device=logits.device))


def _unembed(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = x @ params["unembed"]
    return _mask_pad_vocab(softcap(logits, cfg.final_softcap), cfg)


def forward_hidden(params, tokens: torch.Tensor, cfg: ModelConfig, *,
                   prefix_embed: Optional[torch.Tensor] = None,
                   positions: Optional[torch.Tensor] = None,
                   caches=None) -> Tuple[torch.Tensor, Any, torch.Tensor]:
    """tokens: (B, S) -> (hidden (B, S, d), new_caches, aux_loss () float32,
    summed over the layers)."""
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device).expand(b, s)
    x = _embed(params, tokens, cfg, prefix_embed)
    if cfg.pos == "sinusoidal":
        x = x + sinusoidal_pos(positions, cfg.d_model).to(x.dtype)
    x, new_caches, aux = stack_apply(params["stack"], x, positions, cfg,
                                     caches=caches)
    x = apply_norm(params["final_norm"], x, cfg)
    return x, new_caches, aux


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, *,
            prefix_embed: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            caches=None) -> Tuple[torch.Tensor, Any, torch.Tensor]:
    """tokens: (B, S) -> (logits (B, S, V), new_caches, aux_loss)."""
    x, new_caches, aux = forward_hidden(
        params, tokens, cfg, prefix_embed=prefix_embed, positions=positions,
        caches=caches)
    return _unembed(params, x, cfg), new_caches, aux


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def lm_cache_defs(cfg: ModelConfig, batch: int, max_len: int):
    return stack_cache_defs(cfg, batch, max_len)


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device: DeviceLike = None):
    """Empty caches for ``batch`` sequences of up to ``max_len`` tokens (K/V,
    SSM or recurrent state and conv windows by block kind): zeros stacked
    as the parameters are, length 0."""
    return sharding.zeros_like_defs(lm_cache_defs(cfg, batch, max_len),
                                    device)


def prefill(params, tokens: torch.Tensor, caches, cfg: ModelConfig, *,
            prefix_embed: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Any]:
    """Fill caches from a prompt; return (last-position logits, caches)."""
    logits, new_caches, _ = forward(params, tokens, cfg,
                                    prefix_embed=prefix_embed,
                                    caches=caches)
    return logits[:, -1], new_caches


def decode_step(params, token: torch.Tensor, caches, cfg: ModelConfig, *,
                position: int) -> Tuple[torch.Tensor, Any]:
    """One decode step. token: (B, 1); ``position`` is the number of tokens
    already in the cache."""
    b = token.shape[0]
    positions = torch.full((b, 1), position, dtype=torch.int32,
                           device=token.device)
    logits, new_caches, _ = forward(params, token, cfg,
                                    positions=positions, caches=caches)
    return logits[:, -1], new_caches
