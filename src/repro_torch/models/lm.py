"""Causal LM wrapper: embeddings, stack, prefill and decode steps.

The twin of ``repro/models/lm.py`` for every assigned architecture through
``ModelConfig``: dense (qwen, deepseek, gemma2, llama3), the VLM and audio
backbones (``prefix_embed``, whose front ends are stubs in the JAX package
too), MoE (olmoe, arctic), SSM (mamba2) and hybrid (recurrentgemma). The
parameter tree has the JAX nesting and shapes (``lm_param_defs``).
``forward`` returns the reference's three values, the MoE aux loss last.
``lm_loss`` is the training loss: next-token cross-entropy over sequence
chunks, each under ``torch.utils.checkpoint`` so that the (B, S, V)
logits never exist whole, plus the z-loss and the router's aux loss.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import DeviceLike
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import ParamDef
from repro_torch.nn.layers import needs_grad, sinusoidal_pos, softcap
from repro_torch.nn.transformer import (apply_norm, norm_defs, stack_apply,
                                        stack_cache_defs, stack_param_defs)


def lm_param_defs(cfg: ModelConfig) -> Dict[str, Any]:
    d, v = cfg.d_model, cfg.vocab_pad
    defs: Dict[str, Any] = {
        "embed": ParamDef((v, d), ("vocab", "embed_fsdp"), scale=d ** -0.5,
                          dtype=cfg.dtype),
        "stack": stack_param_defs(cfg),
        "final_norm": norm_defs(cfg),
    }
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((d, v), ("embed_fsdp", "vocab"),
                                   dtype=cfg.dtype)
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
                   caches=None, token_shards=None
                   ) -> Tuple[torch.Tensor, Any, torch.Tensor]:
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
                                     caches=caches,
                                     token_shards=token_shards)
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


def _chunk_loss(xc: torch.Tensor, lc: torch.Tensor, mc: torch.Tensor,
                unembed: torch.Tensor, cfg: ModelConfig):
    """(sum of masked next-token NLL, sum of (lse * mask)^2) over one
    sequence chunk: xc (B, T, d), labels lc (B, T), mask mc (B, T) float32.
    The logits stay in the model's dtype; float32 appears inside the
    reductions, as in the reference."""
    logits = xc @ unembed.T if cfg.tie_embeddings else xc @ unembed
    logits = _mask_pad_vocab(softcap(logits, cfg.final_softcap), cfg)
    m = logits.detach().amax(dim=-1, keepdim=True).to(torch.float32)
    sumexp = torch.exp(logits.to(torch.float32) - m).sum(dim=-1)
    lse = m[..., 0] + torch.log(sumexp)
    ll = torch.gather(logits, -1, lc[..., None].long())[..., 0].to(
        torch.float32)
    return ((lse - ll) * mc).sum(), ((lse * mc) ** 2).sum()


def lm_loss(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig, *,
            loss_chunks: int = 8) -> Tuple[torch.Tensor, Dict[str,
                                                              torch.Tensor]]:
    """Next-token cross-entropy (+ MoE aux + z-loss): the twin of
    ``repro/models/lm.py::lm_loss``. ``batch`` holds ``tokens`` and
    ``labels`` (B, S), and optionally ``mask`` (B, S) and ``prefix_embed``.

    The unembedding and the softmax cross-entropy run per sequence chunk
    (``loss_chunks``, lowered until it divides S), each under
    ``torch.utils.checkpoint`` where autograd needs the graph, so the
    (B, S, V) logits never exist whole. Returns (total, {"xent", "aux",
    "z_loss"}), float32: total = xent + 1e-4 * sum((lse * mask)^2) / denom
    + router_aux_coef * aux, denom = max(sum(mask), 1)."""
    nll_sum, z_sum, mask_sum, aux = lm_loss_sums(params, batch, cfg,
                                                 loss_chunks=loss_chunks)
    denom = torch.clamp(mask_sum, min=1.0)
    xent = nll_sum / denom
    z_loss = 1e-4 * z_sum / denom
    total = xent + z_loss + cfg.router_aux_coef * aux
    return total, {"xent": xent, "aux": aux, "z_loss": z_loss}


def lm_loss_sums(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                 *, loss_chunks: int = 8, token_shards=None
                 ) -> Tuple[torch.Tensor, ...]:
    """``lm_loss``'s parts before the division by the mask's sum: (the
    masked NLL's sum, the masked squared lse's sum, the mask's sum, the
    aux), float32. The data-parallel step adds them over the shards of a
    batch before it divides (``launch/steps.py``); ``token_shards`` is the
    MoE's share (``nn/moe.py::TokenShards``)."""
    tokens, labels = batch["tokens"], batch["labels"]
    mask = batch.get("mask")
    x, _, aux = forward_hidden(params, tokens, cfg,
                               prefix_embed=batch.get("prefix_embed"),
                               token_shards=token_shards)
    b, s, _ = x.shape
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=x.device)
    mask = mask.to(torch.float32)
    unembed = params["embed"] if cfg.tie_embeddings else params["unembed"]
    remat = needs_grad(x, unembed)

    nc = loss_chunks
    while s % nc:
        nc -= 1
    sc = s // nc
    nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    z_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(nc):
        part = (x[:, i * sc:(i + 1) * sc], labels[:, i * sc:(i + 1) * sc],
                mask[:, i * sc:(i + 1) * sc], unembed)
        if remat:
            a, z = checkpoint(_chunk_loss, *part, cfg, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            a, z = _chunk_loss(*part, cfg)
        nll_sum, z_sum = nll_sum + a, z_sum + z
    return nll_sum, z_sum, mask.sum(), aux


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
