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

On a mesh (``rules`` / ``mesh``, inside a position of a serving or
training step's ``shard_map``, ``launch/steps.py``) ``forward_hidden``,
``prefill``, ``decode_step`` and ``lm_loss_sums`` take the position's
pieces: the vocab-sharded embedding is a lookup of the position's rows,
zeros elsewhere, ``psum``med over the vocab axis (the reference's one-hot
product, the same bits; under grad the ``psum``'s transpose hands each
position every token's cotangent for its rows); the unembedding computes
the position's vocab columns, masks the padding by the global column, and
``all_gather``s the logits over the vocab axis; under FSDP both tables'
``embed_fsdp`` dimension is gathered over the data axes first. The
residual between blocks is ("batch", "seq_sp", "embed"): in a prefill or
a training forward each position holds its S/K rows (whole where K does
not divide S). ``lm_loss_sums`` gathers the rows and runs the
vocab-parallel cross-entropy (the reference's ``lm_loss`` under GSPMD):
each position's logits are its vocab columns of the chunk, the row
maximum is the ``pmax`` of the detached local maxima, the float32
``sumexp`` and the label's logit (from the position owning its column)
are ``psum``med, then the lse, the NLL and the z-loss as before.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

from functools import partial

import torch

from repro_torch import DeviceLike
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding
from repro_torch.distributed.collectives import (all_gather, axis_index,
                                                 checkpoint, pmax, psum)
from repro_torch.distributed.sharding import (Mesh, ParamDef, ShardingRules,
                                              logical_constraint)
from repro_torch.distributed.tensor_parallel import (gather_fsdp, gather_seq,
                                                     global_batch, own_rows,
                                                     residual_rules,
                                                     split_axis)
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


def _vocab_parallel_lookup(table: torch.Tensor, tokens: torch.Tensor,
                           axis) -> torch.Tensor:
    """The reference's one-hot lookup (``_onehot_lookup``) from a table
    split by rows over ``axis``: each position takes its rows where a token
    falls in its range and zeros elsewhere, and the pieces are ``psum``med.
    One term of each sum is the row and the others exact zeros: the same
    bits as a gather from the whole table, and as the one-hot product."""
    v_loc = table.shape[0]
    local = tokens.to(torch.int64) - axis_index(axis) * v_loc
    hit = (local >= 0) & (local < v_loc)
    rows = table[local.clamp(0, v_loc - 1)]
    x = torch.where(hit[..., None], rows,
                    torch.zeros((), dtype=rows.dtype, device=rows.device))
    return psum(x, axis)


def _embed(params, tokens: torch.Tensor, cfg: ModelConfig,
           prefix_embed: Optional[torch.Tensor],
           rules: Optional[ShardingRules] = None,
           mesh: Optional[Mesh] = None) -> torch.Tensor:
    vocab_ax = split_axis(rules, mesh, "vocab")
    table = gather_fsdp(params["embed"], 1,
                        split_axis(rules, mesh, "embed_fsdp"))
    if vocab_ax is None:
        # the JAX package's one-hot lookup serves a vocab-sharded table; on
        # a whole table it takes jnp.take, as this index gather does
        x = table[tokens]
    else:
        x = _vocab_parallel_lookup(table, tokens, vocab_ax)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    if prefix_embed is not None and cfg.prefix_len:
        n = prefix_embed.shape[1]
        x = torch.cat([prefix_embed.to(x.dtype), x[:, n:]], dim=1)
    return x


def _unembed_table(params, cfg: ModelConfig,
                   rules: Optional[ShardingRules], mesh: Optional[Mesh]
                   ) -> torch.Tensor:
    """The unembedding's weight as the position holds it (the tied
    embedding (V, d) or ``unembed`` (d, V)), its ``embed_fsdp`` dimension
    gathered where FSDP splits it."""
    ef = split_axis(rules, mesh, "embed_fsdp")
    if cfg.tie_embeddings:
        return gather_fsdp(params["embed"], 1, ef)
    return gather_fsdp(params["unembed"], 0, ef)


def _mask_pad_vocab(logits: torch.Tensor, cfg: ModelConfig,
                    start: int = 0) -> torch.Tensor:
    """-1e30 in the padding columns; ``logits`` hold the vocabulary's
    columns from ``start`` on."""
    if cfg.vocab_pad == cfg.vocab_size:
        return logits
    cols = torch.arange(start, start + logits.shape[-1], device=logits.device)
    return torch.where(cols < cfg.vocab_size, logits,
                       torch.tensor(-1e30, dtype=logits.dtype,
                                    device=logits.device))


def _unembed(params, x: torch.Tensor, cfg: ModelConfig,
             rules: Optional[ShardingRules] = None,
             mesh: Optional[Mesh] = None) -> torch.Tensor:
    table = _unembed_table(params, cfg, rules, mesh)
    logits = x @ table.T if cfg.tie_embeddings else x @ table
    vocab_ax = split_axis(rules, mesh, "vocab")
    start = axis_index(vocab_ax) * logits.shape[-1] if vocab_ax else 0
    logits = _mask_pad_vocab(softcap(logits, cfg.final_softcap), cfg, start)
    logits = logical_constraint(
        logits, "batch", None, "vocab", rules=rules, mesh=mesh,
        shape=(global_batch(x.shape[0], rules, mesh), x.shape[1],
               cfg.vocab_pad))
    if vocab_ax is None:
        return logits
    return all_gather(logits, vocab_ax, axis=-1, tiled=True)


def forward_hidden(params, tokens: torch.Tensor, cfg: ModelConfig, *,
                   prefix_embed: Optional[torch.Tensor] = None,
                   positions: Optional[torch.Tensor] = None,
                   caches=None, token_shards=None,
                   rules: Optional[ShardingRules] = None,
                   mesh: Optional[Mesh] = None
                   ) -> Tuple[torch.Tensor, Any, torch.Tensor]:
    """tokens: (B, S) -> (hidden (B, S, d), new_caches, aux_loss () float32,
    summed over the layers). On a mesh the hidden rows are the position's
    block of the sequence where the residual is split by it."""
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device).expand(b, s)
    rules = residual_rules(rules, mesh, s)
    x = _embed(params, tokens, cfg, prefix_embed, rules=rules, mesh=mesh)
    if cfg.pos == "sinusoidal":
        x = x + sinusoidal_pos(positions, cfg.d_model).to(x.dtype)
    x = own_rows(x, split_axis(rules, mesh, "seq_sp"))
    x = logical_constraint(x, "batch", "seq_sp" if s > 1 else "seq",
                           "embed", rules=rules, mesh=mesh,
                           shape=(global_batch(b, rules, mesh), s,
                                  cfg.d_model))
    x, new_caches, aux = stack_apply(params["stack"], x, positions, cfg,
                                     caches=caches,
                                     token_shards=token_shards,
                                     rules=rules, mesh=mesh)
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
                unembed: torch.Tensor, cfg: ModelConfig, vocab_ax=None):
    """(sum of masked next-token NLL, sum of (lse * mask)^2) over one
    sequence chunk: xc (B, T, d), labels lc (B, T), mask mc (B, T) float32.
    The logits stay in the model's dtype; float32 appears inside the
    reductions, as in the reference. With ``vocab_ax`` the unembedding is
    the position's vocab columns and the row statistics are combined over
    the axis (the module's docstring)."""
    logits = xc @ unembed.T if cfg.tie_embeddings else xc @ unembed
    v_loc = logits.shape[-1]
    start = axis_index(vocab_ax) * v_loc if vocab_ax is not None else 0
    logits = _mask_pad_vocab(softcap(logits, cfg.final_softcap), cfg, start)
    m = logits.detach().amax(dim=-1, keepdim=True).to(torch.float32)
    if vocab_ax is not None:
        m = pmax(m, vocab_ax)
    sumexp = torch.exp(logits.to(torch.float32) - m).sum(dim=-1)
    if vocab_ax is not None:
        sumexp = psum(sumexp, vocab_ax)
    lse = m[..., 0] + torch.log(sumexp)
    if vocab_ax is None:
        ll = torch.gather(logits, -1, lc[..., None].long())[..., 0].to(
            torch.float32)
    else:                       # the label's logit from its column's owner
        local = lc.long() - start
        hit = (local >= 0) & (local < v_loc)
        ll = torch.gather(logits, -1, local.clamp(0, v_loc - 1)[..., None])
        ll = psum(torch.where(hit, ll[..., 0].to(torch.float32), 0.0),
                  vocab_ax)
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
                 *, loss_chunks: int = 8, token_shards=None,
                 rules: Optional[ShardingRules] = None,
                 mesh: Optional[Mesh] = None) -> Tuple[torch.Tensor, ...]:
    """``lm_loss``'s parts before the division by the mask's sum: (the
    masked NLL's sum, the masked squared lse's sum, the mask's sum, the
    aux), float32. The sharded step adds them over the shards of a batch
    before it divides (``launch/steps.py``); ``token_shards`` is the MoE's
    share (``nn/moe.py::TokenShards``). On a mesh (``rules`` / ``mesh``)
    the position's batch rows, the vocab-parallel cross-entropy (the
    module's docstring): the sums are the same on every position of the
    model axis."""
    tokens, labels = batch["tokens"], batch["labels"]
    mask = batch.get("mask")
    x, _, aux = forward_hidden(params, tokens, cfg,
                               prefix_embed=batch.get("prefix_embed"),
                               token_shards=token_shards, rules=rules,
                               mesh=mesh)
    rules = residual_rules(rules, mesh, tokens.shape[1])
    x = gather_seq(x, split_axis(rules, mesh, "seq_sp"))
    b, s, _ = x.shape
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=x.device)
    mask = mask.to(torch.float32)
    unembed = _unembed_table(params, cfg, rules, mesh)
    remat = needs_grad(x, unembed)
    chunk = partial(_chunk_loss, cfg=cfg,
                    vocab_ax=split_axis(rules, mesh, "vocab"))

    nc = loss_chunks
    while s % nc:
        nc -= 1
    sc = s // nc
    nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    z_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(nc):
        part = (x[:, i * sc:(i + 1) * sc], labels[:, i * sc:(i + 1) * sc],
                mask[:, i * sc:(i + 1) * sc], unembed)
        a, z = checkpoint(chunk, *part) if remat else chunk(*part)
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


def _last_logits(params, x: torch.Tensor, cfg: ModelConfig,
                 rules: Optional[ShardingRules], mesh: Optional[Mesh]
                 ) -> torch.Tensor:
    """The last position's logits (B, V) from a forward's hidden rows.
    Where the residual is split by sequence the last row comes from the
    position holding it; on a mesh the vocab columns come from every
    position."""
    sp = split_axis(rules, mesh, "seq_sp")
    if sp is not None:
        x = all_gather(x[:, -1:], sp, axis=1, tiled=True)[:, -1:]
    return _unembed(params, x, cfg, rules, mesh)[:, -1]


def prefill(params, tokens: torch.Tensor, caches, cfg: ModelConfig, *,
            prefix_embed: Optional[torch.Tensor] = None,
            rules: Optional[ShardingRules] = None,
            mesh: Optional[Mesh] = None, token_shards=None
            ) -> Tuple[torch.Tensor, Any]:
    """Fill caches from a prompt; return (last-position logits, caches).
    On a mesh: a position's pieces in, its caches' pieces and its batch
    rows' logits over the whole vocabulary out."""
    rules = residual_rules(rules, mesh, tokens.shape[1])
    x, new_caches, _ = forward_hidden(
        params, tokens, cfg, prefix_embed=prefix_embed, caches=caches,
        token_shards=token_shards, rules=rules, mesh=mesh)
    return _last_logits(params, x, cfg, rules, mesh), new_caches


def decode_step(params, token: torch.Tensor, caches, cfg: ModelConfig, *,
                position: int, rules: Optional[ShardingRules] = None,
                mesh: Optional[Mesh] = None, token_shards=None
                ) -> Tuple[torch.Tensor, Any]:
    """One decode step. token: (B, 1); ``position`` is the number of tokens
    already in the cache. On a mesh as ``prefill``."""
    b = token.shape[0]
    positions = torch.full((b, 1), position, dtype=torch.int32,
                           device=token.device)
    rules = residual_rules(rules, mesh, 1)
    x, new_caches, _ = forward_hidden(
        params, token, cfg, positions=positions, caches=caches,
        token_shards=token_shards, rules=rules, mesh=mesh)
    return _last_logits(params, x, cfg, rules, mesh), new_caches
