"""Block assembly + layer stack.

The twin of ``repro/nn/transformer.py``. Layer patterns
(``cfg.layer_pattern``):

  global       -> group ("attn",)              qwen/deepseek/llama/internvl/
                                               olmoe/arctic/musicgen
  local_global -> group ("local", "attn")      gemma2 (alternating windows)
  griffin      -> group ("rec", "rec", "local") recurrentgemma (+2 rem layers)
  ssm          -> group ("mamba",)             mamba2

An "attn" or "local" block's feed-forward is the MoE (``nn/moe.py``) where
``cfg.num_experts`` is set, plus the dense MLP with ``dense_residual``
(arctic). Every block returns the MoE aux loss as a third value (0 where
there is none), summed over the stack.

The parameter tree keeps the JAX nesting, so JAX weights carry over leaf
for leaf (``checkpoint/convert.py::lm_params_from_jax``): ``{"groups": a
tuple with one tree per position of the group, each leaf stacked on a
leading layer axis, "rem": [one tree per remainder layer]}``. The JAX
package scans the groups; ``stack_apply`` runs a Python loop over the
group index on views of the stacked leaves, and the blocks write their
caches (K/V, SSM state, recurrent state and conv windows) in place into
the stacked buffers through those views.

On a mesh (``rules`` / ``mesh``, inside a position of a serving or
training step's ``shard_map``, ``launch/steps.py``) every block takes its
pieces of the weights and caches and calls the collectives where GSPMD
would put them (``distributed/tensor_parallel.py``); between blocks the
residual is ("batch", "seq_sp", "embed"), each position its block of the
sequence in a prefill or a training forward, whole in decode. Every
family has its form: attention's heads and the MLP's ``ff`` as column and
row pieces, the MoE's banks of experts, Mamba2's SSD on the position's
heads (``nn/ssm.py``), the RG-LRU on its columns of the width
(``nn/rglru.py``).

Per-layer remat. Under ``cfg.remat`` and grad mode, without caches (a
training forward), each block runs under ``distributed/collectives.py::
checkpoint``: its activations are recomputed in the backward, the
reference's ``jax.checkpoint(..., nothing_saveable)`` around the group
body and each remainder block. Off a mesh that is
``torch.utils.checkpoint`` (non-reentrant); inside a position it is the
position's own remat, recomputed in its thread, so that a block's
collectives never run on autograd's worker thread. With remat off, under
``no_grad`` or with caches, nothing changes.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import checkpoint
from repro_torch.distributed.sharding import (Mesh, ParamDef, ShardingRules,
                                              logical_constraint, map_defs)
from repro_torch.distributed.tensor_parallel import global_batch
from repro_torch.nn.attention import KVCache, attention, attn_param_defs
from repro_torch.nn.layers import layernorm, needs_grad, rmsnorm
from repro_torch.nn.mlp import mlp, mlp_param_defs
from repro_torch.nn.moe import moe_ffn, moe_param_defs
from repro_torch.nn.rglru import RecCache, recurrent_block, rglru_param_defs
from repro_torch.nn.ssm import MambaCache, mamba_mixer, mamba_param_defs


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d = cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": ParamDef((d,), (None,), init="ones", dtype=cfg.dtype),
                "bias": ParamDef((d,), (None,), init="zeros",
                                 dtype=cfg.dtype)}
    init = "zeros" if cfg.norm_plus_one else "ones"
    return {"scale": ParamDef((d,), (None,), init=init, dtype=cfg.dtype)}


def apply_norm(p: Dict[str, torch.Tensor], x: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rmsnorm(x, p["scale"], cfg.norm_eps, plus_one=cfg.norm_plus_one)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def block_param_defs(cfg: ModelConfig, kind: str) -> Dict[str, Any]:
    if kind in ("attn", "local"):
        defs: Dict[str, Any] = {
            "ln1": norm_defs(cfg),
            "attn": attn_param_defs(cfg),
            "ln2": norm_defs(cfg),
        }
        if cfg.num_experts:
            defs["moe"] = moe_param_defs(cfg)
            if cfg.dense_residual:
                defs["mlp"] = mlp_param_defs(cfg, gated=True)
        else:
            defs["mlp"] = mlp_param_defs(cfg, gated=cfg.gated_mlp)
        if cfg.post_norms:
            defs["pn1"] = norm_defs(cfg)
            defs["pn2"] = norm_defs(cfg)
        return defs
    if kind == "mamba":
        return {"ln1": norm_defs(cfg), "mamba": mamba_param_defs(cfg)}
    if kind == "rec":
        return {"ln1": norm_defs(cfg), "rec": rglru_param_defs(cfg),
                "ln2": norm_defs(cfg), "mlp": mlp_param_defs(cfg, gated=True)}
    raise ValueError(kind)


def block_apply(params, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig, kind: str, *, cache=None,
                token_shards=None, rules: Optional[ShardingRules] = None,
                mesh: Optional[Mesh] = None
                ) -> Tuple[torch.Tensor, Any, torch.Tensor]:
    """Returns (x, new_cache, aux_loss () float32). ``token_shards``: the
    MoE's data-parallel share (``nn/moe.py::TokenShards``). ``positions``
    are the whole sequence's, also where ``x`` is a position's block of
    it."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    mp = {"rules": rules, "mesh": mesh}
    if kind in ("attn", "local"):
        window = cfg.local_window if kind == "local" else None
        h = apply_norm(params["ln1"], x, cfg)
        a_out, new_cache = attention(params["attn"], h, positions, cfg,
                                     layer_window=window, cache=cache, **mp)
        if cfg.post_norms:
            a_out = apply_norm(params["pn1"], a_out, cfg)
        x = x + a_out
        h = apply_norm(params["ln2"], x, cfg)
        if cfg.num_experts:
            f_out, aux = moe_ffn(params["moe"], h, cfg,
                                 token_shards=token_shards, **mp)
            if cfg.dense_residual:
                f_out = f_out + mlp(params["mlp"], h, cfg, **mp)
        else:
            f_out = mlp(params["mlp"], h, cfg, **mp)
        if cfg.post_norms:
            f_out = apply_norm(params["pn2"], f_out, cfg)
        x = x + f_out
    elif kind == "mamba":
        h = apply_norm(params["ln1"], x, cfg)
        m_out, new_cache = mamba_mixer(params["mamba"], h, cfg, cache=cache,
                                       **mp)
        x = x + m_out
    elif kind == "rec":
        h = apply_norm(params["ln1"], x, cfg)
        r_out, new_cache = recurrent_block(params["rec"], h, cfg,
                                           cache=cache, **mp)
        x = x + r_out
        h = apply_norm(params["ln2"], x, cfg)
        x = x + mlp(params["mlp"], h, cfg, **mp)
    else:
        raise ValueError(kind)
    s = positions.shape[1]
    x = logical_constraint(x, "batch", "seq_sp" if s > 1 else "seq",
                           "embed", rules=rules, mesh=mesh,
                           shape=(global_batch(x.shape[0], rules, mesh), s,
                                  cfg.d_model))
    return x, new_cache, aux


def block_cache_defs(cfg: ModelConfig, kind: str, batch: int,
                     max_len: int):
    """One block's decode cache: zeros of its kind's shapes, length 0."""
    if kind in ("attn", "local"):
        shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        axes = ("batch", "cache_seq", "cache_heads", None)
        return KVCache(k=ParamDef(shape, axes, init="zeros", dtype=cfg.dtype),
                       v=ParamDef(shape, axes, init="zeros", dtype=cfg.dtype),
                       length=0)
    if kind == "mamba":
        return MambaCache(
            state=ParamDef((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                            cfg.ssm_state),
                           ("batch", "ssm_heads", None, None), init="zeros",
                           dtype=torch.float32),
            conv=ParamDef((batch, cfg.ssm_conv - 1,
                           cfg.d_inner + 2 * cfg.ssm_state),
                          ("batch", None, None), init="zeros",
                          dtype=cfg.dtype),
            length=0)
    if kind == "rec":
        return RecCache(
            h=ParamDef((batch, cfg.lru_width), ("batch", "lru_width"),
                       init="zeros", dtype=torch.float32),
            conv=ParamDef((batch, cfg.lru_conv - 1, cfg.lru_width),
                          ("batch", None, "lru_width"),
                          init="zeros", dtype=cfg.dtype),
            length=0)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# the stack
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class StackDef:
    group: Tuple[str, ...]
    num_groups: int
    remainder: Tuple[str, ...]


PATTERNS = {
    "global": ("attn",),
    "local_global": ("local", "attn"),
    "griffin": ("rec", "rec", "local"),
    "ssm": ("mamba",),
}


def stack_pattern(cfg: ModelConfig) -> StackDef:
    group = PATTERNS[cfg.layer_pattern]
    g = len(group)
    if not cfg.scan_layers:
        # unrolled: everything is "remainder"
        full = (group * ((cfg.num_layers + g - 1) // g))[:cfg.num_layers]
        return StackDef(group, 0, tuple(full))
    num_groups = cfg.num_layers // g
    rem = group[:cfg.num_layers % g]
    return StackDef(group, num_groups, rem)


def _stack_defs(cfg: ModelConfig, per_layer_fn) -> Dict[str, Any]:
    """Build {'groups': tuple_per_position(stacked defs), 'rem': [defs]}."""
    sd = stack_pattern(cfg)

    def stacked(defs):
        return map_defs(
            lambda p: ParamDef((sd.num_groups,) + p.shape,
                               ("layers",) + p.logical_axes, init=p.init,
                               scale=p.scale, constant=p.constant,
                               dtype=p.dtype), defs)

    groups = tuple(stacked(per_layer_fn(kind)) for kind in sd.group) \
        if sd.num_groups > 0 else ()
    rem = [per_layer_fn(kind) for kind in sd.remainder]
    return {"groups": groups, "rem": rem}


def stack_param_defs(cfg: ModelConfig) -> Dict[str, Any]:
    return _stack_defs(cfg, lambda kind: block_param_defs(cfg, kind))


def stack_cache_defs(cfg: ModelConfig, batch: int, max_len: int):
    return _stack_defs(
        cfg, lambda kind: block_cache_defs(cfg, kind, batch, max_len))


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree: views of every leaf's slice."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _cache_at(cache, g: int):
    """Layer ``g`` of a stacked cache (a ``KVCache``, ``MambaCache`` or
    ``RecCache``, its tensors first and its length last): views of every
    tensor's slice, so that the block's in-place writes land in the
    stack."""
    return type(cache)(*(t[g] for t in cache[:-1]), cache.length)


def stack_apply(params, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig, *, caches=None, token_shards=None,
                rules: Optional[ShardingRules] = None,
                mesh: Optional[Mesh] = None
                ) -> Tuple[torch.Tensor, Any, torch.Tensor]:
    """Run the full stack. Returns (x, new_caches | None, aux_loss). The
    caches' tensors are written in place; the returned tree holds the same
    tensors with the new lengths."""
    sd = stack_pattern(cfg)
    have_cache = caches is not None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = (cfg.remat and not have_cache
             and needs_grad(x, params))

    def run(p, x, kind, cache):
        if not remat:
            return block_apply(p, x, positions, cfg, kind, cache=cache,
                               token_shards=token_shards, rules=rules,
                               mesh=mesh)
        return checkpoint(partial(block_apply, positions=positions, cfg=cfg,
                                  kind=kind, token_shards=token_shards,
                                  rules=rules, mesh=mesh), p, x)

    lengths: List[Optional[int]] = [None] * len(sd.group)
    for g in range(sd.num_groups):
        for i, kind in enumerate(sd.group):
            cache_i = (_cache_at(caches["groups"][i], g) if have_cache
                       else None)
            x, nc, aux_i = run(_layer(params["groups"][i], g), x, kind,
                               cache_i)
            aux = aux + aux_i
            if have_cache:
                lengths[i] = nc.length

    new_rem_caches = []
    for i, kind in enumerate(sd.remainder):
        cache_i = caches["rem"][i] if have_cache else None
        x, nc, aux_i = run(params["rem"][i], x, kind, cache_i)
        aux = aux + aux_i
        new_rem_caches.append(nc)

    if not have_cache:
        return x, None, aux
    new_groups = tuple(type(c)(*c[:-1], n) for c, n in
                       zip(caches["groups"], lengths)) \
        if sd.num_groups > 0 else ()
    return x, {"groups": new_groups, "rem": new_rem_caches}, aux
