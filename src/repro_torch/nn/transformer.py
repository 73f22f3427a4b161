"""Block assembly + layer stack.

The twin of ``repro/nn/transformer.py``. Layer patterns
(``cfg.layer_pattern``):

  global       -> group ("attn",)              qwen/deepseek/llama/...
  local_global -> group ("local", "attn")      gemma2 (alternating windows)
  griffin      -> group ("rec", "rec", "local") recurrentgemma
  ssm          -> group ("mamba",)             mamba2

The parameter tree keeps the JAX nesting, so JAX weights carry over leaf
for leaf (``checkpoint/convert.py::lm_params_from_jax``): ``{"groups": a
tuple with one tree per position of the group, each leaf stacked on a
leading layer axis, "rem": [one tree per remainder layer]}``. The JAX
package scans the groups; ``stack_apply`` runs a Python loop over the
group index on views of the stacked leaves, and updates the stacked KV
caches in place by layer index.

Only the dense blocks ("attn", "local") are ported. The kinds "mamba" and
"rec" and MoE configs (``cfg.num_experts``) raise ``NotImplementedError``
(ROADMAP queue 1 item 7), never a silent substitute.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import ParamDef, map_defs
from repro_torch.nn.attention import KVCache, attention, attn_param_defs
from repro_torch.nn.layers import layernorm, rmsnorm
from repro_torch.nn.mlp import mlp, mlp_param_defs

DENSE_KINDS = ("attn", "local")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP queue 1 item 7); the "
        f"port serves dense blocks ('attn', 'local') only")


def _check_kind(cfg: ModelConfig, kind: str) -> None:
    if kind not in DENSE_KINDS:
        if kind in ("mamba", "rec"):
            raise _not_ported(f"the '{kind}' block")
        raise ValueError(kind)
    if cfg.num_experts:
        raise _not_ported("the MoE feed-forward (nn/moe.py)")


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d = cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": ParamDef((d,), init="ones", dtype=cfg.dtype),
                "bias": ParamDef((d,), init="zeros", dtype=cfg.dtype)}
    init = "zeros" if cfg.norm_plus_one else "ones"
    return {"scale": ParamDef((d,), init=init, dtype=cfg.dtype)}


def apply_norm(p: Dict[str, torch.Tensor], x: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rmsnorm(x, p["scale"], cfg.norm_eps, plus_one=cfg.norm_plus_one)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def block_param_defs(cfg: ModelConfig, kind: str) -> Dict[str, Any]:
    _check_kind(cfg, kind)
    defs: Dict[str, Any] = {
        "ln1": norm_defs(cfg),
        "attn": attn_param_defs(cfg),
        "ln2": norm_defs(cfg),
        "mlp": mlp_param_defs(cfg, gated=cfg.gated_mlp),
    }
    if cfg.post_norms:
        defs["pn1"] = norm_defs(cfg)
        defs["pn2"] = norm_defs(cfg)
    return defs


def block_apply(params, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig, kind: str, *,
                cache: Optional[KVCache] = None
                ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Returns (x, new_cache). The reference's third value, the MoE aux
    loss, comes back with the MoE block (ROADMAP queue 1 item 7)."""
    _check_kind(cfg, kind)
    window = cfg.local_window if kind == "local" else None
    h = apply_norm(params["ln1"], x, cfg)
    a_out, new_cache = attention(params["attn"], h, positions, cfg,
                                 layer_window=window, cache=cache)
    if cfg.post_norms:
        a_out = apply_norm(params["pn1"], a_out, cfg)
    x = x + a_out
    h = apply_norm(params["ln2"], x, cfg)
    f_out = mlp(params["mlp"], h, cfg)
    if cfg.post_norms:
        f_out = apply_norm(params["pn2"], f_out, cfg)
    x = x + f_out
    return x, new_cache


def block_cache_defs(cfg: ModelConfig, kind: str, batch: int,
                     max_len: int) -> KVCache:
    """One block's decode cache: K and V zeros, length 0."""
    _check_kind(cfg, kind)
    hk, dh = cfg.num_kv_heads, cfg.head_dim
    shape = (batch, max_len, hk, dh)
    return KVCache(k=ParamDef(shape, init="zeros", dtype=cfg.dtype),
                   v=ParamDef(shape, init="zeros", dtype=cfg.dtype),
                   length=0)


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
            lambda p: ParamDef((sd.num_groups,) + p.shape, init=p.init,
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


def stack_apply(params, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig, *, caches=None
                ) -> Tuple[torch.Tensor, Any]:
    """Run the full stack. Returns (x, new_caches | None). The
    caches' K/V tensors are written in place; the returned tree holds the
    same tensors with the new lengths."""
    sd = stack_pattern(cfg)
    have_cache = caches is not None

    lengths: List[Optional[int]] = [None] * len(sd.group)
    for g in range(sd.num_groups):
        for i, kind in enumerate(sd.group):
            cache_i = None
            if have_cache:
                c = caches["groups"][i]
                cache_i = KVCache(c.k[g], c.v[g], c.length)
            x, nc = block_apply(_layer(params["groups"][i], g), x,
                                positions, cfg, kind, cache=cache_i)
            if have_cache:
                lengths[i] = nc.length

    new_rem_caches = []
    for i, kind in enumerate(sd.remainder):
        cache_i = caches["rem"][i] if have_cache else None
        x, nc = block_apply(params["rem"][i], x, positions, cfg, kind,
                            cache=cache_i)
        new_rem_caches.append(nc)

    if not have_cache:
        return x, None
    new_groups = tuple(KVCache(c.k, c.v, n) for c, n in
                       zip(caches["groups"], lengths)) \
        if sd.num_groups > 0 else ()
    return x, {"groups": new_groups, "rem": new_rem_caches}
