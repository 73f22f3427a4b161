"""GQA attention for the LM substrate.

The twin of ``repro/nn/attention.py``. Two paths:

  * ``chunked_attention`` — prefill: KV heads repeated to H, the layout
    turned to (B, H, S, D), and one launch of the hand-written flash kernel
    (``ops.flash_attention``, ``kernels/csrc/flash_attention.cu``). The JAX
    package runs ``nn/flash.py::flash_mha`` here, a jnp flash attention
    over the same block schedule as its Pallas kernel; both compute the
    kernel's function (causal, end-aligned, window, softcap, f32 softmax).
  * ``decode_attention`` — one query over the KV cache, dense PyTorch as
    the JAX package's is dense jnp outside any kernel.

The KV cache stores unrepeated KV heads and is updated in place (JAX
builds a new one): ``KVCache.k`` / ``.v`` are (B, Smax, Hk, D) tensors,
or views of a layer's slice of the stacked cache, and ``length`` is a
Python int, the same for every layer.

On a mesh (``rules`` / ``mesh``, inside a position of a serving or
training step's ``shard_map``) a position holds column pieces of ``wq`` /
``wk`` / ``wv`` (its query heads, and its KV heads where they divide the
model axis) and a row piece of ``wo``; under FSDP their ``embed_fsdp``
rows (``wo``'s columns) are split over the data axes too and gathered
just before the products (``gather_fsdp``). Under grad the position runs
the flash kernel on its heads writing lse and ``flash_attention_bwd`` on
them in the backward (``FlashAttentionFn``), and each collective's
transpose carries the gradient back. A residual split by sequence is all-gathered over it
first; the position runs the flash kernel on its own heads, (B, H/K, S, D),
and its ``wo`` product, a partial sum, is added over the axis in float32
(``psum``, or ``psum_scatter`` back to each position's rows: Megatron-SP).
Where the KV heads do not divide the axis each position holds part of a
head's columns: K and V are all-gathered whole (the reference's
``act_kv = None``) and each query head takes its KV head. The cache
follows ``build_rules``: split by KV heads, each position updating its
own; or, where the heads do not divide, by sequence: the prefill writes
each position's range, and a decode step computes every query head over
each position's range and combines the ranges by ``pmax`` and ``psum``
(flash-decoding), only the position owning the new index writing it.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import (all_gather, axis_index,
                                                 axis_size, pmax, psum)
from repro_torch.distributed.sharding import (Mesh, MeshAxis, ParamDef,
                                              ShardingRules,
                                              logical_constraint)
from repro_torch.distributed.tensor_parallel import (gather_fsdp, gather_seq,
                                                     global_batch,
                                                     row_parallel, split_axis)
from repro_torch.kernels import ops
from repro_torch.nn.layers import apply_rope, softcap


def attn_param_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, h, hk, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    defs = {
        "wq": ParamDef((d, h * dh), ("embed_fsdp", "heads"), dtype=cfg.dtype),
        "wk": ParamDef((d, hk * dh), ("embed_fsdp", "kv_heads"),
                       dtype=cfg.dtype),
        "wv": ParamDef((d, hk * dh), ("embed_fsdp", "kv_heads"),
                       dtype=cfg.dtype),
        "wo": ParamDef((h * dh, d), ("heads", "embed_fsdp"), dtype=cfg.dtype),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((h * dh,), ("heads",), init="zeros",
                              dtype=cfg.dtype)
        defs["bk"] = ParamDef((hk * dh,), ("kv_heads",), init="zeros",
                              dtype=cfg.dtype)
        defs["bv"] = ParamDef((hk * dh,), ("kv_heads",), init="zeros",
                              dtype=cfg.dtype)
    return defs


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      logit_softcap: Optional[float] = None,
                      q_chunk: int = 512, kv_chunk: int = 1024
                      ) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Sk, Hk, D) with H % Hk == 0 -> (B, Sq, H,
    D), one ``ops.flash_attention`` launch.

    Queries are end-aligned with keys at the real lengths, as ``flash_mha``
    aligns them. ``q_chunk`` / ``kv_chunk`` set the JAX block schedule and
    change nothing here: the call passes whole-sequence tiles (Sq, Sk),
    which meet the kernel's length contract for any S with no padding, and
    the CUDA kernel tiles by its own constants.
    """
    sq, h = q.shape[1], q.shape[2]
    sk, hk = k.shape[1], k.shape[2]
    rep = h // hk
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    out = ops.flash_attention(qt, kt, vt, causal=causal, window=window,
                              softcap=logit_softcap, q_tile=sq, kv_tile=sk)
    return out.transpose(1, 2)


def decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, cache_len: int, *,
                     window: Optional[int] = None,
                     logit_softcap: Optional[float] = None, start: int = 0,
                     axis: MeshAxis = None) -> torch.Tensor:
    """q: (B, 1, H, D); cache_k/v: (B, L, Hk, D), cache rows [start, start
    + L); ``cache_len`` tokens are in the cache. Dense single-token
    attention, GQA-grouped (the repeated KV is never built); scores and the
    softmax in float32, the products over the cache's dtype widened to
    float32 (JAX's ``preferred_element_type``). With ``axis`` the cache is
    split by sequence over it: the softmax's maximum is ``pmax``ed and its
    sum ``psum``med over the axis, then each position's rows weighted by
    the global normalisation are ``psum``med (flash-decoding)."""
    b, _, h, d = q.shape
    rows, hk = cache_k.shape[1], cache_k.shape[2]
    rep = h // hk
    f32 = torch.float32
    qg = (q[:, 0] * (1.0 / math.sqrt(d))).reshape(b, hk, rep, d).to(
        cache_k.dtype)
    s = torch.einsum("bkgd,bskd->bkgs", qg.to(f32), cache_k.to(f32))
    s = softcap(s, logit_softcap)
    pos = torch.arange(start, start + rows, device=q.device)
    q_pos = cache_len - 1
    mask = pos <= q_pos
    if window is not None:
        mask &= pos > q_pos - window
    s = torch.where(mask, s, -1e30)
    m = torch.amax(s, dim=-1, keepdim=True)
    if axis is not None:
        m = pmax(m, axis)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    denom = torch.sum(p, dim=-1, keepdim=True)
    if axis is not None:
        denom = psum(denom, axis)
    denom = torch.clamp(denom, min=1e-30)
    o = torch.einsum("bkgs,bskd->bkgd", (p / denom).to(cache_v.dtype).to(f32),
                     cache_v.to(f32))
    if axis is not None:
        o = psum(o, axis)
    return o.reshape(b, 1, h, d).to(q.dtype)


class KVCache(NamedTuple):
    k: torch.Tensor   # (B, Smax, Hk, D), or (G, B, Smax, Hk, D) stacked
    v: torch.Tensor
    length: int       # tokens currently in the cache


def attention(params: Dict[str, torch.Tensor], x: torch.Tensor,
              positions: torch.Tensor, cfg: ModelConfig, *,
              layer_window: Optional[int] = None,
              cache: Optional[KVCache] = None,
              rules: Optional[ShardingRules] = None,
              mesh: Optional[Mesh] = None
              ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Full GQA attention layer. x: (B, S, d).

    Without a cache: prefill (the flash kernel). With a cache and S == 1:
    one decode step, the new K/V written into the cache in place. A
    prefill with a cache writes the prompt's K/V at [0, S) and zeros after.
    On a mesh: the position's pieces (the module's docstring); without one
    every axis below is whole and nothing is gathered or added.
    """
    h, hk, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    rep = h // hk
    sp = split_axis(rules, mesh, "seq_sp")
    head_ax = split_axis(rules, mesh, "heads")
    kv_ax = split_axis(rules, mesh, "kv_heads")
    seq_cache = (split_axis(rules, mesh, "cache_seq") if cache is not None
                 else None)
    ef = split_axis(rules, mesh, "embed_fsdp")
    x = gather_seq(x, sp)
    b, s, _ = x.shape
    q = x @ gather_fsdp(params["wq"], 0, ef)
    k = x @ gather_fsdp(params["wk"], 0, ef)
    v = x @ gather_fsdp(params["wv"], 0, ef)
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    n_q = q.shape[-1] // dh
    q0 = axis_index(head_ax) * n_q if head_ax is not None else 0
    # every KV head on every position where the KV columns are not split,
    # where a position would hold part of a head, or where the cache is
    # split by sequence (every head over each position's range)
    whole_kv = (kv_ax is None or hk % axis_size(kv_ax) != 0
                or seq_cache is not None)
    if kv_ax is not None and whole_kv:
        k = all_gather(k, kv_ax, axis=-1, tiled=True)
        v = all_gather(v, kv_ax, axis=-1, tiled=True)
    n_kv = k.shape[-1] // dh
    kv0 = 0 if whole_kv else axis_index(kv_ax) * n_kv
    if not whole_kv and (n_q != rep * n_kv or q0 != rep * kv0):
        raise NotImplementedError(
            f"query heads [{q0}, {q0 + n_q}) and KV heads "
            f"[{kv0}, {kv0 + n_kv}) on one position are not whole groups")
    q = q.reshape(b, s, n_q, dh)
    k = k.reshape(b, s, n_kv, dh)
    v = v.reshape(b, s, n_kv, dh)
    if cfg.pos == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    gb = global_batch(b, rules, mesh)
    q = logical_constraint(q, "batch", "seq", "act_heads", None, rules=rules,
                           mesh=mesh, shape=(gb, s, h, dh))

    new_cache = None
    if cache is not None and s == 1:
        at = cache.length
        rows = cache.k.shape[1]
        if seq_cache is not None:
            start = axis_index(seq_cache) * rows
            if at >= rows * axis_size(seq_cache):
                raise ValueError(f"the KV cache holds "
                                 f"{rows * axis_size(seq_cache)} tokens; it "
                                 f"is full")
            if start <= at < start + rows:       # the owner of the index
                cache.k[:, at - start] = k[:, 0].to(cache.k.dtype)
                cache.v[:, at - start] = v[:, 0].to(cache.v.dtype)
            q_all = q if head_ax is None else all_gather(
                q.reshape(b, 1, n_q * dh), head_ax, axis=-1,
                tiled=True).reshape(b, 1, h, dh)
            o = decode_attention(q_all, cache.k, cache.v, at + 1,
                                 window=layer_window,
                                 logit_softcap=cfg.attn_softcap, start=start,
                                 axis=seq_cache)
            o = o[:, :, q0:q0 + n_q]
        else:
            if at >= rows:
                raise ValueError(f"the KV cache holds {rows} tokens; it is "
                                 f"full")
            k_c, v_c, c0 = _cache_heads(k, v, cache, rules, mesh, whole_kv,
                                        kv0)
            if n_q != rep * k_c.shape[2] or q0 != rep * c0:
                raise NotImplementedError(
                    f"query heads [{q0}, {q0 + n_q}) over a cache piece of "
                    f"KV heads from {c0}: not whole groups")
            cache.k[:, at] = k_c[:, 0].to(cache.k.dtype)
            cache.v[:, at] = v_c[:, 0].to(cache.v.dtype)
            o = decode_attention(q, cache.k, cache.v, at + 1,
                                 window=layer_window,
                                 logit_softcap=cfg.attn_softcap)
        new_cache = KVCache(cache.k, cache.v, at + 1)
    else:
        k_q, v_q = k, v
        if whole_kv and head_ax is not None:     # each query head its KV head
            own = torch.arange(q0, q0 + n_q, device=x.device) // rep
            k_q, v_q = k[:, :, own], v[:, :, own]
        o = chunked_attention(
            q, k_q, v_q, causal=True, window=layer_window,
            logit_softcap=cfg.attn_softcap, q_chunk=cfg.attn_q_chunk,
            kv_chunk=cfg.attn_kv_chunk)
        if cache is not None:                      # prefill fills the cache
            if seq_cache is not None:
                rows = cache.k.shape[1]
                start = axis_index(seq_cache) * rows
                n = max(0, min(s - start, rows))
                for buf, new in ((cache.k, k), (cache.v, v)):
                    buf[:, :n] = new[:, start:start + n].to(buf.dtype)
                    buf[:, n:] = 0
            else:
                k_c, v_c, _ = _cache_heads(k, v, cache, rules, mesh,
                                           whole_kv, kv0)
                for buf, new in ((cache.k, k_c), (cache.v, v_c)):
                    buf[:, :s] = new.to(buf.dtype)
                    buf[:, s:] = 0
            new_cache = KVCache(cache.k, cache.v, s)

    o = logical_constraint(o, "batch", "seq", "act_heads", None, rules=rules,
                           mesh=mesh, shape=(gb, s, h, dh))
    o = o.reshape(b, s, n_q * dh)
    return (row_parallel(o, gather_fsdp(params["wo"], 1, ef), head_ax, sp,
                         x.dtype), new_cache)


def _cache_heads(k: torch.Tensor, v: torch.Tensor, cache: KVCache,
                 rules: ShardingRules, mesh: Mesh, whole_kv: bool, kv0: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The KV heads of ``k`` / ``v`` (every head, or the position's from
    ``kv0``) that the position's cache piece holds, and the first of
    them."""
    ax = split_axis(rules, mesh, "cache_heads")
    n = cache.k.shape[2]
    c0 = axis_index(ax) * n if ax is not None else 0
    if whole_kv:
        return k[:, :, c0:c0 + n], v[:, :, c0:c0 + n], c0
    if c0 != kv0 or n != k.shape[2]:
        raise NotImplementedError(
            f"a cache piece of KV heads [{c0}, {c0 + n}) on a position "
            f"holding [{kv0}, {kv0 + k.shape[2]})")
    return k, v, c0
