"""GQA attention for the LM substrate.

The twin of ``repro/nn/attention.py``, on one device (no sharding
constraints). Two paths:

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
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import ParamDef
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
                     logit_softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B, 1, H, D); cache_k/v: (B, Smax, Hk, D); ``cache_len`` tokens
    are in the cache. Dense single-token attention, GQA-grouped (the
    repeated KV is never built); scores and the softmax in float32, the
    products over the cache's dtype widened to float32 (JAX's
    ``preferred_element_type``)."""
    b, _, h, d = q.shape
    smax, hk = cache_k.shape[1], cache_k.shape[2]
    rep = h // hk
    f32 = torch.float32
    qg = (q[:, 0] * (1.0 / math.sqrt(d))).reshape(b, hk, rep, d).to(
        cache_k.dtype)
    s = torch.einsum("bkgd,bskd->bkgs", qg.to(f32), cache_k.to(f32))
    s = softcap(s, logit_softcap)
    pos = torch.arange(smax, device=q.device)
    q_pos = cache_len - 1
    mask = pos <= q_pos
    if window is not None:
        mask &= pos > q_pos - window
    s = torch.where(mask, s, -1e30)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    denom = torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bkgs,bskd->bkgd", (p / denom).to(cache_v.dtype).to(f32),
                     cache_v.to(f32))
    return o.reshape(b, 1, h, d).to(q.dtype)


class KVCache(NamedTuple):
    k: torch.Tensor   # (B, Smax, Hk, D), or (G, B, Smax, Hk, D) stacked
    v: torch.Tensor
    length: int       # tokens currently in the cache


def attention(params: Dict[str, torch.Tensor], x: torch.Tensor,
              positions: torch.Tensor, cfg: ModelConfig, *,
              layer_window: Optional[int] = None,
              cache: Optional[KVCache] = None
              ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Full GQA attention layer. x: (B, S, d).

    Without a cache: prefill (the flash kernel). With a cache and S == 1:
    one decode step, the new K/V written into the cache in place. A
    prefill with a cache writes the prompt's K/V at [0, S) and zeros after.
    """
    b, s, _ = x.shape
    h, hk, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(b, s, h, dh)
    k = k.reshape(b, s, hk, dh)
    v = v.reshape(b, s, hk, dh)
    if cfg.pos == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None and s == 1:
        at = cache.length
        if at >= cache.k.shape[1]:
            raise ValueError(f"the KV cache holds {cache.k.shape[1]} "
                             f"tokens; it is full")
        cache.k[:, at] = k[:, 0].to(cache.k.dtype)
        cache.v[:, at] = v[:, 0].to(cache.v.dtype)
        new_cache = KVCache(cache.k, cache.v, at + 1)
        o = decode_attention(q, cache.k, cache.v, at + 1,
                             window=layer_window,
                             logit_softcap=cfg.attn_softcap)
    else:
        o = chunked_attention(
            q, k, v, causal=True, window=layer_window,
            logit_softcap=cfg.attn_softcap, q_chunk=cfg.attn_q_chunk,
            kv_chunk=cfg.attn_kv_chunk)
        if cache is not None:                      # prefill fills the cache
            for buf, new in ((cache.k, k), (cache.v, v)):
                buf[:, :s] = new.to(buf.dtype)
                buf[:, s:] = 0
            new_cache = KVCache(cache.k, cache.v, s)

    out = o.reshape(b, s, h * dh) @ params["wo"]
    return out, new_cache
