"""Griffin / RecurrentGemma recurrent block: a conv1d and the RG-LRU.

The twin of ``repro/nn/rglru.py``:

    r_t = sigmoid(W_a x_t + b_a)            # recurrence gate
    i_t = sigmoid(W_x x_t + b_x)            # input gate
    a_t = exp(-c * softplus(Lambda) * r_t)  # per-channel decay in (0, 1)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The sequence runs as a log-depth scan in both packages (float32): the
reference's ``associative_scan`` and the port's doubling scan combine in
another order, so they agree to float32 rounding, not bitwise. Serving
(grad mode off, or no input that requires grad) runs the scan in place;
where autograd needs the graph it runs out of place, since the backward
needs every step's values (the same values, step for step). Decode is
one step of the recurrence on the cached state. The reference computes all
of it outside any Pallas kernel, as the port does in plain PyTorch.

Caches are updated in place where the caller passes views of a stacked
buffer: ``RecCache.h`` and ``.conv`` are written, ``length`` is a Python
int.

On a mesh (``rules`` / ``mesh``, inside a position of a serving or
training step's ``shard_map``) a position holds its columns of the width
(``lru_width`` on the model axis): column pieces of ``w_y``, ``w_x``, the
conv, the gates and their biases and ``lam``, a row piece of ``w_out``,
its columns of ``RecCache.h`` and of the conv window. ``x`` is gathered
whole over the sequence where the residual is split; the position's
columns of the conv output are ``all_gather``ed over the width in the
model's dtype, since each gate column reads every column of it
(``gate_a`` / ``gate_x`` are ``(W, W / K)`` pieces), while ``b`` takes
the position's own columns. The scan runs on the position's columns;
``w_out``'s partial product is added over the axis in float32 and cast
once (``row_parallel``), scattered over the sequence where the residual
is split. Under FSDP the weights' ``embed_fsdp`` dimension is gathered
just before their products. Without a mesh every split axis is ``None``
and every helper an identity.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (Mesh, ParamDef, ShardingRules,
                                              logical_constraint)
from repro_torch.distributed.tensor_parallel import (gather_dim, gather_fsdp,
                                                     gather_seq, global_batch,
                                                     row_parallel, split_axis)
from repro_torch.nn.layers import activation
from repro_torch.nn.ssm import put_window


def rglru_param_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, w = cfg.d_model, cfg.lru_width
    return {
        "w_y": ParamDef((d, w), ("embed_fsdp", "lru_width"), dtype=cfg.dtype),
        "w_x": ParamDef((d, w), ("embed_fsdp", "lru_width"), dtype=cfg.dtype),
        "conv_w": ParamDef((cfg.lru_conv, w), (None, "lru_width"),
                           scale=0.3, dtype=cfg.dtype),
        "conv_b": ParamDef((w,), ("lru_width",), init="zeros",
                           dtype=cfg.dtype),
        "gate_a": ParamDef((w, w), (None, "lru_width"), dtype=cfg.dtype),
        "gate_a_b": ParamDef((w,), ("lru_width",), init="zeros",
                             dtype=cfg.dtype),
        "gate_x": ParamDef((w, w), (None, "lru_width"), dtype=cfg.dtype),
        "gate_x_b": ParamDef((w,), ("lru_width",), init="zeros",
                             dtype=cfg.dtype),
        # softplus(lambda) = 0.8/c-ish -> a ~ 0.45..0.999 across channels
        "lam": ParamDef((w,), ("lru_width",), init="constant", constant=0.1,
                        dtype=torch.float32),
        "w_out": ParamDef((w, d), ("lru_width", "embed_fsdp"), dtype=cfg.dtype),
    }


class RecCache(NamedTuple):
    h: torch.Tensor      # (B, W) float32 recurrent state
    conv: torch.Tensor   # (B, conv-1, W) conv window
    length: int          # tokens seen


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along the sequence. x: (B, S, C); w: (W, C)."""
    width, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = xp[:, 0:s] * w[0]
    for i in range(1, width):
        out = out + xp[:, i:i + s] * w[i]
    return out + b


def _gates(params, x: torch.Tensor, own: torch.Tensor, cfg: ModelConfig):
    """(a, b) of the recurrence, float32, from the conv output ``x`` (in
    the model's dtype: the reference rounds it there first), whole over
    the width: the gates' products read every column. ``own``: the
    columns of ``x`` the gates' pieces produce (``x`` itself without a
    mesh), which ``b`` multiplies."""
    f32 = torch.float32
    r = torch.sigmoid((x @ params["gate_a"]).to(f32)
                      + params["gate_a_b"].to(f32))
    i = torch.sigmoid((x @ params["gate_x"]).to(f32)
                      + params["gate_x_b"].to(f32))
    a = torch.exp(-cfg.lru_c * F.softplus(params["lam"]) * r)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * own.to(f32))
    return a, b


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along axis 1 (h_{-1} = h0, else 0), as a
    log-depth inclusive scan: step d combines each position with the one d
    before it, (a1, b1) then (a2, b2) -> (a1 a2, a2 b1 + b2)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (a, b, h0)):
        return _scan_for_autograd(a, b, h0)
    a, b = a.clone(), b.clone()
    if h0 is not None:
        b[:, 0] += a[:, 0] * h0
    # each step writes only the positions it changes; the right-hand sides
    # are whole new tensors before the write, so no value is read after
    # this step has overwritten it
    d = 1
    while d < b.shape[1]:
        b[:, d:] = a[:, d:] * b[:, :-d] + b[:, d:]
        if 2 * d < b.shape[1]:
            a[:, d:] = a[:, d:] * a[:, :-d]
        d *= 2
    return b


def _scan_for_autograd(a: torch.Tensor, b: torch.Tensor,
                       h0: Optional[torch.Tensor]) -> torch.Tensor:
    """``rglru_scan`` with every step a new tensor: the same values as the
    in-place scan, and a graph autograd can differentiate (the in-place
    writes overwrite what the backward of the step before needs)."""
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    d = 1
    while d < b.shape[1]:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        if 2 * d < b.shape[1]:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def recurrent_block(params: Dict[str, torch.Tensor], x: torch.Tensor,
                    cfg: ModelConfig, *, cache: Optional[RecCache] = None,
                    rules: Optional[ShardingRules] = None,
                    mesh: Optional[Mesh] = None
                    ) -> Tuple[torch.Tensor, Optional[RecCache]]:
    """Griffin's recurrent branch. x: (B, S, d), a position's rows where
    the residual is split by sequence.

    With a cache and S == 1: one step on the cached state and conv window,
    both written in place. A prefill with a cache writes the last state
    and the last ``lru_conv`` - 1 inputs of the conv (prompts of at least
    that many tokens, as ``nn/ssm.py::put_window`` says). On a mesh each
    position runs its columns of the width (the module's docstring)."""
    sp = split_axis(rules, mesh, "seq_sp")
    wax = split_axis(rules, mesh, "lru_width")
    ef = split_axis(rules, mesh, "embed_fsdp")
    x = gather_seq(x, sp)
    b, s, _ = x.shape
    f32 = torch.float32
    y_branch = activation("gelu")(
        (x @ gather_fsdp(params["w_y"], 0, ef)).to(f32))
    u = x @ gather_fsdp(params["w_x"], 0, ef)

    new_cache = None
    if cache is not None and s == 1:
        window = torch.cat([cache.conv, u], dim=1)
        conv = (torch.einsum("bwc,wc->bc", window.to(f32),
                             params["conv_w"].to(f32))
                + params["conv_b"].to(f32))[:, None, :].to(x.dtype)
        a, bb = _gates(params, gather_dim(conv, wax, 2), conv, cfg)
        h = a[:, 0] * cache.h + bb[:, 0]
        hs = h[:, None, :]
        cache.h.copy_(h)
        cache.conv.copy_(window[:, 1:])
        new_cache = RecCache(cache.h, cache.conv, cache.length + 1)
    else:
        conv = _conv(u, params["conv_w"], params["conv_b"])
        conv = logical_constraint(
            conv, "batch", "seq", "lru_width", rules=rules, mesh=mesh,
            shape=(global_batch(b, rules, mesh), s, cfg.lru_width)
        ).to(x.dtype)
        a, bb = _gates(params, gather_dim(conv, wax, 2), conv, cfg)
        hs = rglru_scan(a, bb, cache.h if cache is not None else None)
        if cache is not None:
            cache.h.copy_(hs[:, -1])
            put_window(cache.conv, u[:, s - cfg.lru_conv + 1:, :])
            new_cache = RecCache(cache.h, cache.conv, s)

    return row_parallel((hs * y_branch).to(x.dtype),
                        gather_fsdp(params["w_out"], 1, ef), wax, sp,
                        x.dtype), new_cache
