"""Shared LM layers: norms, rotary/sinusoidal positions, activations.

The twin of ``repro/nn/layers.py``. Two places where PyTorch's defaults
differ from JAX's:

  * ``jax.nn.gelu`` is the tanh approximation by default;
    ``torch.nn.functional.gelu`` is exact unless ``approximate="tanh"``.
  * ``apply_rope`` rotates the two halves of the head (``jnp.split(x, 2)``),
    not interleaved pairs as some PyTorch code does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
            plus_one: bool = False) -> torch.Tensor:
    """RMS norm in float32, back in ``x.dtype``; ``plus_one`` scales by
    ``1 + scale`` (gemma)."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    s = scale.to(torch.float32)
    return (y * (1.0 + s if plus_one else s)).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)
            + bias.to(torch.float32)).to(x.dtype)


def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int. Rotates the halves
    x[..., :D/2] and x[..., D/2:] by position * freq, in float32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)               # (D/2,)
    ang = positions.to(torch.float32)[..., None] * freqs        # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """positions: (B, S) -> (B, S, d_model) sinusoidal embeddings."""
    half = d_model // 2
    step = torch.log(torch.tensor(10000.0, device=positions.device)) / max(
        half - 1, 1)                                  # float32, as in JAX
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=positions.device) * step)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")      # jax.nn.gelu's default


def activation(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def needs_grad(*trees) -> bool:
    """Grad mode is on and a tensor of ``trees`` (tensors, or dicts, lists
    and tuples of them) requires grad: autograd will need the graph."""
    return torch.is_grad_enabled() and _requires_grad(trees)


def _requires_grad(t) -> bool:
    if isinstance(t, torch.Tensor):
        return t.requires_grad
    if isinstance(t, dict):
        return any(_requires_grad(v) for v in t.values())
    if isinstance(t, (list, tuple)):
        return any(_requires_grad(v) for v in t)
    return False
