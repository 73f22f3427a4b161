"""The fusable phi shared by the fused kernels, as plain PyTorch.

The twin of ``repro/kernels/mp_pipeline.py``, holding only ``BIG`` and
``apply_fusable_phi``. The ``mp_pipeline`` kernel itself (the fused
gather-phi-scatter edge phase with its multi-statistic accumulators and
GAT's in-sweep softmax) is not ported yet: ROADMAP queue 2 item 2.
"""

from __future__ import annotations

from typing import Optional

import torch

# Finite keyed-select offset of the max/min accumulators (empty
# destinations sit at -BIG / +BIG).
BIG = 1e30


def src_weight_mode(src_weight: torch.Tensor, d: int):
    """Classify a src_weight stream: ``('scalar', 0)`` for (E,),
    ``('full', 0)`` for (E, D), ``('head', D // H)`` for per-head (E, H)
    lanes with H dividing D."""
    if src_weight.ndim == 1:
        return "scalar", 0
    h = src_weight.shape[1]
    if h == d:
        return "full", 0
    if h and d % h == 0:
        return "head", d // h
    raise ValueError(
        f"src_weight width {h} must equal D={d} or divide it (per-head)")


def apply_fusable_phi(x: torch.Tensor, senders: torch.Tensor, *,
                      src_weight: Optional[torch.Tensor] = None,
                      edge_term: Optional[torch.Tensor] = None,
                      bias: Optional[torch.Tensor] = None,
                      activation: str = "none") -> torch.Tensor:
    """act(x[snd] * sw + et + b) in float32, terms applied in that order."""
    msg = x[senders].to(torch.float32)
    if src_weight is not None:
        sw = src_weight.to(torch.float32)
        if sw.ndim == 1:
            msg = msg * sw[:, None]
        else:
            mode, head_dim = src_weight_mode(sw, msg.shape[1])
            if mode == "head":
                e_n, d_n = msg.shape
                msg = (msg.reshape(e_n, sw.shape[1], head_dim)
                       * sw[:, :, None]).reshape(e_n, d_n)
            else:
                msg = msg * sw
    if edge_term is not None:
        msg = msg + edge_term.to(torch.float32)
    if bias is not None:
        msg = msg + bias.to(torch.float32)
    if activation == "relu":
        msg = torch.relu(msg)
    elif activation != "none":
        raise ValueError(f"unsupported activation '{activation}'")
    return msg
