"""Flash attention with its backward, in the reference's (B, S, H, D) layout.

The twin of ``repro/nn/flash.py``: ``FlashSpec`` and ``flash_mha``, the
pure-JAX flash attention whose custom VJP saves (q, k, v, out, lse) and
recomputes each block's probabilities in its backward. Here both halves
are hand-written kernels (``kernels/flash_attention.py``): the forward
``csrc/flash_attention.cu`` (with its lse output when autograd needs it)
and the backward ``csrc/flash_attention_bwd.cu``, joined by
``FlashAttentionFn``. On the CPU both are their plain PyTorch versions.

``FlashSpec`` keeps the reference's fields. ``q_chunk``, ``kv_chunk`` and
``unroll`` describe the reference's block schedule and change nothing
here (the kernels tile by their own constants and skip the blocks the
masks hide, as the schedule does). The reference pads the sequences to its
chunks and passes the real lengths in ``sq_real`` / ``sk_real``; the
kernels mask ragged ends themselves, so the port takes unpadded tensors
and raises ``ValueError`` on a real length that differs from the shape.

All shapes are MHA: GQA callers repeat the KV heads first
(``nn/attention.py::chunked_attention``), and autograd of that repeat sums
the group gradients back into the shared KV heads, as the reference's
transpose does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import ops


class FlashSpec(NamedTuple):
    causal: bool
    window: Optional[int]
    softcap: Optional[float]
    q_chunk: int
    kv_chunk: int
    sq_real: int
    sk_real: int
    unroll: bool


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              spec: FlashSpec) -> torch.Tensor:
    """q (B, Sq, H, D), k, v (B, Sk, H, D) -> (B, Sq, H, D) in q's dtype:
    attention with queries end-aligned to the keys, under ``spec``'s
    causal mask, window and softcap. Differentiable through the kernels'
    backward (``FlashAttentionFn``)."""
    sq, sk = q.shape[1], k.shape[1]
    if (spec.sq_real, spec.sk_real) != (sq, sk):
        raise ValueError(f"real lengths ({spec.sq_real}, {spec.sk_real}) "
                         f"differ from the shapes ({sq}, {sk}); the port "
                         f"takes unpadded tensors")
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    out = ops.flash_attention(qt, kt, vt, causal=spec.causal,
                              window=spec.window, softcap=spec.softcap,
                              q_tile=sq, kv_tile=sk)
    return out.transpose(1, 2)
