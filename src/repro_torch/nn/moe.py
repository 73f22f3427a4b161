"""Mixture-of-Experts feed-forward on the port's banked dispatch kernels.

The twin of ``repro/nn/moe.py`` on one device. Token -> expert dispatch is
message passing: tokens are sources, experts destination banks, and the
top-k router emits the edge list on the fly. Per token group:

  1. router logits -> top-k (expert id, weight) per token (float32);
  2. the assignments sorted by expert id, stably (on-the-fly binning);
  3. each one's rank in its expert (``searchsorted``); a rank at or past
     the capacity drops the assignment, which then points at the trash
     slot ``E * C``, one past the buffer;
  4. ``kernels/moe_dispatch.py::moe_dispatch``: one ``mp_scatter`` of the
     routed tokens into the (E * C, d) buffer;
  5. the batched SwiGLU expert FFN (``torch.einsum``, as the reference
     leaves it to XLA outside any kernel);
  6. ``moe_combine``: one ``gather_rows`` and one ``mp_scatter`` back to
     the tokens, weighted by the router.

The reference writes the same dispatch with XLA scatters and holds it
equal to its banked kernel form (``repro/kernels/moe_dispatch.py``,
``tests/test_moe_kernels.py``); the port runs the banked form, so on the
card steps 4 and 6 are three kernel launches. One difference of rounding
follows: the reference adds a token's k contributions in ``x.dtype``, the
combine here in float32, cast once (the same in a float32 model).

Training. The dispatch and the combine differentiate through the kernels'
own backward (``MpScatterFn`` / ``GatherRowsFn``: each kernel's gradient
is the other kernel), the router through the weights and the aux loss,
the experts through PyTorch. Under ``cfg.moe_inner_remat`` and grad mode
each token group runs under ``torch.utils.checkpoint`` (non-reentrant), the
reference's ``jax.checkpoint`` per dispatch group: its buffers are
recomputed in the backward, the kernels launched again.

The expert-parallel mesh (``mesh`` / ``rules``, the psum over the model
axis) is not ported; every expert is local (``bank_start`` 0).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import ParamDef
from repro_torch.kernels.moe_dispatch import (moe_combine, moe_dispatch,
                                              pad_assignments)
from repro_torch.nn.layers import activation, needs_grad

def moe_param_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, e, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    return {
        "router": ParamDef((d, e), dtype=torch.float32),
        "wg": ParamDef((e, d, ff), dtype=cfg.dtype),
        "wu": ParamDef((e, d, ff), dtype=cfg.dtype),
        "wd": ParamDef((e, ff, d), dtype=cfg.dtype),
    }


def _capacity(tokens: int, k: int, e: int, cf: float) -> int:
    c = int(math.ceil(tokens * k / e * cf))
    return max(8, (c + 7) // 8 * 8)


def route(xg: torch.Tensor, rw: torch.Tensor, *, k: int, capacity: int
          ) -> Dict[str, torch.Tensor]:
    """Top-k routing of one token group xg (T, d) by the router rw (d, E),
    binned as the reference bins it. Returns, each (T*k,) in sorted order:
    ``token_ids``, ``slot`` (``E * capacity`` where not owned), ``own``
    (the rank under capacity) and ``weights`` (float32); and, for the aux
    loss, ``probs`` (T, E) and ``experts`` (T*k,) in router order."""
    t = xg.shape[0]
    e_total = rw.shape[1]
    dev = xg.device
    probs = torch.softmax(xg.to(torch.float32) @ rw, dim=-1)       # (T, E)
    top_w, top_i = torch.topk(probs, k, dim=-1)                    # (T, k)
    flat_e = top_i.reshape(-1)
    flat_t = torch.arange(t, device=dev).repeat_interleave(k)
    # torch.argsort is not stable by default; jnp.argsort(stable=True) is
    order = torch.sort(flat_e, stable=True).indices
    se, st, sw = flat_e[order], flat_t[order], top_w.reshape(-1)[order]
    starts = torch.searchsorted(se, torch.arange(e_total, device=dev),
                                side="left")
    rank = torch.arange(t * k, device=dev) - starts[se]
    own = rank < capacity
    slot = torch.where(own, se * capacity + rank, e_total * capacity)
    return {"token_ids": st, "slot": slot, "own": own, "weights": sw,
            "probs": probs, "experts": flat_e}


def expert_ffn(buf: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
               wd: torch.Tensor, act) -> torch.Tensor:
    """The SwiGLU experts over the (E, C, d) bank buffer -> (E, C, d)."""
    h = act(torch.einsum("ecd,edf->ecf", buf, wg)) * torch.einsum(
        "ecd,edf->ecf", buf, wu)
    return torch.einsum("ecf,efd->ecd", h, wd)


def aux_loss(r: Dict[str, torch.Tensor], e_total: int) -> torch.Tensor:
    """Switch-style load balance over ALL assignments, kept or dropped."""
    t = r["probs"].shape[0]
    counts = torch.zeros(e_total, dtype=torch.float32,
                         device=r["probs"].device)
    counts.index_add_(0, r["experts"],
                      torch.ones_like(r["experts"], dtype=torch.float32))
    return e_total * torch.sum(counts / t * r["probs"].mean(dim=0))


def _dispatch_compute_combine(xg: torch.Tensor, params, *, k: int,
                              capacity: int, act
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token group through the experts. xg: (T, d). Returns (out (T,
    d) in xg.dtype, aux () float32)."""
    t, d = xg.shape
    e_total = params["wg"].shape[0]
    num_slots = e_total * capacity
    r = route(xg, params["router"], k=k, capacity=capacity)
    st, slot, own, sw = pad_assignments(r["token_ids"], r["slot"], r["own"],
                                        r["weights"], num_slots)
    buf = moe_dispatch(xg, st, slot, own, num_slots)
    y = expert_ffn(buf.reshape(e_total, capacity, d), params["wg"],
                   params["wu"], params["wd"], act)
    out = moe_combine(y.reshape(num_slots, d), st, slot, own, sw, t)
    return out.to(xg.dtype), aux_loss(r, e_total)


def moe_ffn(params: Dict[str, torch.Tensor], x: torch.Tensor,
            cfg: ModelConfig, *, group_size: int = 8192
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE feed-forward. x: (B, S, d) -> (out (B, S, d), aux () float32).

    The B*S tokens are cut into the reference's groups (at least
    ``ceil(T / group_size)``, raised until they divide T), each with its
    own capacity; the aux is the mean over groups."""
    b, s, d = x.shape
    t = b * s
    x2 = x.reshape(t, d)
    groups = max(1, -(-t // group_size))
    while t % groups:
        groups += 1
    tg = t // groups
    cap = _capacity(tg, cfg.num_experts_per_tok, cfg.num_experts,
                    cfg.capacity_factor)
    act = activation(cfg.act)
    fn = partial(_dispatch_compute_combine, k=cfg.num_experts_per_tok,
                 capacity=cap, act=act)
    if cfg.moe_inner_remat and needs_grad(x, params):
        res = [checkpoint(fn, xg, params, use_reentrant=False,
                          preserve_rng_state=False)
               for xg in x2.reshape(groups, tg, d)]
    else:
        res = [fn(xg, params) for xg in x2.reshape(groups, tg, d)]
    if groups == 1:
        out, aux = res[0]
    else:
        out = torch.cat([r[0] for r in res], dim=0)
        aux = torch.stack([r[1] for r in res]).mean()
    return out.reshape(b, s, d), aux
