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
each token group runs under ``checkpoint`` (``distributed/collectives.py``:
``torch.utils.checkpoint`` off a mesh, the position's own remat on one),
the reference's ``jax.checkpoint`` per dispatch group: its buffers are
recomputed in the backward, the kernels launched again; within a layer's
remat recompute it is a plain call.

Data parallelism (``token_shards``). Under the mesh's data-parallel
train step (``launch/steps.py``) one forward sees only its position's
contiguous share of the tokens the unsharded step would route together.
``TokenShards`` says which share, and ``moe_ffn`` then routes exactly as
the unsharded step does: the token groups and their capacity come from the
global token count; a group that lies whole on this position runs as
before; for a group spread over several positions each position's ranks
start after the assignments of the positions before it (their per-expert
counts, exchanged once a layer, again in its recompute: a position
recomputes in its own thread, ``distributed/collectives.py::checkpoint``),
and
the aux loss is this position's share of the group's, from the group's
counts. The outputs of a position's tokens are then the unsharded step's.

Expert parallelism (``rules`` / ``mesh``, inside a position of a
serving or training step's ``shard_map``). A position holds the bank of
E/K experts
from ``bank_start = axis_index("model") * e_loc``, as the reference's
``moe_ffn`` does. Every position routes the whole token group as ``route``
does, with the same capacity; an assignment outside its bank goes to the
trash slot, and the dispatch and combine run on the local bank through
``kernels/moe_dispatch.py`` (``mp_scatter`` and ``gather_rows`` on every
position). The partial outputs are ``psum``med over the axis in float32
and cast once; where the residual is split by sequence, the tokens are
``all_gather``ed over it first and the sum is a ``psum_scatter`` back to
each position's rows. Under FSDP of the experts (``expert_ff`` on the
data axes, arctic-480b) the bank's ``ff`` columns are gathered over them
first, as the reference's ``moe_ffn`` gathers them. Under grad the
partial combine's ``psum`` (or ``psum_scatter``) and the tokens' gather
carry their transposes back, and the router, whose work every position of
the model axis repeats, gets its gradient's parts from each. The aux loss
is the same on every position of the model axis and is this position's
share over the batch axes (with ``token_shards``, the part of the groups'
aux its tokens carry); the steps add the shares (``launch/steps.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import axis_index, checkpoint
from repro_torch.distributed.sharding import Mesh, ParamDef, ShardingRules
from repro_torch.distributed.tensor_parallel import (gather_fsdp, gather_seq,
                                                     reduce_partial,
                                                     split_axis)
from repro_torch.kernels.moe_dispatch import (moe_combine, moe_dispatch,
                                              pad_assignments)
from repro_torch.nn.layers import activation, needs_grad

def moe_param_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, e, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    return {
        "router": ParamDef((d, e), (None, None), dtype=torch.float32),
        "wg": ParamDef((e, d, ff), ("experts", None, "expert_ff"),
                       dtype=cfg.dtype),
        "wu": ParamDef((e, d, ff), ("experts", None, "expert_ff"),
                       dtype=cfg.dtype),
        "wd": ParamDef((e, ff, d), ("experts", "expert_ff", None),
                       dtype=cfg.dtype),
    }


def _capacity(tokens: int, k: int, e: int, cf: float) -> int:
    c = int(math.ceil(tokens * k / e * cf))
    return max(8, (c + 7) // 8 * 8)


@dataclass
class TokenShards:
    """This forward's tokens as shard ``index`` of ``count`` contiguous
    shards of the tokens the unsharded step routes together. ``gather``
    returns a tensor of every shard, stacked in shard order (a collective
    across the mesh positions holding the shards)."""

    count: int
    index: int
    gather: Callable[[torch.Tensor], torch.Tensor]


def route(xg: torch.Tensor, rw: torch.Tensor, *, k: int, capacity: int,
          offsets: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
    """Top-k routing of one token group xg (T, d) by the router rw (d, E),
    binned as the reference bins it. Returns, each (T*k,) in sorted order:
    ``token_ids``, ``slot`` (``E * capacity`` where not owned), ``own``
    (the rank under capacity) and ``weights`` (float32); and, for the aux
    loss, ``probs`` (T, E) and ``experts`` (T*k,) in router order.

    ``offsets``, for a share of a group spread over several shards, maps
    this share's per-expert assignment counts (E,) to (the counts of the
    shares before it, the whole group's counts): its ranks start after
    the earlier shares', and the group's counts are returned as
    ``group_counts``."""
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
    out = {}
    if offsets is not None:
        ends = torch.searchsorted(se, torch.arange(e_total, device=dev),
                                  side="right")
        before, out["group_counts"] = offsets(ends - starts)
        rank = rank + before[se]
    own = rank < capacity
    slot = torch.where(own, se * capacity + rank, e_total * capacity)
    out.update(token_ids=st, slot=slot, own=own, weights=sw, probs=probs,
               experts=flat_e)
    return out


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


def shared_aux_loss(r: Dict[str, torch.Tensor], e_total: int,
                    group_tokens: int) -> torch.Tensor:
    """This share's part of ``aux_loss`` of a group of ``group_tokens``
    tokens spread over several shards: the group's counts times this
    share's router probabilities (the shares' parts add up to the
    group's)."""
    return e_total * torch.sum(r["group_counts"].to(torch.float32)
                               / group_tokens * r["probs"].sum(dim=0)
                               / group_tokens)


def _dispatch_compute_combine(xg: torch.Tensor, params, *, k: int,
                              capacity: int, act, offsets=None,
                              group_tokens: int = 0, bank_start: int = 0,
                              out_dtype: Optional[torch.dtype] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token group (or, with ``offsets``, this shard's share of one)
    through the local bank of experts from ``bank_start`` (every expert
    where the bank is whole). xg: (T, d). Returns (out (T, d) in
    ``out_dtype`` (xg.dtype by default): the bank's part of the combine;
    aux () float32: the group's, or this share's part of it)."""
    t, d = xg.shape
    e_total = params["router"].shape[1]
    e_loc = params["wg"].shape[0]
    num_slots = e_loc * capacity
    if offsets is None:
        r = route(xg, params["router"], k=k, capacity=capacity)
    else:
        r = route(xg, params["router"], k=k, capacity=capacity,
                  offsets=offsets)
    slot, own = r["slot"], r["own"]
    if e_loc != e_total:            # the bank's slots; the rest to the trash
        lo = bank_start * capacity
        own = own & (slot >= lo) & (slot < lo + num_slots)
        slot = torch.where(own, slot - lo, num_slots)
    st, slot, own, sw = pad_assignments(r["token_ids"], slot, own,
                                        r["weights"], num_slots)
    buf = moe_dispatch(xg, st, slot, own, num_slots)
    y = expert_ffn(buf.reshape(e_loc, capacity, d), params["wg"],
                   params["wu"], params["wd"], act)
    out = moe_combine(y.reshape(num_slots, d), st, slot, own, sw, t)
    aux = (aux_loss(r, e_total) if offsets is None
           else shared_aux_loss(r, e_total, group_tokens))
    return out.to(out_dtype or xg.dtype), aux


def moe_ffn(params: Dict[str, torch.Tensor], x: torch.Tensor,
            cfg: ModelConfig, *, group_size: int = 8192,
            token_shards: Optional[TokenShards] = None,
            rules: Optional[ShardingRules] = None,
            mesh: Optional[Mesh] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE feed-forward. x: (B, S, d) -> (out (B, S, d), aux () float32).

    The B*S tokens are cut into the reference's groups (at least
    ``ceil(T / group_size)``, raised until they divide T), each with its
    own capacity; the aux is the mean over groups. With ``token_shards``
    the groups are those of the unsharded tokens (T times the shard
    count), and the aux is this shard's part of their mean. On a mesh,
    the position's bank of experts (the module's docstring)."""
    ex_ax = split_axis(rules, mesh, "experts")
    sp = split_axis(rules, mesh, "seq_sp")
    ef = split_axis(rules, mesh, "expert_ff")
    if ex_ax is None:               # every expert here: the combine is whole
        bank_start, out_dtype = 0, x.dtype
    else:                           # a partial combine, added in float32
        bank_start = axis_index(ex_ax) * params["wg"].shape[0]
        out_dtype = torch.float32
    if ef is not None:
        params = dict(params, wg=gather_fsdp(params["wg"], 2, ef),
                      wu=gather_fsdp(params["wu"], 2, ef),
                      wd=gather_fsdp(params["wd"], 1, ef))
    out, aux = _moe_groups(params, gather_seq(x, sp), cfg, group_size,
                           token_shards, bank_start, out_dtype)
    return reduce_partial(out, ex_ax, sp, x.dtype), aux


def _moe_groups(params: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg: ModelConfig, group_size: int,
                token_shards: Optional[TokenShards], bank_start: int,
                out_dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_ffn``'s token groups through the bank from ``bank_start``:
    (out (B, S, d) in ``out_dtype``, aux)."""
    b, s, d = x.shape
    t = b * s
    count = token_shards.count if token_shards is not None else 1
    total = t * count
    groups = max(1, -(-total // group_size))
    while total % groups:
        groups += 1
    tg = total // groups
    cap = _capacity(tg, cfg.num_experts_per_tok, cfg.num_experts,
                    cfg.capacity_factor)
    fn = partial(_dispatch_compute_combine, k=cfg.num_experts_per_tok,
                 capacity=cap, act=activation(cfg.act), bank_start=bank_start,
                 out_dtype=out_dtype)
    if (tg % t if tg > t else t % tg):
        raise NotImplementedError(
            f"MoE token groups of {tg} tokens do not align with data shards "
            f"of {t} tokens")
    pieces = x.reshape(max(1, t // tg), min(tg, t), d)
    if tg > t:
        # this shard holds a share of one group spread over tg / t shards
        fn = partial(fn, offsets=_shard_offsets(token_shards, tg // t),
                     group_tokens=tg)
    if cfg.moe_inner_remat and needs_grad(x, params):
        res = [checkpoint(fn, xg, params) for xg in pieces]
    else:
        res = [fn(xg, params) for xg in pieces]
    if count > 1:
        out = torch.cat([r[0] for r in res], dim=0)
        aux = torch.stack([r[1] for r in res]).sum() / groups
    elif groups == 1:
        out, aux = res[0]
    else:
        out = torch.cat([r[0] for r in res], dim=0)
        aux = torch.stack([r[1] for r in res]).mean()
    return out.reshape(b, s, d), aux


def _shard_offsets(shards: TokenShards, span: int):
    """``route``'s ``offsets`` for this shard's share of a group spread over
    ``span`` shards: the per-expert counts of every shard, exchanged."""
    first = shards.index // span * span

    def offsets(counts: torch.Tensor):
        every = shards.gather(counts)
        return (every[first:shards.index].sum(dim=0),
                every[first:first + span].sum(dim=0))
    return offsets
