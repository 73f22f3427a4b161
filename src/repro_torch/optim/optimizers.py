"""Optimizers (AdamW, Adafactor) as functions over parameter trees.

The twin of ``repro/optim/optimizers.py``. State trees are declared as
``ParamDef`` trees (``adamw_state_defs``, ``adafactor_state_defs``) with
the reference's keys: ``step`` (int32, ()) and float32 ``m`` / ``v``
(AdamW) or ``vr`` / ``vc`` (Adafactor's factored second moments), so the
JAX package's optimizer state carries over leaf for leaf
(``checkpoint/convert.py::opt_state_from_jax``) and the two packages'
checkpoints hold the same leaves.

An update takes ``(params, grads, state, tcfg)`` and returns ``(params,
state, {"lr", "grad_norm"})`` as the reference's does, with one
difference: it writes the new values into the given parameter and state
tensors (under ``torch.no_grad``) and returns those same trees. The
parameters stay the leaf tensors autograd differentiates, and no second
copy of the model or its state is made. The arithmetic is the
reference's, in float32, each result cast to its leaf's dtype.

On a mesh (inside a position of the sharded train step's ``shard_map``,
``launch/steps.py``) the updates take ``specs``, the parameters' partition
specs: each position holds its pieces of the parameters, gradients
(already reduced over the positions sharing each piece) and state, and
every statistic over a whole leaf is completed over the axes that split
it: the global norm ``psum``s each leaf's sum of squares over the axes
that split that leaf (so a replicated leaf counts once), and Adafactor's
row and column means and its update RMS sum over the piece, ``psum`` over
the axes splitting the dimensions they reduce, and divide by the whole
leaf's extent. AdamW is elementwise and needs nothing more.

The reference chains its per-leaf updates through optimization barriers
(``_chained_updates``) so that XLA does not schedule every leaf's float32
upcast at once. Eager PyTorch updates one leaf after the other anyway, so
that device has no counterpart here.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.distributed.collectives import current_mesh, psum
# tree_map, tree_leaves and tree_unflatten are this module's names too
from repro_torch.distributed.sharding import (  # noqa: F401
    P, ParamDef, axis_names_of, map_defs, map_tree as tree_map, tree_leaves,
    tree_unflatten)

f32 = torch.float32


class _Split:
    """The mesh axes (of size > 1) that split each dimension of a leaf
    under its partition spec, inside a position of ``shard_map``; no axes
    without a spec."""

    def __init__(self, spec: Optional[P], ndim: int):
        mesh = current_mesh() if spec is not None else None
        self.sizes = {} if mesh is None else mesh.shape
        entries = list(spec or ()) + [None] * ndim
        self.dims = [tuple(n for n in axis_names_of(e)
                           if self.sizes.get(n, 1) > 1)
                     for e in entries[:ndim]]

    def of(self, dim: int) -> Tuple[str, ...]:
        return self.dims[dim]

    def every(self) -> Tuple[str, ...]:
        return tuple(n for d in self.dims for n in d)

    def size(self, axes: Tuple[str, ...]) -> int:
        return math.prod(self.sizes[n] for n in axes)

    def mean(self, x: torch.Tensor, dim: int, leaf_dim: int,
             keepdim: bool = False) -> torch.Tensor:
        """The mean over dimension ``dim`` of ``x``, a piece of the leaf or
        of a statistic of it whose dimension ``dim`` is the leaf's
        ``leaf_dim``, taken over the whole leaf's extent."""
        axes = self.of(leaf_dim)
        if not axes:
            return x.mean(dim=dim, keepdim=keepdim)
        return psum(x.sum(dim=dim, keepdim=keepdim), axes) / (
            x.shape[dim] * self.size(axes))

    def mean_all(self, x: torch.Tensor) -> torch.Tensor:
        axes = self.every()
        if not axes:
            return torch.mean(x)
        return psum(x.sum(), axes) / (x.numel() * self.size(axes))


def _spec_leaves(specs: Any, n: int) -> List[Optional[P]]:
    return [None] * n if specs is None else tree_leaves(specs)


def lr_schedule(step: torch.Tensor, cfg: TrainConfig) -> torch.Tensor:
    """Linear warm-up to ``cfg.learning_rate``, then a cosine down to a
    tenth of it at ``total_steps``; float32, on ``step``'s device."""
    s = step.to(f32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.learning_rate * warm * (0.1 + 0.9 * cos)


def global_norm(grads: Any, specs: Any = None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32. With ``specs``
    (inside ``shard_map``) ``grads`` are pieces: each leaf's sum of squares
    is ``psum``med over the axes that split it first, the leaves sharing a
    set of axes in one ``psum``."""
    leaves = tree_leaves(grads)
    squares = [torch.sum(g.to(f32) ** 2) for g in leaves]
    groups: Dict[Tuple[str, ...], List[int]] = {}
    for i, (g, spec) in enumerate(zip(leaves, _spec_leaves(specs,
                                                           len(leaves)))):
        axes = _Split(spec, g.dim()).every()
        if axes:
            groups.setdefault(axes, []).append(i)
    for axes, idx in groups.items():
        for i, t in zip(idx, psum([squares[i] for i in idx], axes)):
            squares[i] = t
    return torch.sqrt(sum(squares))


def clip_by_global_norm(grads: Any, max_norm: float, specs: Any = None):
    """(grads scaled by min(1, max_norm / global norm), each in its own
    dtype; the global norm). ``specs``: as ``global_norm``'s."""
    gn = global_norm(grads, specs)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.to(f32) * scale).to(g.dtype), grads), gn


def _zeros_like_def(d: ParamDef) -> ParamDef:
    return ParamDef(d.shape, d.opt_axes or d.axes, init="zeros", dtype=f32)


def _step_def() -> ParamDef:
    return ParamDef((), (), init="zeros", dtype=torch.int32)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_state_defs(param_defs) -> Dict[str, Any]:
    return {"step": _step_def(),
            "m": map_defs(_zeros_like_def, param_defs),
            "v": map_defs(_zeros_like_def, param_defs)}


@torch.no_grad()
def adamw_update(params, grads, state, cfg: TrainConfig, specs: Any = None):
    step = state["step"] + 1
    lr = lr_schedule(step, cfg)
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, specs)
    b1, b2 = cfg.b1, cfg.b2
    sf = step.to(f32)
    c1 = 1 - torch.pow(torch.tensor(b1, dtype=f32, device=sf.device), sf)
    c2 = 1 - torch.pow(torch.tensor(b2, dtype=f32, device=sf.device), sf)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        gf = g.to(f32)
        m.copy_(b1 * m + (1 - b1) * gf)
        v.copy_(b2 * v + (1 - b2) * gf * gf)
        pf = p.to(f32)
        pf = pf - lr * ((m / c1) / (torch.sqrt(v / c2) + 1e-8)
                        + cfg.weight_decay * pf)
        p.copy_(pf.to(p.dtype))
    state["step"].copy_(step)
    return params, state, {"lr": lr, "grad_norm": gnorm}


# ---------------------------------------------------------------------------
# Adafactor (factored second moments; memory ~ sum of dims, not product)
# ---------------------------------------------------------------------------

def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor_state_defs(param_defs) -> Dict[str, Any]:
    def row_def(d: ParamDef) -> ParamDef:
        if not _factored(d.shape):
            return _zeros_like_def(d)
        return ParamDef(d.shape[:-1], d.logical_axes[:-1], init="zeros",
                        dtype=f32)

    def col_def(d: ParamDef) -> ParamDef:
        if not _factored(d.shape):
            return ParamDef((1,), (None,), init="zeros", dtype=f32)
        return ParamDef(d.shape[:-2] + d.shape[-1:],
                        d.logical_axes[:-2] + d.logical_axes[-1:],
                        init="zeros", dtype=f32)

    return {"step": _step_def(),
            "vr": map_defs(row_def, param_defs),
            "vc": map_defs(col_def, param_defs)}


@torch.no_grad()
def adafactor_update(params, grads, state, cfg: TrainConfig,
                     specs: Any = None):
    step = state["step"] + 1
    lr = lr_schedule(step, cfg)
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, specs)
    beta2 = 1.0 - step.to(f32) ** -0.8
    eps = 1e-30
    leaves = tree_leaves(params)
    for p, g, vr, vc, spec in zip(leaves, tree_leaves(grads),
                                  tree_leaves(state["vr"]),
                                  tree_leaves(state["vc"]),
                                  _spec_leaves(specs, len(leaves))):
        split = _Split(spec, p.dim())
        gf = g.to(f32)
        g2 = gf * gf + eps
        if _factored(p.shape):
            rows, cols = p.dim() - 2, p.dim() - 1
            vr.copy_(beta2 * vr + (1 - beta2) * split.mean(g2, cols, cols))
            vc.copy_(beta2 * vc + (1 - beta2) * split.mean(g2, rows, rows))
            # vr's last dimension is the leaf's rows
            rfac = vr / torch.clamp(split.mean(vr, vr.dim() - 1, rows,
                                               keepdim=True), min=eps)
            u = gf / (torch.sqrt(rfac)[..., None]
                      * torch.sqrt(vc)[..., None, :])
        else:
            vr.copy_(beta2 * vr + (1 - beta2) * g2)
            u = gf / torch.sqrt(vr + 1e-12)
        # update clipping (Adafactor's d=1.0 RMS rule)
        rms = torch.sqrt(split.mean_all(u * u) + eps)
        u = u / torch.clamp(rms, min=1.0)
        pf = p.to(f32)
        p.copy_((pf - lr * u - lr * cfg.weight_decay * pf).to(p.dtype))
    state["step"].copy_(step)
    return params, state, {"lr": lr, "grad_norm": gnorm}


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

class Optimizer(NamedTuple):
    state_defs: Callable[[Any], Any]
    update: Callable[..., Tuple[Any, Any, Dict[str, torch.Tensor]]]


OPTIMIZERS = {
    "adamw": Optimizer(adamw_state_defs, adamw_update),
    "adafactor": Optimizer(adafactor_state_defs, adafactor_update),
}


def get_optimizer(name: str) -> Optimizer:
    return OPTIMIZERS[name]
