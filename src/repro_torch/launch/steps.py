"""Step builders shared by the trainer and the server.

The twin of the single-device part of ``repro/launch/steps.py``:
``batch_defs`` and its siblings declare a step's inputs as ``ParamDef``s,
``make_train_step`` builds the training step (the loss, its gradient by
autograd, microbatch accumulation, the optimizer), and
``make_prefill_step`` / ``make_decode_step`` the serving steps (under
``torch.no_grad``). The reference's ``build_rules`` and
``lowering_bundle`` lower these steps onto a TPU mesh, with the abstract
inputs of ``prefill_input_defs`` / ``decode_input_defs``; they are mesh
tooling, which the port has not reached (ROADMAP).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.distributed.sharding import ParamDef
from repro_torch.models import lm
from repro_torch.optim.optimizers import (get_optimizer, tree_leaves,
                                          tree_map, tree_unflatten)

# ---------------------------------------------------------------------------
# step inputs
# ---------------------------------------------------------------------------


def batch_defs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, ParamDef]:
    b, s = shape.global_batch, shape.seq_len
    defs = {
        "tokens": ParamDef((b, s), init="zeros", dtype=torch.int32),
        "labels": ParamDef((b, s), init="zeros", dtype=torch.int32),
    }
    if cfg.prefix_len:
        defs["prefix_embed"] = ParamDef((b, cfg.prefix_len, cfg.d_model),
                                        init="zeros", dtype=cfg.dtype)
    return defs


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------

def make_train_step(cfg: ModelConfig, tcfg: TrainConfig) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, with microbatch gradient accumulation.

    ``params`` is a tree of tensors that require grad. With
    ``tcfg.microbatches`` = k > 1 the batch is cut into k slices along its
    first axis; each one's gradient is added into a float32 sum, and the
    sum, the loss and its parts are divided by k, as the reference does.
    The optimizer (``cfg.optimizer``) then updates ``params`` and
    ``opt_state`` in place (``optim/optimizers.py``). ``metrics`` holds
    ``loss``, ``xent``, ``aux``, ``z_loss``, ``lr`` and ``grad_norm``,
    float32 tensors on the device."""
    opt = get_optimizer(cfg.optimizer)

    def value_and_grad(params, mb):
        leaves = tree_leaves(params)
        loss, parts = lm.lm_loss(params, mb, cfg)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return loss.detach(), {k: v.detach() for k, v in parts.items()}, \
            tree_unflatten(params, grads)

    def train_step(params, opt_state, batch):
        k = tcfg.microbatches
        if k <= 1:
            loss, parts, grads = value_and_grad(params, batch)
        else:
            n = next(iter(batch.values())).shape[0] // k
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params)
            lsum = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            psum = {key: torch.zeros_like(lsum)
                    for key in ("xent", "aux", "z_loss")}
            for i in range(k):
                mb = {key: v[i * n:(i + 1) * n] for key, v in batch.items()}
                loss_i, parts_i, g = value_and_grad(params, mb)
                tree_map(lambda s, gg: s.add_(gg.to(torch.float32)), gsum, g)
                lsum = lsum + loss_i
                psum = {key: psum[key] + parts_i[key] for key in psum}
            grads = tree_map(lambda g: g / k, gsum)
            loss = lsum / k
            parts = {key: v / k for key, v in psum.items()}
        params, opt_state, om = opt.update(params, grads, opt_state, tcfg)
        return params, opt_state, {"loss": loss, **parts, **om}

    return train_step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """``prefill_step(params, caches, batch) -> (last-position logits,
    caches)``."""
    @torch.no_grad()
    def prefill_step(params, caches, batch):
        return lm.prefill(params, batch["tokens"], caches, cfg,
                          prefix_embed=batch.get("prefix_embed"))
    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    """``serve_step(params, caches, inputs) -> (logits, caches)`` for one
    token a sequence; ``inputs["position"]`` is the number of tokens
    already in the cache."""
    @torch.no_grad()
    def serve_step(params, caches, inputs):
        return lm.decode_step(params, inputs["token"], caches, cfg,
                              position=int(inputs["position"]))
    return serve_step


__all__ = ["batch_defs", "make_decode_step", "make_prefill_step",
           "make_train_step"]
