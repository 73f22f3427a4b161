"""Step builders shared by the trainer and the server.

The twin of ``repro/launch/steps.py``: ``build_rules`` picks a
deployment's rule table, ``batch_defs`` declares a step's inputs as
``ParamDef``s, ``make_train_step`` builds the training step (the loss, its
gradient by autograd, microbatch accumulation, the optimizer), and
``make_prefill_step`` / ``make_decode_step`` the serving steps (under
``torch.no_grad``).

On a mesh the training step is one ``shard_map``
(``distributed/collectives.py``) for any rule table ``build_rules(cfg,
mesh, "train")`` gives, for every family: data parallelism, tensor,
sequence and vocab parallelism, the experts, Mamba2's SSD heads and the
RG-LRU's width over ``model``, FSDP over the data axes. Its
``in_specs`` are the parameter and optimizer-state specs of the rules
(``param_specs``) and ``P(batch)`` for the batch. Each position holds its
pieces of the weights and state, takes its rows of the batch (position i
of K batch shards the contiguous rows [i B/K, (i+1) B/K)) and runs the
layers' model-axis and FSDP forms (``distributed/tensor_parallel.py``),
the loss ending in the vocab-parallel cross-entropy
(``models/lm.py::lm_loss_sums``). The loss is the global batch's, as the
reference's GSPMD step computes it: a shard's NLL divided by the whole
microbatch's mask sum, a microbatch a slice of the global batch, the MoE
routing the global token groups (``nn/moe.py::TokenShards``). Its
gradient is taken by ``collectives.grad``: autograd over the position's
graph between its collectives, each collective's transpose in between,
in the position's own thread (never on autograd's worker thread, which
the positions on a card share), with remat recomputed there too
(``collectives.checkpoint``). The loss the positions of the model axis
hold alike is seeded with one over their number, so that each
collective's transpose adds every position's part once. Then each leaf's
gradient is reduced once over the positions that share its piece: a
``psum`` over the mesh axes its spec does not split it over (the data
axes for a replicated weight, also ``model`` for one the model axis
repeats, such as a norm scale or the router); an FSDP leaf's data axes
are summed already by its gather's transpose (``psum_scatter``). The
optimizer then updates each position's pieces (``optim/optimizers.py``
with the specs: the global norm and Adafactor's statistics completed over
the axes that split a leaf).

The serving steps on a mesh are tensor, sequence, vocab and expert
parallel, and FSDP where the rules split a weight over a data axis: one
``shard_map`` a step, whose ``in_specs`` are the parameter, cache and
batch specs of ``rules`` and whose ``out_specs`` are ``P()`` for the
logits (gathered whole on every position) and the cache specs for the
caches. Each position holds its pieces of the weights and caches
(``param_specs(lm_param_defs(cfg), rules)``, ``param_specs(lm_cache_defs(
...), rules)``) and its layers call the collectives where the reference's
GSPMD puts them (``distributed/tensor_parallel.py``, ``nn/attention.py``,
``nn/mlp.py``, ``nn/moe.py``, ``nn/ssm.py``, ``nn/rglru.py``,
``models/lm.py``). The steps return the caches as ``Sharded`` trees, and
decode takes them back.

``lowering_bundle`` gives the dry run (``launch/dryrun.py``) a step on a
mesh and its whole inputs as ``meta`` tensors: one run of the step on
meta positions under a ``repro_torch/counter.py::Counter`` is the port's
lowering, as the reference's ``lowering_bundle`` is lowered and compiled.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.distributed import collectives
from repro_torch.distributed.collectives import (all_gather, axis_index,
                                                 psum, shard_map)
from repro_torch.distributed.sharding import (Mesh, P, ParamDef, Sharded,
                                              ShardingRules, abstract_params,
                                              axis_names_of, device_put,
                                              gather,
                                              make_dp_only_rules, make_rules,
                                              map_tree,
                                              param_shardings, param_specs)
from repro_torch.launch.mesh import data_axis_names
from repro_torch.models import lm
from repro_torch.nn.moe import TokenShards
from repro_torch.optim.optimizers import (get_optimizer, tree_leaves,
                                          tree_map, tree_unflatten)


def build_rules(cfg: ModelConfig, mesh: Optional[Mesh], kind: str,
                global_batch: int = 0) -> ShardingRules:
    """The rule table of ``cfg``'s sharding profile on ``mesh`` for a
    ``kind`` step (train / prefill / decode), as the reference picks it."""
    data_axes = data_axis_names(mesh) if mesh is not None else ("data",)
    if cfg.sharding_profile == "dp_only":
        rules = make_dp_only_rules(data_axes=data_axes)
        if mesh is not None and global_batch:
            n = mesh.devices.size
            if global_batch % n:
                t = dict(rules.table)
                t["batch"] = data_axes if len(data_axes) > 1 else data_axes[0]
                rules = ShardingRules(table=t)
        return rules
    # KV-cache layout: shard on kv-heads when they divide the model axis
    # (keeps decode attention collective-free and the cache update local);
    # otherwise shard on seq (flash-decoding combine via all-reduce).
    model_size = mesh.shape["model"] if mesh is not None else 1
    heads_ok = cfg.num_kv_heads and cfg.num_kv_heads % model_size == 0
    rules = make_rules(
        data_axes=data_axes,
        fsdp=cfg.fsdp,
        expert_fsdp=cfg.expert_fsdp,
        shard_seq_for_decode=(kind in ("decode", "prefill")
                              and not heads_ok),
        seq_parallel=(kind != "decode"),
    )
    if mesh is not None and global_batch:
        n_data = 1
        for a in data_axes:
            n_data *= mesh.shape[a]
        if global_batch % n_data:
            # batch-1 long-context decode etc: batch cannot shard
            t = dict(rules.table)
            t["batch"] = None
            rules = ShardingRules(table=t)
    return rules


# ---------------------------------------------------------------------------
# step inputs
# ---------------------------------------------------------------------------


def batch_defs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, ParamDef]:
    b, s = shape.global_batch, shape.seq_len
    defs = {
        "tokens": ParamDef((b, s), ("batch", None), init="zeros",
                           dtype=torch.int32),
        "labels": ParamDef((b, s), ("batch", None), init="zeros",
                           dtype=torch.int32),
    }
    if cfg.prefix_len:
        defs["prefix_embed"] = ParamDef(
            (b, cfg.prefix_len, cfg.d_model), ("batch", None, None),
            init="zeros", dtype=cfg.dtype)
    return defs


def decode_input_defs(cfg: ModelConfig, shape: ShapeConfig
                      ) -> Dict[str, ParamDef]:
    b = shape.global_batch
    return {
        "token": ParamDef((b, 1), ("batch", None), init="zeros",
                          dtype=torch.int32),
        "position": ParamDef((), (), init="zeros", dtype=torch.int32),
    }


def prefill_input_defs(cfg: ModelConfig, shape: ShapeConfig
                       ) -> Dict[str, ParamDef]:
    defs = batch_defs(cfg, shape)
    del defs["labels"]
    return defs


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------

def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    rules: Optional[ShardingRules] = None,
                    mesh: Optional[Mesh] = None) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, with microbatch gradient accumulation; on ``mesh``, the
    sharded step of ``make_sharded_train_step``.

    ``params`` is a tree of tensors that require grad. With
    ``tcfg.microbatches`` = k > 1 the batch is cut into k slices along its
    first axis; each one's gradient is added into a float32 sum, and the
    sum, the loss and its parts are divided by k, as the reference does.
    The optimizer (``cfg.optimizer``) then updates ``params`` and
    ``opt_state`` in place (``optim/optimizers.py``). ``metrics`` holds
    ``loss``, ``xent``, ``aux``, ``z_loss``, ``lr`` and ``grad_norm``,
    float32 tensors on the device."""
    if mesh is not None:
        return make_sharded_train_step(cfg, tcfg, rules, mesh)
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


def make_sharded_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                            rules: Optional[ShardingRules], mesh: Mesh
                            ) -> Callable:
    """The ``train_step(params, opt_state, batch)`` of ``rules`` on
    ``mesh`` (see the module's docstring). ``params`` and ``opt_state``
    are trees of ``Sharded`` leaves placed by the rules (plain tensors are
    placed first, each position owning its piece), updated in place
    position by position and returned; ``batch`` holds whole tensors (or
    ``Sharded`` ones) split by rows over the batch axes. ``metrics`` are
    position 0's tensors.

    With k = ``tcfg.microbatches`` and K batch shards, either K divides k
    (each position runs k / K whole microbatches) or k divides K (a
    microbatch spans K / k positions); other pairs raise
    ``NotImplementedError``."""
    rules = rules if rules is not None else build_rules(cfg, mesh, "train")
    opt = get_optimizer(cfg.optimizer)
    pdefs = lm.lm_param_defs(cfg)
    odefs = opt.state_defs(pdefs)
    pspecs, ospecs = param_specs(pdefs, rules), param_specs(odefs, rules)
    shardings = {"params": param_shardings(pdefs, rules, mesh),
                 "opt": param_shardings(odefs, rules, mesh)}
    batch_axis = rules.axis("batch")
    names = axis_names_of(batch_axis)
    shards = mesh.axis_sizes(batch_axis)
    k = max(tcfg.microbatches, 1)
    if k % shards and shards % k:
        raise NotImplementedError(
            f"{k} microbatches over {shards} batch shards: one must divide "
            f"the other")
    per, span = (k // shards, 1) if k % shards == 0 else (1, shards // k)
    # the positions holding one batch shard hold the same loss: each seeds
    # its share, so that every collective's transpose counts it once
    seed = shards / mesh.size
    # each leaf's gradient summed over the positions sharing its piece
    reduce_over: Dict[Tuple[str, ...], list] = {}
    for j, spec in enumerate(tree_leaves(pspecs)):
        used = {n for e in spec for n in axis_names_of(e)}
        axes = tuple(n for n in mesh.axis_names
                     if mesh.shape[n] > 1 and n not in used)
        if axes:
            reduce_over.setdefault(axes, []).append(j)

    def local(params, opt_state, batch):
        i = axis_index(names) if names else 0
        first = i // span * span

        def group(t: torch.Tensor) -> torch.Tensor:
            """Every member's ``t`` of this position's microbatch group."""
            if span == 1:
                return t[None]
            return all_gather(t, names)[first:first + span]

        leaves = [p.requires_grad_() for p in tree_leaves(params)]
        dev = leaves[0].device
        rows = next(iter(batch.values())).shape[0] // per
        gsum = None
        sums = {key: torch.zeros((), dtype=torch.float32, device=dev)
                for key in ("loss", "xent", "aux", "z_loss")}
        for m in range(per):
            mb = {key: v[m * rows:(m + 1) * rows] for key, v in batch.items()}
            mask = mb.get("mask")
            mask_sum = (mask.to(torch.float32).sum() if mask is not None
                        else torch.tensor(float(mb["tokens"].numel()),
                                          device=dev))
            denom = torch.clamp(group(mask_sum).sum(), min=1.0)
            nll, z, _, aux = lm.lm_loss_sums(
                params, mb, cfg,
                token_shards=TokenShards(span, i - first, group),
                rules=rules, mesh=mesh)
            part = {"xent": nll / denom, "z_loss": 1e-4 * z / denom,
                    "aux": aux}
            loss = part["xent"] + part["z_loss"] + cfg.router_aux_coef * aux
            grads = collectives.grad(loss, leaves,
                                     torch.full_like(loss, seed))
            # microbatches add up in float32; one batch keeps each
            # gradient in its parameter's dtype, as the unsharded step
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(leaves, grads)]
            if k > 1:
                grads = [g.to(torch.float32) for g in grads]
            gsum = grads if gsum is None else [
                s.add_(g) for s, g in zip(gsum, grads)]
            for key, v in {"loss": loss, **part}.items():
                sums[key] = sums[key] + v.detach()
        for axes, idx in reduce_over.items():           # added in float32
            for j, g in zip(idx, psum([gsum[j].to(torch.float32)
                                       for j in idx], axes)):
                gsum[j] = g
        if names:
            sums = psum(sums, names)
        if k > 1:
            gsum = [g / k for g in gsum]
            sums = {key: v / k for key, v in sums.items()}
        params, opt_state, om = opt.update(
            params, tree_unflatten(params, gsum), opt_state, tcfg,
            specs=pspecs)
        return params, opt_state, {**sums, **om}

    mapped = shard_map(local, mesh=mesh,
                       in_specs=(pspecs, ospecs, P(batch_axis)),
                       out_specs=(pspecs, ospecs, P()))

    def train_step(params, opt_state, batch):
        def placed(tree, where):
            return map_tree(lambda x, s: x if isinstance(x, Sharded)
                            else device_put(x, s), tree, where)
        params, opt_state, metrics = mapped(
            placed(params, shardings["params"]),
            placed(opt_state, shardings["opt"]), batch)
        return params, opt_state, gather(metrics)

    return train_step


def make_prefill_step(cfg: ModelConfig,
                      rules: Optional[ShardingRules] = None,
                      mesh: Optional[Mesh] = None) -> Callable:
    """``prefill_step(params, caches, batch) -> (last-position logits,
    caches)``; on ``mesh``, the model-parallel step (the module's
    docstring)."""
    if mesh is not None:
        rules = rules if rules is not None else build_rules(cfg, mesh,
                                                            "prefill")

        def run(params, caches, batch, shards):
            return lm.prefill(params, batch["tokens"], caches, cfg,
                              prefix_embed=batch.get("prefix_embed"),
                              rules=rules, mesh=mesh, token_shards=shards)
        return _serving_step(cfg, rules, mesh, run)

    @torch.no_grad()
    def prefill_step(params, caches, batch):
        return lm.prefill(params, batch["tokens"], caches, cfg,
                          prefix_embed=batch.get("prefix_embed"))
    return prefill_step


def make_decode_step(cfg: ModelConfig,
                     rules: Optional[ShardingRules] = None,
                     mesh: Optional[Mesh] = None) -> Callable:
    """``serve_step(params, caches, inputs) -> (logits, caches)`` for one
    token a sequence; ``inputs["position"]`` is the number of tokens
    already in the cache. On ``mesh``, the model-parallel step."""
    if mesh is not None:
        rules = rules if rules is not None else build_rules(cfg, mesh,
                                                            "decode")

        def run(params, caches, inputs, shards):
            return lm.decode_step(params, inputs["token"], caches, cfg,
                                  position=inputs["position"], rules=rules,
                                  mesh=mesh, token_shards=shards)
        return _serving_step(cfg, rules, mesh, run)

    @torch.no_grad()
    def serve_step(params, caches, inputs):
        return lm.decode_step(params, inputs["token"], caches, cfg,
                              position=int(inputs["position"]))
    return serve_step


def _serving_step(cfg: ModelConfig, rules: ShardingRules, mesh: Mesh,
                  run: Callable) -> Callable:
    """A serving step on ``mesh``: ``run(params, caches, inputs, shards)``
    once a position under ``torch.no_grad``, in one ``shard_map``. Returns
    ``step(params, caches, inputs) -> (logits on position 0's device,
    caches as a tree of Sharded)``. ``params`` and ``caches`` may be whole
    tensors (split by their specs: a position on their device reads a view,
    and the caches are written in place there) or ``Sharded`` trees; the
    inputs' tensors are split by rows over the batch axes."""
    pspecs = param_specs(lm.lm_param_defs(cfg), rules)
    cspecs = map_tree(lambda spec: spec if isinstance(spec, P) else None,
                      param_specs(lm.lm_cache_defs(cfg, 1, 1), rules))
    batch_ax = rules.axis("batch")
    names = axis_names_of(batch_ax)
    shards = mesh.axis_sizes(batch_ax)

    @torch.no_grad()
    def local(params, caches, inputs):
        token_shards = None
        if cfg.num_experts and shards > 1:
            token_shards = TokenShards(shards, axis_index(names),
                                       lambda t: all_gather(t, names))
        logits, caches = run(params, caches, inputs, token_shards)
        if shards > 1:
            logits = all_gather(logits, names, axis=0, tiled=True)
        return logits, caches

    def step(params, caches, inputs):
        inputs = {k: int(v) if k == "position" else v
                  for k, v in inputs.items()}
        ispecs = {k: None if k == "position" else P(batch_ax)
                  for k in inputs}
        logits, caches = shard_map(local, mesh=mesh,
                                   in_specs=(pspecs, cspecs, ispecs),
                                   out_specs=(P(), cspecs))(
            params, caches, inputs)
        return logits.gather(), caches
    return step


# ---------------------------------------------------------------------------
# the dry run's bundle: a step on a mesh and its whole inputs on meta
# ---------------------------------------------------------------------------

def lowering_bundle(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
                    tcfg: Optional[TrainConfig] = None
                    ) -> Tuple[Callable, tuple]:
    """(step, args) with ``step(*args)`` the ``shape.kind`` step of
    ``cfg`` on ``mesh`` under ``build_rules(cfg, mesh, kind,
    global_batch=...)``, and ``args`` its whole inputs as ``meta`` tensors
    (``abstract_params``), which the step's ``shard_map`` splits by their
    specs: (params, opt_state, batch) for training, (params, caches,
    batch) for prefill, (params, caches, inputs) for decode. Training
    takes ``cfg.train_microbatches`` where ``tcfg`` asks for one, as the
    reference does. Decode's ``position`` is a Python int, the cache's last
    slot: the decode attends over the whole cache under a mask
    (``nn/attention.py``), so what it does does not depend on it."""
    kind = shape.kind
    rules = build_rules(cfg, mesh, kind, global_batch=shape.global_batch)
    pdefs = lm.lm_param_defs(cfg)
    p_abs = abstract_params(pdefs)
    if kind == "train":
        tcfg = tcfg or TrainConfig()
        if cfg.train_microbatches > 1 and tcfg.microbatches == 1:
            tcfg = dataclasses.replace(
                tcfg, microbatches=cfg.train_microbatches)
        opt = get_optimizer(cfg.optimizer)
        step = make_train_step(cfg, tcfg, rules, mesh)
        return step, (p_abs, abstract_params(opt.state_defs(pdefs)),
                      abstract_params(batch_defs(cfg, shape)))
    c_abs = abstract_params(lm.lm_cache_defs(cfg, shape.global_batch,
                                             shape.seq_len))
    if kind == "prefill":
        step = make_prefill_step(cfg, rules, mesh)
        return step, (p_abs, c_abs,
                      abstract_params(prefill_input_defs(cfg, shape)))
    if kind == "decode":
        idefs = decode_input_defs(cfg, shape)
        del idefs["position"]
        inputs = {**abstract_params(idefs), "position": shape.seq_len - 1}
        return make_decode_step(cfg, rules, mesh), (p_abs, c_abs, inputs)
    raise ValueError(kind)


__all__ = ["batch_defs", "build_rules", "decode_input_defs",
           "lowering_bundle", "make_decode_step", "make_prefill_step",
           "make_sharded_train_step", "make_train_step",
           "prefill_input_defs"]
