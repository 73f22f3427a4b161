"""Parameter definitions and their initialisation.

The twin of the single-device part of ``repro/distributed/sharding.py``:
``ParamDef`` trees are the one source of parameter shapes, and
``init_params`` fills them with ``_init_one``'s rule (normal with a fan-in
scale unless the definition says zeros, ones or a constant). The logical
axes, rule tables and meshes of the JAX module place tensors on a TPU mesh;
one GPU has none, so a ``ParamDef`` here carries no axes.

A tree is dicts, lists, tuples and ``NamedTuple``s of ``ParamDef`` leaves,
with plain Python values (a cache's length) kept as they are.

``replicate_params`` and ``params_compatible`` are the serving pool's
(``core/engine.py``): one parameter replica per executor, and the check
that a hot-reloaded tree may replace the serving one.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import torch

from repro_torch import DeviceLike, resolve_device


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    init: str = "normal"                   # normal | zeros | ones | constant
    scale: Optional[float] = None          # stddev for normal (default fan-in)
    constant: float = 0.0
    dtype: Any = torch.bfloat16


def map_defs(fn, tree: Any) -> Any:
    """``fn`` on every ``ParamDef`` of ``tree`` in order (dict keys as
    given, then sequences), the structure kept; other leaves unchanged."""
    if isinstance(tree, ParamDef):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_defs(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_defs(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_defs(fn, v) for v in tree)
    return tree


def init_one(generator: torch.Generator, d: ParamDef,
             device: torch.device) -> torch.Tensor:
    """One leaf by ``repro/distributed/sharding.py::_init_one``'s rule,
    drawn in float32 from ``generator`` and cast to ``d.dtype``."""
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=device)
    if d.init == "constant":
        return torch.full(d.shape, d.constant, dtype=d.dtype, device=device)
    if d.scale is not None:
        scale = d.scale
    else:
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return w.mul_(scale).to(d.dtype)


def init_params(generator: torch.Generator, defs: Any,
                device: DeviceLike = None) -> Any:
    """Every leaf of ``defs`` drawn from ``generator`` (which lives on
    ``device``), in tree order. The numbers differ from ``jax.random``'s;
    tests carry JAX weights over through numpy instead."""
    dev = resolve_device(device)
    return map_defs(lambda d: init_one(generator, d, dev), defs)


def zeros_like_defs(defs: Any, device: DeviceLike = None) -> Any:
    """Every leaf of ``defs`` as zeros on ``device`` (caches)."""
    dev = resolve_device(device)
    return map_defs(
        lambda d: torch.zeros(d.shape, dtype=d.dtype, device=dev), defs)


def param_bytes(defs: Any) -> int:
    """Bytes the leaves of ``defs`` take in their dtypes."""
    total = []
    map_defs(lambda d: total.append(
        math.prod(d.shape) * torch.empty((), dtype=d.dtype).element_size()),
        defs)
    return int(sum(total))


def _tree_leaves(tree: Any) -> Tuple[Any, List[Any]]:
    """(structure, leaves) of a tree of dicts (sorted keys), lists, tuples
    and ``NamedTuple``s; the structure records containers, keys and
    lengths, not leaf values."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        subs = [_tree_leaves(tree[k]) for k in keys]
        return (("dict", tuple(keys), tuple(s for s, _ in subs)),
                [x for _, ls in subs for x in ls])
    if isinstance(tree, (list, tuple)):
        subs = [_tree_leaves(v) for v in tree]
        kind = type(tree).__name__ if hasattr(tree, "_fields") else "seq"
        return ((kind, len(tree), tuple(s for s, _ in subs)),
                [x for _, ls in subs for x in ls])
    if tree is None:
        return ("none",), []
    return ("leaf",), [tree]


def _copy_to(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _copy_to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_copy_to(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copy_to(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device, copy=True)
    return tree


def replicate_params(params: Any, devices: Sequence[DeviceLike]) -> list:
    """One copy of ``params`` per entry of ``devices``: a replica per
    EXECUTOR, also where two executors share a device, so that what one
    executor does with its replica (a copy into a captured program's
    resident weights on its own stream) never races another's replays.
    Every leaf tensor is copied, never aliased; a CUDA copy has finished
    when this returns. Returns ``[params_on_dev for dev in devices]``."""
    devs = [resolve_device(d) for d in devices]
    copies = [_copy_to(params, d) for d in devs]
    for d in {d for d in devs if d.type == "cuda"}:
        torch.cuda.synchronize(d)
    return copies


def params_compatible(old: Any, new: Any) -> Optional[str]:
    """Why ``new`` cannot replace ``old`` as a hot-reloaded params tree,
    or ``None`` when it can (same tree structure, leaf shapes, dtypes).

    The serving engine's programs were built on ``old``'s shapes (on a GPU
    captured on tensors of them), so hot reload is same-architecture only:
    anything else is a new engine."""
    s_old, l_old = _tree_leaves(old)
    s_new, l_new = _tree_leaves(new)
    if s_old != s_new:
        return (f"params tree structure changed: {s_new} != serving "
                f"{s_old}")
    for i, (a, b) in enumerate(zip(l_old, l_new)):
        a = a if isinstance(a, torch.Tensor) else torch.as_tensor(a)
        b = b if isinstance(b, torch.Tensor) else torch.as_tensor(b)
        if tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype:
            return (f"params leaf {i} changed: {tuple(b.shape)}/{b.dtype} "
                    f"!= serving {tuple(a.shape)}/{a.dtype}")
    return None
