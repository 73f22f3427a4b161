"""Move parameter trees between the JAX package and the port.

The JAX side keeps its weights as a pytree of dicts and lists; as numpy
(``jax.tree_util.tree_map(np.asarray, params)``) it has the same nesting as
the port's parameters, leaf for leaf, in the same ``(d_in, d_out)`` layout.
The JAX checkpoint format itself is read and written by
``repro_torch/checkpoint/checkpoint.py``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device


def params_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """A tree of numpy arrays (dicts, lists, tuples) as tensors on
    ``device``; the structure is kept, tuples become lists."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return torch.from_numpy(np.array(node, copy=True)).to(dev)

    return conv(tree)


def params_to_numpy(params: Any) -> Any:
    """The port's parameters as a tree of numpy arrays (on the host)."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_to_numpy(v) for v in params]
    return params.detach().cpu().numpy()


def _from_defs(tree: Any, defs: Any, dev: torch.device, what: str) -> Any:
    """A numpy tree as tensors shaped and typed by the ``ParamDef`` tree
    ``defs`` (``ValueError`` on a missing, extra or misshapen leaf)."""
    from repro_torch.distributed.sharding import ParamDef

    def conv(node, d, path):
        if isinstance(d, ParamDef):
            a = np.asarray(node)
            if tuple(a.shape) != tuple(d.shape):
                raise ValueError(f"{path}: shape {tuple(a.shape)}, the "
                                 f"port expects {tuple(d.shape)}")
            # a JAX bfloat16 leaf widens to float32 exactly first
            a = np.array(a, dtype=np.float32 if d.dtype.is_floating_point
                         else a.dtype)
            return torch.from_numpy(a).to(device=dev, dtype=d.dtype)
        if isinstance(d, dict):
            if not isinstance(node, dict) or set(node) != set(d):
                raise ValueError(f"{path}: keys {sorted(node)}, the port "
                                 f"expects {sorted(d)}")
            return {k: conv(node[k], d[k], f"{path}.{k}") for k in d}
        if not isinstance(node, (list, tuple)) or len(node) != len(d):
            raise ValueError(f"{path}: expected a sequence of {len(d)}")
        return type(d)(conv(n, x, f"{path}[{i}]")
                       for i, (n, x) in enumerate(zip(node, d)))

    return conv(tree, defs, what)


def lm_params_from_jax(tree: Any, cfg, device: DeviceLike = None) -> Any:
    """The JAX LM's parameters (``repro/models/lm.py``, as numpy) as the
    port's: every leaf's shape checked against ``lm_param_defs(cfg)``
    (``ValueError`` on a missing, extra or misshapen leaf) and cast to its
    definition's dtype: ``cfg.dtype`` for most leaves, float32 for those
    whose definition says so in any model (the MoE router, mamba's
    ``a_log``, ``d_skip`` and ``dt_bias``, the RG-LRU's ``lam``). A bf16
    leaf arrives from numpy as JAX's ml_dtypes bfloat16, which widens to
    float32 exactly before the cast. The stack's ``groups`` come back as a
    tuple, as the port's defs have them."""
    from repro_torch.models.lm import lm_param_defs
    return _from_defs(tree, lm_param_defs(cfg), resolve_device(device),
                      "params")


def opt_state_from_jax(tree: Any, cfg, device: DeviceLike = None) -> Any:
    """The JAX optimizer state of an LM (``repro/optim/optimizers.py``'s
    tree for ``cfg.optimizer``, as numpy) as the port's: ``step`` int32 and
    float32 ``m`` / ``v`` or ``vr`` / ``vc``, every leaf checked against
    the port's state definitions as ``lm_params_from_jax`` checks the
    parameters. With both, the two packages start from the same params
    and optimizer state."""
    from repro_torch.models.lm import lm_param_defs
    from repro_torch.optim.optimizers import get_optimizer
    defs = get_optimizer(cfg.optimizer).state_defs(lm_param_defs(cfg))
    return _from_defs(tree, defs, resolve_device(device), "opt")
