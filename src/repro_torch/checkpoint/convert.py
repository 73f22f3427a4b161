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


def lm_params_from_jax(tree: Any, cfg, device: DeviceLike = None) -> Any:
    """The JAX LM's parameters (``repro/models/lm.py``, as numpy) as the
    port's: every leaf's shape checked against ``lm_param_defs(cfg)``
    (``ValueError`` on a missing, extra or misshapen leaf) and cast to its
    definition's dtype (``cfg.dtype`` for every LM leaf); the stack's
    ``groups`` come back as a tuple, as the port's defs have them."""
    from repro_torch.distributed.sharding import ParamDef
    from repro_torch.models.lm import lm_param_defs

    dev = resolve_device(device)

    def conv(node, d, path):
        if isinstance(d, ParamDef):
            a = np.asarray(node)
            if tuple(a.shape) != tuple(d.shape):
                raise ValueError(f"{path}: shape {tuple(a.shape)}, the "
                                 f"port expects {tuple(d.shape)}")
            return torch.from_numpy(np.array(a, dtype=np.float32)).to(
                device=dev, dtype=d.dtype)
        if isinstance(d, dict):
            if not isinstance(node, dict) or set(node) != set(d):
                raise ValueError(f"{path}: keys {sorted(node)}, the port "
                                 f"expects {sorted(d)}")
            return {k: conv(node[k], d[k], f"{path}.{k}") for k in d}
        if not isinstance(node, (list, tuple)) or len(node) != len(d):
            raise ValueError(f"{path}: expected a sequence of {len(d)}")
        return type(d)(conv(n, x, f"{path}[{i}]")
                       for i, (n, x) in enumerate(zip(node, d)))

    return conv(tree, lm_param_defs(cfg), "params")
