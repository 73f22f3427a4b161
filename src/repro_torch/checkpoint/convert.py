"""Move parameter trees between the JAX package and the port.

The JAX side keeps its weights as a pytree of dicts and lists; as numpy
(``jax.tree_util.tree_map(np.asarray, params)``) it has the same nesting as
the port's parameters, leaf for leaf, in the same ``(d_in, d_out)`` layout.
Reading and writing the JAX checkpoint format itself is ROADMAP queue 1
item 5.
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
