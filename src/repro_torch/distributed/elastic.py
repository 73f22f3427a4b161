"""Elastic scaling: restore a checkpoint onto a different mesh.

The twin of ``repro/distributed/elastic.py``. Checkpoints hold unsharded
host arrays (``checkpoint/checkpoint.py``), so elasticity is recomputing
the shardings for the new mesh and placing each leaf with ``device_put``
on restore. The token stream is deterministic in (seed, step), so a
resized job resumes the exact stream with a new batch slice a position.

``remesh_plan`` also checks that the new mesh can hold the model (the
sharded dimensions divide), failing fast with the reference's message
instead of a mid-restore crash.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.distributed.sharding import (Mesh, ShardingRules, map_defs,
                                              param_shardings)


def remesh_plan(defs: Any, rules: ShardingRules, new_mesh: Mesh) -> Any:
    """Shardings for ``defs`` on ``new_mesh``; raises on indivisibility."""
    shardings = param_shardings(defs, rules, new_mesh)
    flat: list = []
    map_defs(lambda d: flat.append((d, rules.spec(*d.logical_axes))), defs)
    axis_sizes = dict(zip(new_mesh.axis_names,
                          np.array(new_mesh.devices.shape)))
    for d, spec in flat:
        for dim, name in zip(d.shape, spec):
            if name is None:
                continue
            names = name if isinstance(name, tuple) else (name,)
            n = 1
            for nm in names:
                n *= int(axis_sizes[nm])
            if dim % n:
                raise ValueError(
                    f"cannot remesh: dim {dim} of {d.shape} not divisible "
                    f"by axis product {n} ({names}) on mesh "
                    f"{dict(axis_sizes)}")
    return shardings


def elastic_restore(ckpt_root, defs: Any, rules: ShardingRules,
                    new_mesh: Mesh, like: Any
                    ) -> Optional[Tuple[int, Any, Dict]]:
    """``restore_latest`` with every leaf placed on ``new_mesh``."""
    from repro_torch.checkpoint.checkpoint import restore_latest
    shardings = remesh_plan(defs, rules, new_mesh)
    return restore_latest(ckpt_root, like, shardings=shardings)
