"""Ring hand-offs and the GPipe schedule over a mesh axis.

The twin of ``repro/distributed/pipeline.py``. ``ring_shift`` has two
forms. Inside ``shard_map`` (``ring_shift(x, axis_name, steps=)``) it is
the reference's: a ``ppermute`` that sends every position's value
``steps`` hops forward along the axis. Outside, ``ring_shift(parts,
steps=, streams=)`` is the wide-placement form: the serving engine's
executors are threads of one process, each with its own device and (on a
GPU) its own stream, so the ring is a list of K tensors in ring order and
a shift hands each position the part of the position ``steps`` hops back:
copied to the receiver's device, and on a GPU ordered by an event recorded
on the sender's stream that the receiver's stream waits on. On one card
the part is not copied at all: the receiver reads the sender's tensor once
its stream has waited on the event.

GPipe (``pipeline_apply``): the layer stack is split into ``n_stages``
contiguous chunks, one a position of the pipeline axis, and microbatches
stream through: at step t stage s runs microbatch t - s and hands its
activations to stage s + 1 (``ring_shift``), the fill / steady / drain
schedule over ``n_micro + n_stages - 1`` steps. As in the reference every
stage runs ``stage_fn`` at every step, its bubbles on zeros included, and
the last stage's outputs reach every stage by ``broadcast_from``.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.distributed.collectives import (axis_index, axis_size,
                                                 ppermute, psum, shard_map)
from repro_torch.distributed.sharding import Mesh, P, map_tree


def ring_perm(size: int, *, steps: int = 1) -> List[Tuple[int, int]]:
    """The ring permutation ``i -> (i + steps) % size`` as (source,
    destination) pairs, the reference's ``ppermute`` pairs."""
    return [(i, (i + steps) % size) for i in range(size)]


def ring_shift(parts, axis_name: Optional[str] = None, *, steps: int = 1,
               size: Optional[int] = None,
               streams: Optional[Sequence[Optional[torch.cuda.Stream]]]
               = None):
    """Rotate values ``steps`` hops forward around a ring.

    Inside ``shard_map``, with ``axis_name``: ``parts`` is this position's
    tensor, and the position at ring index i receives the value of index
    ``(i - steps) % size`` (``size`` defaults to the axis's).

    Outside, without ``axis_name``: ``parts`` is one tensor per ring
    position, in ring order, and position i receives part ``(i - steps) %
    K``. ``streams`` are the positions' streams (None on the CPU): position
    i's stream first waits on an event recorded on its source's stream
    (where the part was made), then copies the part to its own device when
    the two differ. The result of position i is used on position i's
    stream.
    """
    if axis_name is not None:
        if size is None:
            size = axis_size(axis_name)
        return ppermute(parts, axis_name, ring_perm(size, steps=steps))
    k = len(parts)
    out: List[torch.Tensor] = []
    for dst in range(k):
        src = (dst - steps) % k
        part = parts[src]
        if streams is None or streams[dst] is None:
            out.append(part.to(parts[dst].device))
            continue
        event = torch.cuda.Event()
        event.record(streams[src])
        streams[dst].wait_event(event)
        with torch.cuda.stream(streams[dst]):
            out.append(part.to(parts[dst].device, non_blocking=True))
    return out


def broadcast_from(x: torch.Tensor, axis_name: str, src: int) -> torch.Tensor:
    """``x`` of ring position ``src`` on every position of ``axis_name``.

    A one-to-all broadcast is not a permutation, so, as in the reference,
    it is mask + psum: every position contributes zeros except ``src``, and
    the sum (in position order) is the broadcast. Runs inside
    ``shard_map``."""
    stage = axis_index(axis_name)
    return psum(x if stage == src else torch.zeros_like(x), axis_name)


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x_microbatches: torch.Tensor, *,
                   mesh: Mesh, axis_name: str = "pod"):
    """Run microbatches through a pipeline over ``axis_name``.

    stage_fn(params_for_stage, x) -> x          (one stage's computation)
    stage_params: tree whose leaves have leading dim n_stages (a ``Sharded``
                  tree split over ``axis_name`` is used as it lies)
    x_microbatches: (n_micro, mb, ...) activations entering stage 0

    Returns the (n_micro, mb, ...) outputs of the final stage, a
    ``Sharded`` replicated over the mesh (``.gather()`` for the tensor)."""
    n_stages = mesh.shape[axis_name]

    def local(params, xs):
        # params: this stage's slice; xs: all microbatches (only stage 0
        # reads them; the others take the permuted inputs)
        params = map_tree(lambda p: p[0], params)      # drop the stage dim
        stage = axis_index(axis_name)
        n_micro = xs.shape[0]
        acc = torch.zeros_like(xs)
        inflight = torch.zeros_like(xs[0])
        for t in range(n_micro + n_stages - 1):
            # stage 0 injects microbatch t (the last one again in the drain)
            x_in = xs[min(t, n_micro - 1)] if stage == 0 else inflight
            y = stage_fn(params, x_in)
            inflight = ring_shift(y, axis_name, size=n_stages)
            # the last stage emits microbatch t - n_stages + 1
            out_idx = t - (n_stages - 1)
            if out_idx >= 0 and stage == n_stages - 1:
                acc[out_idx] = y
        return broadcast_from(acc, axis_name, n_stages - 1)

    return shard_map(local, mesh=mesh, in_specs=(P(axis_name), P()),
                     out_specs=P())(stage_params, x_microbatches)
