"""Ring hand-offs between the members of a gang of executors.

The twin of the ring part of ``repro/distributed/pipeline.py``. There,
``ring_shift`` is a ``ppermute`` inside ``shard_map``: every device of a
mesh axis sends its value ``steps`` hops forward. The port's executors are
threads of one process, each with its own device and (on a GPU) its own
stream, so the ring is a list of K tensors in ring order and a shift hands
each position the part of the position ``steps`` hops back: copied to the
receiver's device, and on a GPU ordered by an event recorded on the
sender's stream that the receiver's stream waits on. On one card the part
is not copied at all: the receiver reads the sender's tensor once its
stream has waited on the event.

The reference's GPipe schedule (``broadcast_from``, ``pipeline_apply``) is
not ported: it belongs to the LM substrate's mesh tooling (ROADMAP queue 1,
item 4).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch


def ring_perm(size: int, *, steps: int = 1) -> List[Tuple[int, int]]:
    """The ring permutation ``i -> (i + steps) % size`` as (source,
    destination) pairs, the reference's ``ppermute`` pairs."""
    return [(i, (i + steps) % size) for i in range(size)]


def ring_shift(parts: Sequence[torch.Tensor], *, steps: int = 1,
               streams: Optional[Sequence[Optional[torch.cuda.Stream]]]
               = None) -> List[torch.Tensor]:
    """Rotate ``parts`` (one tensor per ring position, in ring order)
    ``steps`` hops forward: position i receives part ``(i - steps) % K``.

    ``streams`` are the positions' streams (None on the CPU): position i's
    stream first waits on an event recorded on its source's stream (where
    the part was made), then copies the part to its own device when the two
    differ. The result of position i is used on position i's stream.
    """
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
