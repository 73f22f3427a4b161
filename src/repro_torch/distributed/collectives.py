"""``shard_map`` and the collectives over named mesh axes.

The twin of ``repro/distributed/sharding.py::compat_shard_map`` and of the
``jax.lax`` collectives the reference uses inside it (``psum``, ``pmax``,
``pmean``, ``psum_scatter``, ``axis_index``, ``axis_size``, ``ppermute``,
``all_gather``, untiled and tiled).

One controller, one thread a position. ``shard_map(f, mesh=, in_specs=,
out_specs=)`` splits its inputs by their specs (``distributed/
sharding.py::NamedSharding``) and runs ``f`` once a position of the mesh,
each in its own thread: under ``torch.cuda.device`` and
``torch.cuda.stream`` of the position's own stream on a GPU, in the
caller's grad (or inference) mode, which PyTorch keeps per thread. The
outputs come back as ``Sharded`` tensors assembled by ``out_specs``: a
dimension named there is the positions' pieces side by side, an unnamed
one is taken as replicated (each position keeps its own piece, as with
``check_vma=False`` in JAX).

Collectives meet at a rendezvous of the threads of the named axes (the
positions that differ only in those axes' coordinates), in the order each
thread calls them. A reduction is done by one thread, the group's first
position, in fixed position order, and the others take a copy of its
result: the same bits on the CPU, on one card and on several. A tensor
handed between two positions on one card is read on the receiver's stream
after it waits on an event the sender recorded, and is recorded on the
receiver's stream so that the caching allocator does not hand its memory
out again before the read; between two devices it is copied on the
sender's stream. The position streams wait on the caller's stream before
``f`` starts, and the caller's stream waits on them before ``shard_map``
returns.

Gradients across positions. Under grad mode a collective whose input
requires grad is a function of this position's graph only: its output is
a fresh leaf, and the cut is written on the position's tape with the
collective's transpose, which ``grad`` calls in the position's own thread
while it walks the tape backwards, running ``torch.autograd.grad`` over
each segment between two cuts. No rendezvous therefore ever runs on
autograd's worker thread, which a card's positions share (a backward that
waited there would block the other positions' nodes). The transposes are
those of the collectives as linear maps of every position's value, each
position's seeded output a term of one global loss: ``psum`` ↔ ``psum``,
``pmean`` ↔ ``pmean``, the tiled ``all_gather`` ↔ ``psum_scatter``,
``ppermute`` ↔ its inverse; ``pmax`` has none (it is applied to detached
values). So a value the positions hold alike carries a part of its
cotangent on each, and a loss they hold alike is seeded with one over
their number (``launch/steps.py``). ``checkpoint`` is remat on the same
tape: the forward runs without a graph and is recomputed in ``grad``, in
the position's thread, so that its collectives meet again there.

Process-wide settings (TF32, deterministic algorithms, intra-op threads)
are the caller's to set before ``shard_map``; a position's thread never
sets them. An exception in one position is raised in the caller once every
thread has ended: a position waiting at a rendezvous is released (and its
own work abandoned), and a position that returns without joining a
collective the others wait at fails them with an error naming it. With a
rendezvous timeout set (``rendezvous_timeout``) a position that waits
longer at a rendezvous fails the call with an error naming the
collective, and ``shard_map`` raises it even where another position's
thread never returns.
"""

from __future__ import annotations

import math
import threading
import time
from contextlib import ExitStack, contextmanager
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.distributed.sharding import (Mesh, MeshAxis, NamedSharding,
                                              P, Sharded, axis_names_of,
                                              shard, tree_leaves,
                                              tree_unflatten)

_LOCAL = threading.local()
# seconds a position may wait at one rendezvous (None: no limit)
_TIMEOUT: Dict[str, Optional[float]] = {"s": None}


class _Abandoned(Exception):
    """Raised in a position whose ``shard_map`` failed in another one."""


class _Call:
    """One ``shard_map`` call: its rendezvous slots and its first error."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.cond = threading.Condition()
        self.error: Optional[BaseException] = None
        self.done: set = set()
        self.slots: Dict[Tuple, Dict[str, Any]] = {}


class _Position:
    """The thread-local state of one position inside a ``shard_map``."""

    def __init__(self, call: _Call, coord: Tuple[int, ...]):
        self.call = call
        self.coord = coord
        self.device: torch.device = call.mesh.devices[coord]
        self.stream = call.mesh.streams[coord]
        self.seqs: Dict[Tuple, int] = {}
        self.tapes: List[_Tape] = [_Tape()]
        self.recomputing = 0


def _here() -> _Position:
    pos = getattr(_LOCAL, "position", None)
    if pos is None:
        raise RuntimeError("mesh collectives run inside shard_map")
    return pos


def _group(pos: _Position, axis_name: MeshAxis):
    """(group key, this position's index in it, its members' coordinates in
    row-major order over the named axes)."""
    mesh = pos.call.mesh
    names = axis_names_of(axis_name)
    unknown = [n for n in names if n not in mesh.shape]
    if unknown or not names:
        raise ValueError(f"axis {axis_name!r} is not an axis of {mesh}")
    coord = dict(zip(mesh.axis_names, pos.coord))
    idx = 0
    for n in names:
        idx = idx * mesh.shape[n] + coord[n]
    members = []
    for combo in np.ndindex(*(mesh.shape[n] for n in names)):
        c = dict(coord)
        c.update(zip(names, combo))
        members.append(tuple(c[n] for n in mesh.axis_names))
    others = tuple((n, coord[n]) for n in mesh.axis_names if n not in names)
    return (names, others), idx, members


def axis_index(axis_name: MeshAxis) -> int:
    """This position's index along ``axis_name`` (row-major over a tuple of
    axes)."""
    return _group(_here(), axis_name)[1]


def axis_size(axis_name: MeshAxis) -> int:
    """The number of positions along ``axis_name`` (the product over a
    tuple of axes)."""
    mesh = _here().call.mesh
    return math.prod(mesh.shape[n] for n in axis_names_of(axis_name))


def _exchange(axis_name: MeshAxis, value: Any,
              what: str) -> Tuple[List[Any], int]:
    """Put ``value`` in this position's slot of the group's next
    rendezvous (of the collective ``what``) and wait for every member's:
    (each member's (value, event, stream) in group order, this position's
    index)."""
    pos = _here()
    key, idx, members = _group(pos, axis_name)
    seq = pos.seqs.get(key, 0)
    pos.seqs[key] = seq + 1
    event = None
    if pos.stream is not None:
        event = torch.cuda.Event()
        event.record(pos.stream)
    call = pos.call
    size = len(members)
    limit = _TIMEOUT["s"]
    deadline = None if limit is None else time.monotonic() + limit
    with call.cond:
        entry = call.slots.setdefault(
            (key, seq), {"vals": [None] * size, "n": 0, "left": size})
        entry["vals"][idx] = (value, event, pos.stream)
        entry["n"] += 1
        call.cond.notify_all()
        while entry["n"] < size:
            if call.error is not None:
                raise _Abandoned()
            gone = [members[j] for j in range(size)
                    if entry["vals"][j] is None and members[j] in call.done]
            if gone:
                raise RuntimeError(
                    f"position {gone[0]} returned from the shard_map'd "
                    f"function without joining collective #{seq} over "
                    f"{key[0]}")
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(
                    f"position {pos.coord} waited more than {limit:g} s at "
                    f"{what} (collective #{seq} over {key[0]}): "
                    f"{size - entry['n']} of its {size} positions never "
                    f"came")
            call.cond.wait(None if deadline is None
                           else max(0.0, deadline - time.monotonic()))
        entry["left"] -= 1
        if entry["left"] == 0:
            del call.slots[(key, seq)]
    return entry["vals"], idx


def _received(pos: _Position, t: Any, event, src_stream, *,
              copy: bool) -> Any:
    """Another position's tensor ``t``, usable on this position: on this
    device after this stream waits on the sender's event (a copy with
    ``copy``, else ``t`` itself, recorded on this stream); from another
    device copied on the sender's stream."""
    if not isinstance(t, torch.Tensor):
        return t
    if t.device == pos.device:
        if (pos.stream is not None and src_stream is not None
                and src_stream != pos.stream):
            pos.stream.wait_event(event)
            t.record_stream(pos.stream)
        return t.clone() if copy else t
    if src_stream is not None:
        with torch.cuda.stream(src_stream):
            return t.to(pos.device)
    return t.to(pos.device)


def _reduce(x: Any, axis_name: MeshAxis, op: Callable, what: str,
            take: Optional[Callable] = None) -> Any:
    """``x``'s leaves folded by ``op`` over the positions of ``axis_name``
    in position order by the first; each position gets ``take(total,
    its index)`` of every leaf (the whole total without ``take``)."""
    leaves = tree_leaves(x)
    vals, idx = _exchange(axis_name, leaves, what)
    if len(vals) == 1:
        return x if take is None else tree_unflatten(
            x, [take(t, 0) for t in leaves])
    pos = _here()
    totals = None
    if idx == 0:
        totals = []
        for j, own in enumerate(leaves):
            acc = own
            for m in range(1, len(vals)):
                value, event, stream = vals[m]
                other = _received(pos, value[j], event, stream, copy=False)
                if acc is own:
                    acc = op(acc, other)
                else:
                    op(acc, other, out=acc)         # in place after the first
            totals.append(acc)
    published, _ = _exchange(axis_name, totals, what)
    if idx == 0:
        return tree_unflatten(x, totals if take is None else [
            take(t, 0).contiguous() for t in totals])
    value, event, stream = published[0]
    return tree_unflatten(x, [_received(
        pos, t if take is None else take(t, idx), event, stream, copy=True)
        for t in value])


def _scatter_sum(x: Any, axis_name: MeshAxis, dim: int, what: str,
                 wide: bool = False) -> Any:
    """The tiled ``psum_scatter`` of ``x``'s leaves over ``dim``: each
    position folds its own block of every member's leaf in position order
    (the bits of ``psum`` then the block), widened to float32 first and
    cast back with ``wide``. The members' leaves are read in place: their
    owners must not write them after the call."""
    n = axis_size(axis_name)
    leaves = tree_leaves(x)
    for t in leaves:
        if t.shape[dim] % n:
            raise ValueError(
                f"psum_scatter over {axis_name!r} ({n} positions): "
                f"dimension {dim} of {tuple(t.shape)} does not divide by "
                f"{n}")
    if n == 1:
        return x
    vals, idx = _exchange(axis_name, leaves, what)
    pos = _here()
    out = []
    for j, own in enumerate(leaves):
        size = own.shape[dim] // n
        acc = None
        for m, (value, event, stream) in enumerate(vals):
            t = own if m == idx else _received(pos, value[j], event, stream,
                                               copy=False)
            block = t.narrow(dim, idx * size, size)
            block = block.to(torch.float32) if wide else block
            if acc is None:
                acc = block
            elif m == 1:
                acc = acc + block
            else:
                acc.add_(block)                 # in place after the first
        out.append(acc.to(own.dtype).contiguous())
    return tree_unflatten(x, out)


def _gather(x: torch.Tensor, axis_name: MeshAxis, axis: int, tiled: bool,
            what: str) -> torch.Tensor:
    vals, _ = _exchange(axis_name, x, what)
    pos = _here()
    parts = [_received(pos, v, event, stream, copy=False)
             for v, event, stream in vals]
    return torch.cat(parts, dim=axis) if tiled else torch.stack(parts,
                                                                dim=axis)


def _permute(x: Any, axis_name: MeshAxis, perm: Sequence[Tuple[int, int]],
             what: str) -> Any:
    vals, idx = _exchange(axis_name, tree_leaves(x), what)
    src = [s for s, d in perm if d == idx]
    if not src:
        return tree_unflatten(x, [torch.zeros_like(t)
                                  for t in tree_leaves(x)])
    if src[0] == idx:
        return x
    value, event, stream = vals[src[0]]
    return tree_unflatten(x, [_received(_here(), t, event, stream,
                                        copy=False) for t in value])


def _in_float32(fn: Callable, x: Any) -> Any:
    """``fn`` of ``x``'s leaves widened to float32, each result cast back
    to its leaf's dtype: a sum of cotangents rounded once."""
    leaves = tree_leaves(x)
    out = tree_leaves(fn(tree_unflatten(x, [t.to(torch.float32)
                                            for t in leaves])))
    return tree_unflatten(x, [o.to(t.dtype) for o, t in zip(out, leaves)])


# ---------------------------------------------------------------------------
# the tape: gradients across positions
# ---------------------------------------------------------------------------

class _Node:
    """One cut of a position's graph: the tensors that went in (``None``
    where one needs no gradient), the leaves that came out, and
    ``backward(cotangents of the outputs, wrt, acc)`` -> the inputs'
    cotangents, run in the position's thread by ``grad``."""

    __slots__ = ("inputs", "outputs", "backward")

    def __init__(self, inputs: List, outputs: List, backward: Callable):
        self.inputs = inputs
        self.outputs = outputs
        self.backward = backward


class _Tape:
    """A position's cuts, in the order its forward made them."""

    def __init__(self):
        self.nodes: List[_Node] = []


def _needs(t: Any) -> bool:
    return isinstance(t, torch.Tensor) and t.requires_grad


def _leaf(t: Any) -> Any:
    """A fresh leaf holding ``t``'s value (floating tensors; others as they
    are)."""
    if isinstance(t, torch.Tensor) and t.is_floating_point():
        return t.detach().requires_grad_()
    return t


def _cut(x: Any, forward: Callable, transpose: Callable) -> Any:
    """``forward(x)``, a collective. Under grad mode with a leaf of ``x``
    requiring grad, it runs on ``x``'s values and its output leaves are
    fresh leaves, the cut written on the position's tape with
    ``transpose``: cotangents of the output (a tree like it) -> cotangents
    of ``x`` (a tree like it)."""
    leaves = tree_leaves(x)
    if not (torch.is_grad_enabled() and any(_needs(t) for t in leaves)):
        return forward(x)
    with torch.no_grad():
        y = forward(tree_unflatten(x, [
            t.detach() if isinstance(t, torch.Tensor) else t
            for t in leaves]))
    outs = [_leaf(t) for t in tree_leaves(y)]

    def backward(cots, wrt, acc):
        with torch.no_grad():
            return tree_leaves(transpose(tree_unflatten(y, cots)))
    _here().tapes[-1].nodes.append(_Node(
        [t if _needs(t) else None for t in leaves], outs, backward))
    return tree_unflatten(y, outs)


def _walk(nodes: List[_Node], roots: List, cots: List, wrt: List,
          acc: Dict[int, torch.Tensor]) -> None:
    """Add into ``acc`` (by ``id``) the gradients of ``roots`` (seeded
    with ``cots``) with respect to the tensors of ``wrt`` and to the
    outputs of ``nodes``: first through the segment after the last cut,
    then, cut by cut backwards, the cut's transpose (a collective, in this
    thread) and the segment before it. A cut no gradient reached still
    runs its transpose, on zeros, so that every position meets every
    rendezvous."""
    def through(roots, cots, k):
        pairs = [(r, c) for r, c in zip(roots, cots)
                 if _needs(r) and c is not None]
        if not pairs:
            return
        targets = wrt + [o for n in nodes[:k] for o in n.outputs
                         if _needs(o)]
        if not targets:
            return
        grads = torch.autograd.grad(
            [r for r, _ in pairs], targets, [c for _, c in pairs],
            retain_graph=bool(nodes), allow_unused=True)
        for t, g in zip(targets, grads):
            if g is not None:
                key = id(t)
                acc[key] = g if key not in acc else acc[key] + g

    through(roots, cots, len(nodes))
    for k in range(len(nodes) - 1, -1, -1):
        node = nodes[k]
        outs = [acc.pop(id(o), None) if _needs(o) else None
                for o in node.outputs]
        outs = [torch.zeros_like(o) if c is None and isinstance(
            o, torch.Tensor) else c for c, o in zip(outs, node.outputs)]
        through(node.inputs, node.backward(outs, wrt, acc), k)


def grad(outputs: Any, inputs: Sequence[torch.Tensor],
         grad_outputs: Any = None) -> List[Optional[torch.Tensor]]:
    """The gradients of ``outputs`` (a tensor or a list, seeded with
    ``grad_outputs``, ones by default) with respect to ``inputs``, through
    this position's graph and, backwards across its collectives, their
    transposes (the module's docstring); ``None`` where an input is not
    reached. Consumes the position's tape. Outside ``shard_map``,
    ``torch.autograd.grad``."""
    outs = [outputs] if isinstance(outputs, torch.Tensor) else list(outputs)
    if grad_outputs is None:
        cots = [torch.ones_like(o) for o in outs]
    else:
        cots = ([grad_outputs] if isinstance(grad_outputs, torch.Tensor)
                else list(grad_outputs))
    inputs = list(inputs)
    pos = getattr(_LOCAL, "position", None)
    nodes: List[_Node] = []
    if pos is not None:
        nodes, pos.tapes[-1].nodes = pos.tapes[-1].nodes, []
    acc: Dict[int, torch.Tensor] = {}
    _walk(nodes, outs, cots, [t for t in inputs if _needs(t)], acc)
    return [acc.get(id(t)) for t in inputs]


def checkpoint(fn: Callable, *args: Any) -> Any:
    """``fn(*args)`` with its activations recomputed in the backward
    (remat), differentiable with respect to the tensors of ``args`` and
    to the leaves ``fn`` closes over. Inside a position of ``shard_map``
    under grad mode the forward runs without a graph and is a cut of the
    position's tape, recomputed by ``grad`` in the position's own thread,
    where the collectives inside ``fn`` meet again (a ``checkpoint``
    within the recompute is a plain call); outside one,
    ``torch.utils.checkpoint`` (non-reentrant, no RNG state: the models
    draw no random numbers)."""
    pos = getattr(_LOCAL, "position", None)
    if pos is None:
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False)
    if pos.recomputing or not torch.is_grad_enabled():
        return fn(*args)
    leaves = tree_leaves(list(args))
    with torch.no_grad():
        out = fn(*args)
    outs = [_leaf(t) for t in tree_leaves(out)]
    inputs = [t if _needs(t) else None for t in leaves]

    def backward(cots, wrt, acc):
        fresh = [t if i is None else i.detach().requires_grad_()
                 for t, i in zip(leaves, inputs)]
        tape = _Tape()
        pos.tapes.append(tape)
        pos.recomputing += 1
        try:
            with torch.enable_grad():
                again = fn(*tree_unflatten(list(args), fresh))
        finally:
            pos.tapes.pop()
            pos.recomputing -= 1
        mine = [f for f, i in zip(fresh, inputs) if i is not None]
        _walk(tape.nodes, tree_leaves(again), cots, wrt + mine, acc)
        return [None if i is None else acc.pop(id(f), None)
                for f, i in zip(fresh, inputs)]
    pos.tapes[-1].nodes.append(_Node(inputs, outs, backward))
    return tree_unflatten(out, outs)


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

def psum(x: Any, axis_name: MeshAxis) -> Any:
    """The sum of ``x`` (a tensor or a tree of them) over the positions of
    ``axis_name``, added in position order by the first. Transpose:
    ``psum`` (of the cotangents, in float32)."""
    return _cut(x, lambda v: _reduce(v, axis_name, torch.add, "psum"),
                lambda c: _in_float32(lambda t: _reduce(
                    t, axis_name, torch.add, "psum's transpose (psum)"), c))


def pmax(x: Any, axis_name: MeshAxis) -> Any:
    """The elementwise maximum of ``x`` (a tensor or a tree of them) over
    the positions of ``axis_name``. It has no backward: apply it to
    detached values (under grad mode a tensor that requires grad raises
    ``ValueError``)."""
    if torch.is_grad_enabled() and any(_needs(t) for t in tree_leaves(x)):
        raise ValueError("pmax has no backward: apply it to detached "
                         "values (the reference uses it under "
                         "stop_gradient)")
    return _reduce(x, axis_name, torch.maximum, "pmax")


def pmean(x: Any, axis_name: MeshAxis) -> Any:
    """``psum`` of ``x`` divided by the number of positions of
    ``axis_name`` (``jax.lax.pmean``). Transpose: ``pmean``."""
    n = axis_size(axis_name)
    total = psum(x, axis_name)
    return tree_unflatten(total, [t / n for t in tree_leaves(total)])


def psum_scatter(x: Any, axis_name: MeshAxis, *,
                 scatter_dimension: int) -> Any:
    """``psum`` of ``x`` (a tensor or a tree of them) of which each
    position keeps its block along ``scatter_dimension``: the tiled
    ``jax.lax.psum_scatter``, the dimension cut into ``axis_size`` equal
    blocks, position i keeping block i. The same bits as ``psum`` then the
    block. Transpose: the tiled ``all_gather`` along the same
    dimension."""
    return _cut(
        x, lambda v: _scatter_sum(v, axis_name, scatter_dimension,
                                  "psum_scatter"),
        lambda c: tree_unflatten(c, [_gather(
            t, axis_name, scatter_dimension, True,
            "psum_scatter's transpose (all_gather)")
            for t in tree_leaves(c)]))


def ppermute(x: Any, axis_name: MeshAxis,
             perm: Sequence[Tuple[int, int]]) -> Any:
    """``x`` sent along the (source, destination) pairs of ``perm`` over
    ``axis_name``'s indices; a position no pair sends to gets zeros. On one
    device the received tensor is the sender's own: read it, do not write
    it. Transpose: ``ppermute`` along the pairs reversed."""
    back = [(d, s) for s, d in perm]
    return _cut(x, lambda v: _permute(v, axis_name, perm, "ppermute"),
                lambda c: _permute(c, axis_name, back,
                                   "ppermute's transpose (ppermute)"))


def all_gather(x: torch.Tensor, axis_name: MeshAxis, *, axis: int = 0,
               tiled: bool = False) -> torch.Tensor:
    """Every position's ``x`` over ``axis_name`` in index order
    (``jax.lax.all_gather``): untiled, stacked on a new dimension
    ``axis``; tiled, concatenated along ``axis``. Transpose:
    ``psum_scatter`` of the cotangent along ``axis`` (in float32)."""
    def transpose(c: torch.Tensor) -> torch.Tensor:
        part = _scatter_sum(c, axis_name, axis,
                            "all_gather's transpose (psum_scatter)",
                            wide=True)
        return part if tiled else part.squeeze(axis)
    return _cut(x, lambda v: _gather(v, axis_name, axis, tiled,
                                     "all_gather"), transpose)


@contextmanager
def rendezvous_timeout(seconds: Optional[float]):
    """Within the block, a position that waits more than ``seconds`` at a
    rendezvous fails its ``shard_map`` with a ``TimeoutError`` naming the
    collective (``None``: no limit, the default)."""
    before = _TIMEOUT["s"]
    _TIMEOUT["s"] = seconds
    try:
        yield
    finally:
        _TIMEOUT["s"] = before


def current_mesh() -> Optional[Mesh]:
    """The mesh of the ``shard_map`` this thread is a position of, or
    ``None`` outside one."""
    pos = getattr(_LOCAL, "position", None)
    return None if pos is None else pos.call.mesh


# ---------------------------------------------------------------------------
# shard_map
# ---------------------------------------------------------------------------

def _split(tree: Any, spec: Any, mesh: Mesh) -> Dict[Tuple, Any]:
    """{position: its part of ``tree``} under ``spec`` (a ``P`` for the
    whole subtree, or a tree of them matching ``tree``'s prefix)."""
    positions = mesh.positions()
    if isinstance(spec, P):
        leaves = tree_leaves(tree)
        parts = []
        for leaf in leaves:
            if isinstance(leaf, Sharded):
                if leaf.mesh is mesh and leaf.sharding.spec == spec:
                    parts.append(leaf.pieces)
                else:               # resharded: every position owns a piece
                    parts.append(shard(leaf.gather(),
                                       NamedSharding(mesh, spec)).pieces)
            elif isinstance(leaf, torch.Tensor):
                parts.append(shard(leaf, NamedSharding(mesh, spec),
                                   copy=False).pieces)
            else:
                parts.append(None)
        return {pos: tree_unflatten(tree, [leaf if part is None else part[pos]
                                           for leaf, part in zip(leaves,
                                                                 parts)])
                for pos in positions}
    if spec is None:
        return {pos: tree for pos in positions}
    if isinstance(spec, dict):
        subs = {k: _split(tree[k], spec[k], mesh) for k in spec}
        return {pos: {k: subs[k][pos] for k in tree} for pos in positions}
    if isinstance(spec, (list, tuple)):
        if len(spec) != len(tree):
            raise ValueError(f"spec tree {spec} does not match the value "
                             f"tree ({len(tree)} entries)")
        subs = [_split(t, s, mesh) for t, s in zip(tree, spec)]
        return {pos: type(tree)(*(s[pos] for s in subs))
                if isinstance(tree, tuple) and hasattr(tree, "_fields")
                else type(tree)(s[pos] for s in subs)
                for pos in positions}
    raise TypeError(f"not a partition spec: {spec!r}")


def _global_shape(piece: torch.Tensor, spec: P, mesh: Mesh) -> Tuple:
    shape = list(piece.shape)
    for d, entry in enumerate(spec):
        shape[d] *= mesh.axis_sizes(entry)
    return tuple(shape)


def _assemble(outs: Dict[Tuple, Any], spec: Any, mesh: Mesh) -> Any:
    """The positions' outputs as one tree of ``Sharded`` leaves under
    ``spec`` (non-tensor leaves, and whatever a ``None`` spec covers:
    position 0's)."""
    positions = mesh.positions()
    first = outs[positions[0]]
    if spec is None:
        return first
    if isinstance(spec, P):
        flat = {pos: tree_leaves(outs[pos]) for pos in positions}
        leaves = tree_leaves(first)
        done = []
        for j, leaf in enumerate(leaves):
            if not isinstance(leaf, torch.Tensor):
                done.append(leaf)
                continue
            pieces = np.empty(mesh.devices.shape, dtype=object)
            for pos in positions:
                pieces[pos] = flat[pos][j]
            done.append(Sharded(NamedSharding(mesh, spec),
                                _global_shape(leaf, spec, mesh), pieces))
        return tree_unflatten(first, done)
    if isinstance(spec, dict):
        return {k: _assemble({pos: o[k] for pos, o in outs.items()},
                             spec[k], mesh) for k in spec}
    if isinstance(spec, (list, tuple)):
        parts = [_assemble({pos: o[i] for pos, o in outs.items()}, s, mesh)
                 for i, s in enumerate(spec)]
        if isinstance(first, tuple) and hasattr(first, "_fields"):
            return type(first)(*parts)
        return type(spec)(parts)
    raise TypeError(f"not a partition spec: {spec!r}")


def _position_main(call: _Call, coord, f, args, results, grad: bool,
                   inference: bool, starts) -> None:
    pos = _Position(call, coord)
    _LOCAL.position = pos
    try:
        with ExitStack() as stack:
            if pos.stream is not None:
                stack.enter_context(torch.cuda.device(pos.device))
                stack.enter_context(torch.cuda.stream(pos.stream))
                pos.stream.wait_event(starts[pos.device])
            stack.enter_context(torch.inference_mode() if inference
                                else torch.set_grad_enabled(grad))
            results[coord] = f(*args)
    except _Abandoned:
        pass
    except BaseException as e:                      # noqa: BLE001
        with call.cond:
            if call.error is None:
                call.error = e
            call.cond.notify_all()
    finally:
        with call.cond:
            call.done.add(coord)
            call.cond.notify_all()
        _LOCAL.position = None


def _run_positions(mesh: Mesh, f: Callable,
                   args_of: Dict[Tuple, Sequence[Any]]) -> Dict[Tuple, Any]:
    """``f(*args_of[position])`` once a position of ``mesh``, each in its
    own thread, as ``shard_map`` runs them: {position: what it returned}.
    Raises the first position's exception once every thread has ended (or,
    with a rendezvous timeout, once the others have had that long)."""
    if getattr(_LOCAL, "position", None) is not None:
        raise RuntimeError("shard_map cannot run inside shard_map")
    call = _Call(mesh)
    cuda = {d for d in mesh.devices.flat if d.type == "cuda"}
    starts = {}
    for dev in cuda:
        starts[dev] = torch.cuda.Event()
        starts[dev].record(torch.cuda.current_stream(dev))
    results: Dict[Tuple, Any] = {}
    threads = [threading.Thread(
        target=_position_main, name=f"shard_map{coord}", daemon=True,
        args=(call, coord, f, args_of[coord], results,
              torch.is_grad_enabled(), torch.is_inference_mode_enabled(),
              starts)) for coord in mesh.positions()]
    for t in threads:
        t.start()
    limit = _TIMEOUT["s"]
    failed_at = None
    for t in threads:
        while t.is_alive():
            t.join(None if limit is None else 0.5)
            if limit is None or call.error is None:
                continue
            failed_at = failed_at or time.monotonic()
            if time.monotonic() - failed_at > limit:
                break                   # a thread that never returns
    stuck = [c for c, t in zip(mesh.positions(), threads) if t.is_alive()]
    if stuck:
        raise RuntimeError(
            f"shard_map: positions {stuck} did not return {limit:g} s after "
            f"another failed") from call.error
    for coord in mesh.positions():
        stream = mesh.streams[coord]
        if stream is not None:
            done = torch.cuda.Event()
            done.record(stream)
            torch.cuda.current_stream(stream.device).wait_event(done)
    if call.error is not None:
        raise call.error
    return results


def shard_map(f: Callable, *, mesh: Mesh, in_specs: Any,
              out_specs: Any) -> Callable:
    """``f`` run once a position of ``mesh`` on its part of the inputs.

    ``in_specs`` has one entry an argument: a ``P`` (for every tensor of
    that argument's tree) or a tree of them. A tensor is split by its spec
    (a position on its device gets a view, to read and not to write; others
    a copy); a ``Sharded`` already on ``mesh`` under the same spec passes
    its pieces as they are, and one under another spec is resharded, each
    position owning its new piece.
    Non-tensor leaves reach every position unchanged. ``out_specs`` says
    how each output's pieces fit together; every tensor output comes back
    as a ``Sharded``."""
    specs = in_specs if isinstance(in_specs, tuple) else (in_specs,)

    def mapped(*args):
        if len(specs) != len(args):
            raise ValueError(f"shard_map: {len(args)} arguments, "
                             f"{len(specs)} in_specs")
        parts = [_split(a, s, mesh) for a, s in zip(args, specs)]
        outs = _run_positions(mesh, f, {pos: [p[pos] for p in parts]
                                        for pos in mesh.positions()})
        return _assemble(outs, out_specs, mesh)
    return mapped


__all__ = ["all_gather", "axis_index", "axis_size", "checkpoint",
           "current_mesh", "grad", "pmax", "pmean", "ppermute", "psum",
           "psum_scatter", "rendezvous_timeout", "shard_map"]
