"""Logical-axis sharding rules, parameter definitions and the mesh.

The twin of ``repro/distributed/sharding.py``. Every tensor is annotated
with *logical* axes ('batch', 'embed', 'heads', 'ff', 'vocab', 'experts',
...); a ``ShardingRules`` table maps them to mesh axes per deployment
(DP / FSDP / TP / EP are different tables). ``ParamDef`` trees are the one
source of parameter shapes and logical axes:

  * ``init_params``      -- real initialisation (``_init_one``'s rule:
                            normal with a fan-in scale unless the definition
                            says zeros, ones or a constant);
  * ``abstract_params``  -- ``meta`` tensors of the shapes and dtypes (no
                            allocation);
  * ``param_shardings``  -- one ``NamedSharding`` a leaf.

The mesh. The reference's ``Mesh`` is an array of TPU devices driven by one
controller. Here a ``Mesh`` is an array of *positions*, each a
``torch.device`` and, on a GPU, its own stream; positions may share a card.
``make_mesh`` is the twin of ``compat_make_mesh``, and ``shard_map`` /
``axis_size`` (``distributed/collectives.py``) of ``compat_shard_map`` /
``compat_axis_size``: ``shard_map`` runs a function once a position, each
in its own thread. A ``Sharded`` tensor is what a JAX array
with a ``NamedSharding`` is: one piece a position, split by the spec
(``device_put``) and put back together by ``gather``. Nothing here starts
a thread or needs a process group.

A tree is dicts, lists, tuples and ``NamedTuple``s of ``ParamDef`` leaves,
with plain Python values (a cache's length) kept as they are.

``replicate_params`` and ``params_compatible`` are the serving pool's
(``core/engine.py``): one parameter replica per executor, and the check
that a hot-reloaded tree may replace the serving one.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import (Any, Dict, List, Mapping, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device

MeshAxis = Union[None, str, Tuple[str, ...]]


# ---------------------------------------------------------------------------
# the mesh, partition specs and shardings
# ---------------------------------------------------------------------------

class P:
    """A partition spec (``jax.sharding.PartitionSpec``): one entry per
    leading dimension of a tensor, each ``None`` (whole), a mesh axis name
    or a tuple of names (the dimension split over their product, the first
    name major). Dimensions past the last entry are whole."""

    __slots__ = ("entries",)

    def __init__(self, *entries: MeshAxis):
        self.entries = tuple(tuple(e) if isinstance(e, list) else e
                             for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def _trimmed(self) -> tuple:
        """The entries without trailing ``None``s: ``P(None, None)`` places
        a tensor as ``P()`` does."""
        e = self.entries
        while e and e[-1] is None:
            e = e[:-1]
        return e

    def __eq__(self, other) -> bool:
        return isinstance(other, P) and self._trimmed() == other._trimmed()

    def __hash__(self) -> int:
        return hash(self._trimmed())

    def __repr__(self) -> str:
        return f"P{self.entries!r}"


def axis_names_of(entry: MeshAxis) -> Tuple[str, ...]:
    """A spec entry's mesh axes as a tuple (none for ``None``)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


class Mesh:
    """Named axes over an array of positions.

    ``devices`` is a numpy object array of ``torch.device``s, one a
    position, of shape ``tuple(shape.values())``; ``streams`` the array of
    the positions' own CUDA streams (``None`` where a position is not on a
    GPU). ``shape`` maps each axis name to its size, as ``Mesh.shape`` does
    in JAX."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"a mesh of shape {devices.shape} needs "
                             f"{devices.ndim} axis names, got {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              devices.shape))
        self.streams = np.empty(devices.shape, dtype=object)
        for idx in np.ndindex(devices.shape):
            dev = devices[idx]
            self.streams[idx] = (torch.cuda.Stream(device=dev)
                                 if dev.type == "cuda" else None)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def positions(self) -> List[Tuple[int, ...]]:
        """Every position's coordinates, in row-major order."""
        return list(np.ndindex(self.devices.shape))

    def axis_sizes(self, entry: MeshAxis) -> int:
        """The product of the sizes of a spec entry's axes."""
        return math.prod(self.shape[n] for n in axis_names_of(entry))

    def __repr__(self) -> str:
        devs = sorted({str(d) for d in self.devices.flat})
        return f"Mesh({self.shape}, devices={devs})"


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str], *,
              devices: Union[DeviceLike, Sequence[DeviceLike]] = None
              ) -> Mesh:
    """A mesh of ``axis_shapes`` over ``devices`` (one a position in
    row-major order, or one device for every position). By default
    position i goes on ``cuda:(i mod device_count)``; with no GPU that
    raises, as every entry point of the port does without a device."""
    n = math.prod(axis_shapes)
    if devices is None:
        resolve_device(None)                    # raises without a GPU
        count = torch.cuda.device_count()
        devs = [torch.device("cuda", i % count) for i in range(n)]
    elif isinstance(devices, (str, torch.device)):
        devs = [torch.device(devices)] * n
    else:
        devs = [torch.device(d) for d in devices]
    if len(devs) != n:
        raise ValueError(f"a mesh of shape {tuple(axis_shapes)} has {n} "
                         f"positions; got {len(devs)} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(tuple(axis_shapes)), axis_names)


@dataclass(frozen=True, eq=False)
class NamedSharding:
    """A mesh and a partition spec: how one tensor lies on the mesh."""

    mesh: Mesh
    spec: P

    def blocks(self, shape: Sequence[int]
               ) -> Dict[Tuple[int, ...], Tuple[slice, ...]]:
        """{position: the slices of a ``shape`` tensor it holds}. Raises
        ``ValueError`` where a dimension does not divide by its axes."""
        mesh = self.mesh
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than "
                             f"shape {tuple(shape)} has dimensions")
        out = {}
        for pos in mesh.positions():
            coord = dict(zip(mesh.axis_names, pos))
            slices = []
            for dim, entry in zip(shape, tuple(self.spec) + (None,) * (
                    len(shape) - len(self.spec))):
                names = axis_names_of(entry)
                n = mesh.axis_sizes(entry)
                if dim % n:
                    raise ValueError(f"dim {dim} of {tuple(shape)} does not "
                                     f"divide by axes {names} ({n})")
                block = 0
                for name in names:
                    block = block * mesh.shape[name] + coord[name]
                size = dim // n
                slices.append(slice(block * size, (block + 1) * size))
            out[pos] = tuple(slices)
        return out


class Sharded:
    """A tensor on a mesh: its global ``shape`` and ``dtype``, its
    ``sharding``, and ``pieces``, an object array of the mesh's shape with
    each position's own tensor on that position's device. A replicated
    dimension is whole in every piece. ``np.asarray`` gathers it."""

    __slots__ = ("sharding", "shape", "dtype", "pieces")

    def __init__(self, sharding: NamedSharding, shape: Sequence[int],
                 pieces: np.ndarray):
        self.sharding = sharding
        self.shape = tuple(shape)
        self.pieces = pieces
        self.dtype = pieces.flat[0].dtype

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    def gather(self, device: DeviceLike = None) -> torch.Tensor:
        """The whole tensor on ``device`` (position 0's by default), each
        block taken from the first position that holds it. Where one piece
        is the whole tensor and already on ``device``, that piece itself
        (not a copy) is returned."""
        first = self.pieces.flat[0]
        dev = first.device if device is None else torch.device(device)
        if tuple(first.shape) == self.shape and first.device == dev:
            return first
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        seen = set()
        for pos, sl in self.sharding.blocks(self.shape).items():
            key = tuple((s.start, s.stop) for s in sl)
            if key not in seen:
                seen.add(key)
                out[sl].copy_(self.pieces[pos])
        return out

    def __array__(self, dtype=None, copy=None):
        arr = self.gather().detach().cpu().numpy()
        return arr if dtype is None else arr.astype(dtype)


def shard(x: torch.Tensor, sharding: NamedSharding, *,
          copy: bool = True) -> Sharded:
    """``x`` split onto ``sharding``'s positions. With ``copy`` every
    position owns its piece (a copy, also where it shares ``x``'s device);
    without, a position on ``x``'s device gets a view of ``x``."""
    mesh = sharding.mesh
    pieces = np.empty(mesh.devices.shape, dtype=object)
    made: Dict[Tuple, torch.Tensor] = {}
    for pos, sl in sharding.blocks(x.shape).items():
        dev = mesh.devices[pos]
        block = x[sl]
        key = (str(dev), tuple((s.start, s.stop) for s in sl))
        if not copy and dev == x.device:
            pieces[pos] = block
        elif key in made:                       # one transfer a device
            pieces[pos] = made[key].clone()
        else:
            piece = block.to(dev, copy=True).contiguous()
            made[key] = piece
            pieces[pos] = piece
    return Sharded(sharding, x.shape, pieces)


def device_put(tree: Any, shardings: Any) -> Any:
    """Every tensor leaf of ``tree`` split onto its sharding (``shardings``
    a tree of the same structure, or one ``NamedSharding`` for every leaf):
    a ``Sharded`` whose positions each own a copy of their block on their
    device. A ``Sharded`` leaf is gathered first. Non-tensor leaves stay as
    they are."""
    def put(x, s):
        if isinstance(x, Sharded):
            x = x.gather()
        if s is None or not isinstance(x, torch.Tensor):
            return x
        return shard(x.detach(), s)
    if isinstance(shardings, NamedSharding):
        return map_tree(lambda x: put(x, shardings), tree)
    return map_tree(put, tree, shardings)


def gather(tree: Any, device: DeviceLike = None) -> Any:
    """Every ``Sharded`` leaf of ``tree`` as its whole tensor on ``device``
    (position 0's by default); the inverse of ``device_put``."""
    return map_tree(lambda x: x.gather(device) if isinstance(x, Sharded)
                    else x, tree)


def map_tree(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure), the structure kept: dicts,
    ``NamedTuple``s, lists and tuples are containers; ``None`` is a leaf."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tree(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a tree of dicts (keys sorted, as JAX orders them),
    lists and tuples."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """``like``'s structure with its leaves replaced by ``leaves``, in
    ``tree_leaves`` order."""
    return _unflatten(like, iter(leaves))


def _unflatten(node: Any, it) -> Any:
    # a module-level recursion: a recursive closure would be a reference
    # cycle holding ``leaves`` (tensors) until the cyclic collector ran
    if isinstance(node, dict):
        done = {k: _unflatten(node[k], it) for k in sorted(node)}
        return {k: done[k] for k in node}
    if isinstance(node, (list, tuple)):
        return type(node)(_unflatten(v, it) for v in node)
    return next(it)

# ---------------------------------------------------------------------------
# logical -> physical rules
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShardingRules:
    """Mapping from logical axis names to mesh axes (None = replicated)."""

    table: Mapping[str, MeshAxis]

    def axis(self, logical: Optional[str]) -> MeshAxis:
        if logical is None:
            return None
        return self.table.get(logical, None)

    def spec(self, *logical: Optional[str]) -> P:
        return P(*(self.axis(a) for a in logical))

    def sharding(self, mesh: Mesh, *logical: Optional[str]) -> NamedSharding:
        return NamedSharding(mesh, self.spec(*logical))


def make_rules(*, data_axes: Tuple[str, ...] = ("data",),
               model_axis: str = "model",
               fsdp: bool = False,
               expert_fsdp: bool = False,
               shard_seq_for_decode: bool = False,
               seq_parallel: bool = True) -> ShardingRules:
    """The standard rule tables of the configs, as the reference builds
    them.

    fsdp: additionally shard the *largest* weight dim over the data axes
    (ZeRO-3 style). seq_parallel: shard the residual stream's seq dim over
    the model axis between blocks (sequence parallelism)."""
    data: MeshAxis = data_axes if len(data_axes) > 1 else data_axes[0]
    t = {
        # activations
        "batch": data,
        "seq": None,
        "seq_sp": model_axis if seq_parallel else None,  # residual stream
        "embed": None,             # residual stream feature dim
        "act_heads": model_axis,   # attention activations: heads sharded
        "act_ff": model_axis,
        "act_kv": None,
        "cache_seq": model_axis if shard_seq_for_decode else None,
        "cache_heads": None if shard_seq_for_decode else model_axis,
        # params
        "heads": model_axis,       # q-proj head dim
        "kv_heads": model_axis,    # kv-proj fused head*dim (divisible)
        "ff": model_axis,
        "vocab": model_axis,
        "embed_fsdp": data if fsdp else None,   # second weight dim under FSDP
        "experts": model_axis,
        "expert_ff": data if expert_fsdp else None,
        "layers": None,
        "ssm_heads": model_axis,
        "ssm_state": None,
        "lru_width": model_axis,
    }
    return ShardingRules(table=t)


def make_dp_only_rules(*, data_axes: Tuple[str, ...] = ("data",),
                       model_axis: str = "model") -> ShardingRules:
    """Pure data parallelism: batch sharded over EVERY mesh axis (model
    folded into batch), all parameters replicated. The table for small
    models where tensor-parallel collectives dominate compute."""
    batch: MeshAxis = tuple(data_axes) + (model_axis,)
    t = {k: None for k in make_rules(data_axes=data_axes,
                                     model_axis=model_axis).table}
    t["batch"] = batch
    return ShardingRules(table=t)


def logical_constraint(x: torch.Tensor, *logical: Optional[str],
                       rules: Optional[ShardingRules],
                       mesh: Optional[Mesh],
                       shape: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` by logical axes.

    Without a mesh (or rules) a no-op. Inside a position of a
    ``shard_map`` over ``mesh`` a check that moves no data: ``x`` must be
    the piece of a tensor of global ``shape`` that ``rules.spec(*logical)``
    gives a position of the mesh, and a mismatch raises ``ValueError``
    naming the axes, so that a collective a layer missed is an error and
    not a wrong number. Outside a ``shard_map`` it raises
    ``NotImplementedError``: the port places activations only inside its
    ``shard_map``'d steps, whose layers call the collectives where GSPMD
    would put them (``launch/steps.py``)."""
    if mesh is None or rules is None:
        return x
    from repro_torch.distributed.collectives import current_mesh
    here = current_mesh()
    if here is None:
        raise NotImplementedError(
            "logical_constraint on a mesh outside shard_map: the port "
            "places activations only inside its shard_map'd steps")
    if here is not mesh:
        raise ValueError(f"logical_constraint on {mesh} inside a shard_map "
                         f"over {here}")
    spec = rules.spec(*logical)
    if shape is None or len(shape) != x.ndim or len(logical) != x.ndim:
        raise ValueError(f"logical_constraint: logical axes {logical} and "
                         f"global shape {shape} for a tensor of "
                         f"{x.ndim} dimensions")
    want = []
    for dim, entry in zip(shape, spec):
        n = mesh.axis_sizes(entry)
        if dim % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not divide "
                             f"by axes {axis_names_of(entry)} ({n})")
        want.append(dim // n)
    if tuple(x.shape) != tuple(want):
        raise ValueError(
            f"a position holds {tuple(x.shape)}, not the piece "
            f"{tuple(want)} of {tuple(shape)} that logical axes {logical} "
            f"give on mesh {mesh.shape} ({spec})")
    return x


# ---------------------------------------------------------------------------
# parameter definitions
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Optional[Tuple[Optional[str], ...]] = None   # logical axes
    init: str = "normal"                   # normal | zeros | ones | constant
    scale: Optional[float] = None          # stddev for normal (default fan-in)
    constant: float = 0.0
    dtype: Any = torch.bfloat16
    # optimizer-state axes when they should differ from the param's (ZeRO-1
    # style: e.g. a replicated embedding table with fully-sharded m/v)
    opt_axes: Optional[Tuple[Optional[str], ...]] = None

    def __post_init__(self):
        assert self.axes is None or len(self.axes) == len(self.shape), (
            self.shape, self.axes)

    @property
    def logical_axes(self) -> Tuple[Optional[str], ...]:
        """``axes``, or every dimension unnamed (replicated) without."""
        return self.axes if self.axes is not None else (None,) * len(
            self.shape)


def map_defs(fn, tree: Any) -> Any:
    """``fn`` on every ``ParamDef`` of ``tree`` in order (dict keys as
    given, then sequences), the structure kept; other leaves unchanged."""
    return map_tree(lambda x: fn(x) if isinstance(x, ParamDef) else x, tree)


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


def abstract_params(defs: Any) -> Any:
    """Every leaf of ``defs`` as a ``meta`` tensor of its shape and dtype:
    shapes to reason about (bytes, placements) with nothing allocated."""
    return map_defs(
        lambda d: torch.empty(d.shape, dtype=d.dtype, device="meta"), defs)


def param_specs(defs: Any, rules: ShardingRules) -> Any:
    return map_defs(lambda d: rules.spec(*d.logical_axes), defs)


def param_shardings(defs: Any, rules: ShardingRules, mesh: Mesh) -> Any:
    return map_defs(lambda d: rules.sharding(mesh, *d.logical_axes), defs)


def executor_mesh(device: DeviceLike) -> Mesh:
    """A one-position mesh for one serving executor."""
    return make_mesh((1,), ("executor",), devices=[device])


def param_count(defs: Any) -> int:
    total = []
    map_defs(lambda d: total.append(math.prod(d.shape)), defs)
    return int(sum(total))


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
