"""Counting what each position of a step does: the port's lowering.

The reference lowers a step to XLA and reads the compiled module's costs.
The port has no compiled module: its "lowering" is one run of the real step
on ``meta`` positions (or on the card) under a ``Counter``, which keeps one
``Record`` a position of the mesh with

  * the products' FLOPs, by ``torch.utils.flop_counter``'s registered
    formulas (matrix products, convolutions, attention ops);
  * the bytes: each op's distinct input storages read once (the extent of
    its largest view of each, at most the storage) and its outputs written
    once. The eager port fuses nothing, so this is its own traffic, op by
    op, not XLA's count of a fused module. Views, allocations and ops
    that return no tensor (stream bookkeeping) move nothing;
  * the argument bytes (the position's pieces of the inputs), the output
    bytes, the donated bytes (outputs written into an argument's storage:
    the weights and optimizer state of a training step, the caches of a
    serving step) and the live-bytes peak: the arguments, plus each storage
    an op makes, released when its last tensor dies. Meta tensors all have
    ``data_ptr()`` 0, so storages are keyed by ``untyped_storage()._cdata``
    (a view shares its base's key) and released by ``weakref.finalize``;
  * the kernels' declared work (``note_kernel``; ``kernels/cost.py``):
    launches, bytes and operations of each hand-written kernel, which the
    op stream does not see inside a launch or a meta form;
  * the collectives (``collective``; ``distributed/collectives.py``):
    count and result bytes by kind and group size, which
    ``launch/roofline.py::collective_bytes`` weighs with the conventions of
    the reference's HLO count. The ops a collective runs inside it (the
    fold of a reduction, the copies it hands out) are the collective's:
    they count in the peak, not in the position's FLOPs or bytes.

A ``TorchDispatchMode`` does not follow a Python thread the caller starts,
so ``shard_map`` takes the caller's active counter and opens one record a
position inside each position's thread (``open_position``). Autograd's
worker thread inherits the mode of the thread whose backward it runs, so on
the card a position's backward counts in its record too. Without an active
counter the served path pays one flag check (``active``) and nothing else.
"""

from __future__ import annotations

import threading
import weakref
from collections import defaultdict
from contextlib import contextmanager
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten
# ops that allocate and move no data
_NO_TRAFFIC = {aten.empty.memory_format, aten.empty_strided.default,
               aten.empty_like.default, aten.new_empty.default,
               aten.new_empty_strided.default}

# counters open in the process; the served path reads this and nothing else
_OPEN = [0]
_OPEN_LOCK = threading.Lock()


def active() -> bool:
    """Whether a counter is open anywhere in the process."""
    return _OPEN[0] > 0


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class Record:
    """What one position did (the module's docstring). ``as_dict`` is its
    JSON form."""

    def __init__(self):
        self.flops = 0
        self.backward_flops = 0         # inside collectives.grad
        self.bytes = 0
        self.ops = 0
        self.ops_off_thread = 0         # run on another thread (autograd's)
        # op -> [calls, FLOPs, bytes]: where two records part
        self.by_op: Dict[Any, list] = defaultdict(lambda: [0, 0, 0])
        self.kernels: Dict[str, Dict[str, int]] = defaultdict(
            lambda: {"launches": 0, "bytes": 0, "flops": 0})
        # (kind, group size) -> [count, result bytes]
        self.collectives: Dict[Tuple[str, int], list] = defaultdict(
            lambda: [0, 0])
        self.argument_bytes = 0
        self.output_bytes = 0
        self.alias_bytes = 0
        self.live = 0
        self.peak = 0
        self.backward = 0               # depth of collectives.grad calls
        self.quiet = 0                  # depth of collectives running
        self.thread = threading.get_ident()
        self._args: Dict[int, int] = {}
        self._live: Dict[int, int] = {}
        self._lock = threading.Lock()

    # -- storages -----------------------------------------------------------

    def _free(self, key: int, nbytes: int) -> None:
        with self._lock:
            if self._live.pop(key, None) is not None:
                self.live -= nbytes

    def _allocated(self, t: torch.Tensor) -> None:
        key = _key(t)
        if key in self._args or key in self._live:
            return
        storage = t.untyped_storage()
        nbytes = storage.nbytes()
        with self._lock:
            self._live[key] = nbytes
            self.live += nbytes
            self.peak = max(self.peak, self.live)
        weakref.finalize(storage, self._free, key, nbytes)

    def arguments(self, tree: Any) -> None:
        """Count ``tree``'s tensors as the position's arguments, live from
        the start (a piece's own bytes, not its base's)."""
        extent: Dict[int, int] = {}
        for t in tree_flatten(tree)[0]:
            if isinstance(t, torch.Tensor):
                key = _key(t)
                extent[key] = max(extent.get(key, 0), t.nbytes)
        with self._lock:
            for key, nbytes in extent.items():
                if key not in self._args:
                    self._args[key] = nbytes
                    self.argument_bytes += nbytes
                    self.live += nbytes
            self.peak = max(self.peak, self.live)

    def outputs(self, tree: Any) -> None:
        """Count ``tree``'s tensors as the position's outputs; those in an
        argument's storage are donated (written in place)."""
        seen = set()
        for t in tree_flatten(tree)[0]:
            if isinstance(t, torch.Tensor) and id(t) not in seen:
                seen.add(id(t))
                self.output_bytes += t.nbytes
                if _key(t) in self._args:
                    self.alias_bytes += t.nbytes

    # -- the op stream ------------------------------------------------------

    def op(self, func, args, kwargs, out) -> None:
        if func.is_view:
            return
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        for t in outs:
            self._allocated(t)
        if self.quiet or not outs or func in _NO_TRAFFIC:
            return
        self.ops += 1
        if threading.get_ident() != self.thread:
            self.ops_off_thread += 1
        flops = 0
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            flops = int(formula(*args, **kwargs, out_val=out))
            self.flops += flops
            if self.backward:
                self.backward_flops += flops
        reads: Dict[int, int] = {}
        for t in tree_flatten((args, kwargs))[0]:
            if isinstance(t, torch.Tensor):
                key = _key(t)
                reads[key] = min(max(reads.get(key, 0), t.nbytes),
                                 t.untyped_storage().nbytes())
        nbytes = sum(reads.values()) + sum(t.nbytes for t in outs)
        self.bytes += nbytes
        row = self.by_op[func]
        row[0] += 1
        row[1] += flops
        row[2] += nbytes

    def kernel(self, name: str, nbytes: int, flops: int,
               launches: int) -> None:
        k = self.kernels[name]
        k["launches"] += launches
        k["bytes"] += nbytes
        k["flops"] += flops

    def collective(self, kind: str, result_bytes: int, group: int) -> None:
        c = self.collectives[(kind, group)]
        c[0] += 1
        c[1] += result_bytes

    def op_table(self) -> Dict[str, list]:
        """{op name: [calls, FLOPs, bytes]}, by name."""
        return {str(k): list(v) for k, v in sorted(
            self.by_op.items(), key=lambda kv: str(kv[0]))}

    def as_dict(self) -> Dict[str, Any]:
        kernel_flops = sum(k["flops"] for k in self.kernels.values())
        kernel_bytes = sum(k["bytes"] for k in self.kernels.values())
        return {
            "product_flops": self.flops,
            "backward_product_flops": self.backward_flops,
            "op_bytes": self.bytes,
            "ops": self.ops,
            "ops_off_thread": self.ops_off_thread,
            "kernels": {k: dict(v) for k, v in sorted(self.kernels.items())},
            "kernel_flops": kernel_flops,
            "kernel_bytes": kernel_bytes,
            "flops": self.flops + kernel_flops,
            "bytes": self.bytes + kernel_bytes,
            "collectives": [
                {"kind": kind, "group_size": group, "count": c[0],
                 "result_bytes": c[1]}
                for (kind, group), c in sorted(self.collectives.items())],
            "argument_bytes": self.argument_bytes,
            "output_bytes": self.output_bytes,
            "alias_bytes": self.alias_bytes,
            "peak_bytes": self.peak,
        }


class _CountMode(TorchDispatchMode):
    """Counts every op of this thread (and of autograd's worker while it
    runs this thread's backward) into ``record``."""

    def __init__(self, counter: "Counter", record: Record):
        super().__init__()
        self.counter = counter
        self.record = record

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.record.op(func, args, kwargs, out)
        return out


def _mode() -> Optional[_CountMode]:
    for m in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(m, _CountMode):
            return m
    return None


def current() -> Optional[Record]:
    """The record this thread counts into, or ``None``."""
    if not _OPEN[0]:
        return None
    m = _mode()
    return None if m is None else m.record


class Counter:
    """``with Counter() as c: step(*args)``: ``c.records`` holds one
    ``Record`` a position of every ``shard_map`` the step runs, by its
    coordinate (a second ``shard_map`` adds into the same records);
    ``c.caller`` what the caller's own thread did around them."""

    def __init__(self):
        self.caller = Record()
        self.records: Dict[Tuple[int, ...], Record] = {}
        self._mode: Optional[_CountMode] = None
        self._lock = threading.Lock()

    def __enter__(self) -> "Counter":
        with _OPEN_LOCK:
            _OPEN[0] += 1
        self._mode = _CountMode(self, self.caller)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._mode.__exit__(*exc)
        with _OPEN_LOCK:
            _OPEN[0] -= 1

    @contextmanager
    def position(self, coord: Tuple[int, ...]):
        """Count this thread's ops into position ``coord``'s record."""
        with self._lock:
            rec = self.records.get(coord)
            if rec is None:
                rec = self.records[coord] = Record()
        rec.thread = threading.get_ident()
        with _CountMode(self, rec):
            yield rec


def open_position(coord: Tuple[int, ...]):
    """For ``shard_map``: in the caller's thread, a function that opens
    position ``coord``'s record of the caller's active counter (a context
    manager) in the position's thread, or ``None`` with no counter."""
    if not _OPEN[0]:
        return None
    m = _mode()
    return None if m is None else (lambda: m.counter.position(coord))


def note_kernel(name: str, nbytes: int, flops: int, launches: int = 1) -> None:
    """A kernel wrapper's declared work (``kernels/cost.py``), into this
    thread's record."""
    rec = current()
    if rec is not None:
        rec.kernel(name, nbytes, flops, launches)


@contextmanager
def collective(kind: str, result_bytes: int, group: int):
    """Around a collective's own work: records it (``kind`` one of
    all-reduce, reduce-scatter, all-gather, collective-permute; its result's
    bytes on this position) where the group has more than one position, as
    XLA keeps no collective over one, and keeps the ops inside it out of
    the position's FLOPs and bytes (``launch/roofline.py::collective_bytes``
    applies the reference's conventions to the records)."""
    rec = current()
    if rec is None:
        yield
        return
    if group > 1:
        rec.collective(kind, result_bytes, group)
    rec.quiet += 1
    try:
        yield
    finally:
        rec.quiet -= 1


@contextmanager
def backward():
    """Around ``collectives.grad``: the products inside count as the
    backward's too."""
    rec = current()
    if rec is None:
        yield
        return
    rec.backward += 1
    try:
        yield
    finally:
        rec.backward -= 1


__all__ = ["Counter", "Record", "active", "backward", "collective",
           "current", "note_kernel", "open_position"]
