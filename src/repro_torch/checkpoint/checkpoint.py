"""Fault-tolerant checkpoints in the JAX package's format.

The twin of ``repro/checkpoint/checkpoint.py``, on trees of tensors:

  * one ``step_%010d/`` directory a step, holding a ``leaf_%05d.npy`` file
    a leaf and ``manifest.json`` (the step, ``extra``, and for each leaf
    its file, ``shape``, ``dtype`` and a CRC-32 over ``arr.tobytes()``);
  * a write goes to ``.tmp_step_%010d/``, the manifest is fsynced, then the
    directory is renamed: a crashed writer never leaves a half-valid step;
  * ``restore_latest`` walks the steps newest first and skips one that
    fails validation (a leaf missing or its CRC wrong);
  * after a write only the newest ``keep_n`` steps are kept.

Leaves are keyed as JAX keys them (``"/".join(str(keypath))`` without
quotes: a dict key ``'w1'`` is ``[w1]``, a list index ``[0]``, a
NamedTuple field ``.name``) and numbered in JAX's flattening order (dict
keys sorted), so that either package reads the other's checkpoints and
writes the same file names.

bfloat16. JAX writes a bfloat16 leaf as the ``ml_dtypes`` array it holds:
the ``.npy`` header says ``'<V2'`` (two opaque bytes) and the manifest
``bfloat16``. Such a leaf is read from its 2-byte payload into
``torch.bfloat16`` and written back the same way (same header, same
bytes, so the CRC checks on both sides); a leaf of any other opaque
dtype raises ``ValueError`` rather than be misread.
"""

from __future__ import annotations

import json
import os
import shutil
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import NamedSharding, Sharded, shard

MANIFEST = "manifest.json"


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _flatten(tree, path: str, out: List[Tuple[str, Any]]) -> None:
    if tree is None:                      # an empty subtree, as in JAX
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], f"{path}/[{k!r}]", out)
    elif _is_namedtuple(tree):
        for name, v in zip(tree._fields, tree):
            _flatten(v, f"{path}/.{name}", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{path}/[{i}]", out)
    else:
        out.append((path, tree))


def _leaf_paths(tree) -> List[Tuple[str, Any]]:
    """``(key, leaf)`` in JAX's flattening order, keyed as JAX keys them."""
    out: List[Tuple[str, Any]] = []
    _flatten(tree, "", out)
    return [(key[1:].replace("'", ""), leaf) for key, leaf in out]


def _unflatten(like, leaves: List[Any]):
    """``like``'s structure with its leaves replaced, in ``_leaf_paths``
    order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            done = {k: build(node[k]) for k in sorted(node)}
            return {k: done[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*(build(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)
    return build(like)


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as the host array whose bytes are written, and the dtype the
    manifest names (``bfloat16`` for a 2-byte opaque array)."""
    if isinstance(leaf, Sharded):            # one unsharded copy
        leaf = leaf.gather()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    if str(arr.dtype) == "bfloat16":      # an ml_dtypes array
        return arr.view("V2"), "bfloat16"
    return arr, str(arr.dtype)


def _write_leaf(path: Path, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    # the header JAX's np.save writes for an ml_dtypes bfloat16 array
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False,
                "shape": tuple(arr.shape)})
        f.write(np.ascontiguousarray(arr).tobytes())


def save(root: os.PathLike, step: int, tree: Any, *, keep_n: int = 3,
         extra: Optional[Dict] = None) -> Path:
    """Write ``tree`` as step ``step`` under ``root`` (atomically), then
    prune to the newest ``keep_n`` steps. Returns the step's directory."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    final = root / f"step_{step:010d}"
    tmp = root / f".tmp_step_{step:010d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    manifest = {"step": step, "extra": extra or {}, "leaves": {}}
    for i, (key, leaf) in enumerate(_leaf_paths(tree)):
        arr, dtype = _to_host(leaf)
        fname = f"leaf_{i:05d}.npy"
        _write_leaf(tmp / fname, arr, dtype)
        manifest["leaves"][key] = {
            "file": fname,
            "shape": list(arr.shape),
            "dtype": dtype,
            "crc32": _crc32(arr),
        }
    with open(tmp / MANIFEST, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)

    steps = sorted(p for p in root.glob("step_*") if p.is_dir())
    for p in steps[:-keep_n]:
        shutil.rmtree(p, ignore_errors=True)
    return final


def _crc32(arr: np.ndarray) -> int:
    """CRC-32 of ``arr.tobytes()``, read from the array's own buffer."""
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def _validate(path: Path, keep=()) -> Optional[Tuple[Dict, Dict]]:
    """(the step's manifest, {key: array} for the leaves named in ``keep``)
    if every leaf is present and its CRC checks, else ``None``: one read
    of each file validates it and keeps what the caller restores."""
    try:
        manifest = json.loads((path / MANIFEST).read_text())
        kept = {}
        for key, meta in manifest["leaves"].items():
            f = path / meta["file"]
            if not f.exists():
                return None
            arr = np.load(f)
            if _crc32(arr) != meta["crc32"]:
                return None
            if key in keep:
                kept[key] = arr
        return manifest, kept
    except Exception:
        return None


def list_steps(root: os.PathLike) -> List[int]:
    root = Path(root)
    if not root.exists():
        return []
    return sorted(int(p.name.split("_")[1]) for p in root.glob("step_*")
                  if p.is_dir())


def _to_tensor(arr: np.ndarray, dtype: str, key: str) -> torch.Tensor:
    if arr.dtype.kind == "V":
        if dtype == "bfloat16" and arr.dtype.itemsize == 2:
            return torch.from_numpy(
                np.ascontiguousarray(arr).view(np.int16).copy()).view(
                    torch.bfloat16)
        raise ValueError(f"checkpoint leaf {key}: dtype {dtype} "
                         f"({arr.dtype.itemsize}-byte opaque values) cannot "
                         f"be read into a tensor")
    # an array np.load made is the tensor's own; any other is copied
    return torch.from_numpy(arr if arr.flags.writeable and arr.flags.owndata
                            and arr.flags.c_contiguous
                            else np.array(arr, copy=True))


def _device_of(leaf) -> torch.device:
    if isinstance(leaf, torch.Tensor):
        return leaf.device
    return torch.device("cpu")


def _sharding_leaves(shardings, like) -> List[Any]:
    """``shardings``' leaf for each leaf of ``like`` (a ``NamedSharding``
    or ``None``), in ``_leaf_paths`` order; ``ValueError`` where the two
    trees differ in structure."""
    out: List[Any] = []

    def walk(s, node, path):
        if node is None:
            return
        if isinstance(node, dict):
            if not isinstance(s, dict) or sorted(s) != sorted(node):
                raise ValueError(f"shardings at {path or 'the root'} do not "
                                 f"match like's keys")
            for k in sorted(node):
                walk(s[k], node[k], f"{path}/{k}")
        elif isinstance(node, (list, tuple)):
            if not isinstance(s, (list, tuple)) or len(s) != len(node):
                raise ValueError(f"shardings at {path or 'the root'} do not "
                                 f"match like's sequence")
            for i, (a, b) in enumerate(zip(s, node)):
                walk(a, b, f"{path}/{i}")
        elif s is None or isinstance(s, NamedSharding):
            out.append(s)
        else:
            raise ValueError(f"shardings at {path}: {type(s).__name__} is "
                             f"not a NamedSharding")
    walk(shardings, like, "")
    return out


def restore(root: os.PathLike, step: int, like: Any, *,
            shardings: Any = None) -> Tuple[Any, Dict]:
    """Restore ``step`` into the structure of ``like`` (a tree of tensors),
    in the dtype each leaf was stored in. Returns ``(tree, extra)``.

    Without ``shardings`` each leaf goes to the device of ``like``'s leaf
    (the CPU for a leaf that is not a tensor). ``shardings``, a tree of the
    same structure as ``like`` (``ValueError`` otherwise), places each leaf
    on its ``NamedSharding`` with ``device_put``: a ``Sharded`` whose every
    position owns its block (where the leaf's sharding is ``None``, as
    without). This is where elastic resharding happens. A step that is
    missing or fails validation raises ``IOError``."""
    path = Path(root) / f"step_{step:010d}"
    placements = (None if shardings is None
                  else _sharding_leaves(shardings, like))
    valid = _validate(path, {key for key, _ in _leaf_paths(like)})
    if valid is None:
        raise IOError(f"checkpoint at {path} is missing or corrupt")
    return _read(*valid, like, placements)


def _read(manifest: Dict, arrays: Dict, like: Any, placements) -> Tuple[
        Any, Dict]:
    leaves = []
    for i, (key, leaf) in enumerate(_leaf_paths(like)):
        t = _to_tensor(arrays[key], manifest["leaves"][key]["dtype"], key)
        if placements is not None and placements[i] is not None:
            leaves.append(shard(t, placements[i]))
        else:
            leaves.append(t.to(_device_of(leaf)))
    return _unflatten(like, leaves), manifest["extra"]


def restore_latest(root: os.PathLike, like: Any, *, shardings: Any = None
                   ) -> Optional[Tuple[int, Any, Dict]]:
    """Newest valid checkpoint, skipping corrupt ones. None if none exist."""
    placements = (None if shardings is None
                  else _sharding_leaves(shardings, like))
    keys = {key for key, _ in _leaf_paths(like)}
    for step in reversed(list_steps(root)):
        valid = _validate(Path(root) / f"step_{step:010d}", keys)
        if valid is None:
            continue
        tree, extra = _read(*valid, like, placements)
        return step, tree, extra
    return None
