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
            "crc32": zlib.crc32(arr.tobytes()),
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


def _validate(path: Path) -> Optional[Dict]:
    """The step's manifest if every leaf is present and its CRC checks,
    else ``None``."""
    try:
        manifest = json.loads((path / MANIFEST).read_text())
        for key, meta in manifest["leaves"].items():
            f = path / meta["file"]
            if not f.exists():
                return None
            arr = np.load(f)
            if zlib.crc32(arr.tobytes()) != meta["crc32"]:
                return None
        return manifest
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
    return torch.from_numpy(np.array(arr, copy=True))


def _device_of(leaf) -> torch.device:
    if isinstance(leaf, torch.Tensor):
        return leaf.device
    return torch.device("cpu")


def restore(root: os.PathLike, step: int, like: Any, *,
            shardings: Any = None) -> Tuple[Any, Dict]:
    """Restore ``step`` into the structure of ``like`` (a tree of tensors),
    each leaf on the device of ``like``'s leaf (the CPU for a leaf that is
    not a tensor), in the dtype it was stored in. Returns ``(tree,
    extra)``. ``shardings`` places leaves on a mesh in the JAX package; one
    GPU has none, so anything but ``None`` raises ``ValueError``. A step
    that is missing or fails validation raises ``IOError``."""
    if shardings is not None:
        raise ValueError("shardings= has no meaning on one GPU; leaves go "
                         "to the devices of like's leaves")
    path = Path(root) / f"step_{step:010d}"
    manifest = _validate(path)
    if manifest is None:
        raise IOError(f"checkpoint at {path} is missing or corrupt")
    leaves = []
    for key, leaf in _leaf_paths(like):
        meta = manifest["leaves"][key]
        arr = np.load(path / meta["file"])
        leaves.append(_to_tensor(arr, meta["dtype"], key).to(
            _device_of(leaf)))
    return _unflatten(like, leaves), manifest["extra"]


def restore_latest(root: os.PathLike, like: Any, *, shardings: Any = None
                   ) -> Optional[Tuple[int, Any, Dict]]:
    """Newest valid checkpoint, skipping corrupt ones. None if none exist."""
    for step in reversed(list_steps(root)):
        path = Path(root) / f"step_{step:010d}"
        if _validate(path) is None:
            continue
        tree, extra = restore(root, step, like, shardings=shardings)
        return step, tree, extra
    return None
