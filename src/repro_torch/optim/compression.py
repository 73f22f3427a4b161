"""Int8 error-feedback gradient compression over a mesh axis.

The twin of ``repro/optim/compression.py``. ``compressed_psum`` quantizes
a tensor to int8 with one absmax scale, sums the int8 payloads in int32
over the axis and rescales by the largest of the positions' scales; the
quantization residual is carried in an *error-feedback* buffer added to
the next step's gradient (Karimireddy et al., 2019).

Every operation is the reference's, in the same order and the same dtype
(absmax, a division by 127, a division by the scale, round half to even,
a clip, an int32 sum and a ``pmax`` of the scales), so the payloads, the
scales and the reduced sums are bitwise the reference's. The error buffer
``corrected - q * scale`` is rounded twice here, as the reference's source
writes it; its compiled CPU program fuses the two into one multiply-add
for some elements and not others, so there the two differ by at most one
rounding of ``q * scale``. The reduced sum keeps the reference's
approximation too: each position's
payload is rescaled by the *largest* scale, not its own, so where the
positions' scales differ the sum overshoots the smaller ones' shares; error
feedback does not see that part (it carries only the rounding residual).
Run inside ``shard_map`` (``distributed/collectives.py``).
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.distributed.collectives import pmax, psum
from repro_torch.distributed.sharding import tree_leaves, tree_unflatten


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    absmax = torch.clamp(torch.max(torch.abs(x)), min=1e-12)
    scale = absmax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """All-reduce ``x`` over ``axis_name`` with an int8 payload (summed in
    int32) and the largest of the positions' scales."""
    q, scale = quantize_int8(x)
    total = psum(q.to(torch.int32), axis_name)
    scale_max = pmax(scale, axis_name)
    return total.to(torch.float32) * scale_max


def _ef_quantize(x: torch.Tensor, err: torch.Tensor):
    corrected = x.to(torch.float32) + err
    q, scale = quantize_int8(corrected)
    new_err = corrected - dequantize_int8(q, scale)
    return q.to(torch.int32), scale, new_err


def ef_compressed_psum(x: torch.Tensor, err: torch.Tensor, axis_name: str
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback compressed psum: returns (reduced, new_error)."""
    q, scale, new_err = _ef_quantize(x, err)
    total = psum(q, axis_name)
    scale_max = pmax(scale, axis_name)
    return total.to(torch.float32) * scale_max, new_err


def tree_ef_compressed_psum(grads: Any, errs: Any, axis_name: str
                            ) -> Tuple[Any, Any]:
    """``ef_compressed_psum`` on every leaf of ``grads`` with the matching
    leaf of ``errs``. The leaves' payloads travel in one ``psum`` and their
    scales in one ``pmax`` (the same sums and maxima, leaf by leaf, as one
    collective a leaf)."""
    parts = [_ef_quantize(g, e) for g, e in zip(tree_leaves(grads),
                                                 tree_leaves(errs))]
    totals = psum([q for q, _, _ in parts], axis_name)
    scales = pmax([s for _, s, _ in parts], axis_name)
    reduced = [t.to(torch.float32) * s for t, s in zip(totals, scales)]
    return (tree_unflatten(grads, reduced),
            tree_unflatten(grads, [e for _, _, e in parts]))
