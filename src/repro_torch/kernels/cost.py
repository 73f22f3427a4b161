"""The work of each kernel's function: the bytes it must move and the
operations it must do, counted from its shapes.

One count a kernel, whoever asks: ``chip_smoke.py`` divides it by the
card's peaks for each kernel's bound, and the wrappers declare it to an
active counter (``repro_torch/counter.py``) on every call, on the card and in
their ``meta`` forms, for the dry run's roofline (``launch/roofline.py``).

Bytes: each input read once and each output written once. Indices are
charged at ``INDEX_BYTES``, the int32 the kernels could take (the wrappers
refuse E or N*D >= 2^31), though the port's graphs hold int64. Operations:
those of the function on these inputs. Where the work depends on the data
(the edges whose mask is set), ``valid`` is the count of such edges; the
wrappers declare every edge, since reading the mask would wait for the
card.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

# bytes of one index the function needs
INDEX_BYTES = 4


def visible_pairs(sq: int, sk: int, *, causal: bool,
                  window: Optional[int]) -> int:
    """The (query, key) pairs the attention mask leaves, for one (batch,
    head): positions end-aligned, ``q_pos = i + (Sk - Sq)``; ``causal``
    keeps ``j <= q_pos``, ``window`` keeps ``j > q_pos - window``
    (``kernels/flash_attention.py::visible``)."""
    q_pos = np.arange(sq, dtype=np.int64) + (sk - sq)
    hi = np.minimum(q_pos, sk - 1) if causal else np.full(sq, sk - 1)
    lo = (np.maximum(q_pos - window + 1, 0) if window is not None
          else np.zeros(sq, dtype=np.int64))
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_work(b: int, h: int, sq: int, sk: int, d: int, *, causal: bool,
               window: Optional[int], itemsize: int,
               lse: bool = False) -> Tuple[int, int]:
    """(bytes, operations) of the attention forward: q, k, v and out once
    each (and the float32 lse rows with ``lse``); the two products, 4 D
    operations per visible pair. The softmax's few operations per pair are
    left out (under 2% at D = 128)."""
    pairs = visible_pairs(sq, sk, causal=causal, window=window) * b * h
    nbytes = (2 * b * h * sq * d + 2 * b * h * sk * d) * itemsize
    if lse:
        nbytes += 4 * b * h * sq
    return nbytes, 4 * d * pairs


def flash_bwd_work(b: int, h: int, sq: int, sk: int, d: int, *, causal: bool,
                   window: Optional[int], itemsize: int) -> Tuple[int, int]:
    """(bytes, operations) of the attention backward: q, out, dout (Sq
    rows), k, v (Sk rows) and the float32 lse read once, dq, dk, dv written
    once; its five products, 10 D operations per visible pair."""
    pairs = visible_pairs(sq, sk, causal=causal, window=window) * b * h
    nbytes = ((3 * sq + 2 * sk) + (sq + 2 * sk)) * b * h * d * itemsize \
        + 4 * b * h * sq
    return nbytes, 10 * d * pairs


# operations per unmasked edge and lane of each mp_scatter_multi statistic
# (count: one per edge)
_STAT_OPS = {"sum": 1, "sumsq": 2, "max": 1, "min": 1}


def scatter_work(kernel: str, e: int, width: int, num_nodes: int,
                 itemsize: int, *, valid: Optional[int] = None,
                 stats: Sequence[str] = ("sum",)) -> Tuple[int, int]:
    """(bytes, operations) of ``mp_scatter``, ``mp_scatter_multi`` or
    ``seg_softmax`` over E edges of ``width`` lanes (logits' heads) into
    ``num_nodes`` rows, ``valid`` of the edges unmasked (all by default).
    Bytes: the edge mask once, the unmasked edges' rows and receivers
    once, each output once (the statistics, f32 for the multi sweep and the
    messages' dtype for ``mp_scatter``; seg_softmax's (E, H) f32 weights).
    Operations: per unmasked edge and lane the statistics (sum 1, sumsq 2,
    max 1, min 1; count 1 per edge); for seg_softmax per unmasked edge and
    head the max, the difference, the exponential and the sum, then the
    weight's difference, exponential, clamp and division (8)."""
    valid = e if valid is None else valid
    nbytes = e + valid * (INDEX_BYTES + itemsize * width)
    if kernel == "seg_softmax":
        return nbytes + 4 * e * width, 8 * valid * width
    if kernel == "mp_scatter":
        stats = ("sum",)
    out_item = itemsize if kernel == "mp_scatter" else 4
    nbytes += sum(out_item * num_nodes * (1 if s == "count" else width)
                  for s in stats)
    flops = valid * (width * sum(_STAT_OPS.get(s, 0) for s in stats)
                     + ("count" in stats))
    return nbytes, flops


def gather_rows_work(s: int, d: int, itemsize: int, *,
                     valid: Optional[int] = None) -> Tuple[int, int]:
    """(bytes, operations) of ``gather_rows``: the mask once, the unmasked
    rows' indices and y rows once, the (S, D) float32 output once; no
    arithmetic."""
    valid = s if valid is None else valid
    return s + valid * (INDEX_BYTES + d * itemsize) + s * d * 4, 0


__all__ = ["INDEX_BYTES", "flash_bwd_work", "flash_work", "gather_rows_work",
           "scatter_work", "visible_pairs"]
