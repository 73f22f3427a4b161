"""Typed failures of the serving engine.

The twin of ``repro/core/errors.py``: all eleven classes, with the
reference's bases, fields and messages. The engine raises every one of
them: the admission errors (``InvalidRequest``, ``InvalidGraph``,
``GraphTooLarge``, ``UnknownQueue``) and ``EngineClosed`` at ``submit``;
``PoisonGraph``, ``BatchFailed``, ``DeadlineExceeded`` and
``ExecutorDead`` through the futures (DESIGN.md §8); ``ParamUpdateFailed``
from ``update_params`` (§9). Under wide placement (DESIGN.md §10),
``GraphTooLarge`` also stands for a graph that no ``wide_k``-way split
fits the engine's buckets (``core/engine.py``). All subclass
``RuntimeError`` and carry

  * ``request_ids``    — engine request ids of the affected graphs, and
  * ``executor_index`` — the executor involved, when there is one.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple


class EngineError(RuntimeError):
    """Base class for serving-stack failures."""

    def __init__(self, message: str, *,
                 request_ids: Sequence[int] = (),
                 executor_index: Optional[int] = None):
        self.request_ids: Tuple[int, ...] = tuple(request_ids)
        self.executor_index = executor_index
        tags = []
        if self.request_ids:
            ids = ",".join(map(str, self.request_ids[:8]))
            if len(self.request_ids) > 8:
                ids += ",..."
            tags.append(f"requests=[{ids}]")
        if executor_index is not None:
            tags.append(f"executor={executor_index}")
        super().__init__(f"{message} ({'; '.join(tags)})" if tags
                         else message)


class EngineClosed(EngineError):
    """The engine was closed; no further submissions are accepted."""


class InvalidRequest(EngineError, ValueError):
    """A submission's arguments were rejected at admission (missing edge
    features, ...). Also a ``ValueError``."""


class InvalidGraph(InvalidRequest):
    """The submitted graph failed admission validation
    (``core/validate.py``): out-of-range edge indices, non-integer index
    dtypes, feature-width mismatch, degenerate shapes, or (opt-in)
    non-finite features."""


class GraphTooLarge(InvalidRequest):
    """The submitted graph exceeds the largest bucket the engine serves."""


class UnknownQueue(EngineError, KeyError):
    """The named tenant queue does not exist (no silent remapping; a
    typo fails loudly). Also a ``KeyError`` for pre-hierarchy callers."""

    def __str__(self) -> str:          # KeyError.__str__ would repr-quote
        return BaseException.__str__(self)


class ParamUpdateFailed(EngineError):
    """A hot parameter update was rejected: the new tree's structure or
    leaf shapes/dtypes do not match the serving params, or the canary
    batch produced non-finite / reference-diverging outputs. The
    previous version stays installed (atomic rollback); no in-flight
    request is affected."""


class BatchFailed(EngineError):
    """A batch's execution failed after the retry budget was exhausted
    without the failure being attributable to a single graph."""


class PoisonGraph(BatchFailed):
    """One graph was isolated as the cause of repeated batch failures
    (bisection quarantine) or produced non-finite outputs (validation
    gate). Only this graph's future fails; co-packed neighbors complete."""


class DeadlineExceeded(EngineError):
    """The graph's deadline (measured from enqueue time) expired before
    dispatch, or its batch sat in an executor past the in-flight
    timeout."""


class ExecutorDead(EngineError):
    """A ``DeviceExecutor`` worker died (crash, wedge past the watchdog
    timeout, or shutdown) and the work could not be re-placed on a
    survivor."""
