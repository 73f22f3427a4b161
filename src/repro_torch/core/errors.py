"""Typed failures of the serving engine.

The twin of ``repro/core/errors.py`` (the classes this slice raises). All
subclass ``RuntimeError`` and carry

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
