"""Mesh construction.

The twin of ``repro/launch/mesh.py``: functions, not module-level
constants, so importing this module touches no device.

``make_host_mesh`` is the small mesh of the tests, the examples and the
trainer's ``--data-parallel`` / ``--model-parallel``: its positions go on
the given devices (``devices="cpu"`` for all on the CPU), by default
position i on ``cuda:(i mod device_count)``, so several positions may
share one card, each on its own stream. ``make_production_mesh`` is the
reference's (16, 16) and (2, 16, 16) meshes with every position on the
``meta`` device: enough to plan placements (``distributed/elastic.py::
remesh_plan``) with no hardware.
"""

from __future__ import annotations

from typing import Sequence, Union

from repro_torch import DeviceLike
from repro_torch.distributed.sharding import Mesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices="meta")


def data_axis_names(mesh: Mesh) -> tuple:
    """Batch is sharded over every non-model axis (pod composes with data)."""
    return tuple(n for n in mesh.axis_names if n != "model")


def make_host_mesh(data: int = 1, model: int = 1, *,
                   devices: Union[DeviceLike, Sequence[DeviceLike]] = None
                   ) -> Mesh:
    """A (data, model) mesh over ``devices`` (one a position, or one for
    all); by default position i on ``cuda:(i mod device_count)``."""
    return make_mesh((data, model), ("data", "model"), devices=devices)
