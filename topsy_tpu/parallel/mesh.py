"""Device-mesh helpers for multi-chip rendering."""

from __future__ import annotations

import jax
from jax.sharding import Mesh


PARTICLE_AXIS = "particles"


def make_mesh(n_devices: int | None = None, axis_name: str = PARTICLE_AXIS) -> Mesh:
    """1-D mesh over the particle axis.

    Rendering parallelism is pure data parallelism over particles with a
    framebuffer all-reduce (SURVEY.md §2.10), so a 1-D mesh is the natural
    layout.
    """
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices, (axis_name,))
