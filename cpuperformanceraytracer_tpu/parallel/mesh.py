"""Device mesh construction + multi-host initialization."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
from jax.sharding import Mesh


def make_mesh(
    shape: Tuple[int, ...],
    axis_names: Sequence[str] = ("px", "spp"),
    devices=None,
) -> Mesh:
    """Mesh of the given shape over the available devices (the cards of
    a host reach each other at one rate, so the shape follows the
    algorithm alone)."""
    if devices is not None:
        import numpy as np

        arr = np.asarray(devices).reshape(shape)
        return Mesh(arr, axis_names[: len(shape)])
    return jax.make_mesh(shape, tuple(axis_names[: len(shape)]))


def default_mesh(spp_shards: int = 1, devices=None) -> Mesh:
    """All devices on the "px" axis, optionally splitting off an "spp"
    axis of the given size."""
    devices = list(devices) if devices is not None else jax.devices()
    n = len(devices)
    if n % spp_shards:
        raise ValueError(f"{n} devices not divisible by spp_shards={spp_shards}")
    return make_mesh((n // spp_shards, spp_shards), ("px", "spp"), devices=devices)


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Multi-host bring-up: jax.distributed.initialize.

    The reference is single-process shared-memory (SURVEY.md section 5,
    'distributed communication backend: none'); multi-host here is the
    single-controller JAX runtime — call this once per host before
    building meshes that span hosts. No-ops when already initialized or
    when running single-process.
    """
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
