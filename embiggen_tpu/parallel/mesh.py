"""Device-mesh helpers for multi-device training (SURVEY.md §5.8: the
reference has no inter-node communication at all — this subsystem is new
capability, built on `jax.sharding.Mesh` + `shard_map`; XLA lowers the
collectives to NCCL on GPUs). Meshes are flat 1-D device lists: the cards
of one host are joined all to all, so no device order is preferred."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh

# Share of one device's allocatable memory (`memory_stats()["bytes_limit"]`)
# that replicated embedding tables may take before "auto" distribution
# switches from data-parallel (replicated tables) to row-sharded tables.
# The rest is left for walk buffers, gathered rows and gradients.
REPLICATED_TABLE_SHARE = 0.5


def auto_distribution(table_bytes: int, device) -> str:
    """'rows' when replicating `table_bytes` of tables on `device` would
    exceed `REPLICATED_TABLE_SHARE` of its memory, else 'data'. A backend
    that reports no memory limit (the CPU) gets 'data'."""
    stats = device.memory_stats() or {}
    limit = stats.get("bytes_limit")
    if not limit:
        return "data"
    return "rows" if table_bytes > REPLICATED_TABLE_SHARE * limit else "data"


def make_mesh(
    axis_names: Tuple[str, ...] = ("data",),
    shape: Optional[Tuple[int, ...]] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a mesh over available devices. With no shape, all devices land on
    the first axis."""
    devices = list(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    arr = np.asarray(devices).reshape(shape)
    return Mesh(arr, axis_names)


def resolve_mesh(mesh, axis: str = "data") -> Optional[Mesh]:
    """Normalize the `mesh` argument every production model accepts
    (the counterpart of the reference's `use_mirrored_strategy` flag,
    `tensorflow_embedder.py:73-79`):

    - None        -> None (single-device training)
    - jax.sharding.Mesh -> itself (must be 1-D)
    - int n       -> 1-D mesh over the first n local devices
    - "auto"      -> 1-D mesh over ALL local devices (None if only one)
    """
    if mesh is None:
        return None
    if isinstance(mesh, Mesh):
        if len(mesh.axis_names) != 1:
            raise ValueError(
                "Model-level distribution expects a 1-D mesh; got axes "
                f"{mesh.axis_names}."
            )
        return mesh if mesh.devices.size > 1 else None
    if mesh == "auto":
        devs = jax.devices()
        if len(devs) <= 1:
            return None
        return make_mesh((axis,), devices=devs)
    if isinstance(mesh, int):
        devs = jax.devices()
        if mesh > len(devs):
            raise ValueError(
                f"mesh={mesh} devices requested but only {len(devs)} "
                "are available."
            )
        if mesh <= 1:
            return None
        return make_mesh((axis,), devices=devs[:mesh])
    raise TypeError(
        f"mesh must be None, 'auto', an int or a jax.sharding.Mesh; got "
        f"{type(mesh).__name__}."
    )
