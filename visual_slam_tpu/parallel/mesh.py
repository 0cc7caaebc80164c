"""Device-mesh helpers for multi-chip / multi-host execution.

The reference has no distributed layer at all (SURVEY.md §2.3); scaling here
comes from `jax.sharding.Mesh` + shard_map with XLA collectives (NCCL
over NVLink between the GPUs of one host). Meshes are flat device lists:
every card reaches every other at the same rate, so the mesh follows the
algorithm alone.
"""
from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, axis: str = "obs") -> Mesh:
    """1-D mesh over the first `n_devices` devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0, fill=0):
    """Pad an array along `axis` to a multiple (fixed-shape sharding)."""
    n = x.shape[axis]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return x
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, target - n)
    return np.pad(x, pad, constant_values=fill)
