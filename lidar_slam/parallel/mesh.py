"""Device mesh construction and canonical shardings.

The reference has no parallelism of any kind (SURVEY.md section 2: single
process, single thread); multi-chip scaling is new design surface. The
natural SPMD axes of this workload are:

  - "dp" (data parallel): independent ICP problems — scan pairs, loop-closure
    candidates, yaw seeds (the batch axis of every ICP call);
  - "rp" (ray parallel): rays within a scan for map building — log-odds
    deltas combine by elementwise add, so ray shards psum into the
    replicated grid across devices.

Collectives are inserted by XLA from sharding annotations (pjit) or written
explicitly in shard_map where the combining structure (psum of scatter
deltas) is part of the algorithm.
"""

from __future__ import annotations

from typing import Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None,
              axes: Tuple[str, ...] = ("dp",),
              shape: Tuple[int, ...] | None = None) -> Mesh:
    """Build a mesh over the first n available devices.

    With one axis, all devices go to it. With two axes and no explicit
    shape, devices split as evenly as possible (e.g. 8 -> (4, 2))."""
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    devs = devs[:n_devices]
    if shape is None:
        if len(axes) == 1:
            shape = (n_devices,)
        elif len(axes) == 2:
            a = int(np.floor(np.sqrt(n_devices)))
            while n_devices % a:
                a -= 1
            shape = (n_devices // a, a)
        else:
            raise ValueError("provide an explicit shape for >2 axes")
    arr = np.asarray(devs).reshape(shape)
    return Mesh(arr, axes)


def batch_sharding(mesh: Mesh, axis: str = "dp") -> NamedSharding:
    """Shard the leading (batch) dimension, replicate the rest."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
