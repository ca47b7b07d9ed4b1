"""Mesh construction helpers.

Axis convention (the framework's parallelism vocabulary):
  'dp' — query/data parallelism: query batches and k-means training data
         are sharded here (the DP analogue of SURVEY.md §2.5).
  'db' — database tensor parallelism: the PQ code matrix [N, M] is
         sharded along N here (the TP analogue); per-shard top-k results
         are merged with an all_gather over this axis.

Meshes are host-major, so 'db' collectives stay within a host before
crossing hosts. Multi-device tests use the virtual CPU backend
(xla_force_host_platform_device_count).
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh


def make_mesh(axis_sizes: dict[str, int] | None = None,
              devices=None) -> Mesh:
    """Build a Mesh with named axes. Default: all default-backend devices
    on a single 'db' axis."""
    if devices is None:
        devices = jax.devices()
    if axis_sizes is None:
        axis_sizes = {"db": len(devices)}
    names = tuple(axis_sizes)
    sizes = tuple(axis_sizes.values())
    total = int(np.prod(sizes))
    if total > len(devices):
        raise ValueError(f"need {total} devices, have {len(devices)}")
    dev = np.asarray(devices[:total]).reshape(sizes)
    return Mesh(dev, names)


def cpu_mesh(axis_sizes: dict[str, int]) -> Mesh:
    """Mesh over host CPU devices (requires
    XLA_FLAGS=--xla_force_host_platform_device_count=N set early).
    Used to validate multi-chip shardings without a pod slice."""
    return make_mesh(axis_sizes, devices=jax.devices("cpu"))
