"""Mesh construction and canonical shardings.

Axis convention:
  ``ch``   — channels/windows (pure data parallelism; the throughput
             axis; rides the chip interconnect within a host, the
             network across hosts)
  ``seq``  — the 2.4 Msps time axis of the streaming front end
             (overlap-save halo exchange between neighbors)

The decode of one window always stays resident on one chip (SURVEY.md
section 5: collectives traffic is tiny relative to compute); the mesh
exists for throughput scaling, not model parallelism.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    devices: list | None = None,
    axis_name: str = "ch",
) -> Mesh:
    """1-D mesh over all (or the given) devices."""
    devs = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devs), (axis_name,))


def local_mesh(n: int | None = None, axis_name: str = "ch") -> Mesh:
    """Mesh over the first ``n`` local devices (defaults to all)."""
    devs = jax.devices()
    if n is not None:
        if n > len(devs):
            raise ValueError(
                f"requested {n} devices, only {len(devs)} available; for "
                "CPU testing set XLA_FLAGS=--xla_force_host_platform_"
                f"device_count={n}"
            )
        devs = devs[:n]
    return make_mesh(devs, axis_name)


def channel_sharding(mesh: Mesh, axis_name: str = "ch") -> NamedSharding:
    """Shard the leading (channel/window/attempt) axis over the mesh."""
    return NamedSharding(mesh, P(axis_name))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
