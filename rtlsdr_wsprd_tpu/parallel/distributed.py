"""Multi-host initialization and global meshes.

The reference has no distributed story (single process, one dongle —
SURVEY.md component 39). Here multi-host scaling is standard JAX SPMD:
every host runs the same program, ``jax.distributed.initialize`` wires
the processes into one runtime, and a global 1-D (or 2-D host x chip)
mesh shards the channel axis; each host ingests its own channels (DCN
never carries sample data, only the tiny spot lists if aggregated).

Usage on each host of an N-host slice:

    from rtlsdr_wsprd_tpu.parallel import distributed as dist
    dist.initialize(coordinator="host0:1234", num_processes=N,
                    process_id=rank)
    mesh = dist.global_channel_mesh()
    # shard (B_global, 45000) planar windows over mesh's "ch" axis;
    # each host device_put's only its addressable shard
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Wire this process into a multi-host JAX runtime.

    All-None arguments defer to JAX's environment auto-detection of a
    cluster, where one exists; on a plain GPU host give all three.
    """
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_channel_mesh(axis_name: str = "ch") -> Mesh:
    """1-D mesh over every device in the job (all hosts)."""
    return Mesh(np.asarray(jax.devices()), (axis_name,))


def host_chip_mesh(ch_axis: str = "ch", host_axis: str = "host") -> Mesh:
    """2-D (hosts x local chips) mesh: shard channels over hosts (DCN
    boundary) and over chips within a host (ICI) independently."""
    n_hosts = jax.process_count()
    devs = np.asarray(jax.devices())
    per_host = devs.size // n_hosts
    return Mesh(devs.reshape(n_hosts, per_host), (host_axis, ch_axis))


def local_batch_slice(global_batch: int) -> slice:
    """The [start, stop) channel range this host should ingest when a
    (global_batch, ...) array is sharded over all devices."""
    n = jax.process_count()
    per = global_batch // n
    r = jax.process_index()
    return slice(r * per, (r + 1) * per)


def rank_slice(n_items: int, rank: int | None = None,
               nprocs: int | None = None) -> slice:
    """Partition ``n_items`` channels across ranks, remainder spread
    over the first ranks (rank k of N owns a contiguous run of
    ``n_items // N`` or ``n_items // N + 1`` items; every item is owned
    by exactly one rank). Unlike local_batch_slice this does not
    require divisibility — it drives the integrated multi-host daemon's
    channel assignment (multicli --nprocs/--rank), where the channel
    count is whatever the operator's dongle fleet provides."""
    r = jax.process_index() if rank is None else rank
    n = jax.process_count() if nprocs is None else nprocs
    base, extra = divmod(n_items, n)
    start = r * base + min(r, extra)
    return slice(start, start + base + (1 if r < extra else 0))


def decode_local_shard(i_windows, q_windows, options=None, hashtable=None,
                       device_batch: int = 64):
    """Production multi-host decode: THIS host's channels through the
    staged single-device path (parallel.multichannel decode_channels).

    WSPR decode is embarrassingly parallel per window (SURVEY.md
    section 5), so the fastest multi-host architecture is no mesh
    program at all: every host ingests its own channels, decodes them
    on its local chip(s) with the lane-compacted staged path, and only
    the tiny spot lists ever touch the network (to wsprnet, or to an
    aggregator). Collectives would only add latency. Call
    ``initialize()`` first if chips are physically one pod slice.
    """
    from ..config import DecoderOptions
    from .multichannel import decode_channels

    if options is None:
        options = DecoderOptions()
    return decode_channels(i_windows, q_windows, options, hashtable,
                           device_batch=device_batch)
