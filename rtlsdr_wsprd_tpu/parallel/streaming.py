"""Sequence-parallel streaming front end: time-axis sharding with
overlap-save halo exchange.

The reference processes its 2.4 Msps stream on one core
(rtlsdr_wsprd.c:126-244). When a single stream (or a fused multi-band
stream) outgrows one chip's ingest, the scaling axis is the
TIME dimension: shard the raw sample axis over the mesh, and exchange
the (taps - R) filter-boundary samples between ring neighbors with one
``ppermute`` — the context/sequence-parallel analog for DSP
(SURVEY.md section 5 "long-context / sequence parallelism").

Each shard then runs the identical local polyphase program
(frontend/decimate.py), so results are bit-identical to the unsharded
kernel except the last (taps/R - 1) frames of the final shard, whose
halo wraps circularly — callers either pad the input or drop them
(``valid_frames`` says how many are exact).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

try:  # jax >= 0.4.35
    from jax import shard_map
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map

from ..frontend.decimate import _polyphase_pp, _pp_mats
from ..frontend.filters import R1, R2, STAGE1_TAPS, STAGE2_TAPS


def valid_frames(total_samples: int) -> int:
    """Stage-1 frames whose inputs never wrap past the stream end."""
    return (total_samples - (STAGE1_TAPS - R1)) // R1


def valid_frames_stage2(total_mid: int) -> int:
    """Stage-2 frames whose inputs never wrap past the mid-stream end."""
    return (total_mid - (STAGE2_TAPS - R2)) // R2


@partial(jax.jit, static_argnames=("mesh", "axis"))
def decimate_stage1_sharded(
    xI: jnp.ndarray,
    xQ: jnp.ndarray,
    mesh: Mesh,
    axis: str = "seq",
):
    """Stage-1 polyphase over a time-sharded raw stream.

    xI/xQ: float32[L] with L a multiple of mesh.size * R1. Returns
    planar (float32[L/R1], float32[L/R1]); the trailing
    (STAGE1_TAPS/R1 - 1) frames wrap circularly (see module docstring).
    """
    n = mesh.shape[axis]
    L = xI.shape[0]
    assert L % (n * R1) == 0, (L, n)
    halo = STAGE1_TAPS - R1
    frames_local = L // (n * R1)
    # single-hop halo: each shard must hold at least the filter tail
    assert frames_local * R1 >= halo, (
        f"shard too short for the stage-1 halo: {frames_local * R1} "
        f"local samples < {halo}; need >= {n * (halo + R1)} total")
    H1t, H1b, _, _ = _pp_mats()
    perm = [(i, (i - 1) % n) for i in range(n)]  # shard i -> i-1 (left)

    def local(xi, xq):
        # receive the right neighbor's first `halo` samples
        hi = jax.lax.ppermute(xi[:halo], axis, perm)
        hq = jax.lax.ppermute(xq[:halo], axis, perm)
        fi = jnp.concatenate([xi, hi])
        fq = jnp.concatenate([xq, hq])
        return _polyphase_pp(fi, fq, H1t, H1b, frames_local)

    fn = shard_map(local, mesh=mesh, in_specs=(P(axis), P(axis)),
                   out_specs=(P(axis), P(axis)))
    return fn(xI, xQ)


@partial(jax.jit, static_argnames=("mesh", "axis"))
def decimate_stage2_sharded(
    midI: jnp.ndarray,
    midQ: jnp.ndarray,
    mesh: Mesh,
    axis: str = "seq",
):
    """Stage-2 polyphase over a time-sharded 30 ksps mid-rate stream —
    the same ppermute halo exchange as stage 1 with the stage-2 tail
    (STAGE2_TAPS - R2 = 2320 mid samples, ~77 ms of halo per boundary).

    midI/midQ: float32[M] with M a multiple of mesh.size * R2. Returns
    planar (float32[M/R2], float32[M/R2]); the trailing
    (STAGE2_TAPS/R2 - 1) frames wrap circularly, as in stage 1.
    Chaining both stages keeps a single overwide stream fully
    sequence-parallel from raw 2.4 Msps to 375 sps baseband.
    """
    n = mesh.shape[axis]
    M = midI.shape[0]
    assert M % (n * R2) == 0, (M, n)
    halo = STAGE2_TAPS - R2
    frames_local = M // (n * R2)
    # single-hop halo: each shard must hold at least the filter tail
    # (2320 mid samples = ~77 ms of 30 ksps stream per shard minimum)
    assert frames_local * R2 >= halo, (
        f"shard too short for the stage-2 halo: {frames_local * R2} "
        f"local mid samples < {halo}; need >= {n * (halo + R2)} total")
    _, _, H2t, H2b = _pp_mats()
    perm = [(i, (i - 1) % n) for i in range(n)]

    def local(xi, xq):
        hi = jax.lax.ppermute(xi[:halo], axis, perm)
        hq = jax.lax.ppermute(xq[:halo], axis, perm)
        fi = jnp.concatenate([xi, hi])
        fq = jnp.concatenate([xq, hq])
        return _polyphase_pp(fi, fq, H2t, H2b, frames_local)

    fn = shard_map(local, mesh=mesh, in_specs=(P(axis), P(axis)),
                   out_specs=(P(axis), P(axis)))
    return fn(midI, midQ)
