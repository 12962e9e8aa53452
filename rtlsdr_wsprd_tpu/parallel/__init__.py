"""Device-mesh parallelism.

The reference is a single-process, 3-pthread program
(rtlsdr_wsprd.c:55-66,1161-1167) with no distributed backend; its only
scaling axis is "one dongle, one band". This package is the
first-class replacement (SURVEY.md section 5): channels/windows shard
over a 1-D (or host x chip 2-D) ``jax.sharding.Mesh`` as pure data
parallelism, and the streaming front end shards the 2.4 Msps time axis
with overlap-save halo exchange over ``ppermute`` (the sequence-parallel
analog).
"""

from . import distributed
from .mesh import channel_sharding, local_mesh, make_mesh, replicated
from .multichannel import (
    ChannelDecode,
    decode_channels,
    decode_channels_multidevice,
    multichannel_decode_device,
)
from .streaming import decimate_stage1_sharded

__all__ = [
    "make_mesh",
    "local_mesh",
    "channel_sharding",
    "replicated",
    "ChannelDecode",
    "decode_channels",
    "decode_channels_multidevice",
    "multichannel_decode_device",
    "decimate_stage1_sharded",
    "distributed",
]
