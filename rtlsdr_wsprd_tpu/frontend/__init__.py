"""Streaming front end: 2.4 Msps raw IQ -> 375 sps baseband.

Replaces the reference's per-sample C chain — uint8 recenter + fs/4
economic mixer (rtlsdr_wsprd.c:158-182), CIC N=2 R=6400 decimator
(:184-218) and 33-tap droop-compensation FIR (:220-234) — with ONE
two-stage polyphase FIR decimator built from dense matmuls:

  stage 1: 2.4 Msps -> 30 ksps (R=80), complex coefficients that fold
           the fs/4 downmix into the filter (80 = 0 mod 4 makes the
           per-output-sample mixer phase vanish), uint8->float
           conversion fused on device so the link carries 1 byte/sample;
  stage 2: 30 ksps -> 375 sps (R=80), sharp real lowpass.

Deliberate divergences (documented, SURVEY.md section 7): exact 6400:1
decimation (the C emits every 6401st sample, rtlsdr_wsprd.c:199), flat
passband instead of CIC droop + compensation, and far better alias
rejection (>80 dB vs the CIC's ~tens of dB). Parity is validated at the
message level end to end.
"""

from .filters import (
    GROUP_DELAY_375,
    R1,
    R2,
    STAGE1_TAPS,
    STAGE2_TAPS,
    stage1_coeffs,
    stage2_coeffs,
)
from .channelize import ChannelizingStreamingDecimator
from .decimate import (
    BatchedStreamingDecimator,
    StreamingDecimator,
    decimate_stage1_batched,
    decimate_stage1_xla,
    decimate_stage2_batched,
    decimate_stage2_xla,
    decimate_window,
)
from .host_decimate import (
    HostBatchedStreamingDecimator,
    HostStreamingDecimator,
    resolve_placement,
)

__all__ = [
    "R1", "R2", "STAGE1_TAPS", "STAGE2_TAPS", "GROUP_DELAY_375",
    "stage1_coeffs", "stage2_coeffs",
    "decimate_stage1_xla", "decimate_stage2_xla", "decimate_window",
    "decimate_stage1_batched", "decimate_stage2_batched",
    "StreamingDecimator", "BatchedStreamingDecimator",
    "HostStreamingDecimator", "HostBatchedStreamingDecimator",
    "ChannelizingStreamingDecimator", "resolve_placement",
]
