"""Host front-end microbench: native C++ polyphase throughput per core.

Measures (single-threaded, so the numbers are per-core and scale with
host cores):

  1. plain decimator chain  — HostBatchedStreamingDecimator, uint8
     2.4 Msps -> 375 sps, reported as Msps/core and realtime
     channels/core (the reference's "RX load" analog,
     rtlsdr_wsprd.c:126-244);
  2. wideband channelizer   — ChannelizingStreamingDecimator
     (placement="host"): K dials from ONE 2.4 Msps capture through
     per-dial folded stage-1 taps, reported as decoded dials/core
     (K * Msps / 2.4). These are the numbers quoted in PARITY.md.

Usage: python tools/host_frontend_bench.py [seconds_per_case]
Run on an idle box; any competing load deflates the numbers.
"""

from __future__ import annotations

import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402


def _stream_case(make, secs: float, label: str, k: int = 1) -> None:
    chunk = 2_400_000  # 1 s of raw stream per push
    rng = np.random.default_rng(5)
    ci = rng.integers(0, 256, (1, chunk), dtype=np.uint8)
    cq = rng.integers(0, 256, (1, chunk), dtype=np.uint8)
    dec = make()
    dec.push(ci, cq)  # prime carries + warm
    n = 0
    t0 = time.perf_counter()
    while (dt := time.perf_counter() - t0) < secs:
        dec.push(ci, cq)
        n += 1
    msps = n * chunk / dt / 1e6
    print(f"{label:<28} {msps:7.1f} Msps/core   "
          f"{k * msps / 2.4:7.1f} realtime {'dials' if k > 1 else 'channels'}/core")


def main() -> None:
    secs = float(sys.argv[1]) if len(sys.argv) > 1 else 10.0
    from rtlsdr_wsprd_tpu import native

    if not native.HAS_DECIMATE:
        raise SystemExit("native hostdsp polyphase unavailable (make -C native)")
    from rtlsdr_wsprd_tpu.frontend.channelize import (
        ChannelizingStreamingDecimator,
    )
    from rtlsdr_wsprd_tpu.frontend.host_decimate import (
        HostBatchedStreamingDecimator,
    )

    _stream_case(lambda: HostBatchedStreamingDecimator(1, threads=1), secs,
                 "plain decimator")
    for K in (1, 4):
        offs = [50_000.0 * i for i in range(K)]
        _stream_case(
            lambda offs=offs: ChannelizingStreamingDecimator(
                offs, placement="host", threads=1),
            secs, f"channelizer K={K}", k=K)


if __name__ == "__main__":
    main()
