"""Phase timing of the PRODUCTION staged decode path (run on the GPU).

Runs ``decode_channels`` on the bench batch exactly as bench.py does
(double-buffered upload, 2-pass, subtraction) and reports wall time per
phase, derived from the module's own debug log marks plus explicit
timers around upload/assembly. This profiles what actually ships —
tools/profile_stages.py times the dense per-op shapes instead.

Usage: python tools/profile_staged.py [B] [DB]
"""

from __future__ import annotations

import logging
import sys
import time

import numpy as np

sys.path.insert(0, ".")
from bench import make_batch  # noqa: E402

from rtlsdr_wsprd_tpu.config import DecoderOptions  # noqa: E402
from rtlsdr_wsprd_tpu.parallel import multichannel as mc  # noqa: E402

_pos = [a for a in sys.argv[1:] if a != "-v"]
B = int(_pos[0]) if len(_pos) > 0 else 256
DB = int(_pos[1]) if len(_pos) > 1 else 64


class PhaseLog(logging.Handler):
    """Accumulates (t, message) marks from the staged-path logger."""

    def __init__(self):
        super().__init__(level=logging.DEBUG)
        self.marks: list[tuple[float, str]] = []

    def emit(self, record):
        self.marks.append((time.perf_counter(), record.getMessage()))


def summarize(marks, t0, t1):
    """Assign inter-mark intervals to phases by the ENDING mark."""
    phases: dict[str, float] = {}
    prev = t0
    for t, msg in marks:
        if msg.startswith("stage A done"):
            key = "stage A (STFT+cand+coarse)"
        elif msg.startswith("stage B:"):
            key = "lane compaction (host)"
        elif msg.startswith("stage B fetch"):
            key = "stage B (fine+jitter demod)"
        elif msg.startswith("fano rounds"):
            key = "fano rounds (device+host)"
        elif msg.startswith("host-finishing"):
            key = None  # sub-mark inside fano rounds
        elif msg.startswith("subtracting"):
            key = "spot assembly (host)"
        elif msg.startswith("subtraction done"):
            key = "subtraction (device)"
        else:
            key = None
        if key is not None:
            phases[key] = phases.get(key, 0.0) + (t - prev)
            prev = t
    phases["tail (assembly/sort)"] = t1 - prev
    return phases


def main():
    import jax

    wi, wq = make_batch(B)
    options = DecoderOptions()

    # warmup x2 (compile + thread pools), matching bench.py
    spots = mc.decode_channels(wi, wq, options, device_batch=DB)
    mc.decode_channels(wi, wq, options, device_batch=DB)
    n_spots = sum(len(s) for s in spots)

    handler = PhaseLog()
    mc._LOG.addHandler(handler)
    mc._LOG.setLevel(logging.DEBUG)

    t_up0 = time.perf_counter()
    prepared = mc.prepare_windows(wi, wq, device_batch=DB)
    t_up1 = time.perf_counter()
    # rendezvous: the async upload must LAND before the decode timer
    # starts, else stage A's interval absorbs the window transfer.
    # Steady-state pipelining overlaps this transfer with the previous
    # batch's decode (bench.py), so it is not decode cost.
    jax.block_until_ready(prepared.arrays)
    t_land = time.perf_counter()

    t0 = time.perf_counter()
    mc.decode_channels(None, None, options, windows=prepared)
    jax.effects_barrier()
    t1 = time.perf_counter()

    phases = summarize(handler.marks, t0, t1)
    total = t1 - t0
    if "-v" in sys.argv:
        prev = t0
        for t, msg in handler.marks:
            print(f"  +{1e3 * (t - prev):7.1f} ms  {msg}")
            prev = t
    print(f"device={jax.devices()[0].platform} B={B} DB={DB} "
          f"spots={n_spots}")
    print(f"{'prepare_windows (quantize+put)':34s} {1e3*(t_up1-t_up0):9.1f} ms"
          " (overlaps decode in steady state)")
    print(f"{'window upload landing':34s} {1e3*(t_land-t_up1):9.1f} ms"
          " (link-bound; also overlapped)")
    for k, v in sorted(phases.items(), key=lambda kv: -kv[1]):
        print(f"{k:34s} {1e3 * v:9.1f} ms  {100 * v / total:5.1f}%")
    print(f"{'TOTAL decode':34s} {1e3 * total:9.1f} ms   "
          f"-> {B / total:.1f} windows/s")


if __name__ == "__main__":
    main()
