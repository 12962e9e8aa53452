"""Host-FEC threading evidence (VERDICT r4 weak item 2).

The staged path's FEC phase decodes independent lanes on the native
sequential Fano (``_map_lanes`` in parallel/multichannel.py, a
ThreadPoolExecutor over GIL-releasing ctypes calls), and its cost story
on multicore hosts rests on the claim "threads divide the
budget-exhausting lanes by the core count". This box exposes ONE core
(`os.sched_getaffinity` = {0}), so the claim's SCALING cannot be
measured here — what can be measured, and what the claim actually
rests on, is:

1. **worker sweep** — wall time of the production lane map
   (ThreadPoolExecutor, same pattern as ``_map_lanes``) over N
   budget-exhausting lanes at 1/2/4/8 workers. On one core a flat
   curve bounds the POOL OVERHEAD (threads cannot help, they must not
   hurt); on a multicore host this same sweep IS the scaling curve.
2. **GIL release proof** — a pure-Python counter thread's progress
   rate while a worker thread runs back-to-back native full-budget
   decodes, vs solo. If the ctypes call held the GIL the counter
   would freeze (~0%); released, the OS timeshares the one core
   (~50%). This is the property multicore scaling rests on: with the
   GIL dropped for the entire ~10 ms search, N cores run N lanes
   truly concurrently.
3. **dispatch overhead** — per-lane cost of the Python-side threading
   machinery vs a plain loop vs the batched ``native.fano_decode_many``
   entry, on CLEAN (~tens of us) decodes where overhead is most
   visible. Budget-exhausting lanes (~10 ms each) dwarf any of these
   numbers, which is why a native-internal thread pool is not needed:
   Python thread dispatch costs ~1e-2 of one timeout lane.

Usage: python tools/fec_scaling.py [lanes] [reps]
Prints one JSON line; recorded in PARITY.md. CPU-only (no accelerator).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

sys.path.insert(0, ".")

from rtlsdr_wsprd_tpu import native  # noqa: E402
from rtlsdr_wsprd_tpu.ops.fano import NBITS, build_mettab  # noqa: E402

MAXCYCLES = 10000  # the reference's full budget (wsprd/wsprd.c:747)


def make_lanes(n: int):
    """Budget-exhausting lanes: random symbols burn the full search."""
    rng = np.random.default_rng(20260820)
    return rng.integers(0, 256, (n, 2 * NBITS), dtype=np.uint8)


def make_clean():
    """One clean conv-encoded payload at hard soft bits (~25 us)."""
    rng = np.random.default_rng(7)
    payload = np.zeros(11, np.uint8)
    payload[:6] = rng.integers(0, 256, 6)
    payload[6] = rng.integers(0, 256) & 0xC0
    enc = native.conv_encode(payload, NBITS)
    clean = np.zeros(2 * NBITS, np.uint8)
    clean[0::2] = np.where((enc >> 1) & 1, 230, 25)
    clean[1::2] = np.where(enc & 1, 230, 25)
    return clean


def worker_sweep(mettab, lanes_arr, reps: int):
    """Production-pattern lane map at several worker counts."""
    n = lanes_arr.shape[0]

    def one_lane(k):
        return native.fano_decode(lanes_arr[k], mettab, delta=60,
                                  maxcycles=MAXCYCLES)[0]

    out = {}
    for workers in (1, 2, 4, 8):
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            if workers == 1:
                for k in range(n):
                    one_lane(k)
            else:
                with ThreadPoolExecutor(workers) as ex:
                    list(ex.map(one_lane, range(n)))
            best = min(best, time.perf_counter() - t0)
        out[f"w{workers}"] = round(best, 4)
    return out


def gil_release_ratio(mettab, noise, window_s: float = 0.6):
    """Python-thread progress while native decodes run, vs solo."""

    def count(stop, box):
        c = 0
        while not stop.is_set():
            c += 1
        box.append(c)

    def measure(with_decodes: bool) -> float:
        stop = threading.Event()
        box: list[int] = []
        t = threading.Thread(target=count, args=(stop, box))
        t.start()
        t0 = time.perf_counter()
        if with_decodes:
            while time.perf_counter() - t0 < window_s:
                native.fano_decode(noise, mettab, delta=60,
                                   maxcycles=MAXCYCLES)
        else:
            time.sleep(window_s)
        stop.set()
        t.join()
        return box[0] / (time.perf_counter() - t0)

    solo = measure(False)
    busy = measure(True)
    return busy / solo


def dispatch_overhead(mettab, clean, n: int = 256):
    """Per-lane cost of loop vs pool vs fano_decode_many on clean
    decodes (where the machinery, not the search, dominates)."""
    many = np.broadcast_to(clean, (n, clean.shape[0])).copy()

    def timed(fn) -> float:
        fn()  # warm
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return 1e6 * best / n  # us per lane

    loop_us = timed(lambda: [native.fano_decode(many[k], mettab, delta=60,
                                                maxcycles=MAXCYCLES)
                             for k in range(n)])

    def pooled():
        with ThreadPoolExecutor(4) as ex:
            list(ex.map(lambda k: native.fano_decode(
                many[k], mettab, delta=60, maxcycles=MAXCYCLES), range(n)))

    pool_us = timed(pooled)
    batch_us = timed(lambda: native.fano_decode_many(
        many, mettab, delta=60, maxcycles=MAXCYCLES))
    return {"loop_us_per_lane": round(loop_us, 2),
            "pool_us_per_lane": round(pool_us, 2),
            "decode_many_us_per_lane": round(batch_us, 2)}


def main() -> None:
    assert native.AVAILABLE, "native hostdsp required"
    n_lanes = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    mettab = np.ascontiguousarray(build_mettab(), np.int32)
    lanes_arr = make_lanes(n_lanes)
    noise = lanes_arr[0]

    # one timeout lane's cost anchors every other number
    t0 = time.perf_counter()
    native.fano_decode(noise, mettab, delta=60, maxcycles=MAXCYCLES)
    timeout_ms = 1e3 * (time.perf_counter() - t0)

    result = {
        "cores": len(os.sched_getaffinity(0)),
        "lanes": n_lanes,
        "timeout_lane_ms": round(timeout_ms, 2),
        "sweep_s": worker_sweep(mettab, lanes_arr, reps),
        "gil_release_progress_ratio": round(
            gil_release_ratio(mettab, noise), 3),
        "dispatch": dispatch_overhead(mettab, make_clean()),
    }
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
