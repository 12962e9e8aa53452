"""The daemon: 2-minute window scheduling, decode dispatch, reporting.

Reference: main loop (rtlsdr_wsprd.c:1145-1185) sleeps to wall-clock
t mod 120 == 0, swaps the double buffer and signals the decoder thread
(:263-328), which skips short first windows (<117 s), zero-pads,
normalizes to -3 dB and timestamps the window at now - 119 s.

Here the equivalent is a single-threaded host loop (JAX dispatch is
already async; the decode "thread" is the device): pull samples from the
Source between boundaries, hand each completed window to the decoder,
then print/save/post. Per-window isolation: one bad window logs and
never kills the stream (divergence from the C, which has no such
guard; SURVEY.md section 5).
"""

from __future__ import annotations

import time
import traceback
from dataclasses import dataclass, field

import numpy as np

from ..config import SIGNAL_SAMPLE_RATE, SIGNAL_SAMPLES, DecoderOptions
from ..models.decoder import Spot, WsprDecoder
from . import iqio
from .reporting import WsprnetReporter, print_spots
from .sources import Source

MIN_FIRST_WINDOW = 117 * SIGNAL_SAMPLE_RATE  # rtlsdr_wsprd.c:277


@dataclass
class WindowResult:
    spots: list[Spot]
    gtm: time.struct_time
    n_samples: int
    error: str | None = None


@dataclass
class DaemonStats:
    """Observability counters (SURVEY.md section 5 'metrics')."""

    windows: int = 0
    spots: int = 0
    errors: int = 0
    decode_seconds: float = 0.0
    started: float = field(default_factory=time.time)


class WsprDaemon:
    """Drives source -> decoder -> reporter for consecutive windows."""

    def __init__(
        self,
        source: Source,
        options: DecoderOptions,
        reporter: WsprnetReporter | None = None,
        write_prefix: str | None = None,
        hashtable_path: str = "hashtable.txt",
        quiet: bool = False,
    ):
        self.source = source
        self.options = options
        self.decoder = WsprDecoder(options, hashtable_path)
        self.reporter = reporter
        self.write_prefix = write_prefix
        self.quiet = quiet
        self.stats = DaemonStats()

    # -- one window ---------------------------------------------------------

    def process_window(self, i: np.ndarray, q: np.ndarray,
                       timestamp: float | None = None) -> WindowResult:
        """Decode + report one already-captured window."""
        ts = time.time() if timestamp is None else timestamp
        # timestamp at window start (the C backdates by 120 s - 1,
        # rtlsdr_wsprd.c:310-313)
        gtm = time.gmtime(ts - 119)
        i, q = iqio.normalize_minus3db(i, q)  # rtlsdr_wsprd.c:291-305

        t0 = time.perf_counter()
        try:
            spots = self.decoder.decode(i, q)
            err = None
        except Exception:  # per-window isolation
            spots = []
            err = traceback.format_exc()
            self.stats.errors += 1
        self.stats.decode_seconds += time.perf_counter() - t0
        self.stats.windows += 1
        self.stats.spots += len(spots)

        if self.write_prefix:
            fname = "%.8s_%04d-%02d-%02d_%02d-%02d-%02d.iq" % (
                self.write_prefix, gtm.tm_year, gtm.tm_mon, gtm.tm_mday,
                gtm.tm_hour, gtm.tm_min, gtm.tm_sec)  # rtlsdr_wsprd.c:485-494
            iqio.write_iq_file(i, q, fname)

        if not self.quiet:
            if err:
                print(f"Window decode failed (stream continues): {err}")
            print_spots(spots, gtm)
        if self.reporter is not None and err is None:
            self.reporter.post([s for s in spots if not s.noprint], gtm)
        return WindowResult(spots=spots, gtm=gtm, n_samples=i.shape[0],
                            error=err)

    # -- the loop -----------------------------------------------------------

    def run(self, maxloop: int = 0, align: bool = True,
            _sleep=time.sleep, _now=time.time) -> list[WindowResult]:
        """Main loop (rtlsdr_wsprd.c:1145-1185). ``maxloop`` mirrors -n
        (0 = run until the source dries up / forever). ``align=False``
        is backpressure mode for file/synthetic replay: windows are
        consumed as fast as they decode (SURVEY.md component 9)."""
        results: list[WindowResult] = []
        nloop = 0
        first = True
        while maxloop == 0 or nloop < maxloop:
            if align:
                now = _now()
                wait = 120.0 - (now % 120.0)
                _sleep(wait)
                if first:
                    # capture starts AT the first boundary: samples the
                    # RX thread buffered between connect and the
                    # boundary never enter a window
                    # (rtlsdr_wsprd.c:1145-1160). Later windows read
                    # back-to-back from the ring, so they stay
                    # boundary-anchored while decode overlaps capture
                    # (the reference's double buffer).
                    self.source.discard_buffered()
            wi, wq = self.source.read(SIGNAL_SAMPLES)
            if wi.shape[0] == 0:
                break
            if first and wi.shape[0] < MIN_FIRST_WINDOW:
                first = False
                continue  # partial first window (rtlsdr_wsprd.c:277-279)
            first = False
            if wi.shape[0] < SIGNAL_SAMPLES:
                pad = np.zeros(SIGNAL_SAMPLES - wi.shape[0], np.float32)
                wi = np.concatenate([wi, pad])
                wq = np.concatenate([wq, pad])
                # zero-pad tail (rtlsdr_wsprd.c:285-288)
            results.append(self.process_window(wi, wq, timestamp=_now()))
            nloop += 1
        return results
