"""Integrated many-channel streaming runtime: raw ingest -> spots.

The reference's live path is one continuously running chain — RX
callback -> decimate -> window -> decode -> report
(rtlsdr_wsprd.c:126-328) — for ONE channel. This module is its
many-channel analog, wiring the pieces end to end:

    RawBank (uint8, aligned chunks; runtime/banks.py)
      -> BatchedStreamingDecimator (one batched device program per
         front-end step; uint8 crosses the link, centered on device)
      -> per-channel 120 s window assembly + row-wise -3 dB norm
         (rtlsdr_wsprd.c:291-305)
      -> decode_channels_pipelined (2-deep: batch k+1's ingest and
         host work overlap batch k's device decode — the reference's
         RX/decode double buffer, rtlsdr_wsprd.c:75-91)
      -> per-channel spot reporting.

bench.py's ``e2e_realtime_channels_per_chip`` measures exactly this
chain; tests/test_multidaemon.py runs it on CPU from raw uint8 to
exact decoded messages.
"""

from __future__ import annotations

import queue
import threading
import time
import traceback
from dataclasses import dataclass, field, replace

import numpy as np

from ..config import SIGNAL_SAMPLES, DecoderOptions
from ..frontend.decimate import BatchedStreamingDecimator
from ..models.decoder import Spot
from ..parallel.multichannel import decode_channels_pipelined
from ..utils.hashtable import WsprHashTable
from .banks import RawBank
from .reporting import WsprnetReporter, print_spots


@dataclass
class MultiStats:
    """Observability counters (SURVEY.md section 5 'metrics')."""

    window_batches: int = 0
    channel_windows: int = 0
    spots: int = 0
    errors: int = 0
    dropped_reports: int = 0   # reports discarded by the reporter(s)
    fec: str = ""              # FEC strategy description in effect
    ingest_seconds: float = 0.0
    started: float = field(default_factory=time.time)


def normalize_rows_minus3db(wi: np.ndarray, wq: np.ndarray):
    """Row-wise peak normalization to +-0.5 (rtlsdr_wsprd.c:291-305,
    applied per channel)."""
    mx = np.maximum(np.abs(wi).max(axis=1), np.abs(wq).max(axis=1))
    scale = (0.5 / np.maximum(mx, 1e-24)).astype(np.float32)
    return wi * scale[:, None], wq * scale[:, None]


class MultiChannelDaemon:
    """Drives a RawBank through the full batched chain to spots.

    One instance owns the batched decimator state, the per-channel
    window rings, the shared hashtable, and the decode pipeline. Not
    wall-clock aligned: windows are consumed back to back as the bank
    delivers samples (backpressure mode; a live RtlTcpBank's RX threads
    provide the wall-clock pacing, and window boundaries then land
    wherever the stream starts — acceptable because WSPR decode is
    time-searched within the window, scheduler.py handles strict
    2-minute alignment for the single-channel daemon).
    """

    def __init__(self, bank: RawBank,
                 options: DecoderOptions = DecoderOptions(),
                 reporter: WsprnetReporter | None = None,
                 hashtable_path: str = "hashtable.txt",
                 quiet: bool = True, chunk_s: float = 4.0,
                 depth: int = 2, device_batch: int = 64,
                 fec: str = "auto",
                 dialfreqs: list[int] | None = None,
                 reporters: list[WsprnetReporter | None] | None = None,
                 align: bool = False, frontend: str = "auto",
                 channelize: list[int] | None = None,
                 devices="default", strict_hash_order: bool = False,
                 write_prefix: str | None = None):
        """``dialfreqs``: per-channel dial frequency in Hz for a
        multi-band bank — spot frequencies are decoded against
        ``options.freq`` and re-based per channel before print/post
        (the reference binds one dial per process; here one per
        channel). ``reporters``: per-channel reporter list (each with
        its own dialfreq for heartbeats); overrides ``reporter``.
        ``align``: sleep to the next even-2-minute wall-clock boundary
        and drop pre-boundary samples before the first window (live
        banks; the reference's capture-at-boundary,
        rtlsdr_wsprd.c:1145-1160). ``frontend``: where the 6400:1
        decimator runs — ``"device"`` (raw uint8 to the chip;
        frontend/decimate.py), ``"host"`` (native C++ polyphase, only
        375 sps baseband crosses the link — 1600x fewer bytes;
        frontend/host_decimate.py), or ``"auto"`` (= device).
        ``channelize``: wideband mode — the bank
        is ONE raw stream (n_channels == 1, tuned to ``options.freq``)
        and each listed dial frequency becomes an output channel via
        per-dial derotation ahead of the shared polyphase chain
        (frontend/channelize.py); ``dialfreqs`` defaults to the list.
        The reference binds one dongle to one band
        (rtlsdr_wsprd.c:1044-1124) — this decodes every WSPR dial
        inside the capture's +-1.2 MHz from one dongle.
        ``devices``: ``"default"`` decodes on the default device;
        ``"all"`` shards each window batch's channels across every
        local chip (decode_channels_pipelined_multidevice — the
        one-host-many-chips production layout); or pass an explicit
        device list.
        ``strict_hash_order``: compatibility mode — serialize window
        batches when ``options.usehashtable``. Type-3 ``<hash>`` spots
        already resolve race-free by default (yield-time
        re-resolution, multichannel.resolve_type3_spots); serializing
        additionally matches the reference's decode-time side effects
        (dedupe key / subtraction of a then-unresolved type-3) at the
        cost of the pipeline overlap.
        ``write_prefix``: save every channel's normalized window as
        ``{prefix}_ch{NN}_{timestamp}.iq`` (the reference's ``-w``
        capture saving, rtlsdr_wsprd.c:477-496, per channel)."""
        self.bank = bank
        self.devices = devices
        self.strict_hash_order = strict_hash_order
        self.write_prefix = write_prefix
        self.options = options
        self.reporter = reporter
        self.dialfreqs = dialfreqs
        self.reporters = reporters
        self.align = align
        self.quiet = quiet
        self.chunk = int(round(chunk_s * 2_400_000))
        self.depth = depth
        self.device_batch = device_batch
        self.fec = fec
        self.stats = MultiStats()
        self.hashtable_path = hashtable_path
        if options.usehashtable:
            self.hashtable = WsprHashTable.load(hashtable_path)
        else:
            self.hashtable = WsprHashTable()
        if channelize is not None:
            if bank.n_channels != 1:
                raise ValueError("channelize requires a single-stream "
                                 f"bank (got {bank.n_channels} channels)")
            self.n_out_channels = len(channelize)
            if self.dialfreqs is None:
                self.dialfreqs = list(channelize)
        else:
            self.n_out_channels = bank.n_channels
        self._dec = self._make_frontend(frontend, bank.n_channels,
                                        channelize)
        self._ts: list[float] = []  # completion time per pending batch

    def describe_fec(self) -> str:
        """Resolve and describe the FEC strategy this daemon will use
        (ops/calibrate.describe); recorded in stats, printed by the CLI
        startup banner so the calibrated choice is visible in
        production."""
        from ..ops import calibrate

        self.stats.fec = calibrate.describe(self.fec)
        return self.stats.fec

    def _make_frontend(self, frontend: str, n_channels: int,
                       channelize: list[int] | None):
        from ..frontend.host_decimate import (
            HostBatchedStreamingDecimator,
            resolve_placement,
        )

        frontend = resolve_placement(frontend)
        self.frontend_placement = frontend
        if channelize is not None:
            from ..frontend.channelize import ChannelizingStreamingDecimator

            offsets = [self.options.freq - d for d in channelize]
            return ChannelizingStreamingDecimator(offsets,
                                                  placement=frontend)
        if frontend == "host":
            return HostBatchedStreamingDecimator(n_channels)
        return BatchedStreamingDecimator(n_channels)

    def _save_windows(self, wi: np.ndarray, wq: np.ndarray,
                      ts: float) -> None:
        """Per-channel -w capture saving (rtlsdr_wsprd.c:477-496): one
        timestamped .iq file per channel, normalized windows (the
        reference saves post-normalization, rtlsdr_wsprd.c:291-323)."""
        from . import iqio

        gtm = time.gmtime(ts - 119)
        for ch in range(wi.shape[0]):
            fname = "%.8s_ch%02d_%04d-%02d-%02d_%02d-%02d-%02d.iq" % (
                self.write_prefix, ch, gtm.tm_year, gtm.tm_mon,
                gtm.tm_mday, gtm.tm_hour, gtm.tm_min, gtm.tm_sec)
            iqio.write_iq_file(wi[ch], wq[ch], fname)

    # -- ingest side --------------------------------------------------------

    def window_batches(self, max_windows: int = 0):
        """Generator of normalized (C, SIGNAL_SAMPLES) window batches.

        Pulls aligned raw chunks from the bank, advances the batched
        decimator, and yields every time a full 120 s window of
        baseband accumulates. A final partial window (>= 117 s, the
        reference's short-window threshold rtlsdr_wsprd.c:277) is
        zero-padded; shorter remnants are dropped.
        """
        if self.align:
            time.sleep(120.0 - (time.time() % 120.0))
            self.bank.discard_buffered()
        C = self.n_out_channels
        acc_i = np.zeros((C, 0), np.float32)
        acc_q = np.zeros((C, 0), np.float32)
        n = 0
        eof = False
        while not eof and (max_windows == 0 or n < max_windows):
            t0 = time.perf_counter()
            ri, rq = self.bank.read(self.chunk)
            if ri.shape[1] < self.chunk:
                eof = True
            oi, oq = self._dec.push(ri, rq)
            if eof:
                fi, fq = self._dec.flush()
                oi = np.concatenate([oi, fi], axis=1)
                oq = np.concatenate([oq, fq], axis=1)
            self.stats.ingest_seconds += time.perf_counter() - t0
            if oi.shape[1]:
                acc_i = np.concatenate([acc_i, oi], axis=1)
                acc_q = np.concatenate([acc_q, oq], axis=1)
            while acc_i.shape[1] >= SIGNAL_SAMPLES and (
                    max_windows == 0 or n < max_windows):
                wi = acc_i[:, :SIGNAL_SAMPLES]
                wq = acc_q[:, :SIGNAL_SAMPLES]
                acc_i = acc_i[:, SIGNAL_SAMPLES:]
                acc_q = acc_q[:, SIGNAL_SAMPLES:]
                ts = time.time()
                self._ts.append(ts)
                n += 1
                nwi, nwq = normalize_rows_minus3db(wi, wq)
                if self.write_prefix:
                    self._save_windows(nwi, nwq, ts)
                yield nwi, nwq
        if eof and acc_i.shape[1] >= 117 * 375 and (
                max_windows == 0 or n < max_windows):
            pad = SIGNAL_SAMPLES - acc_i.shape[1]
            wi = np.pad(acc_i, ((0, 0), (0, pad)))
            wq = np.pad(acc_q, ((0, 0), (0, pad)))
            ts = time.time()
            self._ts.append(ts)
            nwi, nwq = normalize_rows_minus3db(wi, wq)
            if self.write_prefix:
                self._save_windows(nwi, nwq, ts)
            yield nwi, nwq

    # -- the loop -----------------------------------------------------------

    def _threaded_batches(self, max_windows: int):
        """Run window_batches on a dedicated ingest thread (the
        reference's RX thread, rtlsdr_wsprd.c:255-259): bank reads,
        the fused decimate dispatch, and window assembly overlap the
        decode side's host work. A bounded queue (depth batches)
        provides the double-buffer backpressure."""
        q: queue.Queue = queue.Queue(maxsize=max(1, self.depth))
        _END = object()

        def produce():
            try:
                for batch in self.window_batches(max_windows):
                    q.put(batch)
                q.put(_END)
            except BaseException as exc:  # forwarded to the consumer
                q.put(exc)

        t = threading.Thread(target=produce, daemon=True,
                             name="wspr-ingest")
        t.start()
        while True:
            item = q.get()
            if item is _END:
                break
            if isinstance(item, BaseException):
                raise item
            yield item

    def run(self, max_windows: int = 0,
            ingest_thread: bool = True) -> list[list[list[Spot]]]:
        """Ingest + decode until the bank dries up (or ``max_windows``
        batches). Returns per-window-batch, per-channel spot lists.
        Per-window isolation: a batch whose decode fails yields no
        spots but never ends the stream (SURVEY.md section 5). An INGEST failure — the bank
        itself died — does end the run, gracefully (stats + hashtable
        are preserved). ``ingest_thread=False`` runs ingest inline
        (deterministic single-thread mode)."""
        out: list[list[list[Spot]]] = []
        gen = (self._threaded_batches(max_windows) if ingest_thread
               else self.window_batches(max_windows))

        def on_batch_error(exc):
            self.stats.errors += 1
            if not self.quiet:
                print("Batch decode failed (stream continues): "
                      f"{exc!r}")

        kw = dict(depth=self.depth, device_batch=self.device_batch,
                  fec=self.fec, on_error=on_batch_error,
                  strict_hash_order=self.strict_hash_order)
        if self.devices == "default":
            pipeline = decode_channels_pipelined(
                gen, self.options, self.hashtable, **kw)
        else:
            import jax

            from ..parallel.multichannel import (
                decode_channels_pipelined_multidevice,
            )

            devs = (jax.local_devices() if self.devices == "all"
                    else self.devices)
            pipeline = decode_channels_pipelined_multidevice(
                gen, self.options, self.hashtable, devices=devs, **kw)
        try:
            for per_channel in pipeline:
                ts = self._ts.pop(0)
                gtm = time.gmtime(ts - 119)  # rtlsdr_wsprd.c:310-313
                out.append(self._report(per_channel, gtm))
        except Exception:
            self.stats.errors += 1
            if not self.quiet:
                print("Ingest failed (stream ends): "
                      + traceback.format_exc())
        if self.options.usehashtable:
            self.hashtable.save(self.hashtable_path)
        return out

    def _rebase(self, spots: list[Spot], ch: int) -> list[Spot]:
        """Re-base spot frequencies from options.freq to channel ch's
        own dial frequency (multi-band banks)."""
        if self.dialfreqs is None:
            return spots
        delta = (self.dialfreqs[ch] - self.options.freq) / 1e6
        if delta == 0.0:
            return spots
        return [replace(s, freq=s.freq + delta) for s in spots]

    def _report(self, per_channel: list[list[Spot]],
                gtm) -> list[list[Spot]]:
        self.stats.window_batches += 1
        self.stats.channel_windows += len(per_channel)
        per_channel = [self._rebase(s, ch)
                       for ch, s in enumerate(per_channel)]
        nsp = sum(len(s) for s in per_channel)
        self.stats.spots += nsp
        if not self.quiet:
            for ch, spots in enumerate(per_channel):
                if spots:
                    print(f"-- channel {ch}")
                    print_spots(spots, gtm)
            print(f"-- {nsp} spot(s) across {len(per_channel)} channels")
        for ch, spots in enumerate(per_channel):
            rep = (self.reporters[ch] if self.reporters is not None
                   else self.reporter)
            if rep is None:
                continue
            live = [s for s in spots if not s.noprint]
            # an empty window still posts: post() sends the
            # function=wsprstat heartbeat wsprnet uses to track
            # receiver uptime (rtlsdr_wsprd.c:389-411 posts it for
            # every spotless window; the single-channel daemon already
            # does, scheduler.py)
            rep.post(live, gtm)
        self.stats.dropped_reports = sum(
            r.dropped for r in self._all_reporters())
        return per_channel

    def _all_reporters(self):
        reps = (self.reporters if self.reporters is not None
                else [self.reporter])
        uniq: dict[int, object] = {}
        for r in reps:
            if r is not None:
                uniq[id(r)] = r  # a shared reporter counts once
        return list(uniq.values())


__all__ = ["MultiChannelDaemon", "MultiStats", "normalize_rows_minus3db"]
