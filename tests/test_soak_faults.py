"""Soak/fault integration: ONE continuous MultiChannelDaemon run over a
real rtl_tcp loopback connection survives, in order, (a) a server
restart (auto-reconnect), (b) a poisoned decode batch (per-window
isolation), and (c) a forced RX-ring overflow — the stream keeps
flowing, stats count every event, and the windows around the faults
still decode their exact messages. Ties together the individually
tested recovery features (sources.py reconnect, pipelined on_error,
bounded-ring overflow drop) the way a long-running deployment exercises
them; the reference instead exits on device loss
(rtlsdr_wsprd.c:247-251).

Stream layout (1 channel, 2.4 Msps uint8 over a scripted loopback
server, paced at ~3x realtime so the consumer never falls behind
before the deliberate faults):

    conn 1: [0, 122 s)   window 1 = message A            <- decodes
            -- server closes: RX auto-reconnects (1 redial) --
    conn 2: [122, 240 s) window 2 = noise                <- decode
                                                            POISONED
            [240, 360 s) window 3 = message C            <- decodes
            [360, 400 s) filler, sent UNPACED in one burst
                         >> ring capacity: forced overflow, dropped
                         bytes counted; no decodable content after
                         (by design: overflow loses stream, so
                         post-overflow alignment is unknowable)
"""

import socket
import struct
import threading
import time

import numpy as np
import pytest

from rtlsdr_wsprd_tpu.config import DecoderOptions
from rtlsdr_wsprd_tpu.runtime.banks import RtlTcpBank
from rtlsdr_wsprd_tpu.runtime.multidaemon import MultiChannelDaemon
from rtlsdr_wsprd_tpu.runtime.synth import synth_raw_2400k
from rtlsdr_wsprd_tpu.utils.channel import get_wspr_channel_symbols
from rtlsdr_wsprd_tpu.utils.hashtable import WsprHashTable

FS = 2_400_000
PACE = 3.0            # paced segments stream at PACE x realtime
RING = 96 << 20       # connection ring: ~20 s of headroom at 1x


def _interleave(ri: np.ndarray, rq: np.ndarray) -> bytes:
    out = np.empty(2 * ri.shape[0], np.uint8)
    out[0::2] = ri
    out[1::2] = rq
    return out.tobytes()


def _msg_chunks(msg, f0, duration_s, seed):
    sym = get_wspr_channel_symbols(msg, WsprHashTable())
    for ri, rq in synth_raw_2400k(sym, f0=f0, t0=2.0, amp_counts=25.0,
                                  noise_counts=3.0,
                                  duration_s=duration_s, seed=seed,
                                  chunk_s=2.0):
        yield _interleave(ri, rq)


def _noise_chunks(duration_s, seed):
    rng = np.random.default_rng(seed)
    left = int(duration_s * FS)
    while left > 0:
        n = min(2 * FS, left)
        left -= n
        yield rng.integers(118, 138, 2 * n, dtype=np.uint8).tobytes()


class _ScriptedServer:
    """Loopback rtl_tcp serving the fault-script stream over exactly two
    connections (the close between them IS fault (a)).

    ``burst_done`` is set once the unpaced overflow burst has fully
    left the server: the test gates the CONSUMER on it (simulating a
    decode-bound stall) so the RX thread must absorb the whole burst
    into its bounded ring — a deterministic overflow instead of a race
    against loopback TCP speed."""

    def __init__(self):
        self.burst_done = threading.Event()
        self._srv = socket.socket()
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(4)
        self.port = self._srv.getsockname()[1]
        self.error = None
        self.stage = "init"
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _handshake(self):
        conn, _ = self._srv.accept()
        conn.settimeout(120.0)
        conn.sendall(b"RTL0" + bytes(8))
        buf = b""
        while len(buf) < 20:  # rate + gain mode + gain + freq commands
            buf += conn.recv(4096)
        assert struct.unpack(">BI", buf[:5]) == (0x02, FS)
        return conn

    def _paced(self, conn, chunks):
        for b in chunks:
            conn.sendall(b)
            time.sleep(len(b) / 2 / FS / PACE)

    def _run(self):
        try:
            # ---- connection 1: window 1 (message A) + 2 s of noise ----
            self.stage = "conn1 handshake"
            conn = self._handshake()
            self.stage = "conn1 window1"
            self._paced(conn, _msg_chunks("K1JT FN20 37", 30.0, 120.0, 7))
            self._paced(conn, _noise_chunks(2.0, 8))
            conn.shutdown(socket.SHUT_WR)  # fault (a): server restart
            conn.close()

            # ---- connection 2: rest of the script ----
            self.stage = "conn2 handshake"
            conn = self._handshake()
            # no further connections: close the listener now so the
            # final post-EOF redial fails fast instead of racing accept
            self._srv.close()
            self.stage = "conn2 window2 noise"
            self._paced(conn, _noise_chunks(118.0, 9))     # rest of w2
            self.stage = "conn2 window3"
            self._paced(conn, _msg_chunks("W1AW FN31 30", -40.0, 120.0,
                                          10))             # window 3
            self.stage = "conn2 burst"
            # let the (faster-than-pace) consumer drain the ring so the
            # burst's overflow eats ONLY filler, never window-3 content
            time.sleep(4.0)
            for b in _noise_chunks(40.0, 11):  # fault (c): unpaced burst
                conn.sendall(b)
            time.sleep(1.0)  # let the RX thread absorb the tail
            self.burst_done.set()
            conn.shutdown(socket.SHUT_WR)
            try:
                while conn.recv(65536):
                    pass
            except OSError:
                pass
            conn.close()
        except Exception as exc:  # surfaced by the test body
            self.error = exc
        finally:
            self._srv.close()


@pytest.mark.slow
def test_daemon_survives_restart_poison_and_overflow(monkeypatch):
    import rtlsdr_wsprd_tpu.parallel.multichannel as mc

    srv = _ScriptedServer()
    bank = RtlTcpBank([("127.0.0.1", srv.port, 14_095_600, dict(
        reconnect=True, reconnect_backoff_s=0.1, max_reconnects=2,
        max_buffer_bytes=RING))])

    # fault (b): the SECOND window batch's decode dies; depth=1 makes
    # batch order == call
    # order deterministic
    real = mc.decode_channels
    calls = {"n": 0}

    def flaky(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("poisoned window batch")
        return real(*args, **kwargs)

    monkeypatch.setattr(mc, "decode_channels", flaky)

    # gate the consumer once every scripted window's content has been
    # read (360 s of stream): the filler burst then lands entirely while
    # reads are stalled, overflowing the bounded ring deterministically
    orig_read = bank.read
    state = {"pairs": 0}

    def gated_read(n):
        if state["pairs"] >= 360 * FS:
            srv.burst_done.wait(timeout=300.0)
        oi, oq = orig_read(n)
        state["pairs"] += oi.shape[1]
        return oi, oq

    bank.read = gated_read

    d = MultiChannelDaemon(bank, DecoderOptions(quickmode=True),
                           device_batch=1, chunk_s=2.0, depth=1)
    out = d.run()
    bank.close()
    assert srv.error is None, (srv.stage, srv.error, d.stats,
                               bank._conns[0].reconnects, len(out))

    # stream continued through all three faults: 3 full windows decoded
    # (the post-overflow filler never fills a 117 s window, by design)
    assert len(out) == 3
    # (a) exactly one reconnect rode out the server restart
    assert bank._conns[0].reconnects == 1
    # (b) the poisoned batch is counted and isolated
    assert d.stats.errors == 1
    assert out[1] == [[]]
    # (c) the burst overflowed the bounded ring and was counted
    assert bank.dropped_bytes[0] >= (8 << 20)
    # windows before/after each live fault decode their exact messages
    got1 = {(s.call, s.loc, s.pwr) for s in out[0][0]}
    got3 = {(s.call, s.loc, s.pwr) for s in out[2][0]}
    assert ("K1JT", "FN20", "37") in got1
    assert ("W1AW", "FN31", "30") in got3
