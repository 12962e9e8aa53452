"""Backend FEC calibration (ops/calibrate.py): the FEC mode and device
budget are chosen by measurement of the attached backend."""

import numpy as np
import pytest

from rtlsdr_wsprd_tpu import native
from rtlsdr_wsprd_tpu.ops import calibrate
from rtlsdr_wsprd_tpu.ops.fano_hybrid import DEVICE_MAXCYCLES


@pytest.fixture(autouse=True)
def _fresh_cache():
    calibrate._CACHE.clear()
    yield
    calibrate._CACHE.clear()


@pytest.mark.skipif(not native.AVAILABLE, reason="no native lib")
def test_calibration_cpu_is_measured_and_consistent():
    """With no override the decision must come from measurement on
    every backend and must FOLLOW the measured economics
    — the mode is the box's to decide (a 1-core box measures 'host':
    the device path has no extra cores to win with; a wide host would
    measure 'hybrid'), the rule wiring is ours."""
    cal = calibrate.get_fec_calibration()
    assert cal.method == "measured"
    assert cal.device_cycle_ms > 0
    assert cal.native_timeout_ms > cal.native_clean_ms > 0
    expected = ("host" if 16 * cal.device_cycle_ms
                > 2.0 * cal.native_timeout_ms else "hybrid")
    assert cal.mode == expected
    assert cal.device_maxcycles in (16, 64, 256)
    # memoized: second call returns the identical object
    assert calibrate.get_fec_calibration() is cal


def test_calibration_env_override(monkeypatch):
    monkeypatch.setenv("RTLSDR_WSPRD_TPU_FEC", "host")
    monkeypatch.setenv("RTLSDR_WSPRD_TPU_FEC_BUDGET", "8")
    cal = calibrate.get_fec_calibration()
    assert (cal.mode, cal.device_maxcycles, cal.method) == ("host", 8, "env")


def test_calibration_malformed_env_budget_is_ignored(monkeypatch, caplog):
    """A typo'd RTLSDR_WSPRD_TPU_FEC_BUDGET must warn and fall back,
    not take the daemon down at first decode (ADVICE r4)."""
    monkeypatch.setenv("RTLSDR_WSPRD_TPU_FEC", "hybrid")
    monkeypatch.setenv("RTLSDR_WSPRD_TPU_FEC_BUDGET", "banana")
    import logging

    with caplog.at_level(logging.WARNING, "rtlsdr_wsprd_tpu.calibrate"):
        cal = calibrate.get_fec_calibration()
    assert cal.device_maxcycles == DEVICE_MAXCYCLES
    assert any("FEC_BUDGET" in r.message for r in caplog.records)


def test_describe_banner_forms(monkeypatch):
    """The startup banner surfaces the calibrated FEC decision:
    pinned, env and measured forms."""
    assert calibrate.describe("host") == "host (pinned by caller)"
    monkeypatch.setenv("RTLSDR_WSPRD_TPU_FEC", "hybrid")
    monkeypatch.setenv("RTLSDR_WSPRD_TPU_FEC_BUDGET", "64")
    s = calibrate.describe()
    assert s == "hybrid (method=env, device budget=64 cycles)"
    calibrate._CACHE.clear()
    monkeypatch.delenv("RTLSDR_WSPRD_TPU_FEC")
    monkeypatch.delenv("RTLSDR_WSPRD_TPU_FEC_BUDGET")
    if not native.AVAILABLE:
        return
    monkeypatch.setattr(calibrate, "measure_device_fano_cycle_ms",
                        lambda device=None, lanes=32: 0.12)
    monkeypatch.setattr(calibrate, "measure_native_fano_ms",
                        lambda: (0.03, 12.0))
    s = calibrate.describe()
    assert s == ("hybrid (method=measured, device budget=64 cycles; "
                 "device 0.12 ms/cycle, native clean 0.03 / timeout "
                 "12 ms)")


def test_multidaemon_records_fec_in_stats(monkeypatch):
    """describe_fec() resolves the strategy into MultiStats.fec."""
    import numpy as np

    from rtlsdr_wsprd_tpu.config import DecoderOptions
    from rtlsdr_wsprd_tpu.runtime.multidaemon import MultiChannelDaemon

    class _Bank:
        n_channels = 1

        def read(self, n):
            return (np.zeros((1, 0), np.uint8),) * 2

        def close(self):
            pass

    monkeypatch.setenv("RTLSDR_WSPRD_TPU_FEC", "host")
    d = MultiChannelDaemon(_Bank(), DecoderOptions(), fec="auto")
    s = d.describe_fec()
    assert s.startswith("host (method=env")
    assert d.stats.fec == s


def test_device_budget_never_exceeds_full(monkeypatch):
    monkeypatch.setenv("RTLSDR_WSPRD_TPU_FEC", "hybrid")
    monkeypatch.setenv("RTLSDR_WSPRD_TPU_FEC_BUDGET", "64")
    assert calibrate.device_fano_budget(10000) == 64
    assert calibrate.device_fano_budget(4) == 4


def test_decision_rule_host_when_device_cycles_dominate(monkeypatch):
    """A slow device decoder (~3 ms per maxcycle) must pick 'host'; a
    fast one must pick 'hybrid' with a larger budget."""
    if not native.AVAILABLE:
        pytest.skip("no native lib")
    monkeypatch.setattr(calibrate, "measure_device_fano_cycle_ms",
                        lambda device=None, lanes=32: 3.0)
    monkeypatch.setattr(calibrate, "measure_native_fano_ms",
                        lambda: (0.03, 12.0))
    cal = calibrate.get_fec_calibration()
    assert cal.mode == "host"  # 16 * 3.0 = 48 ms > 2 * 12 ms

    calibrate._CACHE.clear()
    monkeypatch.setattr(calibrate, "measure_device_fano_cycle_ms",
                        lambda device=None, lanes=32: 0.12)
    cal = calibrate.get_fec_calibration()
    assert cal.mode == "hybrid"  # 16 * 0.12 = 1.9 ms < 24 ms
    # 12 / 0.12 = 100 -> the 64 bucket
    assert cal.device_maxcycles == 64


def test_one_unroll_constant_for_decoder_and_calibration(monkeypatch):
    """batched_fano's default unroll and the calibration's recorded
    unroll are the same module constant, on every backend."""
    import inspect

    from rtlsdr_wsprd_tpu.ops import fano

    sig = inspect.signature(fano.batched_fano)
    assert sig.parameters["unroll"].default == fano.FANO_UNROLL
    assert calibrate.FANO_UNROLL is fano.FANO_UNROLL
    monkeypatch.setenv("RTLSDR_WSPRD_TPU_FEC", "host")
    assert calibrate.get_fec_calibration().unroll == fano.FANO_UNROLL


def test_measure_native_fano_orders_sanely():
    if not native.AVAILABLE:
        pytest.skip("no native lib")
    clean_ms, timeout_ms = calibrate.measure_native_fano_ms(maxcycles=500)
    assert 0 < clean_ms < timeout_ms


def test_measured_budget_formula_brackets():
    assert calibrate._bucket_budget(10) == 16
    assert calibrate._bucket_budget(100) == 64
    assert calibrate._bucket_budget(1000) == 256


def test_staged_decode_respects_env_budget(monkeypatch, rng):
    """The staged path's device Fano budget and its straggler detection
    must both use the calibrated value (consistency contract of
    device_fano_budget)."""
    monkeypatch.setenv("RTLSDR_WSPRD_TPU_FEC", "hybrid")
    monkeypatch.setenv("RTLSDR_WSPRD_TPU_FEC_BUDGET", "16")
    from rtlsdr_wsprd_tpu.config import DecoderOptions
    from rtlsdr_wsprd_tpu.parallel.multichannel import decode_channels
    from rtlsdr_wsprd_tpu.runtime.iqio import normalize_minus3db
    from rtlsdr_wsprd_tpu.runtime.synth import synth_window_at_snr

    i, q = synth_window_at_snr("K1JT FN20 37", snr_db=3.0, f0=-50.0,
                               seed=77)
    i, q = normalize_minus3db(i, q)
    wi = np.stack([i])
    wq = np.stack([q])
    spots = decode_channels(wi, wq, DecoderOptions(quickmode=True),
                            device_batch=1, fec="hybrid")
    assert [(s.call, s.loc, s.pwr) for s in spots[0]] == \
        [("K1JT", "FN20", "37")]
