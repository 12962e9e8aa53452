"""Front-end decimator: spectral properties, batched/streaming equivalence,
streaming-state continuity, and raw-capture end-to-end decode."""

import numpy as np
import pytest

import jax.numpy as jnp

from rtlsdr_wsprd_tpu.frontend import (
    GROUP_DELAY_375,
    R1,
    STAGE1_TAPS,
    StreamingDecimator,
    decimate_stage1_xla,
    decimate_window,
)
from rtlsdr_wsprd_tpu.frontend.filters import (
    kaiser_lowpass,
    stage1_coeffs,
    stage2_coeffs,
)

FS = 2_400_000


def _tone(freq_hz, n, fs=FS, amp=1.0):
    t = np.arange(n, dtype=np.float64) / fs
    z = amp * np.exp(2j * np.pi * freq_hz * t)
    return z.real.astype(np.float32), z.imag.astype(np.float32)


def _stage1(freq_hz, n_frames=600):
    n = n_frames * R1 + STAGE1_TAPS - R1
    i, q = _tone(freq_hz, n)
    yi, yq = decimate_stage1_xla(jnp.asarray(i), jnp.asarray(q), n_frames)
    return np.asarray(yi) + 1j * np.asarray(yq)  # host-side complex is fine


def _stage1_gain(freq_hz, n_frames=600):
    """|gain| of stage 1 for a raw-input tone at freq_hz."""
    y = _stage1(freq_hz, n_frames)
    return float(np.mean(np.abs(y[100:-100])))


def test_stage1_passband_and_mixer():
    # wanted band sits at -fs/4: a tone at -600 kHz must pass at ~unit
    # gain and land at DC after the folded fs/4 mix
    g = _stage1_gain(-600_000.0)
    assert abs(g - 1.0) < 0.01

    # and it really is at DC (not just present): check phase rotation
    y = _stage1(-600_000.0 + 5.0)[100:500]  # 5 Hz above band center
    # instantaneous frequency ~ 5 Hz at 30 ksps
    dphi = np.angle(y[1:] * np.conj(y[:-1]))
    f_est = np.mean(dphi) * 30_000 / (2 * np.pi)
    assert abs(f_est - 5.0) < 0.5


def test_stage1_alias_rejection():
    # tones that would fold onto the final band: -600k + 30k, -600k + 60k
    for alias in (30_000.0, 60_000.0, 120_000.0):
        g = _stage1_gain(-600_000.0 + alias)
        assert g < 10 ** (-70 / 20.0), f"alias at +{alias} Hz leaks: {g}"


def test_stage2_stopband():
    # stage-2 prototype: <= -75 dB beyond 225 Hz at 30 ksps
    h = stage2_coeffs().astype(np.float64)
    f = np.fft.rfftfreq(1 << 18, d=1 / 30_000.0)
    H = np.abs(np.fft.rfft(h, 1 << 18))
    stop = H[f >= 225.0]
    assert np.max(stop) < 10 ** (-75 / 20.0)
    # passband flat within 0.1 dB to 110 Hz
    pb = H[f <= 110.0]
    assert np.max(np.abs(20 * np.log10(pb))) < 0.1


def test_kaiser_dc_gain():
    h = kaiser_lowpass(101, 1000.0, 48000.0)
    assert abs(np.sum(h) - 1.0) < 1e-12


def test_batched_stage1_matches_single_stream():
    """decimate_stage1_batched row c must equal decimate_stage1_xla on
    stream c exactly (same per-row program under vmap)."""
    import jax.numpy as jnp

    from rtlsdr_wsprd_tpu.frontend.decimate import (
        decimate_stage1_batched,
        decimate_stage1_xla,
    )
    from rtlsdr_wsprd_tpu.frontend.filters import R1, STAGE1_TAPS

    n_frames = 600
    L = n_frames * R1 + STAGE1_TAPS - R1
    rng = np.random.default_rng(8)
    xI = rng.normal(0, 30, (3, L)).astype(np.float32)
    xQ = rng.normal(0, 30, (3, L)).astype(np.float32)
    bI, bQ = decimate_stage1_batched(jnp.asarray(xI), jnp.asarray(xQ),
                                     n_frames)
    for c in range(3):
        sI, sQ = decimate_stage1_xla(jnp.asarray(xI[c]), jnp.asarray(xQ[c]),
                                     n_frames)
        np.testing.assert_array_equal(np.asarray(bI[c]), np.asarray(sI))
        np.testing.assert_array_equal(np.asarray(bQ[c]), np.asarray(sQ))


def test_batched_streaming_matches_per_channel():
    """BatchedStreamingDecimator row c must equal an independent
    StreamingDecimator fed channel c's chunks."""
    from rtlsdr_wsprd_tpu.frontend.decimate import (
        BatchedStreamingDecimator,
        StreamingDecimator,
    )

    C = 2
    rng = np.random.default_rng(9)
    chunks = [rng.integers(0, 256, (C, n)).astype(np.uint8)
              for n in (700_000, 500_000, 900_000)]
    chunksQ = [rng.integers(0, 256, c.shape).astype(np.uint8)
               for c in chunks]

    batched = BatchedStreamingDecimator(C)
    outs = [batched.push(ci, cq) for ci, cq in zip(chunks, chunksQ)]
    outs.append(batched.flush())
    bI = np.concatenate([o[0] for o in outs], axis=1)
    bQ = np.concatenate([o[1] for o in outs], axis=1)

    for c in range(C):
        single = StreamingDecimator()
        souts = [single.push(ci[c], cq[c])
                 for ci, cq in zip(chunks, chunksQ)]
        souts.append(single.flush())
        sI = np.concatenate([o[0] for o in souts])
        sQ = np.concatenate([o[1] for o in souts])
        np.testing.assert_array_equal(bI[c], sI)
        np.testing.assert_array_equal(bQ[c], sQ)


def test_streaming_matches_oneshot():
    """Chunked push through StreamingDecimator == one-shot decimate."""
    rng = np.random.default_rng(9)
    n_raw = 6400 * 400  # 400 output samples
    i = rng.normal(0, 20, n_raw).astype(np.float32)
    q = rng.normal(0, 20, n_raw).astype(np.float32)

    oi, oq = decimate_window(i, q)

    sd = StreamingDecimator()
    outs_i, outs_q = [], []
    pos = 0
    for chunk in (100_000, 777_777, 1_000_000, n_raw):  # ragged chunks
        end = min(pos + chunk, n_raw)
        pi, pq = sd.push(i[pos:end], q[pos:end])
        outs_i.append(pi)
        outs_q.append(pq)
        pos = end
        if pos >= n_raw:
            break
    fi, fq = sd.flush()
    outs_i.append(fi)
    outs_q.append(fq)
    si = np.concatenate(outs_i)
    sq = np.concatenate(outs_q)

    n = min(oi.shape[0], si.shape[0])
    np.testing.assert_allclose(si[:n], oi[:n], rtol=0, atol=2e-4)
    np.testing.assert_allclose(sq[:n], oq[:n], rtol=0, atol=2e-4)


@pytest.mark.slow
def test_raw_capture_end_to_end_decode():
    """Full chain: synthetic 2.4 Msps uint8 capture -> two-stage
    decimation -> batched decode -> exact message recovery.

    The reference's equivalent is its live RX path
    (rtlsdr_wsprd.c:126-328); this is the hardware-free version."""
    from rtlsdr_wsprd_tpu.config import SIGNAL_SAMPLES, DecoderOptions
    from rtlsdr_wsprd_tpu.models.decoder import decode_window
    from rtlsdr_wsprd_tpu.runtime.iqio import normalize_minus3db
    from rtlsdr_wsprd_tpu.runtime.synth import synth_raw_2400k
    from rtlsdr_wsprd_tpu.utils.channel import get_wspr_channel_symbols
    from rtlsdr_wsprd_tpu.utils.hashtable import WsprHashTable

    symbols = get_wspr_channel_symbols("K1JT FN20 20", WsprHashTable())
    sd = StreamingDecimator()
    outs_i, outs_q = [], []
    for rawI, rawQ in synth_raw_2400k(symbols, f0=30.0, t0=2.0,
                                      amp_counts=25.0, noise_counts=2.0,
                                      duration_s=120.0, seed=3):
        pi, pq = sd.push(rawI, rawQ)
        outs_i.append(pi)
        outs_q.append(pq)
    fi, fq = sd.flush()
    outs_i.append(fi)
    outs_q.append(fq)
    bi = np.concatenate(outs_i)
    bq = np.concatenate(outs_q)
    assert bi.shape[0] >= SIGNAL_SAMPLES - int(GROUP_DELAY_375) - 1

    wi = np.zeros(SIGNAL_SAMPLES, np.float32)
    wq = np.zeros(SIGNAL_SAMPLES, np.float32)
    wi[: bi.shape[0]] = bi[:SIGNAL_SAMPLES]
    wq[: bq.shape[0]] = bq[:SIGNAL_SAMPLES]
    i, q = normalize_minus3db(wi, wq)

    spots = decode_window(i, q, DecoderOptions())
    assert len(spots) == 1
    s = spots[0]
    assert (s.call, s.loc, s.pwr) == ("K1JT", "FN20", "20")
    assert abs(s.dt - 0.0) < 0.3  # t0=2.0 is the decoder's zero point
    assert abs((s.freq * 1e6 - 1500.0) - 30.0) < 0.5


def test_partial_product_matches_direct_convolution():
    """The partial-product matmul formulation == the mathematical
    definition y[m] = sum_k g[k] x[m*R + k] computed brute-force in
    float64 numpy, both stages (pins the rows@H + shifted-diagonal-sum
    algebra of frontend/decimate._polyphase_pp)."""
    from rtlsdr_wsprd_tpu.frontend.decimate import (
        decimate_stage1_xla,
        decimate_stage2_xla,
    )
    from rtlsdr_wsprd_tpu.frontend.filters import (
        R1,
        R2,
        STAGE1_TAPS,
        STAGE2_TAPS,
        conv_order,
        stage1_coeffs,
        stage2_coeffs,
    )

    rng = np.random.default_rng(99)

    def direct(xI, xQ, g, R, n_frames):
        x = xI.astype(np.float64) + 1j * xQ.astype(np.float64)
        y = np.array([np.dot(g, x[m * R:m * R + g.shape[0]])
                      for m in range(n_frames)])
        return y.real, y.imag

    for fn, g, R, T, nf in (
        (decimate_stage1_xla, conv_order(stage1_coeffs()), R1,
         STAGE1_TAPS, 50),
        (decimate_stage2_xla,
         conv_order(stage2_coeffs().astype(np.complex128)), R2,
         STAGE2_TAPS, 20),
    ):
        L = nf * R + T - R
        xI = rng.normal(0, 30, L).astype(np.float32)
        xQ = rng.normal(0, 30, L).astype(np.float32)
        gi, gq = fn(xI, xQ, nf)
        ei, eq = direct(xI, xQ, g.astype(np.complex128), R, nf)
        scale = np.abs(ei).max() + np.abs(eq).max()
        np.testing.assert_allclose(np.asarray(gi), ei,
                                   atol=1e-5 * scale, rtol=0)
        np.testing.assert_allclose(np.asarray(gq), eq,
                                   atol=1e-5 * scale, rtol=0)


def test_stage1_uint8_input_matches_host_centered():
    """Raw uint8 fed straight to the device kernel must equal the
    host-centered float32 path exactly (the centering is the same
    subtract-128, just on device — 1 byte/sample across the link)."""
    import jax.numpy as jnp

    from rtlsdr_wsprd_tpu.frontend.decimate import decimate_stage1_xla
    from rtlsdr_wsprd_tpu.frontend.filters import R1, STAGE1_TAPS

    n_frames = 400
    L = n_frames * R1 + STAGE1_TAPS - R1
    rng = np.random.default_rng(17)
    u8I = rng.integers(0, 256, (2, L), dtype=np.uint8)
    u8Q = rng.integers(0, 256, (2, L), dtype=np.uint8)
    uI, uQ = decimate_stage1_xla(jnp.asarray(u8I), jnp.asarray(u8Q),
                                 n_frames)
    fI, fQ = decimate_stage1_xla(
        jnp.asarray(u8I.astype(np.float32) - 128.0),
        jnp.asarray(u8Q.astype(np.float32) - 128.0), n_frames)
    np.testing.assert_array_equal(np.asarray(uI), np.asarray(fI))
    np.testing.assert_array_equal(np.asarray(uQ), np.asarray(fQ))


def test_batched_streaming_uint8_chunks_match_float32():
    """BatchedStreamingDecimator fed raw uint8 chunks must produce the
    same baseband as the float32-centered feed (u8 carry buffer + device
    centering vs host centering)."""
    from rtlsdr_wsprd_tpu.frontend.decimate import BatchedStreamingDecimator

    C, n_chunks, chunk = 2, 5, 480_000
    rng = np.random.default_rng(23)
    rawI = rng.integers(0, 256, (C, n_chunks * chunk), dtype=np.uint8)
    rawQ = rng.integers(0, 256, (C, n_chunks * chunk), dtype=np.uint8)

    du = BatchedStreamingDecimator(C)
    df = BatchedStreamingDecimator(C)
    outs_u, outs_f = [], []
    for k in range(n_chunks):
        sl = slice(k * chunk, (k + 1) * chunk)
        outs_u.append(du.push(rawI[:, sl], rawQ[:, sl]))
        outs_f.append(df.push(rawI[:, sl].astype(np.float32) - 128.0,
                              rawQ[:, sl].astype(np.float32) - 128.0))
    outs_u.append(du.flush())
    outs_f.append(df.flush())
    ui = np.concatenate([o[0] for o in outs_u], axis=1)
    fi = np.concatenate([o[0] for o in outs_f], axis=1)
    uq = np.concatenate([o[1] for o in outs_u], axis=1)
    fq = np.concatenate([o[1] for o in outs_f], axis=1)
    np.testing.assert_array_equal(ui, fi)
    np.testing.assert_array_equal(uq, fq)


def test_host_pp_kernel_matches_xla_stage1():
    """Native C++ polyphase (host placement) == device stage-1 kernel
    on the same raw bytes, uint8 and float32 (tolerance: float
    accumulation order differs across the 640-tap sums)."""
    from rtlsdr_wsprd_tpu import native
    from rtlsdr_wsprd_tpu.frontend.decimate import decimate_stage1_xla
    from rtlsdr_wsprd_tpu.frontend.host_decimate import _host_taps

    if not native.HAS_DECIMATE:
        pytest.skip("native hostdsp polyphase unavailable")
    g1r, g1i, g2 = _host_taps()
    rng = np.random.default_rng(17)
    n_frames = 400
    L = n_frames * R1 + STAGE1_TAPS - R1
    u8I = rng.integers(0, 256, L).astype(np.uint8)
    u8Q = rng.integers(0, 256, L).astype(np.uint8)

    hI, hQ = native.pp_decimate(u8I, u8Q, g1r, g1i, R1, n_frames)
    dI, dQ = decimate_stage1_xla(jnp.asarray(u8I), jnp.asarray(u8Q),
                                 n_frames)
    scale = np.abs(np.asarray(dI)).max()
    np.testing.assert_allclose(hI, np.asarray(dI), atol=2e-4 * scale)
    np.testing.assert_allclose(hQ, np.asarray(dQ), atol=2e-4 * scale)

    fI = u8I.astype(np.float32) - 128.0
    fQ = u8Q.astype(np.float32) - 128.0
    hI2, hQ2 = native.pp_decimate(fI, fQ, g1r, g1i, R1, n_frames)
    np.testing.assert_allclose(hI2, hI, atol=1e-4 * scale)
    np.testing.assert_allclose(hQ2, hQ, atol=1e-4 * scale)


def test_host_batched_streaming_matches_device():
    """HostBatchedStreamingDecimator (native C++ placement) produces
    the same 375 sps stream as the device BatchedStreamingDecimator:
    same priming, carries and alignment, chunked uint8 pushes + flush."""
    from rtlsdr_wsprd_tpu import native
    from rtlsdr_wsprd_tpu.frontend.decimate import (
        BatchedStreamingDecimator,
    )
    from rtlsdr_wsprd_tpu.frontend.host_decimate import (
        HostBatchedStreamingDecimator,
    )

    if not native.HAS_DECIMATE:
        pytest.skip("native hostdsp polyphase unavailable")
    C = 2
    rng = np.random.default_rng(23)
    chunks = [rng.integers(0, 256, (C, n)).astype(np.uint8)
              for n in (300_000, 170_001, 250_000)]
    chunksQ = [rng.integers(0, 256, c.shape).astype(np.uint8)
               for c in chunks]

    host = HostBatchedStreamingDecimator(C)
    houts = [host.push(ci, cq) for ci, cq in zip(chunks, chunksQ)]
    houts.append(host.flush())
    hI = np.concatenate([o[0] for o in houts], axis=1)
    hQ = np.concatenate([o[1] for o in houts], axis=1)

    dev = BatchedStreamingDecimator(C)
    douts = [dev.push(ci, cq) for ci, cq in zip(chunks, chunksQ)]
    douts.append(dev.flush())
    dI = np.concatenate([o[0] for o in douts], axis=1)
    dQ = np.concatenate([o[1] for o in douts], axis=1)

    assert hI.shape == dI.shape
    scale = np.abs(dI).max()
    np.testing.assert_allclose(hI, dI, atol=2e-4 * scale)
    np.testing.assert_allclose(hQ, dQ, atol=2e-4 * scale)


def test_channelizer_zero_offset_is_passthrough():
    """A zero-offset channelizer channel is EXACTLY the plain batched
    decimator: derotation by the carried unit phasor must not perturb
    the tuned dial's own path."""
    from rtlsdr_wsprd_tpu.frontend.channelize import (
        ChannelizingStreamingDecimator,
    )
    from rtlsdr_wsprd_tpu.frontend.decimate import (
        BatchedStreamingDecimator,
    )

    rng = np.random.default_rng(31)
    chunks = [rng.integers(0, 256, (1, n)).astype(np.uint8)
              for n in (900_000, 700_123)]
    chunksQ = [rng.integers(0, 256, c.shape).astype(np.uint8)
               for c in chunks]

    cz = ChannelizingStreamingDecimator([0.0], placement="device")
    outs = [cz.push(ci, cq) for ci, cq in zip(chunks, chunksQ)]
    outs.append(cz.flush())
    cI = np.concatenate([o[0] for o in outs], axis=1)
    cQ = np.concatenate([o[1] for o in outs], axis=1)

    plain = BatchedStreamingDecimator(1)
    pouts = [plain.push(ci, cq) for ci, cq in zip(chunks, chunksQ)]
    pouts.append(plain.flush())
    pI = np.concatenate([o[0] for o in pouts], axis=1)
    pQ = np.concatenate([o[1] for o in pouts], axis=1)

    assert cI.shape == pI.shape
    scale = np.abs(pI).max()
    np.testing.assert_allclose(cI, pI, atol=1e-5 * scale)
    np.testing.assert_allclose(cQ, pQ, atol=1e-5 * scale)


def test_channelizer_host_matches_device():
    """Host-placed channelizer (native C++ polyphase, folded taps) ==
    device-placed (fused XLA step), K=2 dials 50 kHz apart, including
    carry/flush behavior and the phase-origin convention."""
    from rtlsdr_wsprd_tpu import native
    from rtlsdr_wsprd_tpu.frontend.channelize import (
        ChannelizingStreamingDecimator,
    )

    if not native.HAS_DECIMATE:
        pytest.skip("native hostdsp polyphase unavailable")
    rng = np.random.default_rng(37)
    # sizes mix large odd-boundary chunks with tiny ones that produce
    # zero stage-1 frames (carry-append branch) or only carry-straddling
    # frames, pinning the in-place chunk-read stitch logic
    chunks = [rng.integers(0, 256, (1, n)).astype(np.uint8)
              for n in (900_000, 137, 700_123, 63, 800_000)]
    chunksQ = [rng.integers(0, 256, c.shape).astype(np.uint8)
               for c in chunks]

    offs = [0.0, 50_000.0]
    cd = ChannelizingStreamingDecimator(offs, placement="device")
    ch = ChannelizingStreamingDecimator(offs, placement="host")
    do = [cd.push(ci, cq) for ci, cq in zip(chunks, chunksQ)]
    do.append(cd.flush())
    ho = [ch.push(ci, cq) for ci, cq in zip(chunks, chunksQ)]
    ho.append(ch.flush())
    dI = np.concatenate([o[0] for o in do], axis=1)
    dQ = np.concatenate([o[1] for o in do], axis=1)
    hI = np.concatenate([o[0] for o in ho], axis=1)
    hQ = np.concatenate([o[1] for o in ho], axis=1)

    assert dI.shape == hI.shape == (2, dI.shape[1])
    scale = np.abs(dI).max()
    np.testing.assert_allclose(hI, dI, atol=2e-4 * scale)
    np.testing.assert_allclose(hQ, dQ, atol=2e-4 * scale)


@pytest.mark.parametrize("arg,want", [("auto", "device"),
                                      ("device", "device"),
                                      ("host", "host")])
def test_resolve_placement(arg, want):
    """'auto' places the front end on the device on every backend."""
    from rtlsdr_wsprd_tpu.frontend.host_decimate import resolve_placement

    assert resolve_placement(arg) == want


def test_resolve_placement_rejects_unknown():
    from rtlsdr_wsprd_tpu.frontend.host_decimate import resolve_placement

    with pytest.raises(ValueError):
        resolve_placement("tunnel")

