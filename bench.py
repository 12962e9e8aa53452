"""Headline benchmark: 2-minute WSPR decode windows per second per chip.

Runs the batched multi-channel decode step (device program: STFT ->
candidate pick -> coarse/fine sync -> jittered soft symbols -> batched
Fano) on realistic synthetic windows and reports steady-state
throughput, including the host spot-assembly path. The headline times
the production pipelined path over device-resident windows (chip-bound);
a transfer-inclusive run and the measured host->device link bandwidth
are reported alongside (see the comment at the steady-state loop).

Baseline: the reference's best published "decode burst" is 0.5 s per
window on an Intel i7-5820K (README.md:151) = 2.0 windows/s.
``vs_baseline`` is our windows/s divided by that.

Prints exactly one JSON line.
"""

from __future__ import annotations

import json
import time

import numpy as np

REF_WINDOWS_PER_S = 2.0  # i7-5820K, 0.5 s/window (reference README.md:151)

# Published dense peaks per device_kind (NVIDIA H100 data sheet, SXM
# part, at its full 700 W power limit; no sparsity). A device missing
# here is an error, never a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_tflops": 989.0, "tf32_tflops": 495.0, "f32_tflops": 67.0,
        "hbm_tbps": 3.35, "source": "NVIDIA H100 data sheet (SXM)"},
}


def device_peaks(device_kind: str) -> dict:
    """Published peaks of ``device_kind``; KeyError if not tabulated."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for device_kind "
                       f"{device_kind!r}; add it to bench.PEAKS") from None


def make_batch(B: int, seed: int = 11) -> np.ndarray:
    """B windows with mixed content: most have 2 signals at varied SNR,
    some are noise-only (a realistic band census)."""
    from rtlsdr_wsprd_tpu.runtime.iqio import normalize_minus3db
    from rtlsdr_wsprd_tpu.runtime.synth import synth_window_at_snr

    calls = ["K1JT FN20 37", "K9AN EN50 33", "G4ABC IO91 30",
             "VK2XYZ QF56 27"]
    wi = np.zeros((B, 45000), dtype=np.float32)
    wq = np.zeros((B, 45000), dtype=np.float32)
    for b in range(B):
        if b % 4 == 3:  # noise-only channel
            rng = np.random.default_rng(seed + b)
            z = rng.normal(0, 1.0, (45000, 2)).astype(np.float32)
            i, q = z[:, 0], z[:, 1]
        else:
            msgs = [calls[b % len(calls)], calls[(b + 1) % len(calls)]]
            i, q = synth_window_at_snr(
                msgs, snr_db=[3.0 - (b % 3) * 4.0, -8.0],
                f0=[-60.0 + 13.0 * (b % 9), 45.0 - 11.0 * (b % 7)],
                t0=[2.0, 1.0], seed=seed + b,
            )
        wi[b], wq[b] = normalize_minus3db(i, q)
    return wi, wq


def measure_e2e_device(wi, wq, options, DC: int = 64, DWIN: int = 3,
                       N_MID: int = 120_000):
    """End-to-end ingest->spots with DEVICE front-end placement: raw
    uint8 is generated ON DEVICE (so the host->device link is not what
    is measured), runs the
    fused stage-1+2 front end, assembles device-resident 120 s windows,
    and decodes them with the FULL schedule via prepare_windows_device
    — baseband never touches the host. Decode load stays realistic:
    the caller's mixed-content windows are uploaded once and mixed in
    at baseband (front-end DSP cost is content-independent; decode
    cost is not; the added 1/8-peak front-end noise shifts census
    SNRs < 1 dB).

    ``N_MID``: stage-1 frames per fused step (multiple of R2, and
    N_MID/R2 must divide 45000); fewer, bigger steps per window trade
    device memory for per-step overhead.

    Returns (realtime_channels_per_chip, seconds, steps_per_window).
    """
    import jax
    import jax.numpy as jnp

    from rtlsdr_wsprd_tpu.config import SIGNAL_SAMPLES
    from rtlsdr_wsprd_tpu.frontend.decimate import _fused_frontend_step
    from rtlsdr_wsprd_tpu.frontend.filters import (
        R1,
        R2,
        STAGE1_TAPS,
        STAGE2_TAPS,
    )
    from rtlsdr_wsprd_tpu.parallel.multichannel import (
        decode_channels_pipelined_multidevice,
        prepare_windows_device,
    )

    assert N_MID % R2 == 0 and SIGNAL_SAMPLES % (N_MID // R2) == 0, \
        "N_MID must be a multiple of 80 whose baseband step divides 45000"
    BB_STEP = N_MID // R2            # baseband samples per step
    STEPS = SIGNAL_SAMPLES // BB_STEP  # steps per 120 s window
    raw_len = N_MID * R1 + STAGE1_TAPS - R1
    tail2 = STAGE2_TAPS - R2
    cont_i = jnp.asarray(wi[:DC])
    cont_q = jnp.asarray(wq[:DC])

    @jax.jit
    def _fe_window(ri, rq, m2i, m2q):
        """One 120 s window of the device chain in ONE dispatch: a
        lax.scan over the STEPS fused front-end steps. Per-dispatch
        cost amortizes over the whole window. The
        raw block is pre-generated ONCE and replayed each step —
        front-end DSP cost is content-independent (the host e2e's
        _LoadBank applies the same policy), and generating hundreds of
        MB of fresh threefry per step would time the PRNG, not the
        ingest chain; decode load comes from the mixed-in content
        windows."""
        import jax.lax as lax

        def body(carry, _):
            ci_, cq_ = carry
            oi, oq, ni, nq = _fused_frontend_step(ri, rq, ci_, cq_, N_MID)
            return (ni, nq), (oi, oq)

        (m2i, m2q), (ois, oqs) = lax.scan(
            body, (m2i, m2q), None, length=STEPS)
        bb_i = jnp.moveaxis(ois, 0, 1).reshape(DC, -1)
        bb_q = jnp.moveaxis(oqs, 0, 1).reshape(DC, -1)
        return bb_i, bb_q, m2i, m2q

    @jax.jit
    def _assemble_win(bb_i, bb_q, ci, cq):
        # scale front-end noise to 1/8 peak, mix with content, then the
        # per-row -3 dB normalization (rtlsdr_wsprd.c:291-305) on device
        m = jnp.maximum(jnp.abs(bb_i).max(axis=1), jnp.abs(bb_q).max(axis=1))
        s = (0.125 / jnp.maximum(m, 1e-24))[:, None]
        zi = ci + bb_i * s
        zq = cq + bb_q * s
        mx = jnp.maximum(jnp.abs(zi).max(axis=1), jnp.abs(zq).max(axis=1))
        sc = (0.5 / jnp.maximum(mx, 1e-24))[:, None]
        return zi * sc, zq * sc

    devs = jax.local_devices()
    D = len(devs)

    def _dev_windows(n_windows, seed):
        ki, kq = jax.random.split(jax.random.PRNGKey(seed))
        ri = jax.random.randint(ki, (DC, raw_len), 0, 256, jnp.uint8)
        rq = jax.random.randint(kq, (DC, raw_len), 0, 256, jnp.uint8)
        m2i = jnp.zeros((DC, tail2), jnp.float32)
        m2q = jnp.zeros((DC, tail2), jnp.float32)
        for _ in range(n_windows):
            bb_i, bb_q, m2i, m2q = _fe_window(ri, rq, m2i, m2q)
            dwi, dwq = _assemble_win(bb_i[:, :SIGNAL_SAMPLES],
                                     bb_q[:, :SIGNAL_SAMPLES],
                                     cont_i, cont_q)
            if D == 1:
                yield prepare_windows_device(dwi, dwq, device_batch=DC)
                continue
            # multi-chip host: one device-resident shard handle per
            # chip (the front-end chain ran on the default device; the
            # shard split crosses the interconnect once), decoded
            # concurrently by the
            # multidevice pipeline
            bounds = [DC * k // D for k in range(D + 1)]
            yield [prepare_windows_device(
                jax.device_put(dwi[s0:s1], d),
                jax.device_put(dwq[s0:s1], d),
                device_batch=s1 - s0, device=d)
                for d, s0, s1 in zip(devs, bounds[:-1], bounds[1:])
                if s1 > s0]

    def _dev_e2e(n_windows, seed):
        t0 = time.perf_counter()
        for _ in decode_channels_pipelined_multidevice(
                _dev_windows(n_windows, seed), options,
                device_batch=DC, devices=devs):
            pass
        jax.effects_barrier()
        return time.perf_counter() - t0

    _dev_e2e(1, 0)  # warm every program in the device chain
    e2e_dev_dt = _dev_e2e(DWIN, 1)
    return DC * DWIN * 120.0 / e2e_dev_dt, e2e_dev_dt, STEPS, D


def main() -> None:
    # NB no config overrides here: what this bench measures IS the
    # shipped default (float32 correlator operands, ops/sync.py::_cdt).
    import os

    import jax

    from rtlsdr_wsprd_tpu import compile_cache
    from rtlsdr_wsprd_tpu.config import DecoderOptions
    from rtlsdr_wsprd_tpu.ops.calibrate import get_fec_calibration
    from rtlsdr_wsprd_tpu.parallel.multichannel import (
        decode_channels,
    )

    compile_cache.enable()
    # bench shapes; env overrides exist so the FULL flow can be
    # integration-checked on CPU at tiny sizes (tests/CI) without
    # touching the production configuration
    B = int(os.environ.get("RTLSDR_WSPRD_TPU_BENCH_B", 512))
    DB = int(os.environ.get("RTLSDR_WSPRD_TPU_BENCH_DB", 128))
    # B: windows per pipeline batch (two batches in flight); DB:
    # per-device-call sub-batch (coarse-grid intermediates fit device
    # memory at 128)
    wi, wq = make_batch(B)
    options = DecoderOptions()

    # warmup (compile) x2: second run warms the straggler thread pool
    spots = decode_channels(wi, wq, options, device_batch=DB)
    n_spots = sum(len(s) for s in spots)
    decode_channels(wi, wq, options, device_batch=DB)

    # steady state: the production 2-deep batch pipeline — batch k+1's
    # host work overlaps batch k's device stages (the analog of the
    # reference's RX/decode double buffer, rtlsdr_wsprd.c:75-91).
    # Headline = chip-bound throughput: the pipeline is fed
    # prepare_windows() handles whose uploads already landed (windows
    # are device-resident, as when the on-device front end produces
    # them). The transfer-inclusive number and the measured link
    # bandwidth are reported alongside so both limits stay
    # attributable.
    import jax.numpy as jnp

    from rtlsdr_wsprd_tpu.parallel.multichannel import (
        decode_channels_pipelined,
        prepare_windows,
    )

    # N_RUNS independent steady-state measurements -> median + spread
    # (one canonical number, variance quantified in the artifact)
    iters = 6
    n_runs = int(os.environ.get("RTLSDR_WSPRD_TPU_BENCH_RUNS", 5))
    runs_wps = []
    for _ in range(n_runs):
        # fresh handles per run: decode subtracts in place on device
        handles = [prepare_windows(wi, wq, device_batch=DB)
                   for _ in range(iters)]
        for h in handles:  # rendezvous: every upload landed first
            jax.block_until_ready(h.arrays)
        t0 = time.perf_counter()
        for _ in decode_channels_pipelined(iter(handles), options,
                                           device_batch=DB):
            pass
        jax.effects_barrier()
        runs_wps.append(B * iters / (time.perf_counter() - t0))
        del handles
    runs_wps.sort()
    windows_per_s = float(np.median(runs_wps))

    # transfer-inclusive: same pipeline fed host float arrays (quantize
    # + upload overlap decode 2-deep); link-bound when the link is
    # slower than ~90 KB x windows/s
    wt_iters = 3
    t0 = time.perf_counter()
    for _ in decode_channels_pipelined(
            ((wi, wq) for _ in range(wt_iters)), options, device_batch=DB):
        pass
    jax.effects_barrier()
    with_transfers_wps = B * wt_iters / (time.perf_counter() - t0)

    # secondary: streaming front-end throughput (stage 1 runs at the
    # full 2.4 Msps input rate and dominates; rtlsdr_wsprd.c "RX load").
    # Production shape: many channels ingest together — the batched
    # kernel multiplies work per scan step instead of step count.
    from rtlsdr_wsprd_tpu.frontend.decimate import decimate_stage1_batched
    from rtlsdr_wsprd_tpu.frontend.filters import R1, STAGE1_TAPS

    C = int(os.environ.get("RTLSDR_WSPRD_TPU_BENCH_C", 128))
    # C: channels per ingest call
    n_frames = 9_375    # 0.025 s of 30 ksps output per channel per call
    L = n_frames * R1 + STAGE1_TAPS - R1
    rng = np.random.default_rng(3)
    xI = jnp.asarray(rng.normal(0, 30, (C, L)).astype(np.float32))
    xQ = jnp.asarray(rng.normal(0, 30, (C, L)).astype(np.float32))
    jax.block_until_ready(decimate_stage1_batched(xI, xQ, n_frames))
    fe_iters = 32
    t0 = time.perf_counter()
    for _ in range(fe_iters):
        mI, mQ = decimate_stage1_batched(xI, xQ, n_frames)
    jax.block_until_ready((mI, mQ))
    fe_dt = time.perf_counter() - t0
    fe_msps = C * n_frames * R1 * fe_iters / fe_dt / 1e6

    # end-to-end: sustained raw uint8 ingest -> decimate -> window ->
    # decode -> spots through the integrated chain (MultiChannelDaemon,
    # the reference's full live path rtlsdr_wsprd.c:126-328). Raw bytes
    # cross the host->device link at 2 B/complex sample (uint8 planar,
    # centered on device); host_to_device_mbps is measured and reported
    # so a link-bound and a device-bound limit are distinguishable.
    from rtlsdr_wsprd_tpu.config import SIGNAL_SAMPLES
    from rtlsdr_wsprd_tpu.runtime.multidaemon import MultiChannelDaemon

    class _LoadBank:
        """Replays one pre-generated aligned raw block (ingest cost is
        content-independent; synthesis must not pollute the measure)."""

        def __init__(self, C, chunk, total):
            rng = np.random.default_rng(7)
            self._ri = rng.integers(0, 256, (C, chunk), dtype=np.uint8)
            self._rq = rng.integers(0, 256, (C, chunk), dtype=np.uint8)
            self._left = total
            self.n_channels = C

        def read(self, n):
            m = min(n, self._ri.shape[1], self._left)
            self._left -= m
            return self._ri[:, :m], self._rq[:, :m]

        def close(self):
            pass

    E2E_C = 4        # channels; per-channel cost is what matters
    E2E_WINDOWS = 1  # 120 s of stream per channel
    raw_per_window = SIGNAL_SAMPLES * 6400
    chunk = 4_800_000  # 2 s per aligned read

    e2e_frontend = {}

    def e2e_once():
        bank = _LoadBank(E2E_C, chunk, raw_per_window + 40_000)
        d = MultiChannelDaemon(bank, DecoderOptions(quickmode=True),
                               device_batch=E2E_C, chunk_s=2.0)
        e2e_frontend["placement"] = d.frontend_placement
        t0 = time.perf_counter()
        d.run(max_windows=E2E_WINDOWS)
        return time.perf_counter() - t0

    e2e_once()  # warm the decimator + decode programs
    e2e_dt = e2e_once()
    e2e_channels = E2E_C * E2E_WINDOWS * 120.0 / e2e_dt

    # host-placed front end (native C++ polyphase, --frontend host)
    host_fe_msps = 0.0
    from rtlsdr_wsprd_tpu import native as _native

    if _native.HAS_DECIMATE:
        from rtlsdr_wsprd_tpu.frontend.host_decimate import (
            HostBatchedStreamingDecimator,
        )

        hdec = HostBatchedStreamingDecimator(1, threads=1)
        rng = np.random.default_rng(13)
        hci = rng.integers(0, 256, (1, 2_400_000), dtype=np.uint8)
        hcq = rng.integers(0, 256, (1, 2_400_000), dtype=np.uint8)
        hdec.push(hci, hcq)  # warm + prime
        t0 = time.perf_counter()
        for _ in range(4):
            hdec.push(hci, hcq)
        host_fe_msps = 4 * 2.4 / (time.perf_counter() - t0)

    # host->device link bandwidth (uint8), to attribute the e2e limit,
    # measured on incompressible random bytes
    blk = np.random.default_rng(7).integers(
        0, 256, 32 << 20, dtype=np.uint8)
    jax.block_until_ready(jnp.asarray(blk))  # warm path
    t0 = time.perf_counter()
    jax.block_until_ready(jnp.asarray(blk))
    link_mbps = blk.nbytes / (time.perf_counter() - t0) / 1e6

    # end-to-end DEVICE placement; see measure_e2e_device. C=128
    # matches the decode path's production DB, so the per-window
    # host-side fixed cost (lane-compaction fetch, FEC round trips, spot
    # fetch) amortizes over as many channels as one decode call holds
    DC = int(os.environ.get("RTLSDR_WSPRD_TPU_BENCH_E2E_DEV_C", 128))
    DWIN = int(os.environ.get("RTLSDR_WSPRD_TPU_BENCH_E2E_DEV_W", 4))
    N_MID = int(os.environ.get("RTLSDR_WSPRD_TPU_BENCH_E2E_NMID",
                               120_000))
    e2e_dev_channels, _e2e_dev_dt, _steps, e2e_dev_D = measure_e2e_device(
        wi, wq, options, DC=DC, DWIN=DWIN, N_MID=N_MID)

    # candidate syncs/s (BASELINE.json metric): MEASURED — time the
    # stage-A program (which scores the full 512 rows x 32 lags x 9
    # drifts coarse grid per window) over device-resident windows
    from rtlsdr_wsprd_tpu.parallel.multichannel import _stage_a_packed

    sa_i = jnp.asarray(wi[:DB])
    sa_q = jnp.asarray(wq[:DB])
    sa_md = jnp.full((DB,), options.maxdrift, jnp.int32)

    def _stage_a():
        return _stage_a_packed(sa_i, sa_q, sa_md, fmin=options.fmin,
                               fmax=options.fmax)

    _stage_a().block_until_ready()  # warm
    sa_iters = 16
    t0 = time.perf_counter()
    for _ in range(sa_iters):
        r = _stage_a()
    r.block_until_ready()
    sa_dt = (time.perf_counter() - t0) / sa_iters
    syncs_per_s_measured = DB * 512 * 32 * 9 / sa_dt
    # measured FEC strategy constants for THIS backend
    fec_cal = get_fec_calibration().as_dict()

    print(json.dumps({
        "metric": "decode_windows_per_s_per_chip",
        "value": round(windows_per_s, 3),
        "unit": "windows/s",
        "vs_baseline": round(windows_per_s / REF_WINDOWS_PER_S, 3),
        # value = MEDIAN of n_runs independent steady-state runs; the
        # sorted runs quantify run-to-run variance in the artifact
        "runs_windows_per_s": [round(r, 1) for r in runs_wps],
        "batch": B,
        "spots_per_batch": n_spots,
        "candidate_syncs_per_s": int(syncs_per_s_measured),
        "realtime_channels_per_chip": int(windows_per_s * 120),
        "with_host_transfers_windows_per_s": round(with_transfers_wps, 3),
        "frontend_msps": round(fe_msps, 1),
        "frontend_realtime_channels": int(fe_msps / 2.4),
        "e2e_realtime_channels_per_chip": round(e2e_channels, 1),
        "e2e_frontend": e2e_frontend.get("placement", "device"),
        "e2e_realtime_channels_per_chip_device": round(e2e_dev_channels, 1),
        # the e2e device chain rides decode_channels_pipelined_
        # multidevice with per-shard device-resident handles, so on a
        # multi-chip host the same bench reports the one-host layout
        "e2e_device_config": f"C={DC} W={DWIN} D={e2e_dev_D} "
                             "full-schedule",
        # host scaling hook: the daemon shards channels across local
        # chips (devices='all', decode_channels_pipelined_multidevice;
        # per-chip decode is independent, so host = chips x per-chip)
        "local_devices": len(jax.local_devices()),
        "e2e_realtime_channels_per_host":
            round(e2e_dev_channels * len(jax.local_devices()), 1),
        "host_frontend_msps_per_core": round(host_fe_msps, 1),
        "host_to_device_mbps": round(link_mbps, 1),
        "fec_calibration": fec_cal,
        "device": str(jax.devices()[0].platform),
    }))


if __name__ == "__main__":
    main()
