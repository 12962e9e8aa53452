"""Roofline accounting for the staged decode path (run on the GPU).

For each device phase of the production staged pipeline (stage A =
STFT + candidates + coarse grid; stage B = fine sync + jitter demod;
the front end and the wideband channelizer), this times the jitted
program at the bench shapes and reads XLA's own cost analysis (flops /
bytes accessed) from the compiled executable, reporting achieved
FLOP/s, GB/s and arithmetic intensity against the device's published
peaks (bench.PEAKS, keyed by device_kind; an unknown device is an
error). Also measures candidate syncs/s DIRECTLY (coarse-grid
sync-metric evaluations per wall second) rather than deriving it.

Host-clock times around work that ends in ``block_until_ready``; the
trace-based roofline is the benchmark's job.

Usage: python tools/roofline.py [B]
"""

from __future__ import annotations

import sys
import time

import numpy as np

sys.path.insert(0, ".")

from bench import device_peaks, make_batch  # noqa: E402


def timed(fn, args, iters=16):
    """Wall time per call over ``iters`` queued dispatches, ending in
    ``block_until_ready``, after one warm (compile) call."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters, out


def cost(fn, args):
    """(flops, bytes) from XLA cost analysis of the lowered program."""
    import jax

    lowered = jax.jit(fn).lower(*args)
    an = lowered.compile().cost_analysis()
    if isinstance(an, list):
        an = an[0]
    return float(an.get("flops", 0.0)), float(
        an.get("bytes accessed", 0.0))


def main() -> None:
    import jax
    import jax.numpy as jnp

    from rtlsdr_wsprd_tpu.config import DecoderOptions
    from rtlsdr_wsprd_tpu.frontend.decimate import decimate_stage1_xla
    from rtlsdr_wsprd_tpu.frontend.filters import R1, STAGE1_TAPS
    from rtlsdr_wsprd_tpu.ops.sync import jitter_offsets
    from rtlsdr_wsprd_tpu.parallel import multichannel as mc

    B = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    kind = jax.devices()[0].device_kind
    peaks = device_peaks(kind)
    # the decode path's matmuls run float32 operands (TF32 on the
    # tensor cores at default precision)
    peak_tflops = peaks["tf32_tflops"]
    peak_gbps = peaks["hbm_tbps"] * 1e3

    options = DecoderOptions()
    wi, wq = make_batch(B)
    si = jnp.asarray(wi)
    sq = jnp.asarray(wq)
    md = jnp.full((B,), options.maxdrift, jnp.int32)

    print(f"device={jax.devices()[0].platform} kind={kind} B={B} "
          f"(published peaks: {peak_tflops} TF32 TFLOP/s, "
          f"{peak_gbps} GB/s; {peaks['source']})")

    # measured ACHIEVABLE streaming bandwidth — the practical ceiling
    # the %peakB column should be read against
    big = jnp.arange(64 << 20, dtype=jnp.float32)  # 256 MB

    @jax.jit
    def _axpy(x):
        return x * 1.000001 + 0.5

    @jax.jit
    def _rsum(x):
        return x.sum()[None]

    dt_ax, _ = timed(_axpy, (big,))
    dt_rs, _ = timed(_rsum, (big,))
    print(f"measured streaming: {big.nbytes / dt_rs / 1e9:.0f} GB/s "
          f"read, {2 * big.nbytes / dt_ax / 1e9:.0f} GB/s r+w")
    rows = []

    # ---- stage A: STFT + candidates + coarse grid ----------------------
    def stage_a(a, b, c):
        return mc._stage_a_packed(a, b, c, fmin=options.fmin,
                                  fmax=options.fmax)

    dt_a, _ = timed(stage_a, (si, sq, md))
    fl_a, by_a = cost(stage_a, (si, sq, md))
    rows.append(("stage A (STFT+cand+coarse)", dt_a, fl_a, by_a))

    # measured candidate syncs/s: the coarse grid scores 512 rows x 32
    # lags x 9 drifts per window each call
    syncs_per_s = B * 512 * 32 * 9 / dt_a

    # ---- stage B: fine sync + jitter demod + gates (packed lanes) ------
    L = B  # one lane per window at bench occupancy
    lane_w = jnp.arange(L, dtype=jnp.int32) % B
    freq = jnp.asarray(np.linspace(-80, 80, L).astype(np.float32))
    shift = jnp.asarray((np.arange(L) * 97 % 4000).astype(np.int32))
    drift = jnp.asarray(np.linspace(-3, 3, L).astype(np.float32))
    lane_valid = jnp.ones((L,), bool)

    def stage_b(a, b, w, f, s, d, v):
        return mc._stage_b_packed(
            a, b, w, f, s, d, v, lagstep=8, iifac=options.iifac,
            quickmode=False, symfac=options.symfac,
            minsync1=options.minsync1, minsync2=options.minsync2,
            minrms=options.minrms)

    args_b = (si, sq, lane_w, freq, shift, drift, lane_valid)
    dt_b, _ = timed(stage_b, args_b)
    fl_b, by_b = cost(stage_b, args_b)
    nj = len(jitter_offsets(options.iifac, False))
    rows.append((f"stage B (fine+{nj}-jitter demod)", dt_b, fl_b, by_b))

    # ---- front end: stage-1 polyphase at ingest shape ------------------
    C, n_frames = 128, 9_375
    Lr = n_frames * R1 + STAGE1_TAPS - R1
    rng = np.random.default_rng(3)
    xI = jnp.asarray(rng.integers(0, 256, (C, Lr), np.uint8))
    xQ = jnp.asarray(rng.integers(0, 256, (C, Lr), np.uint8))

    def fe(a, b):
        return decimate_stage1_xla(a, b, n_frames)

    dt_f, _ = timed(fe, (xI, xQ))
    fl_f, by_f = cost(fe, (xI, xQ))
    rows.append(("front end stage-1 (u8 in)", dt_f, fl_f, by_f))

    # ---- wideband channelizer: K dials, one fused step, raw read once --
    from rtlsdr_wsprd_tpu.frontend.channelize import (
        ChannelizingStreamingDecimator,
    )

    K = 4
    cz = ChannelizingStreamingDecimator(
        [0.0, 50_000.0, -200_000.0, 1_000_000.0][:K], placement="device")
    n_mid = cz.QUANT1
    Lc = n_mid * R1 + STAGE1_TAPS - R1
    cI = jnp.asarray(rng.integers(0, 256, (Lc,), np.uint8))
    cQ = jnp.asarray(rng.integers(0, 256, (Lc,), np.uint8))
    rotC, rotS = cz._rot_tables(n_mid, device=True)
    ph0 = jnp.zeros((K, 1), jnp.float32)
    ph1 = jnp.ones((K, 1), jnp.float32)

    from rtlsdr_wsprd_tpu.frontend.channelize import (
        _folded_frontend_step,
    )

    def chan(a, b, m2i, m2q):
        return _folded_frontend_step(a, b, cz._H1t, cz._H1b, rotC, rotS,
                                     ph1, ph0, m2i, m2q, n_mid)

    args_c = (cI, cQ, cz._m2I, cz._m2Q)
    dt_c, _ = timed(chan, args_c)
    fl_c, by_c = cost(chan, args_c)
    rows.append((f"channelizer ({K} dials, fused)", dt_c, fl_c, by_c))

    print(f"{'phase':34s} {'ms':>8} {'GFLOP':>8} {'GB':>7} "
          f"{'TFLOP/s':>8} {'GB/s':>7} {'AI':>6} {'%peakF':>7} "
          f"{'%peakB':>7}")
    for name, dt, fl, by in rows:
        tf = fl / dt / 1e12
        gb = by / dt / 1e9
        ai = fl / max(by, 1.0)
        print(f"{name:34s} {1e3 * dt:8.1f} {fl / 1e9:8.2f} "
              f"{by / 1e9:7.2f} {tf:8.2f} {gb:7.1f} {ai:6.1f} "
              f"{100 * tf / peak_tflops:6.1f}% "
              f"{100 * gb / peak_gbps:6.1f}%")
    print(f"measured candidate syncs/s: {syncs_per_s:,.0f}")
    fe_msps = C * n_frames * R1 / dt_f / 1e6
    print(f"front-end sustained: {fe_msps:,.0f} Msps "
          f"({fe_msps / 2.4:,.0f} realtime channels)")
    cz_caps = n_mid * R1 / dt_c / 2.4e6
    print(f"channelizer sustained: {cz_caps:,.1f} realtime captures x "
          f"{K} dials = {K * cz_caps:,.0f} decoded dials/chip")


if __name__ == "__main__":
    main()
