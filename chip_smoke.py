"""Chip smoke test: the WSPR daemon's main path on one GPU.

    python chip_smoke.py          # one GPU: phases 1-5 below
    python chip_smoke.py --multi  # four GPUs: the multi-card phase only

Phases, in order; a failed phase exits non-zero and prints no result:

1. Device: JAX must see a GPU (never falls back to the CPU); prints the
   device kind and count, the JAX version, the compile-cache directory
   and the card's name and power limit from ``nvidia-smi``.
2. Main-path ops at real widths against float64 numpy references, at
   the code's own matmul precision and at HIGHEST: the fused stage-1+2
   front end (C=128 channels, 9,375 stage-1 frames, uint8 input), the
   spectrogram of one 45,000-sample window and the coarse-grid score
   table. Prints the front end's achieved bytes/s.
3. Served path through the entry point: ``multicli.main`` with
   ``--synth 4 -x --frontend device`` at the full 2-pass schedule, one
   120 s window of raw 2.4 Msps uint8 per channel (a 4-dongle station).
4. Production-width decode: 2 batches of B=128 windows of bench.py's
   census through decode_channels_pipelined (device_batch=128, full
   schedule), checked against the transmitted messages, and 4 of them
   against the dense reference decode_window. Prints cold and warm
   times, peak device memory and the resolved FEC calibration.
5. The last stdout line: {"ok": true, "device": {...}}.

``--multi`` runs, on 4 cards, the phase-4 windows through
decode_channels_pipelined_multidevice (compared with a 1-card run in
the same process), multichannel_decode_device on a 4-device ``ch`` mesh
and decimate_stage1_sharded on a 4-device ``seq`` mesh (each compared
with the 1-card result).

One process drives every card it uses. Long output goes to
chiprun_out/chip_smoke_*.log.
"""

from __future__ import annotations

import contextlib
import io
import json
import logging
import os
import subprocess
import sys
import time

import numpy as np

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chiprun_out")

# Tolerances on max|op - ref| / max|ref|, by matmul precision.
# DEFAULT: the GPU runs float32 matmul operands as TF32 (10-bit mantissa,
# unit roundoff 2^-11 = 4.9e-4); the error of a K-term dot stays within
# a few unit roundoffs of the output's peak, so 4x that.
# HIGHEST: float32 operands (unit roundoff 6e-8) summed over at most
# 2,400 taps; 2e-5 leaves room for sqrt(K) growth of the rounding.
TOL = {"DEFAULT": 2e-3, "HIGHEST": 2e-5}
TOL_REASON = {
    "DEFAULT": "TF32 operands: unit roundoff 4.9e-4, 4x margin",
    "HIGHEST": "float32 operands: unit roundoff 6e-8, sqrt(K) growth "
               "over <= 2,400 terms",
}

# spot-field tolerances of staged vs dense decode (the same as the
# oracle-parity tests, tests/test_staged_decode.py)
SPOT_TOL = {"freq": 0.5e-6, "snr": 0.5, "dt": 0.05, "drift": 0.01}

# bench.make_batch's transmitted messages (bench.py)
CENSUS_CALLS = ["K1JT FN20 37", "K9AN EN50 33", "G4ABC IO91 30",
                "VK2XYZ QF56 27"]


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---- float64 references (independent of the code under test) ------------

def ref_polyphase(xI: np.ndarray, xQ: np.ndarray, h: np.ndarray,
                  R: int, n_frames: int) -> tuple[np.ndarray, np.ndarray]:
    """Direct decimating convolution in float64:
    y[m] = sum_k h[k] x[m R + T - 1 - k], x = xI + j xQ, h complex or
    real. xI/xQ: (C, n_frames*R + T - R)."""
    h = np.asarray(h, np.complex128)
    T = h.shape[0]
    taps = np.stack([h.real[::-1], h.imag[::-1]], axis=1)  # (T, 2)
    yI = np.zeros((xI.shape[0], n_frames))
    yQ = np.zeros((xI.shape[0], n_frames))
    for c in range(xI.shape[0] if n_frames else 0):
        wi = np.lib.stride_tricks.sliding_window_view(
            np.asarray(xI[c], np.float64), T)[::R][:n_frames]
        wq = np.lib.stride_tricks.sliding_window_view(
            np.asarray(xQ[c], np.float64), T)[::R][:n_frames]
        pi = wi @ taps  # (n, 2): [sum x h_re, sum x h_im]
        pq = wq @ taps
        yI[c] = pi[:, 0] - pq[:, 1]
        yQ[c] = pi[:, 1] + pq[:, 0]
    return yI, yQ


def ref_frontend(rawI: np.ndarray, rawQ: np.ndarray, n_mid: int):
    """The fused stage-1+2 step in float64 for uint8 input and a zero
    (primed) mid-rate carry: returns (stage-1 I, Q) and (stage-2 I, Q)."""
    from rtlsdr_wsprd_tpu.frontend.filters import (
        R1,
        R2,
        STAGE2_TAPS,
        stage1_coeffs,
        stage2_coeffs,
    )

    xI = rawI.astype(np.float64) - 128.0
    xQ = rawQ.astype(np.float64) - 128.0
    mI, mQ = ref_polyphase(xI, xQ, stage1_coeffs(), R1, n_mid)
    prime2 = STAGE2_TAPS // 2
    cI = np.concatenate([np.zeros((xI.shape[0], prime2)), mI], axis=1)
    cQ = np.concatenate([np.zeros((xI.shape[0], prime2)), mQ], axis=1)
    n_out = max((cI.shape[1] - (STAGE2_TAPS - R2)) // R2, 0)
    oI, oQ = ref_polyphase(cI, cQ, stage2_coeffs(), R2, n_out)
    return (mI, mQ), (oI, oQ)


def ref_spectrogram(i: np.ndarray, q: np.ndarray) -> np.ndarray:
    """float64 numpy.fft power spectrogram with the decoder's window and
    hop: ps[j, b] = |FFT(frame_b * w)[(j + 256) % 512]|^2."""
    from rtlsdr_wsprd_tpu.config import FFT_SIZE
    from rtlsdr_wsprd_tpu.ops.stft import BLOCKS, HOP

    w = np.sin(0.006147931 * np.arange(FFT_SIZE, dtype=np.float64))
    x = np.asarray(i, np.float64) + 1j * np.asarray(q, np.float64)
    frames = np.stack([x[b * HOP:b * HOP + FFT_SIZE]
                       for b in range(BLOCKS)])
    z = np.fft.fft(frames * w, axis=1)
    order = (np.arange(FFT_SIZE) + FFT_SIZE // 2) % FFT_SIZE
    return (np.abs(z[:, order]) ** 2).T


def ref_coarse_grid(ps: np.ndarray, rows: slice):
    """float64 (ss, pw)[row, lag, drift] by the reference's loop
    semantics (wsprd/wsprd.c:646-678): tone rows ifr + trunc(fd) + t,
    t in (-3, -1, 1, 3), columns k0 + 2i, out-of-range columns
    contributing nothing."""
    from rtlsdr_wsprd_tpu.config import DF, NBITS, NSYM
    from rtlsdr_wsprd_tpu.ops.coarse import (
        K0_MAX,
        K0_MIN,
        MAX_DRIFT_SPAN,
    )
    from rtlsdr_wsprd_tpu.utils.channel import PR3_VECTOR

    sq = np.sqrt(np.asarray(ps, np.float64))
    nblk = sq.shape[1]
    r = np.arange(sq.shape[0])[rows]
    sign = 2.0 * PR3_VECTOR.astype(np.float64) - 1.0
    i = np.arange(NSYM)
    drifts = range(-MAX_DRIFT_SPAN, MAX_DRIFT_SPAN + 1)
    lags = range(K0_MIN, K0_MAX + 1)
    ss = np.zeros((r.size, len(lags), len(drifts)))
    pw = np.zeros_like(ss)
    for di, d in enumerate(drifts):
        fd = ((i - NBITS) / NBITS) * d / DF
        row = np.trunc(r[:, None] + fd[None, :]).astype(int)  # (R, 162)
        for li, k0 in enumerate(lags):
            k = k0 + 2 * i
            ok = (k >= 0) & (k < nblk)
            kc = np.clip(k, 0, nblk - 1)
            p = [np.where(ok, sq[row + t, kc[None, :]], 0.0)
                 for t in (-3, -1, 1, 3)]
            ss[:, li, di] = ((p[1] + p[3]) - (p[0] + p[2])) @ sign
            pw[:, li, di] = (p[0] + p[1] + p[2] + p[3]).sum(axis=1)
    return ss, pw


def rel_err(got, ref) -> float:
    got = [np.asarray(g, np.float64) for g in got]
    ref = [np.asarray(x, np.float64) for x in ref]
    scale = max(float(np.max(np.abs(x))) for x in ref)
    return max(float(np.max(np.abs(g - x))) for g, x in zip(got, ref)) \
        / max(scale, 1e-30)


def census_truth(B: int) -> list[set[str]]:
    """The messages bench.make_batch(B) transmits in each window."""
    return [set() if b % 4 == 3 else
            {CENSUS_CALLS[b % 4], CENSUS_CALLS[(b + 1) % 4]}
            for b in range(B)]


# ---- phase 1 --------------------------------------------------------------

def phase_device(need: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform "
              f"{devs[0].platform!r}); this script needs one and never "
              "falls back to the CPU", file=sys.stderr)
        sys.exit(2)
    if len(devs) < need:
        print(f"chip_smoke: {need} GPU(s) needed, JAX sees {len(devs)}",
              file=sys.stderr)
        sys.exit(2)
    from rtlsdr_wsprd_tpu import compile_cache

    cache = compile_cache.enable()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()
    check(smi.returncode == 0 and card, f"nvidia-smi failed: {smi.stderr}")
    log(f"phase1 device_kind={devs[0].device_kind} count={len(devs)} "
        f"jax={jax.__version__} compile_cache={cache}")
    for line in card:
        log(f"phase1 nvidia-smi: {line}")
    return devs, card[0]


# ---- phase 2 --------------------------------------------------------------

def phase_ops(card: str) -> None:
    import jax
    import jax.numpy as jnp

    from bench import device_peaks
    from rtlsdr_wsprd_tpu.frontend import decimate
    from rtlsdr_wsprd_tpu.frontend.filters import R1, STAGE1_TAPS, STAGE2_TAPS
    from rtlsdr_wsprd_tpu.ops import coarse, stft

    P = jax.lax.Precision
    precisions = {"DEFAULT": P.DEFAULT, "HIGHEST": P.HIGHEST}
    failures = []

    def report(op, name, err, code_precision):
        tol = TOL[name]
        mark = "ok" if err <= tol else "FAIL"
        used = " (the code's precision)" if \
            precisions[name] == code_precision else ""
        log(f"phase2 {op} precision={name}{used} max_rel_err={err:.3e} "
            f"tol={tol:.0e} [{TOL_REASON[name]}] {mark}")
        if err > tol:
            failures.append(f"{op} at {name}: {err:.3e} > {tol:.0e}")

    # front end at bench shapes: C=128, 9,375 stage-1 frames, uint8
    C, n_mid = 128, 9_375
    L = n_mid * R1 + STAGE1_TAPS - R1
    rng = np.random.default_rng(2026)
    rawI = rng.integers(0, 256, (C, L), dtype=np.uint8)
    rawQ = rng.integers(0, 256, (C, L), dtype=np.uint8)
    t0 = time.perf_counter()
    (mI, mQ), (oI, oQ) = ref_frontend(rawI, rawQ, n_mid)
    log(f"phase2 float64 front-end reference: "
        f"{time.perf_counter() - t0:.1f} s host")
    dI, dQ = jnp.asarray(rawI), jnp.asarray(rawQ)
    carry = jnp.zeros((C, STAGE2_TAPS // 2), jnp.float32)
    for name, prec in precisions.items():
        s1 = decimate.decimate_stage1_batched(dI, dQ, n_mid, precision=prec)
        fused = decimate._fused_frontend_step(dI, dQ, carry, carry, n_mid,
                                              precision=prec)
        report("frontend stage-1 (C=128, 9375 frames, uint8)", name,
               rel_err(s1, (mI, mQ)), decimate.PRECISION)
        report("frontend fused stage-1+2 step", name,
               rel_err(fused[:2], (oI, oQ)), decimate.PRECISION)

    # achieved bytes/s of the XLA front end at the code's precision
    kind = jax.devices()[0].device_kind
    hbm = device_peaks(kind)["hbm_tbps"] * 1e12
    read_bytes = rawI.nbytes + rawQ.nbytes
    for op, fn in (
            ("stage-1", lambda: decimate.decimate_stage1_batched(
                dI, dQ, n_mid)),
            ("fused stage-1+2", lambda: decimate._fused_frontend_step(
                dI, dQ, carry, carry, n_mid))):
        jax.block_until_ready(fn())
        iters = 20
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / iters
        log(f"phase2 frontend {op} C={C} uint8: {1e3 * dt:.3f} ms/step, "
            f"{read_bytes / dt / 1e12:.3f} TB/s of input read = "
            f"{100 * read_bytes / dt / hbm:.1f}% of the {hbm / 1e12} TB/s "
            f"HBM peak ({kind}; {card})")

    # spectrogram of one 45,000-sample window (signals + noise)
    from bench import make_batch

    wi, wq = make_batch(1)
    ps_ref = ref_spectrogram(wi[0], wq[0])
    for name, prec in precisions.items():
        ps = stft.power_spectrogram(jnp.asarray(wi[0]), jnp.asarray(wq[0]),
                                    precision=prec)
        report("spectrogram (45000 samples, 347x512)", name,
               rel_err([ps], [ps_ref]), stft.PRECISION)

    # coarse-grid score table (512 rows x 32 lags x 9 drifts) on the
    # float64 spectrogram, over the rows candidates read
    rows = slice(coarse.ROW_LO, coarse.ROW_HI + 1)
    ss_ref, pw_ref = ref_coarse_grid(ps_ref, rows)
    ps32 = jnp.asarray(ps_ref.astype(np.float32))
    for name, prec in precisions.items():
        ss, pw = coarse.coarse_grid(ps32, precision=prec)
        err = rel_err([np.asarray(ss)[rows], np.asarray(pw)[rows]],
                      [ss_ref, pw_ref])
        report("coarse grid (423 rows x 32 lags x 9 drifts)", name, err,
               coarse.PRECISION)
    check(not failures, "; ".join(failures))


# ---- phase 3 --------------------------------------------------------------

class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.records: list[logging.LogRecord] = []

    def emit(self, record):
        self.records.append(record)


def parse_daemon_spots(text: str) -> tuple[dict[int, list[str]], str]:
    """Per-channel decoded 'CALL LOC PWR' from the daemon's spot lines,
    and its closing 'Processed ...' line."""
    per: dict[int, list[str]] = {}
    ch = None
    processed = ""
    for line in text.splitlines():
        if line.startswith("-- channel "):
            ch = int(line.split()[2])
            per[ch] = []
        elif line.startswith("Spot :") and ch is not None:
            per[ch].append(" ".join(line.split()[-3:]))
        elif line.startswith("Processed "):
            processed = line
    return per, processed


def phase_served() -> None:
    from rtlsdr_wsprd_tpu import multicli

    handler = _Records()
    mlog = logging.getLogger("rtlsdr_wsprd_tpu.multichannel")
    mlog.addHandler(handler)
    buf = io.StringIO()
    argv = ["--synth", "4", "-x", "--frontend", "device", "-n", "1"]
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = multicli.main(argv)
    finally:
        mlog.removeHandler(handler)
    dt = time.perf_counter() - t0
    text = buf.getvalue()
    with open(os.path.join(OUT_DIR, "chip_smoke_multicli.log"), "w") as f:
        f.write(text)
    for line in text.splitlines():
        log(f"phase3 | {line}")
    per, processed = parse_daemon_spots(text)
    log(f"phase3 multicli {' '.join(argv)}: rc={rc}, {dt:.1f} s wall "
        "(synthesis, compile and decode)")
    check(rc == 0, f"multicli returned {rc}")
    want = "K1JT FN20 20"  # SyntheticRawBank's default message
    for c in range(4):
        got = per.get(c, [])
        check(got == [want], f"channel {c}: spots {got}, want [{want!r}]")
    check(processed.endswith(", 0 error(s)."),
          f"daemon errors: {processed!r}")
    check("4 channel-windows, 4 spot(s)" in processed,
          f"unexpected totals: {processed!r}")
    check(not handler.records,
          "warnings from rtlsdr_wsprd_tpu.multichannel: "
          + "; ".join(r.getMessage()[:120] for r in handler.records))


# ---- phase 4 --------------------------------------------------------------

def census_batches(B: int = 128, n: int = 2):
    from bench import make_batch

    return [make_batch(B, seed=11 + 1000 * k) for k in range(n)]


def check_census(per_batch, B: int, label: str) -> None:
    truth = census_truth(B)
    bad = []
    for k, spots in enumerate(per_batch):
        for b, sp in enumerate(spots):
            got = {s.message for s in sp}
            if got != truth[b]:
                bad.append(f"batch {k} window {b}: got {sorted(got)} "
                           f"want {sorted(truth[b])}")
    n_msgs = sum(len(t) for t in truth) * len(per_batch)
    log(f"{label}: {n_msgs} transmitted messages over "
        f"{B * len(per_batch)} windows; {len(bad)} window(s) differ")
    check(not bad, "; ".join(bad[:8]))


def phase_decode(card: str, B: int = 128) -> None:
    import jax

    from rtlsdr_wsprd_tpu.config import DecoderOptions
    from rtlsdr_wsprd_tpu.models.decoder import decode_window
    from rtlsdr_wsprd_tpu.ops.calibrate import get_fec_calibration
    from rtlsdr_wsprd_tpu.parallel.multichannel import (
        decode_channels,
        decode_channels_pipelined,
        prepare_windows,
    )

    DB = B
    options = DecoderOptions()
    batches = census_batches(B)
    t0 = time.perf_counter()
    it = decode_channels_pipelined(iter(batches), options, device_batch=DB)
    out = [next(it)]
    cold = time.perf_counter() - t0
    out.extend(it)
    check_census(out, B, "phase4 pipelined decode")

    wi, wq = batches[1]
    dw = prepare_windows(wi, wq, device_batch=DB)
    jax.block_until_ready(dw.arrays)
    t0 = time.perf_counter()
    warm_spots = decode_channels(None, None, options, windows=dw)
    jax.block_until_ready(dw.arrays)
    warm = time.perf_counter() - t0
    check_census([warm_spots], B, "phase4 warm decode")
    peak = (jax.devices()[0].memory_stats() or {}).get(
        "peak_bytes_in_use", "not reported")
    cal = get_fec_calibration().as_dict()
    log(f"phase4 record cold (compile + first batch of {B}, the second "
        f"in flight): {cold:.3f} s [{card}]")
    log(f"phase4 record warm (one batch of {B}, device-resident input, "
        f"ends in block_until_ready): {warm:.3f} s [{card}]")
    log(f"phase4 record peak_bytes_in_use: {peak} [{card}]")
    log(f"phase4 record FEC calibration: {json.dumps(cal)} [{card}]")

    # staged spots vs the dense reference decode_window on 4 windows
    wi0, wq0 = batches[0]
    for b in [b for b in (0, 1, 2, 48) if b < B]:
        dense = sorted(decode_window(wi0[b], wq0[b], options),
                       key=lambda s: s.message)
        staged = sorted(out[0][b], key=lambda s: s.message)
        check([s.message for s in staged] == [s.message for s in dense],
              f"window {b}: staged {[s.message for s in staged]} != "
              f"dense {[s.message for s in dense]}")
        for s, d in zip(staged, dense):
            for f, tol in SPOT_TOL.items():
                check(abs(getattr(s, f) - getattr(d, f)) <= tol,
                      f"window {b} {s.message}: {f} staged "
                      f"{getattr(s, f)} dense {getattr(d, f)}")
        log(f"phase4 window {b}: staged == dense "
            f"{[s.message for s in staged]}")


# ---- --multi ----------------------------------------------------------------

def phase_multi(devs, B: int = 128) -> None:
    import jax
    import jax.numpy as jnp

    from rtlsdr_wsprd_tpu.config import DecoderOptions
    from rtlsdr_wsprd_tpu.frontend.decimate import decimate_stage1_xla
    from rtlsdr_wsprd_tpu.parallel.mesh import channel_sharding, make_mesh
    from rtlsdr_wsprd_tpu.parallel.multichannel import (
        decode_channels_pipelined,
        decode_channels_pipelined_multidevice,
        multichannel_decode_device,
    )
    from rtlsdr_wsprd_tpu.parallel.streaming import (
        decimate_stage1_sharded,
        valid_frames,
    )

    devs = devs[:4]
    options = DecoderOptions()
    batches = census_batches(B)

    # (a) the daemon's --devices all path vs one card
    t0 = time.perf_counter()
    multi = list(decode_channels_pipelined_multidevice(
        iter(batches), options, device_batch=B, devices=devs))
    t_multi = time.perf_counter() - t0
    t0 = time.perf_counter()
    single = list(decode_channels_pipelined(
        iter(batches), options, device_batch=B, device=devs[0]))
    t_single = time.perf_counter() - t0
    check_census(multi, B, "multi pipelined_multidevice (4 GPUs)")

    def key(out):
        return [[sorted((s.message, round(s.snr, 1), round(s.freq, 6))
                        for s in ch) for ch in batch] for batch in out]
    check(key(multi) == key(single),
          "4-card and 1-card spot sets differ")
    log(f"multi pipelined_multidevice: 4-card spots == 1-card spots "
        f"({t_multi:.1f} s vs {t_single:.1f} s, both cold)")

    # (b) the exported SPMD mesh path on a 4-device ch mesh
    mesh = make_mesh(devs, "ch")
    sh = channel_sharding(mesh)
    wi, wq = batches[0]
    nb = 8
    md = np.full((nb,), options.maxdrift, np.int32)
    kw = dict(max_attempts=64, maxcycles=64)
    out4 = multichannel_decode_device(
        jax.device_put(wi[:nb], sh), jax.device_put(wq[:nb], sh),
        jax.device_put(md, sh), **kw)
    out1 = multichannel_decode_device(
        jax.device_put(wi[:nb], devs[0]), jax.device_put(wq[:nb], devs[0]),
        jax.device_put(md, devs[0]), **kw)
    for f, a4 in out4._asdict().items():
        check(len(a4.sharding.device_set) == 4,
              f"mesh output {f} on {len(a4.sharding.device_set)} devices")
    exact = ("valid", "sel_cand", "sel_jit", "sel_valid", "success")
    for f in exact:
        check(np.array_equal(np.asarray(getattr(out4, f)),
                             np.asarray(getattr(out1, f))),
              f"mesh output {f} differs from the 1-card result")
    ok = np.asarray(out1.success)
    check(np.array_equal(np.asarray(out4.data)[ok],
                         np.asarray(out1.data)[ok]),
          "mesh decoded bytes differ from the 1-card result")
    for f in ("snr", "freq", "sync"):
        err = rel_err([getattr(out4, f)], [getattr(out1, f)])
        check(err <= 1e-4, f"mesh {f} rel err {err:.2e}")
    log(f"multi mesh decode: {nb} windows sharded over 4 devices, every "
        f"output stays 4-way sharded; equals the 1-card result "
        f"({int(ok.sum())} decoded attempts)")

    # (c) sequence-parallel stage 1 on a 4-device seq mesh
    seq = make_mesh(devs, "seq")
    L = 4 * 80 * 30_000
    rng = np.random.default_rng(7)
    xI = rng.normal(0, 30, L).astype(np.float32)
    xQ = rng.normal(0, 30, L).astype(np.float32)
    sI, sQ = decimate_stage1_sharded(jnp.asarray(xI), jnp.asarray(xQ), seq)
    n = valid_frames(L)
    rI, rQ = decimate_stage1_xla(jax.device_put(xI, devs[0]),
                                 jax.device_put(xQ, devs[0]), n)
    err = rel_err([np.asarray(sI)[:n], np.asarray(sQ)[:n]], [rI, rQ])
    check(err <= 1e-5, f"sharded stage 1 rel err {err:.2e}")
    log(f"multi seq-sharded stage 1: {n} frames over 4 devices, "
        f"max_rel_err vs 1 card {err:.2e}")


def main(argv: list[str]) -> int:
    multi = "--multi" in argv
    devs, card = phase_device(4 if multi else 1)
    os.makedirs(OUT_DIR, exist_ok=True)
    import jax

    try:
        if multi:
            phase_multi(devs)
            count = 4
        else:
            phase_ops(card)
            phase_served()
            phase_decode(card)
            count = len(jax.devices())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
