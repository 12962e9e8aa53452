"""Fine sync and soft-symbol demodulation: batched correlator banks.

The reference's sync_and_demodulate (wsprd/wsprd.c:101-259) is a
3-mode sequential matched filter: per (freq, lag) it rebuilds 4 tone
phasors by Chebyshev recursion (with a non-reentrant static cache) and
correlates 162 symbols x 256 samples. Here all candidates run at once
and the phasor factorizes:

    exp(-i*2*pi*dt*(fp_i + (t-1.5)*DF)*j)
      = E_cand[c,i,j] * E_TONE[j,t]

where E_cand depends only on the candidate's (freq, drift) and E_TONE
is a static (256, 4) matrix. The lag/jitter offset axis tensorizes
too: because E_cand is a pure exponential in the sample index,
``E_cand[c,i,u-o] = E_cand[c,i,u] * conj(E_cand)[c,i,o]`` — so the
correlation at EVERY static offset o is one matmul

    (C*162, 512) @ (512, n_offsets*4)

against a static offset-shifted tone matrix, and the leftover
unit-modulus phase ``conj(E_cand)[c,i,o]`` vanishes under the
magnitude. One matmul replaces the reference's per-lag /
per-jitter loop (and our former 33/43-step lax.scan). A
frequency-offset factor E_freq[f,j] separates the same way for the
mode-1 search.

All complex arithmetic is PLANAR REAL (separate re/im float32 arrays):
the correlations are explicit 4-term real einsums and magnitudes are
sqrt(re^2 + im^2).

Modes map to: fine_sync (mode 0 lag search + mode 1 freq search,
wsprd/wsprd.c:709-726) and soft_symbols_jittered (mode 2 over the
full jitter schedule, wsprd/wsprd.c:739-766).
"""

from __future__ import annotations

import os
from functools import lru_cache, partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DF, DT, NBITS, NSPERSYM, NSYM
from ..utils.channel import PR3_VECTOR

TWOPIDT = 2.0 * np.pi * DT

# Correlator operand dtype (reductions always accumulate float32 via
# preferred_element_type): float32 on every backend, so parity tests and
# the served path compute the same numbers. RTLSDR_WSPRD_TPU_SYNC_BF16=1
# opts into bfloat16 operands, which also casts the elementwise
# derotate/phasor operands; its effect on decode counts and speed on
# the GPU is not measured. Resolved lazily at first trace, not import,
# so importing the package never initializes an XLA backend (required
# by jax.distributed.initialize, see multichannel._BIG).
def _cdt():
    v = os.environ.get("RTLSDR_WSPRD_TPU_SYNC_BF16")
    return jnp.bfloat16 if v == "1" else jnp.float32


# Matmul precision of the float32 correlator einsums. DEFAULT lets the
# GPU run float32 operands as TF32 (10-bit mantissa); the soft symbols
# are quantized to 8 bits after these sums.
CORR_PRECISION = jax.lax.Precision.DEFAULT

# E_TONE[j, t] = exp(-i * 2*pi*dt * (t-1.5)*DF * j): static tone phasors
_j = np.arange(NSPERSYM, dtype=np.float64)
_t = np.arange(4, dtype=np.float64) - 1.5
_ANG_TONE = TWOPIDT * DF * np.outer(_j, _t)
E_TONE_R = np.cos(_ANG_TONE).astype(np.float32)   # (256, 4)
E_TONE_I = (-np.sin(_ANG_TONE)).astype(np.float32)

_PR3 = PR3_VECTOR.astype(bool)          # (162,)
_PR3_SIGN = 2.0 * PR3_VECTOR.astype(np.float32) - 1.0


def _cand_phasor_conj(f0: jnp.ndarray, drift: jnp.ndarray,
                      ulen: int = NSPERSYM):
    """conj of the per-candidate base phasor, planar (re, im), each
    (C, 162, ulen) in the correlator compute dtype.

    fp_i = f0 + (drift/2) * (i - 81)/81 (wsprd/wsprd.c:156); phase
    accumulates as j * 2*pi*dt*fp_i within each symbol (phase resets at
    symbol boundaries, wsprd/wsprd.c:174-188). ``ulen=2*NSPERSYM``
    extends the pure exponential over the double-length symbol frames
    used by the offset-tensorized correlator (module docstring).

    bf16 path (opt-in, see _cdt): the sample-index axis is built by
    LOG-DOUBLING complex powers — E^u for u in [0, ulen) from 9 planar
    squaring/append rounds — instead of 2*C*162*ulen transcendental
    evals; the ~1e-6 relative error of 9 chained complex products is
    far below the bf16 truncation the operands get anyway. The float32
    default keeps direct cos/sin so exact-parity tests stay
    bit-stable.
    """
    cdt = _cdt()
    i = jnp.arange(NSYM, dtype=jnp.float32)
    fp = f0[:, None] + (drift[:, None] / 2.0) * (i[None, :] - NBITS) / NBITS  # (C,162)
    dphi = TWOPIDT * fp  # (C,162)
    if cdt == jnp.bfloat16:
        cr = jnp.cos(dphi)            # E^1 = e^{-i dphi}, planar
        ci = -jnp.sin(dphi)
        pr = jnp.ones_like(dphi)[..., None]   # E^0
        pim = jnp.zeros_like(dphi)[..., None]
        sr, si = cr, ci               # step = E^(2^k)
        while pr.shape[-1] < ulen:
            nr = pr * sr[..., None] - pim * si[..., None]
            ni = pr * si[..., None] + pim * sr[..., None]
            pr = jnp.concatenate([pr, nr], axis=-1)
            pim = jnp.concatenate([pim, ni], axis=-1)
            sr, si = sr * sr - si * si, 2.0 * sr * si
        return pr[..., :ulen].astype(cdt), pim[..., :ulen].astype(cdt)
    phase = dphi[:, :, None] * jnp.arange(ulen, dtype=jnp.float32)  # (C,162,ulen)
    return (jnp.cos(phase).astype(cdt),
            (-jnp.sin(phase)).astype(cdt))


# ---- slice-based candidate windows ------------------------------------------
#
# No generic (C,162,256) gather: one vmapped contiguous dynamic_slice pulls each candidate's
# maximal window covering every lag/jitter offset; a single reshape +
# concat then yields double-length symbol frames (C, 162, 512) from
# which the correlation at every offset is one matmul (module
# docstring) — gather-free and scan-free.

HALF_SPAN = 128                       # max |lag| (mode 0) and |jitter|
NSIG = NSYM * NSPERSYM                # 41472
WLEN = NSIG + 2 * HALF_SPAN           # per-candidate window length
ULEN = 2 * NSPERSYM                   # double-length frame: all offsets
_PAD = 2048                           # coarse shift range is [-1152, 2944]


def _padded_signal(sig_i: jnp.ndarray, sig_q: jnp.ndarray):
    """Zero sample 0 (the C's strict k > 0 bound, wsprd/wsprd.c:199 —
    every read of it is masked) and pad so all window starts/ends are
    in range; out-of-range samples read the zero padding, matching the
    reference's mask."""
    zi = sig_i.at[0].set(0.0)
    zq = sig_q.at[0].set(0.0)
    pi = jnp.pad(zi, (_PAD, _PAD))
    pq = jnp.pad(zq, (_PAD, _PAD))
    return pi, pq


def _candidate_windows(pi: jnp.ndarray, pq: jnp.ndarray,
                       shifts: jnp.ndarray):
    """(C,) base shifts -> (C, WLEN) windows starting at shift-HALF_SPAN."""
    starts = shifts + (_PAD - HALF_SPAN)

    def slice1(s):
        return (jax.lax.dynamic_slice(pi, (s,), (WLEN,)),
                jax.lax.dynamic_slice(pq, (s,), (WLEN,)))

    return jax.vmap(slice1)(starts)


def _double_frames(w: jnp.ndarray) -> jnp.ndarray:
    """(C, WLEN) windows -> (C, 162, 512) double-length symbol frames
    D[c,i,u] = w[c, 256*i + u]: frame i plus frame i+1, covering every
    offset in [0, 2*HALF_SPAN]. WLEN = 163*256 exactly, so this is a
    reshape + one 50%-overlap concat (no gather)."""
    C = w.shape[0]
    f = w.reshape(C, NSYM + 1, NSPERSYM)
    return jnp.concatenate([f[:, :NSYM], f[:, 1:]], axis=2)


def _window_symbols_percand(wr: jnp.ndarray, wi: jnp.ndarray,
                            offs: jnp.ndarray):
    """Per-candidate offsets (C,) -> (C, 162, 256) frames."""

    def one(w_r, w_i, o):
        return (
            jax.lax.dynamic_slice(w_r, (o,), (NSIG,)).reshape(NSYM, NSPERSYM),
            jax.lax.dynamic_slice(w_i, (o,), (NSIG,)).reshape(NSYM, NSPERSYM),
        )

    return jax.vmap(one)(wr, wi, offs)


def _padded_signals(sig_i: jnp.ndarray, sig_q: jnp.ndarray):
    """Batched _padded_signal: (B, N) -> (B, N + 2*_PAD)."""
    return jax.vmap(_padded_signal)(sig_i, sig_q)


def _lane_windows(pi: jnp.ndarray, pq: jnp.ndarray, lane_w: jnp.ndarray,
                  shifts: jnp.ndarray):
    """Cross-window candidate lanes: pi/pq (B, N+2*_PAD) padded signal
    planes, lane_w int32[G] window index per lane, shifts int32[G] ->
    (G, WLEN) windows. One 2-D dynamic_slice per lane — gather-free,
    same as _candidate_windows but with a batch coordinate."""
    starts = shifts + (_PAD - HALF_SPAN)

    def one(w, s):
        return (jax.lax.dynamic_slice(pi, (w, s), (1, WLEN))[0],
                jax.lax.dynamic_slice(pq, (w, s), (1, WLEN))[0])

    return jax.vmap(one)(lane_w, starts)


def _tone_mags(yr: jnp.ndarray, yi: jnp.ndarray,
               er: jnp.ndarray, ei: jnp.ndarray) -> jnp.ndarray:
    """y: (C,162,256) de-rotated samples (planar); e: (256, K) tone
    (/freq) phasors (planar) -> |z|: (C,162,K). Four real einsums."""
    kw = dict(precision=CORR_PRECISION, preferred_element_type=jnp.float32)
    zr = (jnp.einsum("cij,jk->cik", yr, er, **kw)
          - jnp.einsum("cij,jk->cik", yi, ei, **kw))
    zi = (jnp.einsum("cij,jk->cik", yr, ei, **kw)
          + jnp.einsum("cij,jk->cik", yi, er, **kw))
    return jnp.sqrt(zr * zr + zi * zi)


def _derotate(xr, xi, ecr, eci):
    """y = x * ec, planar (in the correlator compute dtype)."""
    xr = xr.astype(ecr.dtype)
    xi = xi.astype(ecr.dtype)
    return xr * ecr - xi * eci, xr * eci + xi * ecr


@lru_cache(maxsize=None)
def _offset_tone_matrix(offsets: tuple):
    """Static planar (ULEN, L*4) matrices T[u, (l,t)] = E_TONE[u-o_l, t]
    (zero outside [o_l, o_l+256)) for absolute offsets o_l in
    [0, 2*HALF_SPAN]. Right operand of the offset-tensorized correlator
    matmul (module docstring)."""
    L = len(offsets)
    tr = np.zeros((ULEN, L, 4), np.float32)
    ti = np.zeros((ULEN, L, 4), np.float32)
    for idx, o in enumerate(offsets):
        tr[o:o + NSPERSYM, idx] = E_TONE_R
        ti[o:o + NSPERSYM, idx] = E_TONE_I
    return tr.reshape(ULEN, L * 4), ti.reshape(ULEN, L * 4)


def _tone_mags_offsets(wr: jnp.ndarray, wi: jnp.ndarray,
                       freq: jnp.ndarray, drift: jnp.ndarray,
                       offsets: tuple, phasor=None) -> jnp.ndarray:
    """Tone magnitudes at EVERY static window offset in one matmul
    pair: (C, WLEN) windows -> (C, 162, L, 4). Offsets are absolute
    (relative lag/jitter + HALF_SPAN). ``phasor``: optional
    precomputed _cand_phasor_conj(freq, drift, ULEN) to share across
    modes."""
    cdt = _cdt()
    dr = _double_frames(wr)
    di = _double_frames(wi)
    ecr, eci = (phasor if phasor is not None
                else _cand_phasor_conj(freq, drift, ulen=ULEN))
    yr, yi = _derotate(dr, di, ecr, eci)
    tr_np, ti_np = _offset_tone_matrix(offsets)
    tr = jnp.asarray(tr_np).astype(cdt)
    ti = jnp.asarray(ti_np).astype(cdt)
    p = _tone_mags(yr, yi, tr, ti)                        # (C,162,L*4)
    C = p.shape[0]
    return p.reshape(C, NSYM, len(offsets), 4)


def _sync_from_powers(p: jnp.ndarray) -> jnp.ndarray:
    """p: (..., 162, 4) tone magnitudes -> sync metric (...,)
    (wsprd/wsprd.c:216-227)."""
    cmet = (p[..., 1] + p[..., 3]) - (p[..., 0] + p[..., 2])
    ss = jnp.sum(jnp.asarray(_PR3_SIGN) * cmet, axis=-1)
    totp = jnp.sum(p, axis=(-2, -1))
    return ss / jnp.maximum(totp, 1e-30)


class FineSync(NamedTuple):
    freq: jnp.ndarray   # float32[C]
    shift: jnp.ndarray  # int32[C]
    sync: jnp.ndarray   # float32[C]


def _fine_sync_core(
    wr: jnp.ndarray,
    wi: jnp.ndarray,
    freq: jnp.ndarray,
    shift: jnp.ndarray,
    drift: jnp.ndarray,
    lagstep: int,
) -> FineSync:
    """Shared mode-0/mode-1 body over already-built (C, WLEN) windows."""
    cdt = _cdt()

    # ---- mode 0: lag search — ONE matmul over all lags ----
    rel_lags = np.arange(-128, 129, lagstep, dtype=np.int32)
    offs = tuple(int(r) + HALF_SPAN for r in rel_lags)
    ec512 = _cand_phasor_conj(freq, drift, ulen=ULEN)   # shared 0/1
    p = _tone_mags_offsets(wr, wi, freq, drift, offs, phasor=ec512)
    sync_l = _sync_from_powers(jnp.moveaxis(p, 2, 0))   # (L, C)
    best_l = jnp.argmax(sync_l, axis=0)  # first max wins = C lag order
    shift1 = shift + jnp.asarray(rel_lags)[best_l]

    # mode 1 reuses mode 0's phasor: E^u powers are identical on the
    # first NSPERSYM columns (pure exponential)
    ecr, eci = ec512[0][..., :NSPERSYM], ec512[1][..., :NSPERSYM]
    etr = jnp.asarray(E_TONE_R).astype(cdt)
    eti = jnp.asarray(E_TONE_I).astype(cdt)

    # ---- mode 1: freq search at the best lag ----
    fstep = 0.1
    ifreqs = jnp.arange(-2, 3, dtype=jnp.float32)
    # separable frequency offset phasor (256, 5), then combined with the
    # tone phasors into a (256, 20) planar matrix
    jj = jnp.arange(NSPERSYM, dtype=jnp.float32)
    ph = TWOPIDT * fstep * jnp.outer(jj, ifreqs)
    efr, efi = jnp.cos(ph), -jnp.sin(ph)  # (256,5)
    er = (efr[:, :, None] * etr[:, None, :]
          - efi[:, :, None] * eti[:, None, :]).reshape(NSPERSYM, 20)
    ei = (efr[:, :, None] * eti[:, None, :]
          + efi[:, :, None] * etr[:, None, :]).reshape(NSPERSYM, 20)
    er = er.astype(cdt)
    ei = ei.astype(cdt)

    # shift1 - shift in [-128, 128] -> still inside the same windows
    xr, xi = _window_symbols_percand(wr, wi, shift1 - shift + HALF_SPAN)
    yr, yi = _derotate(xr, xi, ecr, eci)
    p = _tone_mags(yr, yi, er, ei)                      # (C,162,20)
    p = p.reshape(p.shape[0], NSYM, 5, 4)
    sync_f = _sync_from_powers(jnp.moveaxis(p, 2, 0))   # (5, C)
    best_f = jnp.argmax(sync_f, axis=0)                 # freq ascending, first wins
    freq1 = freq + (best_f.astype(jnp.float32) - 2.0) * fstep
    sync1 = jnp.take_along_axis(sync_f, best_f[None, :], axis=0)[0]
    return FineSync(freq=freq1, shift=shift1, sync=sync1)


@partial(jax.jit, static_argnames=("lagstep",))
def fine_sync(
    sig_i: jnp.ndarray,
    sig_q: jnp.ndarray,
    freq: jnp.ndarray,
    shift: jnp.ndarray,
    drift: jnp.ndarray,
    lagstep: int = 8,
) -> FineSync:
    """Mode-0 lag search (+/-128 by lagstep) then mode-1 freq search
    (+/-0.2 Hz, step 0.1) for all candidates at once
    (wsprd/wsprd.c:709-726). quickmode uses lagstep=16."""
    pi, pq = _padded_signal(sig_i, sig_q)
    wr, wi = _candidate_windows(pi, pq, shift)  # (C, WLEN)
    return _fine_sync_core(wr, wi, freq, shift, drift, lagstep)


def fine_sync_lanes(
    sig_i: jnp.ndarray,
    sig_q: jnp.ndarray,
    lane_w: jnp.ndarray,
    freq: jnp.ndarray,
    shift: jnp.ndarray,
    drift: jnp.ndarray,
    lagstep: int = 8,
) -> FineSync:
    """fine_sync over candidate LANES compacted across a window batch:
    sig_i/sig_q (B, N) planar signals, lane_w int32[G] maps each lane to
    its window. Identical math per lane; the lane axis replaces the
    (window x candidate) grid so invalid candidates cost nothing."""
    pi, pq = _padded_signals(sig_i, sig_q)
    wr, wi = _lane_windows(pi, pq, lane_w, shift)  # (G, WLEN)
    return _fine_sync_core(wr, wi, freq, shift, drift, lagstep)


def jitter_offsets(iifac: int = 3, quickmode: bool = False) -> np.ndarray:
    """The DT peak-up schedule 0, -1, +1, -2, +2, ... times iifac
    (wsprd/wsprd.c:741-745); quickmode tries only the first."""
    n = 1 if quickmode else (128 // iifac) + 1
    out = []
    for idt in range(n):
        ii = (idt + 1) // 2
        if idt % 2 == 1:
            ii = -ii
        out.append(iifac * ii)
    return np.asarray(out, dtype=np.int32)


class JitteredSymbols(NamedTuple):
    symbols: jnp.ndarray  # uint8[J, C, 162] soft symbols (128 = erasure)
    sync: jnp.ndarray     # float32[J, C] mode-2 sync metric
    rms: jnp.ndarray      # float32[J, C] soft-symbol RMS


def _soft_symbols_core(
    wr: jnp.ndarray,
    wi: jnp.ndarray,
    freq: jnp.ndarray,
    drift: jnp.ndarray,
    iifac: int,
    quickmode: bool,
    symfac: int,
) -> JitteredSymbols:
    """Shared mode-2 body over already-built (C, WLEN) windows.

    All jitter attempts evaluate in ONE offset-tensorized matmul; the
    J axis stays in schedule order (0, -ii, +ii, ...) so downstream
    first-success selection keeps the reference's jitter-loop
    semantics (wsprd/wsprd.c:739-766)."""
    offs = tuple(int(o) + HALF_SPAN
                 for o in jitter_offsets(iifac, quickmode))
    p = _tone_mags_offsets(wr, wi, freq, drift, offs)  # (C,162,J,4)
    pj = jnp.moveaxis(p, 2, 0)                         # (J,C,162,4)
    sync = _sync_from_powers(pj)                       # (J,C)
    pr3 = jnp.asarray(_PR3)
    # fsymb = p3-p1 (pr3=1) else p2-p0 (wsprd/wsprd.c:219-225)
    fsymb = jnp.where(pr3[None, None, :],
                      pj[..., 3] - pj[..., 1], pj[..., 2] - pj[..., 0])
    fsum = jnp.sum(fsymb / NSYM, axis=-1, keepdims=True)
    f2sum = jnp.sum(fsymb * fsymb / NSYM, axis=-1, keepdims=True)
    fac = jnp.sqrt(jnp.maximum(f2sum - fsum * fsum, 1e-30))
    fs = symfac * fsymb / fac
    fs = jnp.clip(fs, -128.0, 127.0)
    # C: symbols[i] = (uchar)(fsymb[i] + 128) truncates toward zero;
    # fs+128 >= 0 so trunc == floor
    sym = jnp.floor(fs + 128.0).astype(jnp.uint8)      # (J,C,162)
    y = sym.astype(jnp.float32) - 128.0
    rms = jnp.sqrt(jnp.sum(y * y, axis=-1) / NSYM)     # (J,C)
    return JitteredSymbols(symbols=sym, sync=sync, rms=rms)


@partial(jax.jit, static_argnames=("iifac", "quickmode", "symfac"))
def soft_symbols_jittered(
    sig_i: jnp.ndarray,
    sig_q: jnp.ndarray,
    freq: jnp.ndarray,
    shift: jnp.ndarray,
    drift: jnp.ndarray,
    iifac: int = 3,
    quickmode: bool = False,
    symfac: int = 50,
) -> JitteredSymbols:
    """Mode-2 soft symbols for every jitter attempt of every candidate
    (wsprd/wsprd.c:739-766 jitter loop; mode-2 body :219-256)."""
    pi, pq = _padded_signal(sig_i, sig_q)
    wr, wi = _candidate_windows(pi, pq, shift)  # (C, WLEN)
    return _soft_symbols_core(wr, wi, freq, drift, iifac, quickmode, symfac)


def soft_symbols_lanes(
    sig_i: jnp.ndarray,
    sig_q: jnp.ndarray,
    lane_w: jnp.ndarray,
    freq: jnp.ndarray,
    shift: jnp.ndarray,
    drift: jnp.ndarray,
    iifac: int = 3,
    quickmode: bool = False,
    symfac: int = 50,
) -> JitteredSymbols:
    """Mode-2 soft symbols over candidate lanes compacted across a
    window batch (see fine_sync_lanes)."""
    pi, pq = _padded_signals(sig_i, sig_q)
    wr, wi = _lane_windows(pi, pq, lane_w, shift)  # (G, WLEN)
    return _soft_symbols_core(wr, wi, freq, drift, iifac, quickmode, symfac)
