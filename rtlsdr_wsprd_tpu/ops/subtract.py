"""Decoded-signal subtraction for multi-pass decoding (planar real).

``subtract_signal2`` is the production path (wsprd/wsprd.c:315-413,
invoked at :785): regenerate the decoded transmission as a
continuous-phase 4-FSK reference r(t), estimate the channel's complex
envelope c(t) = LPF[s(t) * conj(r(t))] with a 360-tap half-sine FIR,
and subtract c(t) * r(t) with partial-sum edge normalization.

``subtract_signal`` is the simpler per-symbol variant the reference
defines but never calls (wsprd/wsprd.c:263-312); implemented for API
parity.

Complex arithmetic is planar (re, im) float32; the LPF is a chunked
im2col matvec (the conv primitive is avoided entirely, which also
sidesteps backend conv support).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DF, DT, NSPERSYM, NSYM, SIGNAL_SAMPLES

TWOPIDT = 2.0 * np.pi * DT
NFILT = 360  # LPF taps (wsprd/wsprd.c:326)
NSIG = NSYM * NSPERSYM  # 41472 reference samples
# headroom for dynamic_slice window extraction: sync shifts span about
# [-1300, 3100] (coarse 128*(k0+1), k0 in -10..21, plus fine lag and
# jitter); anything outside +/- _PAD clamps and is gate-rejected anyway
_PAD = 8192


def _halfsine_taps() -> tuple[np.ndarray, np.ndarray]:
    """Normalized half-sine LPF and its partial sums
    (wsprd/wsprd.c:353-368)."""
    w = np.sin(np.pi * np.arange(NFILT, dtype=np.float64) / (NFILT - 1))
    w = (w / w.sum()).astype(np.float32)
    partial = np.concatenate([[0.0], np.cumsum(w[1:])]).astype(np.float32)
    return w, partial


_W, _PARTIAL = _halfsine_taps()

_NFRAME = SIGNAL_SAMPLES // NFILT  # 125 frames of NFILT samples


def _toeplitz_w3() -> np.ndarray:
    """Block-Toeplitz matrix turning the 'same' FIR into ONE matmul.

    Split x into 125 frames of 360; y's frame m depends only on x's
    frames m-1, m, m+1 (the filter spans 360 samples), so with
    xcat[m, j] = x[(m-1)*360 + j], j in [0, 1080):
        y[m*360 + t] = sum_k w[k] x[m*360 + t + 179 - k]
                     = sum_j xcat[m, j] * W3[j, t],
    W3[j, t] = w[t + 539 - j] where that index is in [0, 360).
    (125, 1080) @ (1080, 360) is one dense matmul — no gather, no scan.
    """
    w3 = np.zeros((3 * NFILT, NFILT), np.float32)
    j = np.arange(3 * NFILT)[:, None]
    t = np.arange(NFILT)[None, :]
    k = t + 539 - j
    ok = (k >= 0) & (k < NFILT)
    w3[ok] = _W[k[ok]]
    return w3


_W3 = _toeplitz_w3()


def _fir_same(x: jnp.ndarray) -> jnp.ndarray:
    """numpy-convolve-'same' half-sine FIR: y[n] = sum_k w[k] x[n+179-k].

    One block-Toeplitz matmul (see _toeplitz_w3); x: float32[45000].
    """
    xp = jnp.pad(x, (NFILT, NFILT))  # covers x[n-180 .. n+179] at edges
    xcat = jnp.concatenate([
        xp[0:SIGNAL_SAMPLES].reshape(_NFRAME, NFILT),
        xp[NFILT:NFILT + SIGNAL_SAMPLES].reshape(_NFRAME, NFILT),
        xp[2 * NFILT:2 * NFILT + SIGNAL_SAMPLES].reshape(_NFRAME, NFILT),
    ], axis=1)                                     # (125, 1080)
    # precision="highest": a default-precision float32 matmul may round
    # operands to TF32 or bfloat16 on an accelerator; the subtraction
    # rewrites SAMPLES, so a -48 dB filter error would leak into the
    # pass-2 residual right at the weak-signal floor
    y = jnp.dot(xcat, jnp.asarray(_W3), precision="highest",
                preferred_element_type=jnp.float32)
    return y.reshape(-1)


def _reference_signal(f0, drift, symbols: jnp.ndarray):
    """Continuous-phase 4-FSK reference r(t), planar (re, im)
    float32[41472] (wsprd/wsprd.c:339-351)."""
    i = jnp.arange(NSYM, dtype=jnp.float32)
    cs = symbols.astype(jnp.float32)
    fsym = f0 + (drift / 2.0) * (i - NSYM / 2.0) / (NSYM / 2.0) + (cs - 1.5) * DF
    dphi = TWOPIDT * fsym                       # per-sample increment per symbol
    incr = jnp.repeat(dphi, NSPERSYM)           # (41472,)
    phi = jnp.concatenate([jnp.zeros(1), jnp.cumsum(incr)[:-1]])
    return jnp.cos(phi), jnp.sin(phi)


@jax.jit
def subtract_signal2(
    sig_i: jnp.ndarray,   # float32[SIGNAL_SAMPLES], window I plane
    sig_q: jnp.ndarray,   # float32[SIGNAL_SAMPLES], window Q plane
    f0: jnp.ndarray,      # scalar float32
    shift: jnp.ndarray,   # scalar int32
    drift: jnp.ndarray,   # scalar float32
    symbols: jnp.ndarray  # uint8[162] channel symbols of the decode
):
    """Return (i, q) with the decoded signal coherently removed."""
    rr, ri = _reference_signal(f0, drift, symbols)  # (41472,) x2

    # s(t) * conj(r(t)) at k = shift + i, valid for 0 < k < np
    # (wsprd/wsprd.c:375-381); the C pads NFILT zeros in front.
    # k is CONTIGUOUS, so the extract is a dynamic_slice on a padded
    # plane and the write-back a dynamic_update_slice — no generic
    # gather/scatter.
    i = jnp.arange(NSIG, dtype=jnp.int32)
    k = shift + i
    ok = (k > 0) & (k < SIGNAL_SAMPLES)
    pad_i = jnp.pad(sig_i, (_PAD, _PAD))
    pad_q = jnp.pad(sig_q, (_PAD, _PAD))
    start = (shift + _PAD,)
    sr = jnp.where(ok, jax.lax.dynamic_slice(pad_i, start, (NSIG,)), 0.0)
    si = jnp.where(ok, jax.lax.dynamic_slice(pad_q, start, (NSIG,)), 0.0)
    # s * conj(r)
    cr0 = sr * rr + si * ri
    ci0 = si * rr - sr * ri
    cr = jax.lax.dynamic_update_slice(
        jnp.zeros(SIGNAL_SAMPLES, sig_i.dtype), cr0, (NFILT,))
    ci = jax.lax.dynamic_update_slice(
        jnp.zeros(SIGNAL_SAMPLES, sig_i.dtype), ci0, (NFILT,))

    # 360-tap half-sine LPF, output restricted to
    # [NFILT/2, SIGNAL_SAMPLES - NFILT/2) (wsprd/wsprd.c:384-391)
    cfr = _fir_same(cr)
    cfi = _fir_same(ci)
    pos = jnp.arange(SIGNAL_SAMPLES)
    keep = (pos >= NFILT // 2) & (pos < SIGNAL_SAMPLES - NFILT // 2)
    cfr = jnp.where(keep, cfr, 0.0)
    cfi = jnp.where(keep, cfi, 0.0)

    # edge normalization by the filter's partial step response
    # (wsprd/wsprd.c:397-411)
    partial = jnp.asarray(_PARTIAL)
    norm = jnp.where(
        i < NFILT // 2, partial[NFILT // 2 + i],
        jnp.where(i > NSIG - 1 - NFILT // 2,
                  partial[jnp.clip(NFILT // 2 + NSIG - 1 - i, 0, NFILT - 1)],
                  1.0),
    )
    gr = jax.lax.slice(cfr, (NFILT,), (NFILT + NSIG,)) / norm
    gi = jax.lax.slice(cfi, (NFILT,), (NFILT + NSIG,)) / norm
    # delta = c(t) * r(t), written back through the same padded plane
    dr = jnp.where(ok, gr * rr - gi * ri, 0.0)
    di = jnp.where(ok, gr * ri + gi * rr, 0.0)
    zeros_pad = jnp.zeros(SIGNAL_SAMPLES + 2 * _PAD, sig_i.dtype)
    full_i = jax.lax.dynamic_update_slice(zeros_pad, dr, start)
    full_q = jax.lax.dynamic_update_slice(zeros_pad, di, start)
    out_i = sig_i - jax.lax.slice(full_i, (_PAD,), (_PAD + SIGNAL_SAMPLES,))
    out_q = sig_q - jax.lax.slice(full_q, (_PAD,), (_PAD + SIGNAL_SAMPLES,))
    return out_i, out_q


def _subtract_one_masked(sig_i, sig_q, f0, shift, drift, symbols, enable):
    ni, nq = subtract_signal2(sig_i, sig_q, f0, shift, drift, symbols)
    return (jnp.where(enable, ni, sig_i), jnp.where(enable, nq, sig_q))


@jax.jit
def subtract_rows(sig_i, sig_q, bidx, f0, shift, drift, symbols, enable):
    """Device-resident batched subtraction: apply one decode per ROW of
    a (B, SIGNAL_SAMPLES) window batch, in place (functionally).

    bidx int32[R] selects the row each lane updates; enable bool[R]
    masks padding lanes. Updates are applied as ADDed deltas, so
    disabled lanes (delta 0) can share a row index with an enabled
    lane safely; two ENABLED lanes must not target the same row (one
    decode per channel per round, wsprd/wsprd.c:781-789 sequencing is
    kept by the caller's round loop).

    The row pick and write-back are one-hot matmuls, NOT
    gather/scatter over (R, 45000) rows."""
    B = sig_i.shape[0]
    sel = (bidx[:, None] == jnp.arange(B, dtype=bidx.dtype)[None, :])
    sel_f = sel.astype(sig_i.dtype)              # (R, B) one-hot rows
    # precision="highest" keeps the picked/written samples bit-exact: a
    # default-precision matmul may round float32 operands to TF32 or
    # bfloat16, which would corrupt every subtracted window's samples
    hp = dict(precision="highest", preferred_element_type=jnp.float32)
    row_i = jnp.dot(sel_f, sig_i, **hp)
    row_q = jnp.dot(sel_f, sig_q, **hp)
    ni, nq = jax.vmap(subtract_signal2)(row_i, row_q, f0, shift, drift,
                                        symbols)
    en = enable[:, None]
    di = jnp.where(en, ni - row_i, 0.0)
    dq = jnp.where(en, nq - row_q, 0.0)
    return (sig_i + jnp.dot(sel_f.T, di, **hp),
            sig_q + jnp.dot(sel_f.T, dq, **hp))


@jax.jit
def subtract_signal2_many(sig_i, sig_q, f0, shift, drift, symbols, enable):
    """Vmapped coherent subtraction: one decode per window lane.

    sig_i/sig_q: float32[N, SIGNAL_SAMPLES]; f0/drift float32[N];
    shift int32[N]; symbols uint8[N, 162]; enable bool[N] (False lanes
    pass through untouched — used to pad partial rounds). Decodes for
    the SAME window must go in separate sequential calls (each
    subtraction reads the previous result), matching the reference's
    sequential order (wsprd/wsprd.c:781-789).
    """
    return jax.vmap(_subtract_one_masked)(
        sig_i, sig_q, f0, shift, drift, symbols, enable)


@jax.jit
def subtract_signal(
    sig_i: jnp.ndarray, sig_q: jnp.ndarray, f0: jnp.ndarray,
    shift: jnp.ndarray, drift: jnp.ndarray, symbols: jnp.ndarray,
):
    """Per-symbol amplitude estimate and subtraction
    (wsprd/wsprd.c:263-312; defined but unused in the reference)."""
    i = jnp.arange(NSYM, dtype=jnp.float32)
    cs = symbols.astype(jnp.float32)
    # NB: this variant uses (i - NBITS)/NBITS like sync (wsprd/wsprd.c:274)
    fsym = f0 + (drift / 2.0) * (i - 81.0) / 81.0 + (cs - 1.5) * DF
    dphi = TWOPIDT * fsym  # (162,)
    # phase resets at each symbol (c0[0]=1, wsprd/wsprd.c:280-286)
    phase = dphi[:, None] * jnp.arange(NSPERSYM, dtype=jnp.float32)[None, :]
    er, ei = jnp.cos(phase), jnp.sin(phase)  # (162,256)

    k = (shift + (jnp.arange(NSYM)[:, None] * NSPERSYM)
         + jnp.arange(NSPERSYM)[None, :]).astype(jnp.int32)
    ok = (k > 0) & (k < SIGNAL_SAMPLES)
    kc = jnp.clip(k, 0, SIGNAL_SAMPLES - 1)
    sr = jnp.where(ok, sig_i[kc], 0.0)
    si = jnp.where(ok, sig_q[kc], 0.0)
    # amp = mean(s * conj(e)) per symbol
    ar = jnp.sum(sr * er + si * ei, axis=1) / NSPERSYM  # (162,)
    ai = jnp.sum(si * er - sr * ei, axis=1) / NSPERSYM
    dr = ar[:, None] * er - ai[:, None] * ei
    di = ar[:, None] * ei + ai[:, None] * er
    out_i = sig_i.at[kc.ravel()].add(jnp.where(ok, -dr, 0.0).ravel())
    out_q = sig_q.at[kc.ravel()].add(jnp.where(ok, -di, 0.0).ravel())
    return out_i, out_q
