"""Polyphase decimation: XLA reference path + streaming runtime.

Both stages use the same partial-product scheme: with T = tpp * R, the
input reshapes (free) to rows[(n_frames + tpp - 1), R] and ONE matmul
``rows @ H`` with H float32[R, 2*tpp] produces every phase's partial
output; frame m is then the shifted diagonal sum

    y[m] = sum_t P[m + t, 2t (+1)]        (tpp cheap slice-adds).

Unlike an im2col formulation — which materializes each input sample
tpp times (8x for stage 1, 30x for stage 2) — every input sample is
read ONCE, so the kernel runs at HBM streaming bandwidth; there is no
scan, so per-step dispatch overhead vanishes and any leading batch
dims (channels) ride the same matmul. uint8 inputs convert to centered
float32 on DEVICE (the reference's XOR 0x80, rtlsdr_wsprd.c:171), so
raw RTL bytes cross the host->device link at 1 byte/sample.

The reference's equivalent is the per-sample C loop at
rtlsdr_wsprd.c:184-234 (CIC + FIR); parity is spectral + end-to-end,
not bitwise (SURVEY.md section 7).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .filters import (
    R1,
    R2,
    STAGE1_TAPS,
    STAGE2_TAPS,
    conv_order,
    stage1_coeffs,
    stage2_coeffs,
)


def _pp_split(g: np.ndarray, R: int) -> tuple[np.ndarray, np.ndarray]:
    """conv-ordered complex coeffs g[T] -> (Htop, Hbot) float32[R, 2*tpp]
    partial-product matrices: P = rowsI @ Htop + rowsQ @ Hbot, with
    column 2t the I partial of phase t and 2t+1 the Q partial.

    Derivation: y[m] = sum_k g[k] x[mR + k]; write k = tR + p, so
    y[m] = sum_t (rows @ g[tR:(t+1)R])[m + t]. Complex filter on planar
    I/Q: yI = xI*Re(g) - xQ*Im(g), yQ = xI*Im(g) + xQ*Re(g).
    """
    T = g.shape[0]
    tpp = T // R
    gr = np.real(g).astype(np.float32).reshape(tpp, R)
    gi = np.imag(g).astype(np.float32).reshape(tpp, R)
    top = np.zeros((R, 2 * tpp), np.float32)
    bot = np.zeros((R, 2 * tpp), np.float32)
    top[:, 0::2] = gr.T
    top[:, 1::2] = gi.T
    bot[:, 0::2] = -gi.T
    bot[:, 1::2] = gr.T
    return top, bot


_PP = None


def _pp_mats():
    """Partial-product filter matrices as NUMPY constants
    (H1top, H1bot, H2top, H2bot)."""
    global _PP
    if _PP is None:
        g1 = conv_order(stage1_coeffs())
        g2 = conv_order(stage2_coeffs().astype(np.complex64))
        _PP = (*_pp_split(g1, R1), *_pp_split(g2, R2))
    return _PP


# Matmul precision of both polyphase stages. DEFAULT lets the GPU run
# the float32 operands as TF32 (10-bit mantissa; uint8 input samples are
# exact in it); chip_smoke.py measures the error of both DEFAULT and
# HIGHEST against a float64 polyphase reference.
PRECISION = jax.lax.Precision.DEFAULT


def _center_f32(x: jnp.ndarray) -> jnp.ndarray:
    """uint8 RTL bytes -> centered float32 on device; floats pass
    through (already centered)."""
    if x.dtype == jnp.uint8:
        return x.astype(jnp.float32) - 128.0
    return x.astype(jnp.float32)


@partial(jax.jit, static_argnames=("n_frames", "precision"))
def _polyphase_pp(xI, xQ, Htop, Hbot, n_frames: int, precision=PRECISION):
    """xI/xQ: float32 or uint8[..., n_frames*R + T - R]; returns planar
    (float32[..., n_frames], float32[..., n_frames]). Leading dims are
    batch (channels)."""
    R = Htop.shape[0]
    tpp = Htop.shape[1] // 2
    fI = _center_f32(xI)
    fQ = _center_f32(xQ)
    lead = fI.shape[:-1]
    rowsI = fI.reshape(*lead, n_frames + tpp - 1, R)
    rowsQ = fQ.reshape(*lead, n_frames + tpp - 1, R)
    kw = dict(precision=precision, preferred_element_type=jnp.float32)
    P = jnp.dot(rowsI, Htop, **kw) + jnp.dot(rowsQ, Hbot, **kw)
    yI = P[..., 0:n_frames, 0]
    yQ = P[..., 0:n_frames, 1]
    for t in range(1, tpp):
        yI = yI + P[..., t:t + n_frames, 2 * t]
        yQ = yQ + P[..., t:t + n_frames, 2 * t + 1]
    return yI, yQ


def decimate_stage1_xla(xI: jnp.ndarray, xQ: jnp.ndarray,
                        n_frames: int, precision=PRECISION):
    """2.4 Msps planar float32 (or raw uint8) -> 30 ksps planar (I, Q)
    float32 (fs/4 mix folded in). Input length must be
    n_frames*R1 + STAGE1_TAPS - R1; leading batch dims allowed.
    """
    H1t, H1b, _, _ = _pp_mats()
    return _polyphase_pp(xI, xQ, H1t, H1b, n_frames, precision)


def decimate_stage1_batched(xI: jnp.ndarray, xQ: jnp.ndarray,
                            n_frames: int, precision=PRECISION):
    """Stage-1 polyphase over a CHANNEL batch: (C, L) planar float32 or
    uint8 -> (C, n_frames) planar, L = n_frames*R1 + STAGE1_TAPS - R1.

    Same kernel as decimate_stage1_xla (the partial-product matmul is
    batch-agnostic); the alias exists because the production ingest
    path is many channels in lockstep and single-stream callers
    predate the unification.
    """
    return decimate_stage1_xla(xI, xQ, n_frames, precision)


def decimate_stage2_xla(midI: jnp.ndarray, midQ: jnp.ndarray,
                        n_frames: int):
    """30 ksps planar -> 375 sps planar (I, Q) float32.

    Input length must be n_frames*R2 + STAGE2_TAPS - R2; leading batch
    dims allowed.
    """
    _, _, H2t, H2b = _pp_mats()
    return _polyphase_pp(midI, midQ, H2t, H2b, n_frames)


def decimate_stage2_batched(midI: jnp.ndarray, midQ: jnp.ndarray,
                            n_frames: int):
    """Stage-2 polyphase over a channel batch: (C, L2) -> (C, n_frames),
    L2 = n_frames*R2 + STAGE2_TAPS - R2."""
    return decimate_stage2_xla(midI, midQ, n_frames)


def decimate_window(
    rawI: np.ndarray, rawQ: np.ndarray, n_out: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """One-shot 2.4 Msps -> 375 sps planar (I, Q) for a whole capture.

    rawI/rawQ: uint8 or float planar arrays (same length). Output is
    time-aligned so out[m] ~ input time m*6400 (half-filter priming).
    """
    L = rawI.shape[0]
    prime1 = STAGE1_TAPS // 2
    if rawI.dtype == np.uint8:
        xI = np.empty(L + prime1, np.float32)
        xQ = np.empty(L + prime1, np.float32)
        xI[:prime1] = 0.0
        xQ[:prime1] = 0.0
        xI[prime1:] = rawI.astype(np.float32) - 128.0
        xQ[prime1:] = rawQ.astype(np.float32) - 128.0
    else:
        xI = np.concatenate([np.zeros(prime1, np.float32),
                             rawI.astype(np.float32)])
        xQ = np.concatenate([np.zeros(prime1, np.float32),
                             rawQ.astype(np.float32)])

    n_mid = (xI.shape[0] - (STAGE1_TAPS - R1)) // R1
    need = n_mid * R1 + STAGE1_TAPS - R1
    midI, midQ = decimate_stage1_xla(
        jnp.asarray(xI[:need]), jnp.asarray(xQ[:need]), n_mid)

    prime2 = STAGE2_TAPS // 2
    z = jnp.zeros(prime2, jnp.float32)
    midI = jnp.concatenate([z, midI])
    midQ = jnp.concatenate([z, midQ])
    n_final = (midI.shape[0] - (STAGE2_TAPS - R2)) // R2
    if n_out is not None:
        n_final = min(n_final, n_out)
    need2 = n_final * R2 + STAGE2_TAPS - R2
    outI, outQ = decimate_stage2_xla(midI[:need2], midQ[:need2], n_final)
    return np.asarray(outI), np.asarray(outQ)


class StreamingDecimator:
    """Stateful overlap-save streaming front end (host-driven).

    The reference carries CIC/FIR state in C statics across USB
    callbacks (rtlsdr_wsprd.c:129-156); here the state is explicit:
    float32 tails of (STAGE1_TAPS - R1) input samples and
    (STAGE2_TAPS - R2) mid-rate samples, primed half-filter for time
    alignment. ``push`` accepts arbitrary-size planar chunks and
    returns whatever 375 sps samples become available.
    """

    # work-size quanta: frame counts are static shapes under jit, so
    # processing only in these multiples bounds the number of compiled
    # executables regardless of push chunk sizes
    QUANT1 = 7500   # stage-1 output frames (0.25 s of mid-rate)
    QUANT2 = 125    # stage-2 output frames (1/3 s of baseband)

    def __init__(self):
        prime1 = STAGE1_TAPS // 2
        prime2 = STAGE2_TAPS // 2
        # prime half a filter of zeros so output m ~ input time m*6400
        self._bufI = np.zeros(prime1, np.float32)
        self._bufQ = np.zeros(prime1, np.float32)
        self._midI = np.zeros(prime2, np.float32)
        self._midQ = np.zeros(prime2, np.float32)
        self._tail1 = STAGE1_TAPS - R1
        self._tail2 = STAGE2_TAPS - R2

    def push(self, rawI: np.ndarray, rawQ: np.ndarray,
             exact: bool = False) -> tuple[np.ndarray, np.ndarray]:
        """Feed a chunk; returns newly available planar (I, Q) 375 sps
        samples. ``exact=True`` (flush) processes every whole frame
        available instead of quantized work sizes."""
        if rawI.dtype == np.uint8:
            fI = rawI.astype(np.float32) - 128.0
            fQ = rawQ.astype(np.float32) - 128.0
        else:
            fI = rawI.astype(np.float32)
            fQ = rawQ.astype(np.float32)
        self._bufI = np.concatenate([self._bufI, fI])
        self._bufQ = np.concatenate([self._bufQ, fQ])

        n_mid = (self._bufI.shape[0] - self._tail1) // R1
        if not exact:
            n_mid -= n_mid % self.QUANT1
        if n_mid > 0:
            need = n_mid * R1 + self._tail1
            mi, mq = decimate_stage1_xla(
                jnp.asarray(self._bufI[:need]),
                jnp.asarray(self._bufQ[:need]), n_mid)
            consumed = n_mid * R1
            self._bufI = self._bufI[consumed:]
            self._bufQ = self._bufQ[consumed:]
            self._midI = np.concatenate([self._midI, np.asarray(mi)])
            self._midQ = np.concatenate([self._midQ, np.asarray(mq)])

        n_out = (self._midI.shape[0] - self._tail2) // R2
        if not exact:
            n_out -= n_out % self.QUANT2
        if n_out <= 0:
            return np.zeros(0, np.float32), np.zeros(0, np.float32)
        need2 = n_out * R2 + self._tail2
        oi, oq = decimate_stage2_xla(jnp.asarray(self._midI[:need2]),
                                     jnp.asarray(self._midQ[:need2]), n_out)
        self._midI = self._midI[n_out * R2:]
        self._midQ = self._midQ[n_out * R2:]
        return np.asarray(oi), np.asarray(oq)

    def flush(self) -> tuple[np.ndarray, np.ndarray]:
        """Drain every whole output frame still in the pipeline."""
        return self.push(np.zeros(0, np.float32), np.zeros(0, np.float32),
                         exact=True)


@partial(jax.jit, static_argnames=("n_mid", "precision"))
def _fused_frontend_step(rawI, rawQ, m2I, m2Q, n_mid: int,
                         precision=PRECISION):
    """One fused stage-1 + stage-2 device step for C channels.

    rawI/rawQ: uint8|float32[C, n_mid*R1 + tail1] raw chunk (the 560
    tail-overlap samples are re-sent — ~0.23 ms of stream); m2I/m2Q:
    float32[C, m] DEVICE-RESIDENT mid-rate carry. Returns (outI, outQ,
    new m2I, new m2Q). The 30 ksps intermediate never touches the host
    — one dispatch and one raw upload per step, the XLA analog of the
    reference's single-pass CIC+FIR chain (rtlsdr_wsprd.c:184-234).
    With n_mid a multiple of R2 the carry shape is fixed at tail2 from
    the second step on, so steady state reuses one executable."""
    H1t, H1b, H2t, H2b = _pp_mats()
    tail2 = STAGE2_TAPS - R2
    mi, mq = _polyphase_pp(rawI, rawQ, H1t, H1b, n_mid, precision)
    midI = jnp.concatenate([m2I, mi], axis=1)
    midQ = jnp.concatenate([m2Q, mq], axis=1)
    n_out = (midI.shape[1] - tail2) // R2
    need2 = n_out * R2
    oi, oq = _polyphase_pp(midI[:, :need2 + tail2],
                           midQ[:, :need2 + tail2], H2t, H2b, n_out,
                           precision)
    return oi, oq, midI[:, need2:], midQ[:, need2:]


class BatchedStreamingDecimator:
    """Stateful streaming front end for C channels in lockstep.

    Production many-dongle/many-band ingest: all channels receive the
    same-size chunk each ``push`` (a multi-channel source naturally
    delivers aligned blocks), so ONE fused stage-1+stage-2 device call
    advances every stream; the mid-rate carry stays device-resident
    (_fused_frontend_step). Per-row math is identical to
    StreamingDecimator; states are (C, n) planes.

    uint8 chunks stay uint8 on the host AND across the host->device
    link (centered on device inside the stage-1 kernel) — a quarter of
    the ingest transfer bytes, the production raw-RTL path. Mixed-dtype
    streams upconvert the carry buffer once.
    """

    # steady-state work quantum: stage-1 output frames per fused step.
    # A multiple of R2 (80) keeps the device mid carry at a FIXED
    # tail2 length, so every steady-state step hits one executable.
    QUANT1 = 8000

    def __init__(self, n_channels: int):
        C = n_channels
        prime1 = STAGE1_TAPS // 2
        prime2 = STAGE2_TAPS // 2
        # raw carry starts empty-dtype-agnostic: the first nonempty push
        # decides uint8 vs float32 (prime pad = 128 <-> 0.0 centered)
        self._bufI: np.ndarray | None = None
        self._bufQ: np.ndarray | None = None
        self._prime1 = prime1
        # device-resident mid-rate carry, primed half a stage-2 filter
        self._m2I = jnp.zeros((C, prime2), jnp.float32)
        self._m2Q = jnp.zeros((C, prime2), jnp.float32)
        self._tail1 = STAGE1_TAPS - R1
        self._tail2 = STAGE2_TAPS - R2
        self._C = C

    def _prime_raw(self, dtype) -> None:
        fill = 128 if dtype == np.uint8 else 0
        self._bufI = np.full((self._C, self._prime1), fill, dtype)
        self._bufQ = np.full((self._C, self._prime1), fill, dtype)

    def push(self, rawI: np.ndarray, rawQ: np.ndarray,
             exact: bool = False) -> tuple[np.ndarray, np.ndarray]:
        """Feed (C, n) planar chunks (uint8 or float); returns newly
        available (C, m) planar 375 sps samples (m can be 0)."""
        in_dtype = (np.uint8 if rawI.dtype == np.uint8 else np.float32)
        if self._bufI is None:
            self._prime_raw(in_dtype)
        if in_dtype != self._bufI.dtype and rawI.size > 0:
            if self._bufI.dtype == np.uint8:  # upconvert carry once
                self._bufI = self._bufI.astype(np.float32) - 128.0
                self._bufQ = self._bufQ.astype(np.float32) - 128.0
            else:  # float carry continues; center incoming u8 on host
                rawI = rawI.astype(np.float32) - 128.0
                rawQ = rawQ.astype(np.float32) - 128.0
        if rawI.size > 0:
            self._bufI = np.concatenate(
                [self._bufI, np.asarray(rawI, self._bufI.dtype)], axis=1)
            self._bufQ = np.concatenate(
                [self._bufQ, np.asarray(rawQ, self._bufQ.dtype)], axis=1)

        C = self._bufI.shape[0]
        n_mid = (self._bufI.shape[1] - self._tail1) // R1
        if not exact:
            n_mid -= n_mid % self.QUANT1
            if n_mid <= 0:
                return (np.zeros((C, 0), np.float32),
                        np.zeros((C, 0), np.float32))
            need = n_mid * R1 + self._tail1
            oi, oq, self._m2I, self._m2Q = _fused_frontend_step(
                jnp.asarray(self._bufI[:, :need]),
                jnp.asarray(self._bufQ[:, :need]),
                self._m2I, self._m2Q, n_mid)
            self._bufI = self._bufI[:, n_mid * R1:]
            self._bufQ = self._bufQ[:, n_mid * R1:]
            return np.asarray(oi), np.asarray(oq)

        # exact (flush) path: arbitrary remainder sizes, host-driven
        midI, midQ = np.asarray(self._m2I), np.asarray(self._m2Q)
        if n_mid > 0:
            need = n_mid * R1 + self._tail1
            mi, mq = decimate_stage1_batched(
                jnp.asarray(self._bufI[:, :need]),
                jnp.asarray(self._bufQ[:, :need]), n_mid)
            self._bufI = self._bufI[:, n_mid * R1:]
            self._bufQ = self._bufQ[:, n_mid * R1:]
            midI = np.concatenate([midI, np.asarray(mi)], axis=1)
            midQ = np.concatenate([midQ, np.asarray(mq)], axis=1)
        n_out = (midI.shape[1] - self._tail2) // R2
        if n_out <= 0:
            self._m2I, self._m2Q = jnp.asarray(midI), jnp.asarray(midQ)
            return (np.zeros((C, 0), np.float32),
                    np.zeros((C, 0), np.float32))
        need2 = n_out * R2 + self._tail2
        oi, oq = decimate_stage2_batched(
            jnp.asarray(midI[:, :need2]), jnp.asarray(midQ[:, :need2]),
            n_out)
        self._m2I = jnp.asarray(midI[:, n_out * R2:])
        self._m2Q = jnp.asarray(midQ[:, n_out * R2:])
        return np.asarray(oi), np.asarray(oq)

    def flush(self) -> tuple[np.ndarray, np.ndarray]:
        """Drain every whole output frame still in the pipeline."""
        C = self._bufI.shape[0]
        return self.push(np.zeros((C, 0), np.float32),
                         np.zeros((C, 0), np.float32), exact=True)
