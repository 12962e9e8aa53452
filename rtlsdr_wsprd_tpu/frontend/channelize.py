"""Wideband channelizer: N WSPR dials from ONE 2.4 Msps capture.

The reference binds one dongle to one 200 Hz WSPR band
(rtlsdr_wsprd.c:1044-1124). A 2.4 Msps capture spans much more — the
tuned center sits at dial + 601.5 kHz, so the capture covers
dial - 598.5 kHz .. dial + 1801.5 kHz, which can hold several WSPR
dials (137/475 kHz LF+MF under direct sampling, 5.2887 + 7.0386 MHz
60m + 40m, ...). This module decodes ALL of them from the one stream.

Per dial k the needed heterodyne is exp(j*theta_k*n) with
theta_k = 2*pi*(tuned_dial - dial_k)/fs, which moves dial_k's band to
the -600 kHz slot the stage-1 polyphase expects
(frontend/filters.py). Rather than derotating the full-rate stream
(6 FLOP + table reads per raw sample PER DIAL), the heterodyne is
COMMUTED THROUGH THE DECIMATOR:

    sum_t g[t] * x[mR+t] * e^{j theta (mR+t)}
        = e^{j theta R m} * sum_t (g[t] e^{j theta t}) * x[mR+t]

so each dial gets its own folded stage-1 coefficients
g'_k[t] = g[t]*e^{j theta_k t} (640 complex taps — bytes, not a
full-rate table) and one residual rotation PER OUTPUT FRAME at the
30 ksps mid-rate — 80x fewer samples than derotate-first. Stage 2 is
shared (the band is at baseband after the rotation). On the device the
fused step reads the raw block once: rows @ H with H the K dials'
folded partial-product matrices concatenated into ONE matmul, so K
bands cost one band's link bytes and one band's HBM reads. Host
placement runs the identical math through the native C++ polyphase
(native/hostdsp.cpp) with per-dial taps.

Phase bookkeeping: a per-dial float64 scalar carries the stream phase
at the raw-carry buffer's origin (init -theta*prime1 for the zero
pad), advanced by exactly the consumed raw-sample count each step;
frame m's rotation is e^{j(phi + theta*R1*m)}. The window-constant
residual phase per dial is irrelevant to WSPR decode (validated:
zero-offset output equals the plain decimator).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .. import native
from .decimate import (
    PRECISION,
    _center_f32,
    _polyphase_pp,
    _pp_mats,
    _pp_split,
)
from .filters import R1, R2, STAGE1_TAPS, STAGE2_TAPS, conv_order, stage1_coeffs
from .host_decimate import _host_taps

FS = 2_400_000


def folded_stage1_taps(offsets_hz: np.ndarray) -> np.ndarray:
    """Per-dial conv-ordered complex stage-1 taps
    g'_k[t] = g[t] * e^{j theta_k t}, complex128[K, STAGE1_TAPS]."""
    g = conv_order(stage1_coeffs()).astype(np.complex128)
    t = np.arange(STAGE1_TAPS, dtype=np.float64)
    theta = 2.0 * np.pi * np.asarray(offsets_hz, np.float64) / FS
    return g[None, :] * np.exp(1j * theta[:, None] * t[None, :])


@partial(jax.jit, static_argnames=("n_mid",))
def _folded_frontend_step(rawI, rawQ, H1t, H1b, rotC, rotS, phC, phS,
                          m2I, m2Q, n_mid: int):
    """One fused stage-1(folded) + rotate + stage-2 step for K dials.

    rawI/rawQ: uint8|float32[L] single raw stream, L = n_mid*R1+tail1;
    H1t/H1b: float32[R1, K*2*tpp] concatenated per-dial folded
    partial-product matrices; rotC/rotS: float32[K, n_mid] mid-rate
    rotation tables cos/sin(theta_k*R1*m); phC/phS: float32[K, 1]
    carried phase scalars; m2I/m2Q: float32[K, m] device-resident mid
    carry. Returns (outI, outQ, new m2I, new m2Q).
    """
    _, _, H2t, H2b = _pp_mats()
    tail2 = STAGE2_TAPS - R2
    K = rotC.shape[0]
    cols = H1t.shape[1] // K
    tpp = cols // 2
    fI = _center_f32(rawI)
    fQ = _center_f32(rawQ)
    P = n_mid + tpp - 1
    rowsI = fI.reshape(P, R1)
    rowsQ = fQ.reshape(P, R1)
    # ONE matmul for all dials: (P, R1) @ (R1, K*2*tpp)
    kw = dict(precision=PRECISION, preferred_element_type=jnp.float32)
    Pm = jnp.dot(rowsI, H1t, **kw) + jnp.dot(rowsQ, H1b, **kw)
    Pk = jnp.transpose(Pm.reshape(P, K, cols), (1, 0, 2))  # (K, P, cols)
    mi = Pk[:, 0:n_mid, 0]
    mq = Pk[:, 0:n_mid, 1]
    for t in range(1, tpp):
        mi = mi + Pk[:, t:t + n_mid, 2 * t]
        mq = mq + Pk[:, t:t + n_mid, 2 * t + 1]
    # residual per-frame rotation e^{j(phi + theta*R1*m)} at 30 ksps
    c = phC * rotC - phS * rotS
    s = phC * rotS + phS * rotC
    ri = mi * c - mq * s
    rq = mi * s + mq * c
    midI = jnp.concatenate([m2I, ri], axis=1)
    midQ = jnp.concatenate([m2Q, rq], axis=1)
    n_out = (midI.shape[1] - tail2) // R2
    need2 = n_out * R2
    oi, oq = _polyphase_pp(midI[:, :need2 + tail2],
                           midQ[:, :need2 + tail2], H2t, H2b, n_out)
    return oi, oq, midI[:, need2:], midQ[:, need2:]


class ChannelizingStreamingDecimator:
    """Stateful streaming channelizer: push one raw stream, get K
    375 sps channels.

    ``offsets_hz[k] = tuned_dial - dial_k`` (0 for the tuned dial
    itself). Same push/flush contract as BatchedStreamingDecimator
    except the input is the single stream — (n,) or (1, n) planar
    uint8/float32 — and the output is (K, m) planar float32.
    ``placement``: "device" (one fused XLA step per push) or "host"
    (native C++ polyphase with per-dial folded taps, dials threaded).
    """

    # device stage-1 frames per fused step (multiple of R2). 24000 =
    # 0.8 s of stream per dispatch, so fixed per-dispatch cost (program
    # launch, transfer latency) amortizes over many samples while the
    # raw chunk stays small (1.92 M samples, ~7.7 MB f32 per plane).
    QUANT1 = 24_000

    def __init__(self, offsets_hz, placement: str = "device",
                 threads: int = 8):
        self.offsets = np.asarray(offsets_hz, np.float64)
        K = self.offsets.shape[0]
        self._K = K
        if placement not in ("device", "host"):
            raise ValueError(f"unknown placement: {placement!r}")
        if placement == "host" and not native.HAS_DECIMATE:
            raise RuntimeError("native hostdsp polyphase unavailable")
        self.placement = placement
        self._threads = threads
        prime1 = STAGE1_TAPS // 2
        prime2 = STAGE2_TAPS // 2
        self._prime1 = prime1
        self._tail1 = STAGE1_TAPS - R1
        self._tail2 = STAGE2_TAPS - R2
        self._theta = 2.0 * np.pi * self.offsets / FS

        # folded per-dial stage-1 taps (g' = g * e^{j theta t})
        gk = folded_stage1_taps(self.offsets)
        if placement == "device":
            tops, bots = [], []
            for k in range(K):
                t, b = _pp_split(gk[k].astype(np.complex64), R1)
                tops.append(t)
                bots.append(b)
            # concatenate along columns: (R1, K*2*tpp), one matmul
            self._H1t = jnp.asarray(np.concatenate(tops, axis=1))
            self._H1b = jnp.asarray(np.concatenate(bots, axis=1))
            self._m2I = jnp.zeros((K, prime2), jnp.float32)
            self._m2Q = jnp.zeros((K, prime2), jnp.float32)
        else:
            self._g1r = np.ascontiguousarray(np.real(gk), np.float32)
            self._g1i = np.ascontiguousarray(np.imag(gk), np.float32)
            self._g2 = _host_taps()[2]
            self._m2I_np = np.zeros((K, prime2), np.float32)
            self._m2Q_np = np.zeros((K, prime2), np.float32)

        # stream phase at buffer origin: the first prime1 entries are
        # the zero pad, so the origin starts at -theta*prime1
        self._phase = np.mod(-self._theta * prime1, 2.0 * np.pi)
        self._bufI: np.ndarray | None = None
        self._bufQ: np.ndarray | None = None
        self._rots: dict[tuple, tuple] = {}

    # -- shared helpers -----------------------------------------------------

    def _rot_tables(self, n_mid: int, device: bool):
        """cos/sin(theta_k * R1 * m), m = 0..n_mid-1 (float64 math)."""
        key = (n_mid, device)
        t = self._rots.get(key)
        if t is None:
            if len(self._rots) >= 8:  # bound memory under odd chunking
                self._rots.clear()
            ang = (self._theta[:, None] * R1) * np.arange(
                n_mid, dtype=np.float64)[None, :]
            c = np.cos(ang).astype(np.float32)
            s = np.sin(ang).astype(np.float32)
            if device:
                c, s = jnp.asarray(c), jnp.asarray(s)
            t = self._rots[key] = (c, s)
        return t

    def _advance_phase(self, n_raw: int) -> None:
        self._phase = np.mod(self._phase + self._theta * n_raw,
                             2.0 * np.pi)

    def _normalize_chunk(self, rawI, rawQ):
        """Prime the carry on first use and reconcile chunk/carry
        dtypes (u8 carry upconverts once to float; float carry centers
        incoming u8). Returns the chunk as contiguous arrays of the
        carry's dtype WITHOUT appending it."""
        in_dtype = (np.uint8 if rawI.dtype == np.uint8 else np.float32)
        if self._bufI is None:
            fill = 128 if in_dtype == np.uint8 else 0
            self._bufI = np.full(self._prime1, fill, in_dtype)
            self._bufQ = np.full(self._prime1, fill, in_dtype)
        if in_dtype != self._bufI.dtype and rawI.size > 0:
            if self._bufI.dtype == np.uint8:  # upconvert carry once
                self._bufI = self._bufI.astype(np.float32) - 128.0
                self._bufQ = self._bufQ.astype(np.float32) - 128.0
            else:
                rawI = rawI.astype(np.float32) - 128.0
                rawQ = rawQ.astype(np.float32) - 128.0
        return (np.ascontiguousarray(rawI, self._bufI.dtype),
                np.ascontiguousarray(rawQ, self._bufQ.dtype))

    def _append_raw(self, rawI, rawQ) -> None:
        rawI, rawQ = self._normalize_chunk(rawI, rawQ)
        if rawI.size > 0:
            self._bufI = np.concatenate([self._bufI, rawI])
            self._bufQ = np.concatenate([self._bufQ, rawQ])

    @staticmethod
    def _flat(raw: np.ndarray) -> np.ndarray:
        if raw.ndim == 2:
            assert raw.shape[0] == 1, "channelizer takes ONE raw stream"
            return raw[0]
        return raw

    # -- device placement ----------------------------------------------------

    def _push_device(self, exact: bool):
        K = self._K
        n_whole = (self._bufI.shape[0] - self._tail1) // R1
        n_mid = n_whole - (n_whole % (R2 if exact else self.QUANT1))
        if n_mid > 0:
            need = n_mid * R1 + self._tail1
            rotC, rotS = self._rot_tables(n_mid, device=True)
            phC = jnp.asarray(
                np.cos(self._phase).astype(np.float32)[:, None])
            phS = jnp.asarray(
                np.sin(self._phase).astype(np.float32)[:, None])
            oi, oq, self._m2I, self._m2Q = _folded_frontend_step(
                jnp.asarray(self._bufI[:need]),
                jnp.asarray(self._bufQ[:need]),
                self._H1t, self._H1b, rotC, rotS, phC, phS,
                self._m2I, self._m2Q, n_mid)
            self._bufI = self._bufI[n_mid * R1:]
            self._bufQ = self._bufQ[n_mid * R1:]
            self._advance_phase(n_mid * R1)
            out = np.asarray(oi), np.asarray(oq)
        else:
            out = (np.zeros((K, 0), np.float32),
                   np.zeros((K, 0), np.float32))
        if not exact:
            return out
        self._stage1_rest_device(n_whole - n_mid)
        rest = self._drain_mid_device()
        return (np.concatenate([out[0], rest[0]], axis=1),
                np.concatenate([out[1], rest[1]], axis=1))

    def _stage1_rest_device(self, n_rest: int) -> None:
        """Flush remainder stage-1 frames (< R2) into the mid carry via
        a small numpy evaluation of the same folded math, so flush
        loses no whole output frame while the steady-state fused step
        keeps one fixed executable."""
        if n_rest <= 0:
            return
        mi, mq = self._stage1_host_block(n_rest)
        self._m2I = jnp.concatenate([self._m2I, jnp.asarray(mi)], axis=1)
        self._m2Q = jnp.concatenate([self._m2Q, jnp.asarray(mq)], axis=1)

    def _drain_mid_device(self):
        from .decimate import decimate_stage2_batched

        midI, midQ = np.asarray(self._m2I), np.asarray(self._m2Q)
        n_out = (midI.shape[1] - self._tail2) // R2
        if n_out <= 0:
            return (np.zeros((self._K, 0), np.float32),
                    np.zeros((self._K, 0), np.float32))
        need2 = n_out * R2 + self._tail2
        oi, oq = decimate_stage2_batched(
            jnp.asarray(midI[:, :need2]), jnp.asarray(midQ[:, :need2]),
            n_out)
        self._m2I = jnp.asarray(midI[:, n_out * R2:])
        self._m2Q = jnp.asarray(midQ[:, n_out * R2:])
        return np.asarray(oi), np.asarray(oq)

    # -- host placement --------------------------------------------------------

    def _stage1_host_block(self, n_mid: int):
        """Folded stage-1 + rotation for the first n_mid frames of the
        raw carry, on host (numpy/native), consuming them. Returns
        rotated (K, n_mid) mid-rate planes."""
        K = self._K
        need = n_mid * R1 + self._tail1
        bi = self._bufI[:need]
        bq = self._bufQ[:need]
        mi = np.empty((K, n_mid), np.float32)
        mq = np.empty((K, n_mid), np.float32)
        if self.placement == "host" and native.HAS_DECIMATE:
            g1r, g1i = self._g1r, self._g1i

            def s1(k):
                mi[k], mq[k] = native.pp_decimate(
                    bi, bq, g1r[k], g1i[k], R1, n_mid)

            self._map_dials(s1, K)
        else:  # tiny flush remainders on the device placement
            gk = folded_stage1_taps(self.offsets).astype(np.complex64)
            if bi.dtype == np.uint8:
                fI = bi.astype(np.float32) - 128.0
                fQ = bq.astype(np.float32) - 128.0
            else:
                fI, fQ = bi.astype(np.float32), bq.astype(np.float32)
            z = fI + 1j * fQ
            for k in range(K):
                acc = np.zeros(n_mid, np.complex64)
                for m in range(n_mid):
                    acc[m] = np.dot(gk[k], z[m * R1:m * R1 + STAGE1_TAPS])
                mi[k], mq[k] = np.real(acc), np.imag(acc)
        ri, rq = self._rotate_mid(mi, mq, n_mid)
        self._bufI = self._bufI[n_mid * R1:]
        self._bufQ = self._bufQ[n_mid * R1:]
        self._advance_phase(n_mid * R1)
        return ri, rq

    def _rotate_mid(self, mi, mq, n_mid: int):
        """Apply the residual per-frame rotation e^{j(phi+theta*R1*m)}
        at the current carried phase (does NOT advance it)."""
        rotC, rotS = self._rot_tables(n_mid, device=False)
        cph = np.cos(self._phase).astype(np.float32)[:, None]
        sph = np.sin(self._phase).astype(np.float32)[:, None]
        c = cph * rotC - sph * rotS
        s = cph * rotS + sph * rotC
        return mi * c - mq * s, mi * s + mq * c

    def _map_dials(self, fn, n: int):
        if n == 1 or self._threads <= 1:
            for k in range(n):
                fn(k)
        else:
            with ThreadPoolExecutor(max_workers=min(self._threads,
                                                    n)) as ex:
                list(ex.map(fn, range(n)))

    def _push_host(self, rawI, rawQ):
        """Host steady-state step: stage 1 reads the caller's chunk in
        place — only frames spanning the carry/chunk boundary (the
        carry is < taps samples, so <= taps/R1 = 8 of them) go through
        a small stitch buffer, the same structure as
        HostBatchedStreamingDecimator.push."""
        K = self._K
        rawI, rawQ = self._normalize_chunk(rawI, rawQ)
        nc = self._bufI.shape[0]
        total = nc + rawI.shape[0]
        n_mid = (total - self._tail1) // R1
        if n_mid > 0:
            m_b = min(n_mid, -(-nc // R1))  # frames touching the carry
            take = m_b * R1 + self._tail1 - nc
            stI = np.concatenate([self._bufI, rawI[:take]])
            stQ = np.concatenate([self._bufQ, rawQ[:take]])
            off = m_b * R1 - nc
            n_bulk = n_mid - m_b
            end = off + n_bulk * R1 + self._tail1
            mi = np.empty((K, n_mid), np.float32)
            mq = np.empty((K, n_mid), np.float32)
            g1r, g1i = self._g1r, self._g1i

            def s1(k):
                mi[k, :m_b], mq[k, :m_b] = native.pp_decimate(
                    stI, stQ, g1r[k], g1i[k], R1, m_b)
                if n_bulk > 0:
                    mi[k, m_b:], mq[k, m_b:] = native.pp_decimate(
                        rawI[off:end], rawQ[off:end], g1r[k], g1i[k],
                        R1, n_bulk)

            self._map_dials(s1, K)
            ri, rq = self._rotate_mid(mi, mq, n_mid)
            pos = n_mid * R1
            if pos >= nc:
                self._bufI = rawI[pos - nc:].copy()
                self._bufQ = rawQ[pos - nc:].copy()
            else:
                self._bufI = np.concatenate([self._bufI[pos:], rawI])
                self._bufQ = np.concatenate([self._bufQ[pos:], rawQ])
            self._advance_phase(pos)
            self._m2I_np = np.concatenate([self._m2I_np, ri], axis=1)
            self._m2Q_np = np.concatenate([self._m2Q_np, rq], axis=1)
        elif rawI.size > 0:
            self._bufI = np.concatenate([self._bufI, rawI])
            self._bufQ = np.concatenate([self._bufQ, rawQ])
        n_out = (self._m2I_np.shape[1] - self._tail2) // R2
        if n_out <= 0:
            return (np.zeros((K, 0), np.float32),
                    np.zeros((K, 0), np.float32))
        need2 = n_out * R2 + self._tail2
        oi = np.empty((K, n_out), np.float32)
        oq = np.empty((K, n_out), np.float32)
        midI = np.ascontiguousarray(self._m2I_np[:, :need2])
        midQ = np.ascontiguousarray(self._m2Q_np[:, :need2])
        g2 = self._g2

        def s2(k):
            oi[k], oq[k] = native.fir_decimate(midI[k], midQ[k], g2,
                                               R2, n_out)

        self._map_dials(s2, K)
        self._m2I_np = self._m2I_np[:, n_out * R2:]
        self._m2Q_np = self._m2Q_np[:, n_out * R2:]
        return oi, oq

    # -- public API ------------------------------------------------------------

    def push(self, rawI: np.ndarray, rawQ: np.ndarray,
             exact: bool = False) -> tuple[np.ndarray, np.ndarray]:
        rawI, rawQ = self._flat(rawI), self._flat(rawQ)
        if self.placement == "host":
            return self._push_host(rawI, rawQ)
        self._append_raw(rawI, rawQ)
        return self._push_device(exact)

    def flush(self) -> tuple[np.ndarray, np.ndarray]:
        return self.push(np.zeros(0, np.float32),
                         np.zeros(0, np.float32), exact=True)


__all__ = ["ChannelizingStreamingDecimator", "folded_stage1_taps"]
