"""Host-placed streaming front end (native C++ polyphase).

Placement policy: the 6400:1 front end runs wherever the raw byte
stream is cheapest to deliver.

* **Device** (default, and what ``auto`` resolves to;
  frontend/decimate.py): raw uint8 crosses the link at 1 B/sample and
  the device's matmuls do the math.
* **Host** (this module, explicit ``host``): link-constrained
  deployments — raw bytes never cross the link at all; the native C++ polyphase
  (native/hostdsp.cpp wspr_pp_decimate_*) produces 375 sps float32
  baseband, so the link carries ~3 KB/s per channel (1600x fewer bytes
  than raw). This mirrors the reference's own placement: its front end
  is host CPU (rtlsdr_wsprd.c:184-234) feeding a decoder.

``HostBatchedStreamingDecimator`` is push/flush-compatible with
``BatchedStreamingDecimator`` (same priming, carries and output
alignment — tests/test_frontend.py pins equality), so the many-channel
runtime (runtime/multidaemon.py) swaps them via its ``frontend``
option. Channels fan out over a thread pool (the ctypes calls release
the GIL).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import native
from .filters import (
    R1,
    R2,
    STAGE1_TAPS,
    STAGE2_TAPS,
    conv_order,
    stage1_coeffs,
    stage2_coeffs,
)

_TAPS = None


def _host_taps():
    """(g1r, g1i, g2) conv-ordered float32 tap arrays."""
    global _TAPS
    if _TAPS is None:
        g1 = conv_order(stage1_coeffs())
        g2 = conv_order(stage2_coeffs())
        _TAPS = (np.real(g1).astype(np.float32).copy(),
                 np.imag(g1).astype(np.float32).copy(),
                 np.ascontiguousarray(g2, np.float32))
    return _TAPS


class HostBatchedStreamingDecimator:
    """Stateful C-channel streaming front end on the host CPU.

    Same contract as frontend.decimate.BatchedStreamingDecimator:
    ``push((C, n) planar uint8|float32)`` returns newly available
    (C, m) planar float32 375 sps samples; ``flush()`` drains whole
    frames. Unlike the device version there are no compiled shapes, so
    every push processes all whole frames (no work quantum).
    """

    def __init__(self, n_channels: int, threads: int = 8):
        if not native.HAS_DECIMATE:
            raise RuntimeError(
                "native hostdsp polyphase unavailable; use the device "
                "front end (frontend.decimate.BatchedStreamingDecimator)")
        C = n_channels
        self._C = C
        self._threads = threads
        prime1 = STAGE1_TAPS // 2
        prime2 = STAGE2_TAPS // 2
        self._prime1 = prime1
        # raw carry dtype is decided by the first nonempty push
        # (prime pad 128 <-> 0.0 centered), like the device version
        self._bufI: np.ndarray | None = None
        self._bufQ: np.ndarray | None = None
        self._midI = np.zeros((C, prime2), np.float32)
        self._midQ = np.zeros((C, prime2), np.float32)
        self._tail1 = STAGE1_TAPS - R1
        self._tail2 = STAGE2_TAPS - R2

    def _prime_raw(self, dtype) -> None:
        fill = 128 if dtype == np.uint8 else 0
        self._bufI = np.full((self._C, self._prime1), fill, dtype)
        self._bufQ = np.full((self._C, self._prime1), fill, dtype)

    def _map_rows(self, fn, n_rows: int):
        if n_rows == 1 or self._threads <= 1:
            for k in range(n_rows):
                fn(k)
        else:
            with ThreadPoolExecutor(
                    max_workers=min(self._threads, n_rows)) as ex:
                list(ex.map(fn, range(n_rows)))

    def push(self, rawI: np.ndarray, rawQ: np.ndarray,
             exact: bool = False) -> tuple[np.ndarray, np.ndarray]:
        del exact  # host path always processes every whole frame
        in_dtype = (np.uint8 if rawI.dtype == np.uint8 else np.float32)
        if self._bufI is None:
            self._prime_raw(in_dtype)
        if in_dtype != self._bufI.dtype and rawI.size > 0:
            if self._bufI.dtype == np.uint8:  # upconvert carry once
                self._bufI = self._bufI.astype(np.float32) - 128.0
                self._bufQ = self._bufQ.astype(np.float32) - 128.0
            else:  # float carry continues; center incoming u8
                rawI = rawI.astype(np.float32) - 128.0
                rawQ = rawQ.astype(np.float32) - 128.0
        rawI = np.ascontiguousarray(rawI, self._bufI.dtype)
        rawQ = np.ascontiguousarray(rawQ, self._bufQ.dtype)

        C = self._C
        g1r, g1i, g2 = _host_taps()

        # stage 1 reads the caller's chunk IN PLACE: only frames that
        # span the carry/chunk boundary go through a small stitch
        # buffer (the carry is < taps samples, so <= taps/R1 = 8
        # frames); concatenating the carry onto a whole 2.4 MB chunk
        # was ~35% of push wall time.
        nc = self._bufI.shape[1]
        total = nc + rawI.shape[1]
        n_mid = (total - self._tail1) // R1
        if n_mid > 0:
            m_b = min(n_mid, -(-nc // R1))  # frames touching the carry
            take = m_b * R1 + self._tail1 - nc  # chunk samples stitched
            stI = np.concatenate([self._bufI, rawI[:, :take]], axis=1)
            stQ = np.concatenate([self._bufQ, rawQ[:, :take]], axis=1)
            off = m_b * R1 - nc  # bulk frames' start inside the chunk
            n_bulk = n_mid - m_b
            end = off + n_bulk * R1 + self._tail1
            mi = np.empty((C, n_mid), np.float32)
            mq = np.empty((C, n_mid), np.float32)

            def s1(k):
                mi[k, :m_b], mq[k, :m_b] = native.pp_decimate(
                    stI[k], stQ[k], g1r, g1i, R1, m_b)
                if n_bulk > 0:
                    mi[k, m_b:], mq[k, m_b:] = native.pp_decimate(
                        rawI[k, off:end], rawQ[k, off:end], g1r, g1i,
                        R1, n_bulk)

            self._map_rows(s1, C)
            pos = n_mid * R1  # carry = samples [pos, total)
            if pos >= nc:
                self._bufI = rawI[:, pos - nc:].copy()
                self._bufQ = rawQ[:, pos - nc:].copy()
            else:
                self._bufI = np.concatenate(
                    [self._bufI[:, pos:], rawI], axis=1)
                self._bufQ = np.concatenate(
                    [self._bufQ[:, pos:], rawQ], axis=1)
            self._midI = np.concatenate([self._midI, mi], axis=1)
            self._midQ = np.concatenate([self._midQ, mq], axis=1)
        elif rawI.size > 0:
            self._bufI = np.concatenate([self._bufI, rawI], axis=1)
            self._bufQ = np.concatenate([self._bufQ, rawQ], axis=1)

        n_out = (self._midI.shape[1] - self._tail2) // R2
        if n_out <= 0:
            return (np.zeros((C, 0), np.float32),
                    np.zeros((C, 0), np.float32))
        need2 = n_out * R2 + self._tail2
        oi = np.empty((C, n_out), np.float32)
        oq = np.empty((C, n_out), np.float32)
        midI = np.ascontiguousarray(self._midI[:, :need2])
        midQ = np.ascontiguousarray(self._midQ[:, :need2])

        def s2(k):
            oi[k], oq[k] = native.fir_decimate(
                midI[k], midQ[k], g2, R2, n_out)

        self._map_rows(s2, C)
        self._midI = self._midI[:, n_out * R2:]
        self._midQ = self._midQ[:, n_out * R2:]
        return oi, oq

    def flush(self) -> tuple[np.ndarray, np.ndarray]:
        """Drain every whole output frame still in the pipeline."""
        if self._bufI is None:
            self._prime_raw(np.float32)
        return self.push(np.zeros((self._C, 0), np.float32),
                         np.zeros((self._C, 0), np.float32))


class HostStreamingDecimator:
    """Single-stream adapter over HostBatchedStreamingDecimator:
    StreamingDecimator-compatible push/flush with 1-D planar arrays
    (runtime/sources.py single-channel live path)."""

    def __init__(self, threads: int = 1):
        self._b = HostBatchedStreamingDecimator(1, threads=threads)

    def push(self, rawI: np.ndarray, rawQ: np.ndarray,
             exact: bool = False) -> tuple[np.ndarray, np.ndarray]:
        oi, oq = self._b.push(rawI[None, :], rawQ[None, :], exact)
        return oi[0], oq[0]

    def flush(self) -> tuple[np.ndarray, np.ndarray]:
        oi, oq = self._b.flush()
        return oi[0], oq[0]


def resolve_placement(frontend: str) -> str:
    """'auto' -> 'device'; explicit 'host' or 'device' pass through."""
    if frontend == "auto":
        return "device"
    if frontend in ("host", "device"):
        return frontend
    raise ValueError(f"unknown frontend placement: {frontend!r}")


__all__ = ["HostBatchedStreamingDecimator", "HostStreamingDecimator",
           "resolve_placement"]
