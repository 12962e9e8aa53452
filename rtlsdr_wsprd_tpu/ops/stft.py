"""STFT power spectrogram of a 2-minute WSPR window — planar real,
matmul DFT.

The reference computes 347 sequential 512-point FFTW transforms with a
quarter-symbol hop and a pseudo-Hann window, then fftshifts into a
power array ps[512][347] (wsprd/wsprd.c:496-553).

Batched formulation: the device compute path carries I/Q as two
float32 planes (planar real, no complex dtype), so the 512-point DFT
becomes four (347, 512) @ (512, 512) float32 matmuls against constant
cos/sin matrices, with the fftshift folded into the matrix column
order so no roll op is needed. At ~0.7 GFLOP per window this is small
next to the sync correlators, and it needs no FFT support at all.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import FFT_SIZE, SIGNAL_SAMPLES

# blocks = 4 * floor(samples / 512) - 1 (wsprd/wsprd.c:516)
BLOCKS = 4 * (SIGNAL_SAMPLES // FFT_SIZE) - 1  # = 347
HOP = FFT_SIZE // 4  # quarter-symbol hop = 128


def _hann() -> np.ndarray:
    # pseudo-Hann: sin(0.006147931 * i) ~= sin(pi*i/511) (wsprd/wsprd.c:510-513)
    return np.sin(0.006147931 * np.arange(FFT_SIZE, dtype=np.float64)).astype(np.float32)


HANN = _hann()


def _dft_matrices() -> tuple[np.ndarray, np.ndarray]:
    """Constant DFT matrices with fftshifted column order: output
    column j is FFT bin (j + 256) mod 512 (wsprd/wsprd.c:547-551)."""
    n = np.arange(FFT_SIZE, dtype=np.float64)
    k = (np.arange(FFT_SIZE) + FFT_SIZE // 2) % FFT_SIZE
    ang = 2.0 * np.pi * np.outer(n, k) / FFT_SIZE
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


_DFT_COS, _DFT_SIN = _dft_matrices()

# Matmul precision of the DFT. DEFAULT lets the GPU run the float32
# operands as TF32 (10-bit mantissa); chip_smoke.py measures the error
# of both DEFAULT and HIGHEST against a float64 FFT.
PRECISION = jax.lax.Precision.DEFAULT


def power_spectrogram(i: jnp.ndarray, q: jnp.ndarray,
                      precision=PRECISION) -> jnp.ndarray:
    """i, q: float32[SIGNAL_SAMPLES] -> ps: float32[FFT_SIZE, BLOCKS].

    ps[j, b] is the power in fftshifted bin j (bin 256 = DC) of frame b,
    matching the reference's quarter-symbol-hop layout
    (wsprd/wsprd.c:536-553). Frequency resolution is DF/2 = 375/512 Hz
    per bin; frame b starts at sample 128*b.
    """
    # framing with hop 128 = FFT_SIZE/4 as four static slices of a
    # (350, 128) reshape — no (347, 512) gather
    def frames(x):
        blk = x[:(BLOCKS + 3) * HOP].reshape(BLOCKS + 3, HOP)
        return jnp.concatenate(
            [blk[t:t + BLOCKS] for t in range(4)], axis=1)  # (347, 512)

    w = jnp.asarray(HANN)
    fr = frames(i) * w  # (BLOCKS, 512)
    fi = frames(q) * w
    C = jnp.asarray(_DFT_COS)
    S = jnp.asarray(_DFT_SIN)
    # Z[b,k] = sum_n (fr + j fi)[b,n] * (cos - j sin)[n,k]
    kw = dict(precision=precision, preferred_element_type=jnp.float32)
    zr = jnp.dot(fr, C, **kw) + jnp.dot(fi, S, **kw)
    zi = jnp.dot(fi, C, **kw) - jnp.dot(fr, S, **kw)
    ps = zr * zr + zi * zi  # (BLOCKS, 512)
    return ps.T  # (512, BLOCKS)
