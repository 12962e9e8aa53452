"""Coarse (freq, time-shift, drift) estimation for all candidates at once.

The reference runs a triple-nested grid per candidate sequentially
(wsprd/wsprd.c:646-678): 3 freq bins x 32 time lags x (2*maxdrift+1)
drifts, scoring a pr3-signed sum of sqrt-power at the 4 tone bins over
162 symbols.

Batched formulation: the score at grid point (row r, lag l, drift d) is the
same for every candidate whose frequency row lands on r, so the whole
(row x lag x drift) score table is computed ONCE as a single
matmul and candidates just read their 3 rows from it:

  1. The C's per-symbol row offset trunc(ifr + fd(i, d)) factorizes as
     ifr + floor(fd) — verified exact for the float32 grid (the
     smallest |fd - nearest_int| is 2.6e-3, three orders above the
     rounding ulp at row 467) — so the offset table FD_INT[i, d] is a
     CONSTANT in [-2, 2].
  2. G[r, l, i] = sqrtps[r, k0_l + 2i] is 32 strided column slices of
     the zero-padded spectrogram (the zero padding reproduces the C's
     kindex < 0 / >= blocks exclusion, wsprd/wsprd.c:657).
  3. For each (drift d, row offset s = FD_INT + tone offset, kind in
     {signed, total}) the symbol sum is a weight vector over i, so all
     scores come from one (512*32, 162) @ (162, |d|*|s|*2) matmul
     followed by |s| shifted adds over the row axis.

Deliberate divergence from the reference (documented, see SURVEY.md
section 7 "quirks"): the C guards only kindex < blocks and reads out of
bounds for kindex < 0 (wsprd/wsprd.c:657); we treat kindex < 0 as
invalid (zero contribution) instead of reading garbage.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DF, NBITS, NSYM
from ..utils.channel import PR3_VECTOR
from .stft import BLOCKS

N_FREQ = 3          # ifr in if0-1..if0+1
K0_MIN, K0_MAX = -10, 21  # time search (wsprd/wsprd.c:650)
N_LAG = K0_MAX - K0_MIN + 1  # 32
MAX_DRIFT_SPAN = 4  # compile-time width; actual drift limited by mask
N_DRIFT = 2 * MAX_DRIFT_SPAN + 1  # 9
N_ROWS = 512

_TONE_OFFSETS = (-3, -1, 1, 3)   # p0, p1, p2, p3 rows (wsprd/wsprd.c:659-667)
_PR3_SIGN = (2.0 * PR3_VECTOR.astype(np.float32) - 1.0)  # (162,)


class CoarseEstimate(NamedTuple):
    freq: jnp.ndarray   # float32[C] refined bin freq, Hz
    shift: jnp.ndarray  # int32[C] sample shift = 128*(k0+1)
    drift: jnp.ndarray  # float32[C]
    sync: jnp.ndarray   # float32[C]


def _fd_int() -> np.ndarray:
    """floor of the float32 drift offset chain (== the C's trunc once
    combined with an in-range integer row), (162, 9) int."""
    dfc = np.float32(DF)
    k = np.arange(NSYM, dtype=np.float32)
    d = np.arange(-MAX_DRIFT_SPAN, MAX_DRIFT_SPAN + 1, dtype=np.float32)
    fd = (((k[:, None] - NBITS) / np.float32(NBITS)) * d[None, :]
          / dfc).astype(np.float32)
    return np.floor(fd).astype(np.int64)


def _weights() -> tuple[np.ndarray, np.ndarray, int]:
    """Weight matrix W[i, (d, s, kind)] and the list of row shifts.

    kind 0: pr3-signed tone-difference sum (ss numerator);
    kind 1: total power sum (pw denominator).
    Tone coefficient for ss: (p1 + p3) - (p0 + p2) -> -1 for offsets
    -3, 1 and +1 for -1, 3 (wsprd/wsprd.c:669-672).
    """
    fd_int = _fd_int()  # (162, 9)
    smin = int(fd_int.min()) + min(_TONE_OFFSETS)
    smax = int(fd_int.max()) + max(_TONE_OFFSETS)
    shifts = list(range(smin, smax + 1))
    n_s = len(shifts)
    W = np.zeros((NSYM, N_DRIFT, n_s, 2), dtype=np.float32)
    ss_coef = {-3: -1.0, -1: +1.0, 1: -1.0, 3: +1.0}
    for d in range(N_DRIFT):
        for t in _TONE_OFFSETS:
            s_idx = fd_int[:, d] + t - smin  # (162,)
            for i in range(NSYM):
                W[i, d, s_idx[i], 0] += ss_coef[t] * _PR3_SIGN[i]
                W[i, d, s_idx[i], 1] += 1.0
    return W.reshape(NSYM, -1), np.asarray(shifts), n_s


_W, _SHIFTS, _NS = _weights()

# Matmul precision of the score-table matmul. DEFAULT lets the GPU run
# the float32 operands as TF32 (10-bit mantissa); chip_smoke.py
# measures the error of both DEFAULT and HIGHEST against float64.
PRECISION = jax.lax.Precision.DEFAULT

# rows any candidate can read (if0 +/- 1 over the smspec bins); the
# row-shift roll below wraps only outside them
ROW_LO, ROW_HI = 45, 467


def coarse_grid(ps: jnp.ndarray, precision=PRECISION):
    """ps: float32[512, BLOCKS] -> (ss, pw), each float32[512, 32, 9]:
    the pr3-signed tone-difference sum and the total tone power of every
    (row, lag k0, drift) grid point (wsprd/wsprd.c:655-673). Valid on
    rows ROW_LO..ROW_HI."""
    sqrtps = jnp.sqrt(ps)  # (512, BLOCKS)

    # G[r, l, i] = sqrtps[r, k0_l + 2i], zero outside [0, BLOCKS)
    pad_l = -2 * K0_MIN  # generous left pad (k0 >= -10)
    # split even/odd columns ONCE (a (.., n, 2) reshape), so each lag
    # is a contiguous slice instead of one of 32 stride-2 slices
    padded = jnp.pad(sqrtps, ((0, 0), (pad_l, 65)))  # width 432, even
    pairs = padded.reshape(N_ROWS, -1, 2)
    eo = (pairs[:, :, 0], pairs[:, :, 1])
    cols = []
    for k0 in range(K0_MIN, K0_MAX + 1):
        start = k0 + pad_l
        half = eo[start % 2]
        cols.append(half[:, start // 2:start // 2 + NSYM])
    G = jnp.stack(cols, axis=1)  # (512, 32, 162)

    # one matmul gives every (row, lag, drift, shift, kind) sum
    out = jnp.dot(G.reshape(N_ROWS * N_LAG, NSYM), jnp.asarray(_W),
                  precision=precision, preferred_element_type=jnp.float32)
    out = out.reshape(N_ROWS, N_LAG, N_DRIFT, _NS, 2)

    # combine row shifts: S[r, l, d, kind] = sum_s out[r + s, l, d, s_idx]
    S = jnp.zeros((N_ROWS, N_LAG, N_DRIFT, 2), jnp.float32)
    for s_idx, s in enumerate(np.asarray(_SHIFTS)):
        S = S + jnp.roll(out[:, :, :, s_idx, :], -int(s), axis=0)
    # (rows of interest are ROW_LO..ROW_HI; the roll wrap never
    # reaches them)
    return S[..., 0], S[..., 1]


def coarse_search(ps: jnp.ndarray, bin_idx: jnp.ndarray, maxdrift=4) -> CoarseEstimate:
    """ps: float32[512, BLOCKS]; bin_idx: int32[C] smspec bin per candidate.

    Returns the best (freq, shift, drift, sync) per candidate over the
    full grid, with the C's first-max-wins tie-breaking in (ifr, k0,
    idrift) loop order (wsprd/wsprd.c:646-678).
    """
    ss, pw = coarse_grid(ps)
    sync_grid = ss / jnp.maximum(pw, 1e-30)  # (512, 32, 9)

    # drift mask (pass 3 runs with maxdrift=0, wsprd/wsprd.c:529)
    idrift = jnp.arange(-MAX_DRIFT_SPAN, MAX_DRIFT_SPAN + 1, dtype=jnp.int32)
    dmask = (jnp.abs(idrift) <= maxdrift)[None, None, :]
    sync_grid = jnp.where(dmask, sync_grid, -jnp.inf)

    # reduce the grid PER ROW first (first max wins over (k0, idrift) =
    # the C's inner loop order), so candidates gather only 3 scalars per
    # row instead of 3 full (32, 9) planes
    row_flat = sync_grid.reshape(N_ROWS, N_LAG * N_DRIFT)
    row_arg = jnp.argmax(row_flat, axis=1)                  # (512,)
    row_val = jnp.take_along_axis(row_flat, row_arg[:, None], axis=1)[:, 0]

    # per candidate: read rows if0-1, if0, if0+1
    # if0 = freq/(DF/2) + 256 = (j - 205) + 256 = j + 51 (wsprd/wsprd.c:648)
    if0 = bin_idx.astype(jnp.int32) + 51  # (C,)
    ifr = if0[:, None] + jnp.arange(-1, 2, dtype=jnp.int32)[None, :]  # (C, 3)
    ifr_c = jnp.clip(ifr, 0, N_ROWS - 1)
    val3 = row_val[ifr_c]  # (C, 3)
    arg3 = row_arg[ifr_c]  # (C, 3)

    bi = jnp.argmax(val3, axis=1)  # first max wins = the C's ifr order
    best_rd = jnp.take_along_axis(arg3, bi[:, None], axis=1)[:, 0]
    bk = best_rd // N_DRIFT
    bd = best_rd % N_DRIFT

    k0 = jnp.arange(K0_MIN, K0_MAX + 1, dtype=jnp.int32)
    best_ifr = jnp.take_along_axis(ifr, bi[:, None], axis=1)[:, 0]
    freq = (best_ifr - 256).astype(jnp.float32) * (DF / 2.0)
    shift = 128 * (k0[bk] + 1)
    drift = idrift[bd].astype(jnp.float32)
    best_sync = jnp.take_along_axis(val3, bi[:, None], axis=1)[:, 0]
    return CoarseEstimate(freq=freq, shift=shift, drift=drift, sync=best_sync)
