"""Noise floor estimation and candidate peak picking.

Re-formulates the reference's sequential scan (wsprd/wsprd.c:555-631)
as fixed-shape vector ops: 7-point boxcar smoothing of the average
spectrum over the center +/-150 Hz, a 30th-percentile noise floor via a
full sort, SNR renormalization, local-maxima masking, and a stable
descending sort into a fixed-size candidate tensor with a validity
mask (a static-shape replacement for the C's early-exit candidate list).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..config import DF, MAX_CANDIDATES

SMSPEC_BINS = 411          # center bins, +/-150 Hz (wsprd/wsprd.c:564-573)
NOISE_PERCENTILE_IDX = 122  # 30th percentile of 411 (wsprd/wsprd.c:582)
SNR_SCALING = 26.3         # wspr bw -> 2500 Hz bw (wsprd/wsprd.c:591)
MIN_SNR = 10.0 ** (-8.0 / 10.0)  # -8 dB floor (wsprd/wsprd.c:590)


class Candidates(NamedTuple):
    """Fixed-size candidate set, sorted by SNR descending."""

    bin_idx: jnp.ndarray  # int32[MAX_CANDIDATES] smspec bin j (0..410)
    freq: jnp.ndarray     # float32[MAX_CANDIDATES] (j-205)*DF/2, Hz
    snr: jnp.ndarray      # float32[MAX_CANDIDATES] dB
    valid: jnp.ndarray    # bool[MAX_CANDIDATES]


def smoothed_spectrum(ps: jnp.ndarray) -> jnp.ndarray:
    """ps[512, BLOCKS] -> renormalized smoothed spectrum smspec[411]."""
    psavg = jnp.sum(ps, axis=1)  # (512,)
    # smspec[i] = sum_{j=-3..3} psavg[51 + i + j]  (center 256-205=51),
    # as 7 static shifted slices (not a (411, 7) gather)
    base = 256 - 205
    smspec = sum(psavg[base - 3 + t:base - 3 + t + SMSPEC_BINS]
                 for t in range(7))  # (411,)

    noise_level = jnp.sort(smspec)[NOISE_PERCENTILE_IDX]
    smspec = smspec / noise_level - 1.0
    smspec = jnp.where(smspec < MIN_SNR, 0.1 * MIN_SNR, smspec)
    return smspec


def find_candidates(
    ps: jnp.ndarray, fmin: float = -110.0, fmax: float = 110.0
) -> Candidates:
    """Pick up to MAX_CANDIDATES local maxima (wsprd/wsprd.c:599-631).

    Mirrors the C ordering semantics: the first 200 local maxima in bin
    order are kept (the cap applies before band filtering), then
    candidates outside [fmin, fmax] are dropped, then the survivors are
    sorted by SNR descending (stable).
    """
    smspec = smoothed_spectrum(ps)
    j = jnp.arange(SMSPEC_BINS)
    interior = (j >= 1) & (j <= SMSPEC_BINS - 2)
    left = jnp.roll(smspec, 1)
    right = jnp.roll(smspec, -1)
    is_peak = interior & (smspec > left) & (smspec > right)
    # cap at MAX_CANDIDATES in bin order (npk < MAX_CANDIDATES, :613)
    order_rank = jnp.cumsum(is_peak.astype(jnp.int32)) - 1
    is_peak = is_peak & (order_rank < MAX_CANDIDATES)

    freq = (j - 205).astype(jnp.float32) * (DF / 2.0)
    in_band = (freq >= fmin) & (freq <= fmax)
    valid = is_peak & in_band

    snr = 10.0 * jnp.log10(smspec) - SNR_SCALING

    # stable sort by SNR descending; invalid entries sink to the end
    key = jnp.where(valid, -snr, jnp.inf)
    perm = jnp.argsort(key, stable=True)[:MAX_CANDIDATES]
    return Candidates(
        bin_idx=perm.astype(jnp.int32),
        freq=freq[perm],
        snr=snr[perm].astype(jnp.float32),
        valid=valid[perm],
    )
