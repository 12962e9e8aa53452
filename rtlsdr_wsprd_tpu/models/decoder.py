"""The batched WSPR window decoder — the framework's flagship model.

Equivalent of the reference's ``wspr_decode`` (wsprd/wsprd.c:416-855),
re-architected for an accelerator: instead of the C's sequential per-candidate
refinement and per-jitter FEC attempts, one jitted device program
evaluates ALL candidates x lags x freqs x jitters as dense tensors,
and a single batched Fano call decodes every gate-passing attempt at
once. Host code handles only strings, gating/compaction, dedupe and
the pass loop (subtraction forces sequential passes).

Per pass:
  device:  STFT power spectrogram -> smoothed-noise-floor candidate
           pick -> coarse (freq, lag, drift) grid -> fine lag + freq
           sync -> mode-2 soft symbols for the full jitter schedule
  host:    gate (minsync1/minsync2/rms), compact attempts to a padded
           batch
  device:  deinterleave + batched Fano over all attempts
  host:    first-success-per-candidate select (reference jitter order),
           unpack, dedupe (same call within 3 Hz)
  device:  coherent subtraction of each new unique decode

Documented divergences from the reference (see SURVEY.md section 7):
  * Within a pass the reference subtracts each decode immediately,
    affecting later candidates in the SAME pass; we decode the whole
    pass from one window state and subtract unique decodes between
    passes (batched formulation; parity on the golden capture and the
    self-test; at equal npasses this trades intra-pass for inter-pass
    subtraction).
  * The reference emits an empty spot when a Fano false-decode fails
    message unpacking (wsprd/wsprd.c:768-821 never re-checks), and
    `break`s out of the whole candidate loop on an "A000AA" grid or a
    failed re-encode; we skip the candidate instead.
  * Duplicate decodes are deduped before subtraction so one signal is
    never subtracted twice (the C's sequential flow makes the shadow
    candidate fail instead).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import (
    DT,
    MAX_CANDIDATES,
    MAX_UNIQUES,
    SIGNAL_SAMPLES,
    DecoderOptions,
)
from ..ops.candidates import find_candidates
from ..ops.coarse import coarse_search
from ..ops.calibrate import device_fano_budget
from ..ops.fano import batched_fano, build_mettab
from ..ops.fano_hybrid import host_finish, pending_mask
from ..ops.stft import power_spectrogram
from ..ops.subtract import subtract_signal2
from ..ops.sync import fine_sync, jitter_offsets, soft_symbols_jittered
from ..utils.channel import INTERLEAVE_PERM, get_wspr_channel_symbols
from ..utils.codec import unpack_message
from ..utils.hashtable import WsprHashTable

_METTAB = build_mettab()

# attempt-batch padding buckets (jit cache friendliness)
_FANO_BUCKETS = (64, 256, 1024, 4096, 8704)


@dataclass
class Spot:
    """One decoded transmission (reference struct decoder_results,
    wsprd/wsprd.h:62-74)."""

    freq: float      # printed frequency, MHz (dial + (1500+f)/1e6)
    sync: float
    snr: float       # dB
    dt: float        # s (shift*DT - 2.0)
    drift: float
    jitter: int
    message: str
    call: str
    loc: str
    pwr: str
    cycles: int
    noprint: bool = False
    ihash: int = -1  # type-3 spots: the 15-bit hash behind ``call``
    #                  (-1 otherwise); carried so pipelined consumers
    #                  can re-resolve a not-yet-taught "<...>" at
    #                  yield time (multichannel.resolve_type3_spots)


@partial(jax.jit, static_argnames=("lagstep", "iifac", "quickmode", "symfac"))
def _analyze_pass(
    sig_i: jnp.ndarray,
    sig_q: jnp.ndarray,
    maxdrift: jnp.ndarray,
    fmin: float,
    fmax: float,
    lagstep: int,
    iifac: int,
    quickmode: bool,
    symfac: int,
):
    """Device part of one pass: everything up to (but excluding) Fano.

    I/Q are planar float32 throughout the device path (see
    ops/sync.py)."""
    ps = power_spectrogram(sig_i, sig_q)
    cand = find_candidates(ps, fmin, fmax)
    coarse = coarse_search(ps, cand.bin_idx, maxdrift)
    fine = fine_sync(sig_i, sig_q, coarse.freq, coarse.shift, coarse.drift,
                     lagstep=lagstep)
    jit = soft_symbols_jittered(
        sig_i, sig_q, fine.freq, fine.shift, coarse.drift,
        iifac=iifac, quickmode=quickmode, symfac=symfac,
    )
    return cand, coarse, fine, jit


@partial(jax.jit, static_argnames=("delta", "maxcycles"))
def _fano_batch(symbols: jnp.ndarray, delta: int = 60, maxcycles: int = 10000):
    deint = symbols[:, INTERLEAVE_PERM]
    return batched_fano(deint, jnp.asarray(_METTAB), delta=delta,
                        maxcycles=maxcycles)


def decode_window(
    i_samples: np.ndarray,
    q_samples: np.ndarray,
    options: DecoderOptions = DecoderOptions(),
    hashtable: WsprHashTable | None = None,
) -> list[Spot]:
    """Decode one 120 s window -> list of Spots sorted by SNR descending.

    ``i_samples``/``q_samples`` are the normalized float32 window (the
    callers — file reader, front end, self-test — apply the -3 dB
    normalization, as in the reference).
    """
    ht = hashtable if hashtable is not None else WsprHashTable()
    sig_i = jnp.asarray(i_samples, jnp.float32)
    sig_q = jnp.asarray(q_samples, jnp.float32)
    assert sig_i.shape == sig_q.shape == (SIGNAL_SAMPLES,)

    lagstep = 16 if options.quickmode else 8
    jit_offsets = jitter_offsets(options.iifac, options.quickmode)

    uniques: list[Spot] = []
    seen: list[tuple[str, float]] = []  # (callsign, baseband freq Hz)

    for ipass in range(options.npasses):
        if ipass == 1 and not uniques:
            break  # wsprd/wsprd.c:522
        maxdrift = options.maxdrift if ipass < 2 else 0
        minsync2 = options.minsync2 if ipass < 2 else 0.10

        cand, coarse, fine, jit = _analyze_pass(
            sig_i, sig_q, jnp.int32(maxdrift), options.fmin, options.fmax,
            lagstep, options.iifac, options.quickmode, options.symfac,
        )
        valid = np.asarray(cand.valid)
        snr = np.asarray(cand.snr)
        sync_fine = np.asarray(fine.sync)
        freq_fine = np.asarray(fine.freq)
        shift_fine = np.asarray(fine.shift)
        drift_c = np.asarray(coarse.drift)
        sync2 = np.asarray(jit.sync)      # (J, C)
        rms = np.asarray(jit.rms)         # (J, C)
        symbols = np.asarray(jit.symbols)  # (J, C, 162)

        worth = valid & (sync_fine > options.minsync1)  # wsprd/wsprd.c:733
        gate = (sync2 > minsync2) & (rms > options.minrms)  # :758

        # compact (candidate, jitter) attempts, candidate-major in the
        # reference's jitter order
        attempts: list[tuple[int, int]] = []
        for c in np.nonzero(worth)[0]:
            for j in range(len(jit_offsets)):
                if gate[j, c]:
                    attempts.append((c, j))

        decoded: dict[int, tuple[int, bytes, int]] = {}  # cand -> (jitter idx, data, cycles)
        if attempts:
            n = len(attempts)
            bucket = next(b for b in _FANO_BUCKETS if b >= min(n, _FANO_BUCKETS[-1]))
            batch = np.zeros((bucket, 162), dtype=np.uint8)
            for a, (c, j) in enumerate(attempts[:bucket]):
                batch[a] = symbols[j, c]
            # hybrid FEC: small calibrated device budget, host C++
            # finishes the stragglers bit-exactly (ops/fano_hybrid.py,
            # ops/calibrate.py)
            dev_mc = device_fano_budget(options.maxcycles)
            res = _fano_batch(jnp.asarray(batch),
                              delta=options.delta, maxcycles=dev_mc)
            success = np.asarray(res.success)
            data = np.asarray(res.data)
            cycles = np.asarray(res.cycles)
            pend = pending_mask(success, cycles, dev_mc, options.maxcycles)
            if pend.any():
                deint_np = batch[:, np.asarray(INTERLEAVE_PERM)]
                success, data, cycles = host_finish(
                    deint_np, success, data, cycles, pend,
                    options.delta, options.maxcycles)
            for a, (c, j) in enumerate(attempts[:bucket]):
                if success[a] and c not in decoded:
                    decoded[c] = (j, bytes(data[a]), int(cycles[a]))

        # host: unpack, dedupe, collect spots (wsprd/wsprd.c:768-822)
        new_decodes = []
        for c in np.nonzero(worth)[0]:
            if int(c) not in decoded:
                continue
            j, data, cycles = decoded[int(c)]
            msg = unpack_message(
                [b if b < 128 else b - 256 for b in data[:11]], ht)
            if msg is None:
                continue  # divergence: the reference emits an empty spot
            if msg.loc == "A000AA":
                continue  # divergence: the reference breaks the loop
            dupe = any(
                msg.callsign == s_call and abs(freq_fine[c] - s_freq) < 3.0
                for s_call, s_freq in seen
            )
            if dupe:
                continue
            if len(uniques) >= MAX_UNIQUES:
                break  # result buffer bound (wsprd/wsprd.h:41)
            seen.append((msg.callsign, float(freq_fine[c])))
            dialfreq_mhz = options.freq / 1e6
            spot = Spot(
                freq=dialfreq_mhz + (1500.0 + float(freq_fine[c])) / 1e6,
                sync=float(sync_fine[c]),
                snr=float(snr[c]),
                dt=float(shift_fine[c]) * DT - 2.0,
                drift=float(drift_c[c]),
                jitter=int(jit_offsets[j]),
                message=msg.call_loc_pow,
                call=msg.call,
                loc=msg.loc,
                pwr=msg.pwr,
                cycles=cycles,
                noprint=msg.noprint,
                ihash=msg.ihash,
            )
            uniques.append(spot)
            if options.subtraction and ipass == 0 and not msg.noprint:
                new_decodes.append((c, msg.call_loc_pow))

        # device: coherent subtraction of the new uniques, in candidate
        # (SNR-descending) order
        for c, call_loc_pow in new_decodes:
            chan_syms = get_wspr_channel_symbols(call_loc_pow, ht)
            if chan_syms is None:
                continue  # divergence: the reference breaks the loop
            sig_i, sig_q = subtract_signal2(
                sig_i, sig_q, jnp.float32(freq_fine[c]),
                jnp.int32(shift_fine[c]), jnp.float32(drift_c[c]),
                jnp.asarray(chan_syms),
            )

    uniques.sort(key=lambda s: -s.snr)  # wsprd/wsprd.c:826-827
    return uniques


class WsprDecoder:
    """Stateful wrapper owning options + the persistent hashtable.

    ``staged=True`` (default) routes through the lane-compacted staged
    path (parallel.multichannel.decode_channels with B=1) — the fast
    production program; ``staged=False`` keeps the dense per-window
    reference formulation (decode_window), the parity anchor."""

    def __init__(self, options: DecoderOptions = DecoderOptions(),
                 hashtable_path: str = "hashtable.txt",
                 staged: bool = True):
        self.options = options
        self.hashtable_path = hashtable_path
        self.staged = staged
        if options.usehashtable:
            self.hashtable = WsprHashTable.load(hashtable_path)
        else:
            self.hashtable = WsprHashTable()

    def decode(self, i_samples: np.ndarray,
               q_samples: np.ndarray) -> list[Spot]:
        if self.staged:
            from ..parallel.multichannel import decode_channels
            spots = decode_channels(
                i_samples[None, :], q_samples[None, :], self.options,
                self.hashtable, device_batch=1)[0]
        else:
            spots = decode_window(i_samples, q_samples, self.options,
                                  self.hashtable)
        if self.options.usehashtable:
            self.hashtable.save(self.hashtable_path)
        return spots
