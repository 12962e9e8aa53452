"""Hybrid device/host Fano decoding.

The batched device Fano (ops/fano.py) advances every attempt in
lockstep, so wall time is set by the SLOWEST lane — and a lane that
exhausts the full reference budget (10000 cycles/bit = 810k cycles,
wsprd/wsprd.c:430) costs ~1.6M flat steps.

The hybrid split (SURVEY.md section 7, "hard parts" #1): run the
batched search with a small device budget — the overwhelming majority
of decodable attempts finish in well under 64*81 cycles — and re-run
only the straggler lanes on the native sequential decoder
(native/hostdsp.cpp), bit-exact vs wsprd/fano.c, from scratch with the
full budget. Fano is deterministic: a lane re-run from scratch with a
larger budget passes through the identical state sequence, so the
merged results equal a full-budget device run bit for bit.
"""

from __future__ import annotations

import numpy as np

from .. import native
from .fano import NBITS, batched_fano, build_mettab

_METTAB = build_mettab()

# DEFAULT device-side budget (cycles per bit, like the C's maxcycles);
# lanes still searching after budget*81 cycles fall back to the host
# decoder. Clean decodes finish in ~1-3 cycles/bit, so stragglers are
# rare. Production paths use the per-backend MEASURED value instead
# (ops/calibrate.py device_fano_budget: the real device decoder's
# per-cycle cost vs native decode cost); this constant is the fallback
# and the deterministic dryrun/compile-check value.
DEVICE_MAXCYCLES = 16


def pending_mask(success: np.ndarray, cycles: np.ndarray,
                 device_maxcycles: int, full_maxcycles: int) -> np.ndarray:
    """Lanes that hit the device budget without finishing (their
    cycles carry the timeout marker budget*81 + 2) and would have been
    allowed to continue under the full budget."""
    if device_maxcycles >= full_maxcycles:
        return np.zeros_like(success, dtype=bool)
    marker = np.uint32(device_maxcycles * NBITS + 2)
    return (~success) & (cycles == marker)


def host_finish(deint_symbols: np.ndarray, success: np.ndarray,
                data: np.ndarray, cycles: np.ndarray,
                pending: np.ndarray, delta: int, maxcycles: int):
    """Re-run pending lanes on the host decoder; returns updated
    (success, data, cycles) arrays (copies where modified)."""
    idx = np.nonzero(pending)[0]
    if idx.size == 0:
        return success, data, cycles
    if native.AVAILABLE:
        ok, d, c, _m, _np = native.fano_decode_many(
            deint_symbols[idx], _METTAB, delta=delta, maxcycles=maxcycles)
    else:  # pure-JAX fallback: full budget on the device/CPU backend
        import jax.numpy as jnp
        res = batched_fano(jnp.asarray(deint_symbols[idx]),
                           jnp.asarray(_METTAB), delta=delta,
                           maxcycles=maxcycles)
        ok = np.asarray(res.success)
        d = np.asarray(res.data)
        c = np.asarray(res.cycles)
    success = success.copy()
    data = data.copy()
    cycles = cycles.copy()
    success[idx] = ok
    data[idx] = d
    cycles[idx] = c
    return success, data, cycles
