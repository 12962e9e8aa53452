"""Batched Fano sequential decoder for the WSPR K=32 r=1/2 code.

The reference decodes one candidate at a time with a pointer-chasing
sequential tree search (wsprd/fano.c:87-238). The algorithm is pure
32-bit integer arithmetic, so this lane-parallel reformulation is
*bit-exact*: every lane reproduces the C's path metrics, cycle counts,
threshold walk and decoded bytes. The per-node state (gamma, encoder
state, sorted branch metrics, branch index) lives in (B, 82) arrays;
the current-node pointer becomes a per-lane position index updated with
one-hot masks; the forward/backtrack control flow becomes a two-level
``lax.while_loop`` (outer = Fano cycles, inner = the backtrack walk).
Hundreds of (candidate x jitter) attempts decode simultaneously, and
the loop exits as soon as every lane has finished - wall clock is the
*slowest* lane, not the sum like the sequential C.

Structure of one Fano cycle (mirrors wsprd/fano.c:153-220):
  look forward with the current best branch; if the threshold passes,
  advance (tightening the threshold on first visits) and compute the
  new node's sorted branch metrics (tail nodes only explore the
  0-branch); otherwise walk backward until a node with another branch
  to try is found, or relax the threshold at the origin.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import NBITS
from ..utils.channel import POLY1, POLY2
from ..utils.metric_tables import METRIC_TABLES

# flat Fano steps per while_loop iteration (batched_fano's default, and
# what the FEC calibration measures)
FANO_UNROLL = 2

N_NODES = NBITS + 1  # 82: nodes[0..80] + the final position
TAIL = NBITS - 31    # 50: first node of the all-zero tail (fano.c:112)


def _c_roundf(x: np.ndarray) -> np.ndarray:
    """C roundf: round half away from zero."""
    return np.trunc(x + np.copysign(0.5, x))


def build_mettab(bias: float = 0.45) -> np.ndarray:
    """Integer branch metric table (2, 256) int32 (wsprd/wsprd.c:467-473):
    mettab[0][i] = roundf(10*(metric_tables[2][i] - bias)), mettab[1]
    uses the reversed index."""
    t2 = np.asarray(METRIC_TABLES[2], dtype=np.float32)
    sub0 = (t2 - np.float32(bias)).astype(np.float32)
    sub1 = (t2[::-1] - np.float32(bias)).astype(np.float32)
    # C: roundf(10.0 * (float)(v - bias)) — the double product converts
    # to float32 at the roundf call boundary (e.g. -4.4999999 -> -4.5f
    # -> -5), so we must narrow before rounding.
    m0 = _c_roundf((10.0 * sub0.astype(np.float64)).astype(np.float32))
    m1 = _c_roundf((10.0 * sub1.astype(np.float64)).astype(np.float32))
    return np.stack([m0, m1]).astype(np.int32)


def _encode_sym(encstate: jnp.ndarray) -> jnp.ndarray:
    """The ENCODE macro (wsprd/fano.h:35-44): 2-bit symbol from the
    parities of encstate & POLY1 / POLY2."""
    p1 = jax.lax.population_count(encstate & jnp.uint32(POLY1)) & 1
    p2 = jax.lax.population_count(encstate & jnp.uint32(POLY2)) & 1
    return ((p1 << 1) | p2).astype(jnp.int32)


class FanoResult(NamedTuple):
    data: jnp.ndarray     # uint8[B, 11] decoded bytes (last byte always 0)
    success: jnp.ndarray  # bool[B] (C: fano() == 0)
    metric: jnp.ndarray   # int32[B] final path metric
    cycles: jnp.ndarray   # uint32[B] cycle count (C *cycles semantics)
    maxnp: jnp.ndarray    # int32[B] deepest node reached


def _onehot_set(arr: jnp.ndarray, pos: jnp.ndarray, val: jnp.ndarray,
                mask: jnp.ndarray) -> jnp.ndarray:
    """arr[b, pos[b]] = val[b] where mask[b], for (B, N_NODES) arrays."""
    nodes = jnp.arange(arr.shape[1], dtype=jnp.int32)[None, :]
    hit = (nodes == pos[:, None]) & mask[:, None]
    return jnp.where(hit, val[:, None].astype(arr.dtype), arr)


def _take_at(arr: jnp.ndarray, pos: jnp.ndarray) -> jnp.ndarray:
    """arr[b, pos[b]] for (B, N_NODES) arrays."""
    return jnp.take_along_axis(arr, pos[:, None], axis=1)[:, 0]


@partial(jax.jit, static_argnames=("delta", "maxcycles", "unroll"))
def batched_fano(
    symbols: jnp.ndarray,
    mettab: jnp.ndarray,
    delta: int = 60,
    maxcycles: int = 10000,
    valid: jnp.ndarray | None = None,
    unroll: int = FANO_UNROLL,
) -> FanoResult:
    """Decode B deinterleaved soft-symbol streams at once.

    symbols: uint8[B, 162]; mettab: int32[2, 256];
    maxcycles is per-bit like the C (total budget = maxcycles * 81,
    wsprd/fano.c:149). ``valid`` (bool[B], optional) marks live lanes;
    padding lanes start done (success=False, zero cycles) so they cost
    no iterations of the batched search.

    Performance shape: the C's nested control flow (forward loop with a
    complete backtrack walk inside each cycle, wsprd/fano.c:153-220) is
    FLATTENED into a single-level state machine — each flat step is
    either one forward-look or one backtrack step, selected per lane by
    a ``back`` flag — and ``unroll`` flat steps run per while_loop
    iteration. This keeps every op a fused (B,)-/(B,82)-shaped vector
    op with no nested while (nested loops cost a device sync per inner
    iteration), which is what makes 810k-cycle timeout lanes affordable.
    Cycle accounting is unchanged: ``i`` increments only on
    forward-look steps, exactly one per C loop iteration.
    """
    B = symbols.shape[0]
    max_total = jnp.uint32(maxcycles * NBITS)
    delta_i = jnp.int32(delta)

    sym = symbols.astype(jnp.int32)
    s0, s1 = sym[:, 0::2], sym[:, 1::2]  # (B, 81)
    m_t0, m_t1 = mettab[0], mettab[1]
    # branch metrics per node, indexed by the 2-bit tx symbol
    # (wsprd/fano.c:118-124)
    metrics = jnp.stack(
        [m_t0[s0] + m_t0[s1], m_t0[s0] + m_t1[s1],
         m_t1[s0] + m_t0[s1], m_t1[s0] + m_t1[s1]], axis=-1,
    )  # (B, 81, 4) int32

    # ---- root node init (wsprd/fano.c:126-150) ----
    m0 = metrics[:, 0, 0]            # lsym = ENCODE(0) = 0
    m1 = metrics[:, 0, 3]            # complementary branch (3 ^ 0)
    swap0 = m0 <= m1                 # C: if (m0 > m1) keep else swap
    gamma = jnp.zeros((B, N_NODES), jnp.int32)
    encstate = jnp.zeros((B, N_NODES), jnp.uint32)
    encstate = encstate.at[:, 0].set(swap0.astype(jnp.uint32))
    tm0 = jnp.zeros((B, N_NODES), jnp.int32).at[:, 0].set(jnp.where(swap0, m1, m0))
    tm1 = jnp.zeros((B, N_NODES), jnp.int32).at[:, 0].set(jnp.where(swap0, m0, m1))
    ii = jnp.zeros((B, N_NODES), jnp.int32)

    pos = jnp.zeros((B,), jnp.int32)
    t = jnp.zeros((B,), jnp.int32)
    cyc = jnp.zeros((B,), jnp.uint32)      # C's loop variable i (pre-increment)
    maxnp = jnp.zeros((B,), jnp.int32)
    done = jnp.zeros((B,), bool) if valid is None else ~valid
    back = jnp.zeros((B,), bool)           # lane is inside the backtrack walk
    success = jnp.zeros((B,), bool)
    metric = jnp.zeros((B,), jnp.int32)
    cycles_out = jnp.zeros((B,), jnp.uint32)

    def step(state):
        """One flat step: forward-look for lanes with back=False, one
        backtrack move for lanes with back=True."""
        (done, back, success, metric, cycles_out, gamma, encstate, tm0,
         tm1, ii, pos, t, cyc, maxnp) = state
        fwd_mode = ~done & ~back
        i_now = cyc + 1  # the C cycle index if this forward-look runs

        maxnp = jnp.where(fwd_mode & (pos > maxnp), pos, maxnp)

        g_p = _take_at(gamma, pos)
        i_p = _take_at(ii, pos)
        tm_p = jnp.where(i_p == 0, _take_at(tm0, pos), _take_at(tm1, pos))
        ngamma = g_p + tm_p
        fwd = fwd_mode & (ngamma >= t)

        # ---- forward move (wsprd/fano.c:158-197) ----
        first_visit = g_p < t + delta_i
        t_tight = t + delta_i * ((ngamma - t) // delta_i)
        t = jnp.where(fwd & first_visit, t_tight, t)

        newpos = jnp.where(fwd, pos + 1, pos)
        es_p = _take_at(encstate, pos)
        es_new = es_p << 1
        gamma = _onehot_set(gamma, newpos, ngamma, fwd)
        encstate = _onehot_set(encstate, newpos, es_new, fwd)

        finished = fwd & (newpos == NBITS)
        advancing = fwd & ~finished

        # new node's sorted branch metrics (wsprd/fano.c:178-196)
        np_c = jnp.clip(newpos, 0, NBITS - 1)
        lsym = _encode_sym(es_new)
        met_node = jnp.take_along_axis(
            metrics, np_c[:, None, None], axis=1)[:, 0]  # (B, 4)
        mm0 = jnp.take_along_axis(met_node, lsym[:, None], axis=1)[:, 0]
        mm1 = jnp.take_along_axis(met_node, (3 ^ lsym)[:, None], axis=1)[:, 0]
        in_tail = np_c >= TAIL
        swap = (~in_tail) & (mm0 <= mm1)
        new_tm0 = jnp.where(in_tail, mm0, jnp.where(swap, mm1, mm0))
        new_tm1 = jnp.where(swap, mm0, mm1)  # tail: tm1 stale (never read)
        write_tm1 = advancing & ~in_tail
        tm0 = _onehot_set(tm0, newpos, new_tm0, advancing)
        tm1 = _onehot_set(tm1, newpos, new_tm1, write_tm1)
        encstate = _onehot_set(encstate, newpos, es_new + swap.astype(jnp.uint32),
                               advancing & swap)
        ii = _onehot_set(ii, newpos, jnp.zeros_like(newpos), advancing)
        pos = jnp.where(fwd, newpos, pos)

        # forward-look failed: enter the backtrack walk (same C cycle)
        back = back | (fwd_mode & ~fwd & (ngamma < t))

        # ---- one backtrack step (wsprd/fano.c:199-219) ----
        walk = ~done & back & ~fwd_mode  # lanes already walking this step
        g_prev = _take_at(gamma, jnp.maximum(pos - 1, 0))
        relax = walk & ((pos == 0) | (g_prev < t))
        t = jnp.where(relax, t - delta_i, t)
        i_cur = _take_at(ii, pos)
        flip = relax & (i_cur != 0)
        ii = _onehot_set(ii, pos, jnp.zeros_like(pos), flip)
        encstate = _onehot_set(
            encstate, pos, _take_at(encstate, pos) ^ 1, flip)
        back = back & ~relax  # relax exits the walk

        stepping = walk & ~relax
        pos = jnp.where(stepping, pos - 1, pos)
        i_b = _take_at(ii, pos)
        can_try = stepping & (pos < TAIL) & (i_b != 1)
        ii = _onehot_set(ii, pos, i_b + 1, can_try)
        encstate = _onehot_set(
            encstate, pos, _take_at(encstate, pos) ^ 1, can_try)
        back = back & ~can_try  # alternate branch found: walk ends

        # ---- bookkeeping: completion & timeout ----
        cyc = jnp.where(fwd_mode, i_now, cyc)
        # The C records the timeout state AFTER the final iteration's
        # backtrack walk completes (wsprd/fano.c:149,222-231), so a
        # lane times out only once it is back out of the walk.
        timeout = ~done & ~back & ~finished & (cyc >= max_total)
        newly_done = finished | timeout
        metric = jnp.where(finished, ngamma,
                           jnp.where(timeout, _take_at(gamma, pos), metric))
        # C: *cycles = i + 1 with i = break iteration on success, or
        # maxcycles+1 on natural exit (wsprd/fano.c:231)
        cycles_out = jnp.where(finished, i_now + 1,
                               jnp.where(timeout, max_total + 2, cycles_out))
        # success requires i < maxcycles at exit (wsprd/fano.c:234-235)
        success = success | (finished & (i_now < max_total))
        done = done | newly_done
        return (done, back, success, metric, cycles_out, gamma, encstate,
                tm0, tm1, ii, pos, t, cyc, maxnp)

    def cond(state):
        return jnp.any(~state[0])

    def body(state):
        for _ in range(unroll):
            state = step(state)
        return state

    state = (done, back, success, metric, cycles_out, gamma, encstate, tm0,
             tm1, ii, pos, t, cyc, maxnp)
    (done, back, success, metric, cycles_out, gamma, encstate, tm0, tm1, ii,
     pos, t, cyc, maxnp) = jax.lax.while_loop(cond, body, state)

    # extract decoded bytes from nodes 7, 15, ..., 79 (wsprd/fano.c:224-230)
    byte_nodes = 7 + 8 * jnp.arange(NBITS >> 3, dtype=jnp.int32)  # (10,)
    data10 = (encstate[:, byte_nodes] & 0xFF).astype(jnp.uint8)  # (B, 10)
    data = jnp.concatenate(
        [data10, jnp.zeros((B, 1), jnp.uint8)], axis=1)  # (B, 11)
    return FanoResult(data=data, success=success, metric=metric,
                      cycles=cycles_out, maxnp=maxnp)
