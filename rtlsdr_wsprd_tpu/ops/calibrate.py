"""Backend calibration for the FEC decode strategy.

The hybrid Fano split (ops/fano_hybrid.py) has two knobs: the device
budget (``DEVICE_MAXCYCLES``) and the host-vs-hybrid mode switch. This
module chooses both from a small startup measurement of the attached
backend:

* ``device_cycle_ms`` — the marginal cost of ONE maxcycle unit of the
  REAL device decoder (ops/fano.py batched_fano), measured as the
  slope between two budgets of the actual program on
  budget-exhausting symbols (differencing cancels dispatch/fetch
  overhead). A bare tiny while_loop is no proxy for it: the production
  fano step carries wide lane state, and its per-iteration cost can sit
  orders of magnitude above a toy loop's. Calibrate on the program you
  ship, not a model of it.
* ``native_timeout_ms`` / ``native_clean_ms`` — one full-budget
  (810k-step) timeout and one clean decode on the native sequential
  decoder (native/hostdsp.cpp), the cost of the host alternative.

Decision rule:

* ``host`` when the cheapest useful device call (budget 16) costs
  DECISIVELY more (2x) than a native full-budget timeout — the device
  search can never win there.
* ``hybrid`` otherwise, with the device budget sized so one call's
  cost lands near the native timeout cost, bucketed to {16, 64, 256}
  so the static-shape compile cache stays small.

Overrides: ``RTLSDR_WSPRD_TPU_FEC`` (``host``/``hybrid``) pins the
mode, ``RTLSDR_WSPRD_TPU_FEC_BUDGET`` pins the device budget.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import asdict, dataclass

import numpy as np

from .. import native
from .fano import FANO_UNROLL, NBITS
from .fano_hybrid import DEVICE_MAXCYCLES as DEFAULT_DEVICE_MAXCYCLES

_LOG = logging.getLogger("rtlsdr_wsprd_tpu.calibrate")
_BUDGET_BUCKETS = (16, 64, 256)


@dataclass(frozen=True)
class FecCalibration:
    mode: str                 # 'host' | 'hybrid'
    device_maxcycles: int     # device budget when mode == 'hybrid'
    unroll: int               # flat steps per while iteration (fano.py)
    device_cycle_ms: float    # marginal ms per maxcycle unit of the
    #                           REAL device decoder; -1.0 = not measured
    native_clean_ms: float    # -1.0 when native unavailable
    native_timeout_ms: float  # -1.0 when native unavailable
    method: str               # 'measured' | 'env' | 'default'

    def as_dict(self) -> dict:
        return asdict(self)


def measure_device_fano_cycle_ms(device=None, lanes: int = 32) -> float:
    """Marginal cost of ONE maxcycle unit of the REAL device decoder
    (ops/fano.py batched_fano), in ms: time the actual program on
    budget-exhausting random symbols at two static budgets and take
    the slope. Costs two compiles of batched_fano."""
    import jax
    import jax.numpy as jnp

    from .fano import batched_fano, build_mettab

    mettab = build_mettab()
    rng = np.random.default_rng(20260821)
    syms = rng.integers(0, 256, (lanes, 2 * NBITS), dtype=np.uint8)
    if device is not None:
        # operands pinned to the REQUESTED device: get_fec_calibration
        # caches per-device keys, so the measurement must run on the
        # chip the key names, not the default one
        syms = jax.device_put(syms, device)
        mt = jax.device_put(np.asarray(mettab), device)
    else:
        syms = jnp.asarray(syms)
        mt = jnp.asarray(mettab)

    def timed(mc: int) -> float:
        batched_fano(syms, mt, delta=60, maxcycles=mc).data \
            .block_until_ready()  # warm
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            batched_fano(syms, mt, delta=60, maxcycles=mc).data \
                .block_until_ready()
            best = min(best, time.perf_counter() - t0)
        return best

    t_lo, t_hi = timed(16), timed(48)
    return max(1e3 * (t_hi - t_lo) / 32.0, 1e-6)


def measure_native_fano_ms(maxcycles: int = 10000):
    """(clean_ms, timeout_ms) on the native sequential decoder."""
    from .fano import build_mettab

    if not native.AVAILABLE:
        return -1.0, -1.0
    mettab = build_mettab()
    rng = np.random.default_rng(20260820)

    # clean case: a real conv-encoded payload at hard soft bits
    # (conv_encode emits ONE 2-bit symbol per input bit; the decoder
    # reads two soft bytes per bit, poly1 first)
    payload = np.zeros(11, np.uint8)
    payload[:6] = rng.integers(0, 256, 6)
    payload[6] = rng.integers(0, 256) & 0xC0
    enc = native.conv_encode(payload, NBITS)
    clean = np.zeros(2 * NBITS, np.uint8)
    clean[0::2] = np.where((enc >> 1) & 1, 230, 25)
    clean[1::2] = np.where(enc & 1, 230, 25)
    # undecodable case: random symbols (burns the full budget)
    noise = rng.integers(0, 256, 162).astype(np.uint8)

    def timed(syms) -> float:
        native.fano_decode(syms, mettab, delta=60, maxcycles=maxcycles)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            native.fano_decode(syms, mettab, delta=60,
                               maxcycles=maxcycles)
            best = min(best, time.perf_counter() - t0)
        return 1e3 * best

    return timed(clean), timed(noise)


def _bucket_budget(raw: float) -> int:
    if raw < 40:
        return _BUDGET_BUCKETS[0]
    if raw < 160:
        return _BUDGET_BUCKETS[1]
    return _BUDGET_BUCKETS[2]


_CACHE: dict = {}


def get_fec_calibration(device=None) -> FecCalibration:
    """Memoized per-process calibration; see module docstring."""
    key = str(device)
    hit = _CACHE.get(key)
    if hit is not None:
        return hit

    env_mode = os.environ.get("RTLSDR_WSPRD_TPU_FEC", "").strip().lower()
    env_budget = os.environ.get("RTLSDR_WSPRD_TPU_FEC_BUDGET", "").strip()
    budget = DEFAULT_DEVICE_MAXCYCLES
    if env_budget:
        try:
            budget = int(env_budget)
        except ValueError:
            # a typo'd override must not take the daemon down at its
            # first decode; fall back and say so
            _LOG.warning("ignoring malformed RTLSDR_WSPRD_TPU_FEC_BUDGET"
                         "=%r (want an integer); using %d", env_budget,
                         budget)
            env_budget = ""
    cal = None
    if env_mode in ("host", "hybrid"):
        cal = FecCalibration(env_mode, budget, FANO_UNROLL,
                             -1.0, -1.0, -1.0, "env")
    elif not native.AVAILABLE:
        # no host decoder: the device search is the only option
        cal = FecCalibration("hybrid", budget, FANO_UNROLL,
                             -1.0, -1.0, -1.0, "default")
    else:
        clean_ms, timeout_ms = measure_native_fano_ms()
        cyc_ms = measure_device_fano_cycle_ms(device=device)
        # cheapest useful device call (the smallest bucket) vs one
        # native full-budget timeout; 2x margin prefers hybrid near
        # the boundary — the probe's fixed dispatch amortizes over
        # real batches and pipelined rounds, so only a DECISIVE loss
        # sends everything to the host
        min_call_ms = _BUDGET_BUCKETS[0] * cyc_ms
        if min_call_ms > 2.0 * timeout_ms:
            mode = "host"
        else:
            mode = "hybrid"
            if not env_budget:
                budget = _bucket_budget(timeout_ms / max(cyc_ms, 1e-9))
        cal = FecCalibration(mode, budget, FANO_UNROLL, round(cyc_ms, 6),
                             round(clean_ms, 4), round(timeout_ms, 3),
                             "measured")
        _LOG.info("FEC calibration: %s", cal)
    _CACHE[key] = cal
    return cal


def describe(mode_arg: str = "auto") -> str:
    """One-line startup-banner description of the FEC strategy in
    effect — production visibility of the calibrated host/hybrid
    decision (an operator on a PCIe host can see which mode was chosen
    and why). Resolves (and caches) the calibration."""
    if mode_arg in ("host", "hybrid"):
        return f"{mode_arg} (pinned by caller)"
    cal = get_fec_calibration()
    s = f"{cal.mode} (method={cal.method}"
    if cal.mode == "hybrid":
        s += f", device budget={cal.device_maxcycles} cycles"
    if cal.method == "measured":
        s += (f"; device {cal.device_cycle_ms:.3g} ms/cycle, native "
              f"clean {cal.native_clean_ms:.3g} / timeout "
              f"{cal.native_timeout_ms:.3g} ms")
    return s + ")"


def device_fano_budget(full_maxcycles: int) -> int:
    """Device-side Fano budget for the hybrid split — the calibrated
    per-backend value, never above the reference's full budget. Every
    producer of device Fano results and every pending_mask consumer
    must use THIS value so straggler detection matches the budget the
    device actually ran."""
    return min(full_maxcycles, get_fec_calibration().device_maxcycles)


__all__ = ["FecCalibration", "get_fec_calibration", "device_fano_budget",
           "describe", "measure_native_fano_ms",
           "DEFAULT_DEVICE_MAXCYCLES"]
