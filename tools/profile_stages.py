"""Per-stage device timing of the decode pipeline (run on the GPU).

Times each jitted stage of multichannel decode separately at the bench
shape (device_batch windows) to show where device time goes, each
ending in ``block_until_ready``.

Usage: python tools/profile_stages.py [device_batch]
"""

from __future__ import annotations

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")
from bench import make_batch  # noqa: E402

from rtlsdr_wsprd_tpu.ops.candidates import find_candidates  # noqa: E402
from rtlsdr_wsprd_tpu.ops.coarse import coarse_search  # noqa: E402
from rtlsdr_wsprd_tpu.ops.fano import batched_fano, build_mettab  # noqa: E402
from rtlsdr_wsprd_tpu.ops.stft import power_spectrogram  # noqa: E402
from rtlsdr_wsprd_tpu.ops.sync import (  # noqa: E402
    fine_sync,
    soft_symbols_jittered,
)

DB = int(sys.argv[1]) if len(sys.argv) > 1 else 16


def barrier(tree):
    jax.block_until_ready(tree)


def timeit(name, fn, *args, iters=3, **kw):
    try:
        out = fn(*args, **kw)  # compile
        barrier(out)
    except Exception as e:  # e.g. HBM OOM for dense stages at big DB
        print(f"{name:28s}    FAILED: {type(e).__name__} {str(e)[:60]}")
        raise SystemExit(1) from e
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kw)
        barrier(out)
    dt = (time.perf_counter() - t0) / iters
    print(f"{name:28s} {dt * 1e3:9.1f} ms")
    return out


def main():
    wi, wq = make_batch(DB)
    sig_i = jnp.asarray(wi)
    sig_q = jnp.asarray(wq)
    maxdrift = jnp.full((DB,), 4, jnp.int32)
    mettab = jnp.asarray(build_mettab())

    stft = jax.jit(jax.vmap(power_spectrogram))
    cands = jax.jit(jax.vmap(lambda p: find_candidates(p, -110.0, 110.0)))
    coarse = jax.jit(jax.vmap(coarse_search))
    fine = jax.jit(jax.vmap(lambda i, q, f, s, d: fine_sync(
        i, q, f, s, d, lagstep=8)))
    jitter = jax.jit(jax.vmap(lambda i, q, f, s, d: soft_symbols_jittered(
        i, q, f, s, d, iifac=3, quickmode=False, symfac=50)))

    print(f"device={jax.devices()[0].platform} DB={DB}")
    ps = timeit("stft power_spectrogram", stft, sig_i, sig_q)
    cd = timeit("find_candidates", cands, ps)
    co = timeit("coarse_search", coarse, ps, cd.bin_idx, maxdrift)
    fs = timeit("fine_sync (33 lags + freq)", fine, sig_i, sig_q,
                co.freq, co.shift, co.drift)
    jt = timeit("soft_symbols_jittered (43)", jitter, sig_i, sig_q,
                fs.freq, fs.shift, co.drift)

    del jt
    # fano at a large attempt shape with all-valid mask (worst case:
    # every lane undecodable noise, runs to the device budget)
    K = 128
    rng = np.random.default_rng(0)
    soft = rng.integers(0, 256, (DB * K, 162)).astype(np.uint8)
    fano_in = jnp.asarray(soft)
    timeit("batched_fano (all-noise, 16cyc)", batched_fano, fano_in, mettab,
           delta=60, maxcycles=16)

    # how many candidates are real at this shape?
    print("valid candidates/window:", np.asarray(cd.valid.sum(axis=1)))
    worth = np.asarray((fs.sync > 0.10) & np.asarray(cd.valid))
    print("minsync1 passers/window:", worth.sum(axis=1))


if __name__ == "__main__":
    main()
