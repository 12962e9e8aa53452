"""Scaling measurements: 1 device / 1 host x N devices / N hosts.

BASELINE.md's target demands scaling measured at 1 chip, 1 host, and
N>=2 hosts. These runs use virtual CPU devices where every "device"
shares the host's cores — wall-clock cannot speed up by
design. What IS measurable and meaningful here is the OVERHEAD the
scaling machinery adds on top of perfectly divided work:

* ``mesh`` mode (1 host x N devices): the SPMD decode step
  (multichannel_decode_device) sharded over 8 virtual devices vs the
  identical step unsharded on one device, same global batch. The step
  has zero cross-device collectives by design (channel-parallel), so
  any delta is pure partitioning overhead; on real chips throughput
  then scales linearly with device count.
* ``dist`` mode (N=2 hosts): two jax.distributed processes each
  decoding half the global batch (parallel/distributed.decode_local_
  shard — the production multi-host architecture) vs one process
  decoding all of it. Work division is measured in per-process CPU
  time (process_time); the ranks' warm+timed phases are STAGGERED via
  a file handshake so each rank's measured decode runs alone on the
  single core (the idle rank sleep-polls) — CPU-seconds per window
  then isolates the jax.distributed runtime overhead instead of also
  charging rank-vs-rank cache thrash to it (the round-2 bound was
  <=35% with both ranks timesharing the core; VERDICT r2 item 8).
* ``daemon`` mode (N=2 hosts, INTEGRATED): the full multi-host daemon
  chain per rank — jax.distributed.initialize + rank_slice channel
  assignment + SyntheticRawBank raw uint8 -> decimate -> window ->
  staged decode -> spots (runtime/multidaemon.MultiChannelDaemon, the
  multicli --nprocs surface) — two ranks on half the global channels
  each vs one solo process on all of them AND on the half set (the
  fixed-shape baseline). Ingest CPU (raw synthesis + front end) is
  reported separately from decode CPU so the distributed-runtime
  overhead is visible on both.

Usage:
    python tools/scaling.py mesh
    python tools/scaling.py dist
    python tools/scaling.py daemon
Prints one JSON line per mode. Results recorded in PARITY.md.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

sys.path.insert(0, ".")

B_GLOBAL = 8
DEVICE_BATCH = 2
DECODE_KW = dict(quickmode=True, lagstep=16, max_attempts=16,
                 maxcycles=64)  # the dryrun config: compile-cache warm


def _force_cpu(ndev: int) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={ndev}"
        ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    from rtlsdr_wsprd_tpu import compile_cache

    compile_cache.enable()


def _windows(n: int):
    import numpy as np

    from rtlsdr_wsprd_tpu.runtime.iqio import normalize_minus3db
    from rtlsdr_wsprd_tpu.runtime.synth import synth_window_at_snr

    wi = np.zeros((n, 45000), np.float32)
    wq = np.zeros((n, 45000), np.float32)
    for k in range(n):
        i, q = synth_window_at_snr(
            "K1JT FN20 37", snr_db=0.0, f0=-90.0 + 23.0 * k, seed=50 + k)
        wi[k], wq[k] = normalize_minus3db(i, q)
    return wi, wq


def mesh_mode() -> None:
    _force_cpu(8)
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rtlsdr_wsprd_tpu.parallel.mesh import channel_sharding, local_mesh
    from rtlsdr_wsprd_tpu.parallel.multichannel import (
        multichannel_decode_device,
    )

    wi, wq = _windows(8)
    md = np.full((8,), 4, np.int32)
    sharding = channel_sharding(local_mesh(8))

    def timed(args):
        out = multichannel_decode_device(*args, **DECODE_KW)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(3):
            out = multichannel_decode_device(*args, **DECODE_KW)
            jax.block_until_ready(out)
        return (time.perf_counter() - t0) / 3, out

    plain_args = (jnp.asarray(wi), jnp.asarray(wq), jnp.asarray(md))
    shard_args = tuple(jax.device_put(a, s) for a, s in zip(
        plain_args, (sharding, sharding, sharding)))
    t_plain, _ = timed(plain_args)
    t_shard, out = timed(shard_args)
    assert len(out.snr.sharding.device_set) == 8
    print(json.dumps({
        "mode": "mesh", "B": 8, "devices": 8,
        "t_unsharded_s": round(t_plain, 4),
        "t_sharded_8dev_s": round(t_shard, 4),
        "spmd_overhead": round(t_shard / t_plain - 1.0, 4),
    }))


def _wait_for(path: str, timeout_s: float = 3000.0) -> None:
    deadline = time.time() + timeout_s
    while not os.path.exists(path):
        time.sleep(0.1)
        if time.time() > deadline:
            raise TimeoutError(f"stagger flag never appeared: {path}")


def dist_worker(rank: int, nprocs: int, port: int,
                stagger: str = "", b_override: int = 0) -> None:
    _force_cpu(4)
    import jax

    from rtlsdr_wsprd_tpu.config import DecoderOptions
    from rtlsdr_wsprd_tpu.parallel import distributed as dist

    if nprocs > 1:
        dist.initialize(coordinator=f"127.0.0.1:{port}",
                        num_processes=nprocs, process_id=rank)
        assert jax.process_count() == nprocs
    # staggered measurement: rank r idles (sleep-polling, ~zero CPU)
    # until rank r-1 finished its whole synth+warm+timed phase, so the
    # measured decode runs ALONE on the core; only the OTHER rank's
    # jax.distributed service threads stay live — which is exactly the
    # overhead being measured. The gate sits right after initialize
    # (which itself requires all ranks connected).
    if stagger and rank > 0:
        _wait_for(f"{stagger}.{rank - 1}")
    b_local = b_override or B_GLOBAL // nprocs
    wi, wq = _windows(B_GLOBAL)
    sl = (dist.local_batch_slice(B_GLOBAL) if nprocs > 1
          else slice(0, b_local))
    opts = DecoderOptions(quickmode=True)

    def run():
        return dist.decode_local_shard(wi[sl], wq[sl], opts,
                                       device_batch=DEVICE_BATCH)

    run()  # warm: compile + caches
    wall = cpu = float("inf")
    for _ in range(3):  # best-of-3: least scheduler contamination
        w0, c0 = time.perf_counter(), time.process_time()
        spots = run()
        wall = min(wall, time.perf_counter() - w0)
        cpu = min(cpu, time.process_time() - c0)
    n_spots = sum(len(ch) for ch in spots)
    assert n_spots >= b_local  # every window carries a 0 dB signal
    print(json.dumps({
        "rank": rank, "nprocs": nprocs, "windows": b_local,
        "wall_s": round(wall, 3), "cpu_s": round(cpu, 3),
        "cpu_s_per_window": round(cpu / b_local, 4),
    }), flush=True)
    if stagger:
        open(f"{stagger}.{rank}", "w").close()
        # the coordinator (rank 0) must outlive every rank's heartbeat
        _wait_for(f"{stagger}.{nprocs - 1}")


C_GLOBAL = 4  # daemon mode: global synthetic channel count


def daemon_worker(rank: int, nprocs: int, port: int,
                  stagger: str = "", c_override: int = 0) -> None:
    """One rank of the INTEGRATED multi-host daemon chain (the multicli
    --nprocs surface without argv plumbing): raw uint8 -> decimate ->
    window -> staged decode -> spots on this rank's channel slice."""
    _force_cpu(2)
    from rtlsdr_wsprd_tpu.config import DecoderOptions
    from rtlsdr_wsprd_tpu.parallel import distributed as dist
    from rtlsdr_wsprd_tpu.runtime.banks import SyntheticRawBank
    from rtlsdr_wsprd_tpu.runtime.multidaemon import MultiChannelDaemon

    if nprocs > 1:
        dist.initialize(coordinator=f"127.0.0.1:{port}",
                        num_processes=nprocs, process_id=rank)
        sl = dist.rank_slice(C_GLOBAL, rank, nprocs)
    else:
        sl = slice(0, c_override or C_GLOBAL)
    # multicli's synthetic channel set, rank-sliced
    f0s = [(37 * k) % 180 - 90.0 for k in range(C_GLOBAL)][sl]
    seeds = list(range(1000, 1000 + C_GLOBAL))[sl]
    c_local = len(f0s)
    opts = DecoderOptions(quickmode=True)

    # pre-render the raw streams ONCE, outside every timer: live
    # synthesis costs ~50 CPU-s per channel-window — two orders above
    # the whole decimate+decode chain — and buried the quantity under
    # test (the distributed runtime's cost on the FRAMEWORK chain) in
    # synthesis load noise when the first version synthesized per run
    src = SyntheticRawBank(c_local, f0s=f0s, seeds=seeds)
    raw_i, raw_q = src.read(2_400_000 * 123)

    class _Replay:
        n_channels = c_local

        def __init__(self):
            self._pos = 0

        def read(self, n):
            lo = self._pos
            self._pos = min(lo + n, raw_i.shape[1])
            return raw_i[:, lo:self._pos], raw_q[:, lo:self._pos]

        def close(self):
            pass

    def run():
        d = MultiChannelDaemon(_Replay(), opts, quiet=True,
                               device_batch=2)
        out = d.run(max_windows=1)
        return d, out

    run()  # warm: compile + caches (CONCURRENT across ranks — only
    # the timed phase below is staggered, halving the serial span)
    if stagger and rank > 0:
        _wait_for(f"{stagger}.{rank - 1}")
    wall = cpu = ingest = float("inf")
    for _ in range(2):  # best-of-2 (each run re-synthesizes its raw)
        w0, c0 = time.perf_counter(), time.process_time()
        d, out = run()
        wall = min(wall, time.perf_counter() - w0)
        cpu = min(cpu, time.process_time() - c0)
        ingest = min(ingest, d.stats.ingest_seconds)
        n_spots = sum(len(ch) for ch in out[0])
        assert n_spots == c_local, (n_spots, c_local)
    print(json.dumps({
        "rank": rank, "nprocs": nprocs, "channels": c_local,
        "wall_s": round(wall, 3), "cpu_s": round(cpu, 3),
        "ingest_s": round(ingest, 3),
        "cpu_s_per_channel_window": round(cpu / c_local, 4),
        "decode_cpu_s_per_channel_window":
            round((cpu - ingest) / c_local, 4),
    }), flush=True)
    if stagger:
        open(f"{stagger}.{rank}", "w").close()
        _wait_for(f"{stagger}.{nprocs - 1}")


def daemon_mode() -> None:
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"

    import tempfile

    stagger = os.path.join(tempfile.mkdtemp(prefix="wspr_scaling_"),
                           "rank_done")

    def launch(rank, nprocs, port, c_override=0):
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "_daemon_worker",
             str(rank), str(nprocs), str(port),
             stagger if nprocs > 1 else "", str(c_override)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env, cwd=REPO)

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()

    p1 = launch(0, 1, 0)
    out1, _ = p1.communicate(timeout=3600)
    assert p1.returncode == 0, out1[-3000:]
    base = json.loads(out1.strip().splitlines()[-1])
    ph = launch(0, 1, 0, c_override=C_GLOBAL // 2)
    outh, _ = ph.communicate(timeout=3600)
    assert ph.returncode == 0, outh[-3000:]
    base_half = json.loads(outh.strip().splitlines()[-1])

    procs = [launch(r, 2, port) for r in (0, 1)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=3600)
        outs.append(out)
    # assert only after BOTH communicated: a dead rank kills its peer
    # through the coordination service, and the peer's log alone hides
    # the root cause
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (
            f"rank {r} failed:\n{out[-2000:]}\n---- other rank:\n"
            f"{outs[1 - r][-2000:]}")
    rows = [json.loads(o.strip().splitlines()[-1]) for o in outs]

    per_1 = base["cpu_s_per_channel_window"]
    per_h = base_half["cpu_s_per_channel_window"]
    per_2 = max(r["cpu_s_per_channel_window"] for r in rows)
    dec_h = base_half["decode_cpu_s_per_channel_window"]
    dec_2 = max(r["decode_cpu_s_per_channel_window"] for r in rows)
    print(json.dumps({
        "mode": "daemon", "C_global": C_GLOBAL,
        "one_proc_cpu_s_per_channel_window": per_1,
        "one_proc_halfset_cpu_s_per_channel_window": per_h,
        "two_proc_cpu_s_per_channel_window": per_2,
        # integrated-chain jax.distributed cost at identical work shape
        "daemon_dist_runtime_overhead": round(per_2 / per_h - 1.0, 4),
        "daemon_dist_overhead_vs_full_set": round(per_2 / per_1 - 1.0, 4),
        # decode side only (ingest = raw synthesis + front end removed)
        "decode_only_dist_runtime_overhead":
            round(dec_2 / dec_h - 1.0, 4),
        "ranks": rows,
    }))


def dist_mode() -> None:
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"

    import tempfile

    stagger = os.path.join(tempfile.mkdtemp(prefix="wspr_scaling_"),
                           "rank_done")

    def launch(rank, nprocs, port, b_override=0):
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "_worker",
             str(rank), str(nprocs), str(port),
             stagger if nprocs > 1 else "", str(b_override)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env, cwd=REPO)

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()

    # solo baselines: full batch (scaling-efficiency denominator) and
    # HALF batch (a rank's exact work shape, so the fixed-shape delta
    # isolates the jax.distributed runtime from batch amortization)
    p1 = launch(0, 1, 0)
    out1, _ = p1.communicate(timeout=3600)
    assert p1.returncode == 0, out1[-3000:]
    base = json.loads(out1.strip().splitlines()[-1])
    ph = launch(0, 1, 0, b_override=B_GLOBAL // 2)
    outh, _ = ph.communicate(timeout=3600)
    assert ph.returncode == 0, outh[-3000:]
    base_half = json.loads(outh.strip().splitlines()[-1])

    procs = [launch(r, 2, port) for r in (0, 1)]
    rows = []
    for p in procs:
        out, _ = p.communicate(timeout=3600)
        assert p.returncode == 0, out[-3000:]
        rows.append(json.loads(out.strip().splitlines()[-1]))

    per_win_1 = base["cpu_s_per_window"]
    per_win_h = base_half["cpu_s_per_window"]
    per_win_2 = max(r["cpu_s_per_window"] for r in rows)
    print(json.dumps({
        "mode": "dist", "B_global": B_GLOBAL,
        "one_proc_cpu_s_per_window": per_win_1,
        "one_proc_halfbatch_cpu_s_per_window": per_win_h,
        "two_proc_cpu_s_per_window": per_win_2,
        # pure jax.distributed runtime cost at identical work shape
        "dist_runtime_overhead": round(per_win_2 / per_win_h - 1.0, 4),
        # total per-window cost growth vs the full solo batch (includes
        # the smaller per-call batch's amortization loss)
        "dist_overhead_vs_full_batch":
            round(per_win_2 / per_win_1 - 1.0, 4),
        "ranks": rows,
    }))


def main() -> None:
    mode = sys.argv[1] if len(sys.argv) > 1 else "mesh"
    if mode == "mesh":
        mesh_mode()
    elif mode == "dist":
        dist_mode()
    elif mode == "daemon":
        daemon_mode()
    elif mode == "_worker":
        dist_worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                    sys.argv[5] if len(sys.argv) > 5 else "",
                    int(sys.argv[6]) if len(sys.argv) > 6 else 0)
    elif mode == "_daemon_worker":
        daemon_worker(int(sys.argv[2]), int(sys.argv[3]),
                      int(sys.argv[4]),
                      sys.argv[5] if len(sys.argv) > 5 else "",
                      int(sys.argv[6]) if len(sys.argv) > 6 else 0)
    else:
        raise SystemExit(f"unknown mode {mode!r}")


if __name__ == "__main__":
    main()
