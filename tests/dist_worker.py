"""Worker for the 2-process jax.distributed test (run by
tests/test_distributed.py, one process per 'host').

Covers SURVEY.md section 5's distributed-backend plan end to end on a
CPU cluster: jax.distributed.initialize wiring, global/host-chip mesh
construction, a cross-process collective program (the stage-1
overlap-save halo exchange, whose ppermute rides Gloo between the two
processes = the DCN analog), and the production multi-host decode
architecture (decode_local_shard: each host decodes its own channels).

Usage: python dist_worker.py <rank> <nprocs> <port>
"""

import os
import sys

# Launched as `python tests/dist_worker.py`, which puts tests/ (not the
# repo root) on sys.path — bootstrap the package location so the test is
# self-contained in a non-pip-installed checkout.
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)

rank, nprocs, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=4").strip()

import jax  # noqa: E402

# jax.config.update is authoritative even if jax was imported earlier
jax.config.update("jax_platforms", "cpu")

from rtlsdr_wsprd_tpu import compile_cache  # noqa: E402

compile_cache.enable()

import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from rtlsdr_wsprd_tpu.parallel import distributed as dist  # noqa: E402


def main() -> None:
    dist.initialize(coordinator=f"127.0.0.1:{port}",
                    num_processes=nprocs, process_id=rank)
    assert jax.process_count() == nprocs
    assert jax.process_index() == rank
    n_global = len(jax.devices())
    n_local = len(jax.local_devices())
    assert n_global == nprocs * n_local, (n_global, n_local)

    mesh = dist.global_channel_mesh()
    assert mesh.devices.size == n_global
    hc = dist.host_chip_mesh()
    assert hc.shape["host"] == nprocs
    assert hc.shape["ch"] == n_local

    # -- cross-process collective: sharded stage-1 halo exchange --------
    from rtlsdr_wsprd_tpu.frontend.decimate import decimate_stage1_xla
    from rtlsdr_wsprd_tpu.frontend.filters import R1, STAGE1_TAPS
    from rtlsdr_wsprd_tpu.parallel.streaming import decimate_stage1_sharded

    frames_per_shard = 128
    L = n_global * frames_per_shard * R1
    rng = np.random.default_rng(42)  # identical stream on every host
    xi = rng.normal(0, 30, L).astype(np.float32)
    xq = rng.normal(0, 30, L).astype(np.float32)

    sh = NamedSharding(mesh, P("ch"))
    per = L // n_global
    lo, hi = rank * n_local * per, (rank + 1) * n_local * per
    gxi = jax.make_array_from_process_local_data(sh, xi[lo:hi], (L,))
    gxq = jax.make_array_from_process_local_data(sh, xq[lo:hi], (L,))
    yi, yq = decimate_stage1_sharded(gxi, gxq, mesh, axis="ch")

    # expected: the unsharded kernel on the circularly-extended stream
    # (the sharded ring wraps the final shard's halo to shard 0, so a
    # circular extension reproduces EVERY output frame, tail included)
    nf = L // R1
    tail = STAGE1_TAPS - R1
    ci = np.concatenate([xi, xi[:tail]])
    cq = np.concatenate([xq, xq[:tail]])
    ei, eq = decimate_stage1_xla(ci, cq, nf)
    ei, eq = np.asarray(ei), np.asarray(eq)
    for arr, exp in ((yi, ei), (yq, eq)):
        for s in arr.addressable_shards:
            start = s.index[0].start or 0
            got = np.asarray(s.data)
            np.testing.assert_allclose(
                got, exp[start:start + len(got)], rtol=1e-6, atol=1e-5)

    # -- production multi-host decode: each host its own channels -------
    from rtlsdr_wsprd_tpu.config import DecoderOptions
    from rtlsdr_wsprd_tpu.runtime.iqio import normalize_minus3db
    from rtlsdr_wsprd_tpu.runtime.synth import synth_window_at_snr

    B_global = 2 * nprocs
    msgs = ["K1JT FN20 37", "K9AN EN50 33", "G4ABC IO91 30",
            "VA2GKA FN35 27"]
    sl = dist.local_batch_slice(B_global)
    assert sl == slice(rank * 2, rank * 2 + 2)
    wi = np.zeros((2, 45000), np.float32)
    wq = np.zeros((2, 45000), np.float32)
    for k, g in enumerate(range(sl.start, sl.stop)):
        i, q = synth_window_at_snr(msgs[g], snr_db=5.0,
                                   f0=-70.0 + 40.0 * g, seed=100 + g)
        wi[k], wq[k] = normalize_minus3db(i, q)
    spots = dist.decode_local_shard(
        wi, wq, DecoderOptions(quickmode=True), device_batch=2)
    got = [[s.message for s in ch] for ch in spots]
    want = [[msgs[g]] for g in range(sl.start, sl.stop)]
    assert got == want, (rank, got, want)

    print(f"DIST_OK rank={rank} ndev={n_global}", flush=True)


if __name__ == "__main__":
    main()
